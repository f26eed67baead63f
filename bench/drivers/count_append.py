"""Exact count requests to one ``CountServer`` while one ingest client
appends to its store (``kind: count_append``).

Set-up builds a ``CountServer`` with the configuration's ``server`` options
(``async_flush``, ``background_compaction``, the fold's ``merge_ratio``),
otherwise with its defaults, over the configuration's table, and asks it one
request: an answer that does not name the store version it was counted at
cannot be checked while the store grows, so set-up stops there with no
result.  It then appends ``initial_delta_rows`` rows of a second table of the
same model (stream ``append_stream`` of the seed) in batches of
``append_rows``, and offers the warm-up with both streams.

In the window the count stream is ``count_open``'s open loop, unchanged.
The ingest client, on its own thread, appends the next ``append_rows`` rows
of the second table every ``1 / append_rate_per_s`` seconds on a fixed
schedule, and records each append's acknowledgement and the version it
returned.  Each count request records the version of the last append the
client had acknowledged before the request was submitted.  At the window's
close the client stops issuing appends; one that was due in the window and
is not acknowledged within ``answer_wait_s`` after the close, or that
raises, has failed.

Once both streams are over, ``check_requests`` requests drawn from the seed
are compared, count for count, with the plain reference's counts at the
version each answer names (``bench/reference/versioned.py``), and every
answer at a version older than its request's acknowledged one is stale.
"""
from __future__ import annotations

import sys
import threading
import time
from itertools import chain
from typing import List, Optional, Tuple

import numpy as np

from bench.drivers.count_open import open_loop
from bench.harness import HarnessError, SpanDrain, load_file
from bench.metrics._common import nearest_rank
from bench.reference.table import item_matrix
from bench.reference.versioned import VersionedTable
from bench.workload import arrivals, count_requests, rng_for


class Ingest:
    """One ingest client over the rows of the second table, taken in
    order."""

    def __init__(self, server, rows, classes, batch_rows: int,
                 base_rows: int):
        self.server = server
        self.rows, self.classes = rows, classes
        self.batch_rows = batch_rows
        self.next_row = 0
        self.taken: List[Tuple[int, int]] = []    # acknowledged batches
        self.rows_at = {0: base_rows}   # version -> rows of the history
        self.acked = 0                  # version of the last acknowledged

    def append_next(self) -> int:
        a, b = self.next_row, self.next_row + self.batch_rows
        self.next_row = b
        version = self.server.append(self.rows[a:b],
                                     classes=self.classes[a:b])
        self.taken.append((a, b))
        self.rows_at[version] = self.rows_at[self.acked] + (b - a)
        self.acked = version
        return version

    def run(self, t_base: float, n_batches: int, period: float,
            give_up: float, log: list) -> None:
        """Append batch ``j`` at ``t_base + j * period`` (late ones at
        once); one not issued by ``give_up`` is not issued.  Logs (due,
        called, acknowledged, version or None) per append issued."""
        for j in range(n_batches):
            due = t_base + j * period
            ahead = due - time.perf_counter()
            if ahead > 0:
                time.sleep(ahead)
            called = time.perf_counter()
            if called > give_up:
                return
            try:
                version: Optional[int] = self.append_next()
            except Exception as e:     # a failed append: counted, not fatal
                print(f"bench: append {j} failed: {type(e).__name__}: {e}",
                      file=sys.stderr)
                version = None
            log.append((due, called, time.perf_counter(), version))


class VersionedClient:
    """The count client's view of the server: each submit records the
    version of the last acknowledged append, and keeps the future so that
    its answer's version can be read."""

    def __init__(self, server, ingest: Ingest):
        self.server, self.ingest = server, ingest
        self.acked_at: List[int] = []
        self.futures: list = []

    def submit_async(self, client_id, itemsets):
        self.acked_at.append(self.ingest.acked)
        self.futures.append(None)
        fut = self.server.submit_async(client_id, itemsets)
        self.futures[-1] = fut
        return fut


def _report_appends(log: list, t0: float, seconds: float) -> None:
    ok = [(due, called, acked) for due, called, acked, v in log
          if v is not None]
    if not ok:
        print("bench: no append acknowledged in the window", file=sys.stderr)
        return
    service = [1e3 * (acked - called) for _, called, acked in ok]
    late = [1e3 * (acked - due) for due, _, acked in ok]
    print(f"bench: appends acknowledged {len(ok)}: service p50 "
          f"{nearest_rank(service, 0.5)!r} ms, p99 "
          f"{nearest_rank(service, 0.99)!r} ms; from due p50 "
          f"{nearest_rank(late, 0.5)!r} ms", file=sys.stderr)
    for name, lo, hi in (("first", 0.0, 0.2), ("last", 0.8, 1.0)):
        part = [s for (d, _, _), s in zip(ok, service)
                if lo * seconds <= d - t0 < hi * seconds]
        if part:
            print(f"bench: appends in the window's {name} fifth: {len(part)}"
                  f", mean {sum(part) / len(part)!r} ms, p50 "
                  f"{nearest_rank(part, 0.5)!r} ms", file=sys.stderr)


def run(ctx) -> None:
    import torch
    from repro_torch import obs
    from repro_torch.serve.service import CountServer

    cfg, mix, rec = ctx.cell.cfg, ctx.cell.mix, ctx.record
    rate, wait = mix["rate_per_s"], mix["answer_wait_s"]
    period = 1.0 / mix["append_rate_per_s"]
    per = mix["append_rows"]
    warm_batches = int(round(mix["append_rate_per_s"]
                             * mix["warmup_seconds"]))
    window_batches = int(round(mix["append_rate_per_s"] * ctx.seconds))
    setup_batches = -(-mix["initial_delta_rows"] // per)
    tx, y = ctx.generate(0)
    gen = load_file(ctx.root / "bench" / "generators"
                    f"/{cfg['generator']}.py",
                    f"bench_generator_{cfg['generator']}")
    n_more = per * (setup_batches + warm_batches + window_batches)
    more, y_more = gen.generate(dict(cfg, n_transactions=n_more),
                                [int(ctx.seed) % (1 << 64),
                                 mix["append_stream"]])
    items = sorted(set(chain.from_iterable(tx)), key=repr)
    warm, due, reqs = count_requests(mix, items, ctx.seed, ctx.seconds)
    server = CountServer(tx, classes=y, n_classes=2, device=ctx.device,
                         **cfg["server"])
    try:
        probe = server.submit_async("probe", [tuple(items[:2])])
        probe.result(wait)
        if getattr(probe, "version", None) is None:
            raise HarnessError("the count server's answers name no store "
                               "version, so none can be checked while the "
                               "store takes appends")
        ingest = Ingest(server, more, y_more, per, len(tx))
        for _ in range(setup_batches):
            ingest.append_next()
        if warm:
            t_warm = time.perf_counter()
            side = threading.Thread(
                target=ingest.run, name="bench-ingest-warmup",
                args=(t_warm, warm_batches, period, t_warm
                      + mix["warmup_seconds"] + wait, []))
            side.start()
            open_loop(server, arrivals(rate, mix["warmup_seconds"],
                                       rng_for(ctx.seed, 4))[:len(warm)],
                      warm, t_warm, wait)
            side.join()
        if ctx.device.startswith("cuda"):
            torch.cuda.synchronize()
        ctx.setup_done()
        drain = dtrace = None
        if ctx.trace:
            obs.configure(tracing=True)
            drain = SpanDrain(obs.TRACER).__enter__()
            if ctx.device.startswith("cuda"):
                from bench.devtrace import DeviceTrace

                dtrace = DeviceTrace()
                dtrace.start()
        client = VersionedClient(server, ingest)
        log: list = []
        delta_open = server.store.delta_rows
        before = obs.snapshot()
        t0 = ctx.window_opens()
        give_up = t0 + ctx.seconds + wait
        feeder = threading.Thread(
            target=ingest.run, name="bench-ingest", daemon=True,
            args=(t0, window_batches, period, give_up, log))
        feeder.start()
        answers, done = open_loop(client, due, reqs, t0, wait)
        feeder.join(max(0.0, give_up - time.perf_counter()) + 1.0)
        rec.window_t1 = max([d for d in done if d is not None], default=t0)
        after = obs.snapshot()
        delta_close = server.store.delta_rows
        if dtrace is not None:
            rec.timeline = dtrace.stop()
        if drain is not None:
            obs.configure(tracing=False)
            drain.__exit__(None, None, None)
            rec.spans = drain.spans
    finally:
        server.close()
    ctx.window_closed()
    rec.counters = {name: obs.counter_total(after, name)
                    - obs.counter_total(before, name)
                    for name in after.get("counters", {})}
    acked_in_time = sum(1 for _, _, a, v in list(log)
                        if v is not None and a <= give_up)
    failed_appends = window_batches - acked_in_time
    missing = sum(a is None for a in answers)
    rec.attempted = len(reqs) + window_batches
    rec.failed = missing + failed_appends
    worst = (time.perf_counter() - t0) * 1e3
    rec.latencies_ms = [(float(d - t0 - due[i]) * 1e3 if d is not None
                         else worst) for i, d in enumerate(done)]
    lat = rec.latencies_ms
    print(f"bench: count p50 {nearest_rank(lat, 0.5)!r} ms, p95 "
          f"{nearest_rank(lat, 0.95)!r} ms at {rate!r}/s; delta rows "
          f"{delta_open} at the window's open, {delta_close} at its close; "
          f"folds committed in the window "
          f"{rec.counters.get('store_compactions_total', 0.0)!r}, builds "
          f"discarded "
          f"{rec.counters.get('store_discarded_compactions_total', 0.0)!r}",
          file=sys.stderr)
    half = len(reqs) // 2
    for part, lat in (("first", lat[:half]), ("second", lat[half:])):
        print(f"bench: {part} half of the window: count p50 "
              f"{nearest_rank(lat, 0.5)!r} ms, p95 "
              f"{nearest_rank(lat, 0.95)!r} ms", file=sys.stderr)
    _report_appends(list(log), t0, ctx.seconds)

    n = len(reqs)
    version = [None if answers[i] is None else client.futures[i].version
               for i in range(n)]
    acked_at = client.acked_at
    pick = rng_for(ctx.seed, 3).choice(
        n, size=min(n, mix["check_requests"]), replace=False)
    pick = [int(i) for i in pick if answers[i] is not None]
    got = {i: np.asarray(answers[i]) for i in pick}
    if ctx.control:     # one increment too few: the version before the ack
        version = [None if v is None else acked_at[i] - 1
                   for i, v in enumerate(version)]
    history = tx + list(chain.from_iterable(more[a:b]
                                            for a, b in ingest.taken))
    classes = np.concatenate([np.asarray(y)]
                             + [np.asarray(y_more[a:b])
                                for a, b in ingest.taken])
    mat, order = item_matrix(history)
    ref = VersionedTable(mat, classes, 2, order, ingest.rows_at)
    if ctx.control:
        got = {i: ref.counts_at(version[i], reqs[i]) for i in pick}
    wrong = 0
    truth = [client.futures[i].version for i in pick]
    for v in sorted(set(truth)):
        group = [i for i, t in zip(pick, truth) if t == v]
        keys = [k for i in group for k in reqs[i]]
        if v not in ref.rows_at:         # no acknowledged append made it
            wrong += len(keys)
            continue
        want = ref.counts_at(v, keys)
        mine = np.concatenate([got[i] for i in group])
        wrong += int(np.any(mine != want, axis=1).sum())
    stale = sum(1 for i, v in enumerate(version)
                if v is not None and v < acked_at[i])
    rec.checks.append(("wrong_counts", wrong, 0))
    rec.checks.append(("stale_answers", stale, 0))
    rec.checks.append(("missing_answers", missing, 0))
    rec.checks.append(("failed_appends", failed_appends, 0))
