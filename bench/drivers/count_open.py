"""Open-loop exact count requests to one ``CountServer`` (``kind:
count_open``).

Set-up builds ``CountServer(async_flush=True)`` with its defaults over the
configuration's table, then offers the mix's warm-up requests and waits for
them.  In the window a client thread submits each request when it is due on
the open-loop schedule (``bench/workload.py``), and a second thread takes the
answers in order; a request's latency runs from when it was due to when that
thread holds its answer.  Every request due in the window is waited for, up
to ``answer_wait_s`` past the window's close; one that never comes, or fails,
is missing.

Once the window has closed, ``check_requests`` requests drawn from the seed
are compared, count for count, with the plain reference's counts over the
same table (``bench/reference/table.py``).
"""
from __future__ import annotations

import queue
import sys
import threading
import time
from itertools import chain
from typing import List, Optional

import numpy as np

from bench.harness import SpanDrain
from bench.reference.table import PackedTable, item_matrix, pack_rows
from bench.workload import arrivals, count_requests, rng_for


def open_loop(server, due: np.ndarray, reqs: List, t_base: float,
              wait_s: float):
    """Offer ``reqs[i]`` at ``t_base + due[i]``; returns (answers, done
    times), None where a request got no answer."""
    n = len(reqs)
    answers: List[Optional[np.ndarray]] = [None] * n
    done: List[Optional[float]] = [None] * n
    inbox: "queue.SimpleQueue" = queue.SimpleQueue()
    give_up = t_base + float(due[-1]) + wait_s

    def collect() -> None:
        for _ in range(n):
            i, fut = inbox.get()
            if fut is None:
                continue
            try:
                answers[i] = fut.result(max(0.0, give_up - time.perf_counter()))
                done[i] = time.perf_counter()
            except Exception:    # late past the wait, or failed: missing
                pass

    taker = threading.Thread(target=collect, name="bench-client-answers")
    taker.start()
    try:
        for i, req in enumerate(reqs):
            when = t_base + due[i]
            ahead = when - time.perf_counter()
            if ahead > 0:
                time.sleep(ahead)
            try:
                fut = server.submit_async(f"client-{i % 64}", req)
            except Exception:
                fut = None
            inbox.put((i, fut))
    finally:
        taker.join()
    return answers, done


def run(ctx) -> None:
    import torch
    from repro_torch import obs
    from repro_torch.serve.service import CountServer

    cfg, mix, rec = ctx.cell.cfg, ctx.cell.mix, ctx.record
    rate = mix["rate_per_s"]
    tx, y = ctx.generate(0)
    items = sorted(set(chain.from_iterable(tx)), key=repr)
    warm, due, reqs = count_requests(mix, items, ctx.seed, ctx.seconds)
    server = CountServer(tx, classes=y, n_classes=2, async_flush=True,
                         device=ctx.device)
    try:
        if warm:
            open_loop(server, arrivals(rate, mix["warmup_seconds"],
                                       rng_for(ctx.seed, 4))[:len(warm)],
                      warm, time.perf_counter(), mix["answer_wait_s"])
        if ctx.device.startswith("cuda"):
            torch.cuda.synchronize()
        before = obs.snapshot()
        ctx.setup_done()
        drain = dtrace = None
        if ctx.trace:
            obs.configure(tracing=True)
            drain = SpanDrain(obs.TRACER).__enter__()
            if ctx.device.startswith("cuda"):
                from bench.devtrace import DeviceTrace

                dtrace = DeviceTrace()
                dtrace.start()
        t0 = ctx.window_opens()
        answers, done = open_loop(server, due, reqs, t0,
                                        mix["answer_wait_s"])
        rec.window_t1 = max([d for d in done if d is not None], default=t0)
        if dtrace is not None:
            rec.timeline = dtrace.stop()
        if drain is not None:
            obs.configure(tracing=False)
            drain.__exit__(None, None, None)
            rec.spans = drain.spans
    finally:
        server.close()
    ctx.window_closed()
    after = obs.snapshot()
    rec.counters = {name: obs.counter_total(after, name)
                    - obs.counter_total(before, name)
                    for name in after.get("counters", {})}
    rec.attempted = len(reqs)
    missing = sum(a is None for a in answers)
    rec.failed = missing
    worst = (time.perf_counter() - t0) * 1e3
    rec.latencies_ms = [(float(d - t0 - due[i]) * 1e3 if d is not None else worst)
                        for i, d in enumerate(done)]
    half = len(reqs) // 2
    for part, lat in (("first", rec.latencies_ms[:half]),
                      ("second", rec.latencies_ms[half:])):
        lat = sorted(lat)
        print(f"bench: {part} half of the window at {rate!r}/s: p50 "
              f"{lat[len(lat) // 2]!r} ms, p95 "
              f"{lat[min(len(lat) - 1, int(0.95 * len(lat)))]!r} ms, max "
              f"{lat[-1]!r} ms", file=sys.stderr)

    pick = rng_for(ctx.seed, 3).choice(
        len(reqs), size=min(len(reqs), mix["check_requests"]), replace=False)
    pick = [int(i) for i in pick if answers[i] is not None]
    mat, order = item_matrix(tx)
    yy = np.asarray(y)
    keys = [k for i in pick for k in reqs[i]]
    want = PackedTable(mat, yy, 2, order).counts(keys)
    if ctx.control:      # multiplicities dropped: each distinct row once
        key = np.concatenate([pack_rows(mat), yy[:, None]], axis=1)
        first = np.sort(np.unique(key, axis=0, return_index=True)[1])
        got = PackedTable(mat[first], yy[first], 2, order).counts(keys)
    else:
        got = np.concatenate([np.asarray(answers[i]) for i in pick]) \
            if pick else np.zeros((0, 2), np.int64)
    wrong = int(np.any(got != want, axis=1).sum()) if len(keys) else 0
    rec.checks.append(("wrong_counts", wrong, 0))
    rec.checks.append(("missing_answers", missing, 0))
