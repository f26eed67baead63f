"""Closed-loop Minority-Report mine jobs (``kind: mine_jobs``).

One analyst runs whole ``minority_report_dense`` jobs back to back, over a
pool of ``pool`` tables made in set-up from the seed, in turn, so that no job
meets the table of the job before it.  A job that starts inside the window
runs to its end.  Set-up ends with one job over the first ``warmup_rows`` rows
of the first table, which loads the kernels.

Each job's rule list is compared, once the window has closed, with the plain
reference (``bench/reference/mra.py``) over the same table: every rule's
antecedent, its two class counts, its support and its confidence.

In the traced run the harness wraps the calls into two layers of the port,
``mining.dense.mra_encode`` and ``mining.driver.mine_frequent``, to time
them, counts the wrapper's launches per job, turns the program's spans on
and profiles the card.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List

from bench.harness import SpanDrain
from bench.reference.mra import minority_report


def _rules(result) -> Dict:
    return {frozenset(r.antecedent): (r.count, r.g_count, r.support,
                                      r.confidence) for r in result.rules}


def mismatches(got: Dict, want: Dict) -> int:
    """Antecedents missing on one side or with different numbers."""
    return sum(got.get(k) != want.get(k) for k in set(got) | set(want))


class _Timed:
    """Wraps a module attribute; adds each call's seconds to ``job[key]``
    and its span to ``spans``."""

    def __init__(self, module, attr: str, key: str, jobs: List[dict],
                 spans: list):
        self.module, self.attr, self.key, self.jobs = module, attr, key, jobs
        self.spans = spans
        self.inner = getattr(module, attr)

    def __call__(self, *a, **kw):
        t = time.perf_counter()
        try:
            return self.inner(*a, **kw)
        finally:
            t1 = time.perf_counter()
            job = self.jobs[-1]
            job[self.key] = job.get(self.key, 0.0) + t1 - t
            self.spans.append((f"bench.{self.attr}", t, t1))

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.inner)


def run(ctx) -> None:
    import contextlib

    import torch
    from repro_torch import obs
    from repro_torch.kernels.itemset_count import ops
    from repro_torch.mining import dense, driver

    cfg, mix, rec = ctx.cell.cfg, ctx.cell.mix, ctx.record
    params = dict(min_support=cfg["min_support"],
                  min_confidence=cfg["min_confidence"])
    pool = [ctx.generate(i) for i in range(mix["pool"])]
    tx, y = pool[0]
    n = mix["warmup_rows"]
    try:
        dense.minority_report_dense(tx[:n], y[:n], device=ctx.device,
                                    **params)
        warm_failed = 0
    except Exception as e:       # judged with the window's jobs
        print(f"bench: the warm-up job failed: {e!r}", file=sys.stderr)
        warm_failed = 1
    if ctx.device.startswith("cuda"):
        torch.cuda.synchronize()

    jobs: List[dict] = []
    own_spans: list = []
    ctx.setup_done()
    with contextlib.ExitStack() as stack:
        if ctx.trace:
            from bench.devtrace import DeviceTrace

            stack.enter_context(_Timed(dense, "mra_encode", "encode_s", jobs,
                                       own_spans))
            stack.enter_context(_Timed(driver, "mine_frequent", "driver_s",
                                       jobs, own_spans))
            obs.configure(tracing=True)
            drain = stack.enter_context(SpanDrain(obs.TRACER))
            dtrace = DeviceTrace()
            if ctx.device.startswith("cuda"):
                dtrace.start()
        t0 = ctx.window_opens()
        results = []
        while time.perf_counter() < t0 + ctx.seconds:
            db = len(jobs) % len(pool)
            job = {"db": db, "launches": -ops.KERNEL_LAUNCHES,
                   "t0": time.perf_counter()}
            jobs.append(job)
            tx, y = pool[db]
            try:
                results.append(dense.minority_report_dense(
                    tx, y, device=ctx.device, **params))
            except Exception as e:   # a failed job is counted, not timed
                print(f"bench: job {len(jobs)} failed: {e!r}",
                      file=sys.stderr)
                results.append(e)
            job["t1"] = time.perf_counter()
            job["launches"] += ops.KERNEL_LAUNCHES
        rec.window_t1 = jobs[-1]["t1"]
        if ctx.trace:
            if ctx.device.startswith("cuda"):
                rec.timeline = dtrace.stop()
            obs.configure(tracing=False)
    if ctx.trace:
        rec.spans = drain.spans + own_spans + [
            ("bench.job", j["t0"], j["t1"]) for j in jobs]
    ctx.window_closed()
    print("bench: job seconds " + " ".join(
        f"{j['t1'] - j['t0']:.4f}" for j in jobs), file=sys.stderr)
    rec.jobs = jobs
    rec.attempted = len(jobs)
    rec.failed = sum(isinstance(r, Exception) for r in results)

    wrong = 0
    refs: Dict[int, object] = {}
    controls: Dict[int, Dict] = {}
    for job, got in zip(jobs, results):
        if isinstance(got, Exception):
            continue
        db = job["db"]
        if db not in refs:
            refs[db] = minority_report(*pool[db], **params)
        if ctx.control:
            if db not in controls:
                controls[db] = minority_report(
                    *pool[db], multiplicity=False, **params).rules
            got = controls[db]
        else:
            got = _rules(got)
        wrong += mismatches(got, refs[db].rules)
        job["passes"] = refs[db].passes
    rec.checks.append(("rule_mismatches", wrong, 0))
    rec.checks.append(("failed_jobs", rec.failed + warm_failed, 0))
