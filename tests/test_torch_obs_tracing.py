"""The port's span tracer on its two host paths, on the CPU: the span tree
of a Minority-Report job, a count request's lock and queue wait, the
dispatch kept outside the flush, Python's collector as ``py.gc`` spans, and
nothing recorded or installed with tracing off."""
from __future__ import annotations

import gc
import threading
import time
import tracemalloc
from pathlib import Path

import pytest

from repro_torch import obs
from repro_torch.data.synth import bernoulli_db
from repro_torch.mining.dense import minority_report_dense
from repro_torch.obs import TRACER, hist_get
from repro_torch.serve.service import CountServer


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    obs.reset()
    yield
    obs.reset()


@pytest.fixture(scope="module")
def table():
    return bernoulli_db(3000, 16, 0.2, 0.1, 7)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _ancestors(span, by_id):
    while span.parent_id is not None:
        span = by_id[span.parent_id]
        yield span


# the tree of one job: every span and the name of its parent
_MRA_TREE = {
    "mra.job": None,
    "mra.encode": "mra.job",
    "mra.scan": "mra.encode",
    "encode.bitmap": "mra.encode",
    "encode.dedup": "mra.encode",
    "encode.upload": "mra.encode",
    "mine.driver": "mra.job",
    "mine.singles": "mine.driver",
    "mine.candidates": "mine.driver",
    "mine.level": "mine.driver",
    "mine.absorb": "mine.driver",
    "mra.fused": "mra.job",
    "mra.rules": "mra.job",
}


def test_minority_report_job_gives_the_span_tree(table):
    tx, y = table
    # every seventh non-empty row repeats its first item: set semantics
    tx = [t + t[:1] if i % 7 == 0 and t else t for i, t in enumerate(tx)]
    planted = sum(1 for i, t in enumerate(table[0]) if i % 7 == 0 and t)
    assert planted > 0
    obs.configure(tracing=True)
    res = minority_report_dense(tx, y, min_support=0.01,
                                min_confidence=0.05, device="cpu")
    obs.configure(tracing=False)
    assert res.rules
    spans = TRACER.spans()
    by_id = {s.span_id: s for s in spans}
    named = _by_name(spans)
    assert set(_MRA_TREE) <= set(named)
    for name, parent in _MRA_TREE.items():
        for s in named[name]:
            got = by_id[s.parent_id].name if s.parent_id else None
            assert got == parent, (name, got)
            if parent is not None:
                p = by_id[s.parent_id]
                assert p.t0 <= s.t0 <= s.t1 <= p.t1, name
    (job,) = named["mra.job"]
    (dedup,) = named["encode.dedup"]
    assert dedup.attrs["rows_in"] == len(tx)
    assert 0 < dedup.attrs["rows_out"] <= len(tx)
    (scan,) = named["mra.scan"]
    assert scan.attrs["items_kept"] == len(res.items_kept)
    assert scan.attrs["items_in"] == sum(map(len, tx))
    assert scan.attrs["repeats_dropped"] == planted
    (encode,) = named["mra.encode"]
    assert [s.name for s in spans if s.parent_id == encode.span_id] == [
        "mra.scan", "encode.bitmap", "encode.dedup", "encode.upload"]
    levels = [(s.attrs["level"], s.attrs["n_candidates"])
              for s in named["mine.candidates"]]
    assert [lv for lv, _ in levels] == list(range(2, 2 + len(levels)))
    counted = {s.attrs["level"]: s.attrs["n_candidates"]
               for s in named["mine.level"]}
    assert all(counted[lv] == n for lv, n in levels if n)
    # the job's four parts lie inside it, one after another
    parts = sum(s.t1 - s.t0 for n in ("mra.encode", "mine.driver",
                                      "mra.fused", "mra.rules")
                for s in named[n])
    assert parts <= job.t1 - job.t0


class _AnnouncedLock:
    """The server's lock, announcing when the watched thread starts to take
    it, so that a holder can keep it for a known time after that."""

    def __init__(self, lock, watched: int) -> None:
        self._lock = lock
        self._watched = watched
        self.asked = threading.Event()

    def __enter__(self):
        if threading.get_ident() == self._watched:
            self.asked.set()
        return self._lock.__enter__()

    def __exit__(self, *exc):
        return self._lock.__exit__(*exc)


def test_lock_wait_and_queue_wait_count_a_held_server_lock(table):
    tx, y = table
    server = CountServer(tx, classes=y, n_classes=2, async_flush=True,
                         device="cpu")
    lock = server._lock = _AnnouncedLock(server._lock, threading.get_ident())
    try:
        obs.configure(tracing=True)
        held = threading.Event()

        def hold() -> None:
            # held from before the submit asks for the lock until 50 ms
            # after it has asked
            with lock:
                held.set()
                assert lock.asked.wait(10)
                time.sleep(0.05)

        holder = threading.Thread(target=hold)
        holder.start()
        assert held.wait(10)
        fut = server.submit_async("c", [tx[0][:2]])
        fut.result(30)
        holder.join(10)
        assert not holder.is_alive()
        obs.configure(tracing=False)
    finally:
        server.close()
    named = _by_name(TRACER.spans())
    (lock,) = [s for s in named["serve.lock_wait"]
               if s.attrs["ticket"] == fut.ticket]
    (queued,) = [s for s in named["serve.queued"]
                 if s.attrs["ticket"] == fut.ticket]
    assert lock.t1 - lock.t0 >= 0.045
    assert queued.t1 - queued.t0 >= 0.045
    assert queued.t0 == lock.t0 and queued.parent_id is None
    dedup = [s for s in named["serve.dedup"]
             if s.attrs.get("first_ticket", -1) <= fut.ticket
             <= s.attrs.get("last_ticket", -1)]
    assert len(dedup) == 1
    h = hist_get(obs.snapshot(), "serve_queue_wait_ms")
    assert h["count"] == 1 and h["sum"] >= 45.0
    assert h["sum"] == pytest.approx(1e3 * (queued.t1 - queued.t0))


def test_dispatch_is_never_inside_a_flush(table):
    tx, y = table
    server = CountServer(tx, classes=y, n_classes=2, async_flush=True,
                         max_delay_ms=2.0, min_batch=4, device="cpu")
    try:
        obs.configure(tracing=True)
        # the flusher parks again once this is answered, now traced, and
        # the next submit wakes it
        server.submit_async("first", [tx[0][:2]]).result(30)
        time.sleep(0.05)
        futs = [server.submit_async(f"c{i}", [tx[i][:2], tx[i + 1][:3]])
                for i in range(24)]
        ticket = server.submit("sync", [tx[0][:1]])
        out = server.flush()
        for f in futs:
            f.result(30)
        obs.configure(tracing=False)
    finally:
        server.close()
    assert ticket in out
    spans = TRACER.spans()
    by_id = {s.span_id: s for s in spans}
    named = _by_name(spans)
    assert named["serve.dispatch"] and named["serve.flush"]
    for s in named["serve.dispatch"]:
        assert "serve.flush" not in {a.name for a in _ancestors(s, by_id)}
    ended = {s.attrs["ended"] for s in named["serve.batch_wait"]}
    assert "woken" in ended and ended <= {"woken", "timeout", "backoff"}
    # the flush's inner spans are still its descendants
    for name in ("serve.dedup", "serve.cache_lookup", "serve.masks"):
        for s in named[name]:
            assert "serve.flush" in {a.name for a in _ancestors(s, by_id)}


def test_collections_are_spans_only_while_tracing():
    obs.configure(tracing=True)
    with TRACER.span("outer") as outer:
        gc.collect()
    obs.configure(tracing=False)
    n_on = len(TRACER.spans())
    gc.collect()
    assert len(TRACER.spans()) == n_on
    full = [s for s in TRACER.spans() if s.name == "py.gc"
            and s.attrs["generation"] == 2
            and s.tid == threading.get_ident()]
    assert len(full) == 1
    (s,) = full
    assert s.parent_id == outer.span_id
    assert outer.t0 <= s.t0 <= s.t1 <= outer.t1
    assert isinstance(s.attrs["collected"], int)


def test_tracing_off_installs_no_hook_and_allocates_no_span(table):
    tx, y = table
    before = list(gc.callbacks)
    obs.configure(tracing=True)
    assert len(gc.callbacks) == len(before) + 1
    obs.configure(tracing=True)          # switching on twice installs once
    assert len(gc.callbacks) == len(before) + 1
    obs.configure(tracing=False)
    assert gc.callbacks == before
    obs.configure(tracing=True)
    obs.reset()
    assert gc.callbacks == before
    TRACER.enabled = True                # the flag alone is the same switch
    assert len(gc.callbacks) == len(before) + 1
    TRACER.enabled = False
    assert gc.callbacks == before

    server = CountServer(tx, classes=y, n_classes=2, device="cpu")
    reqs = [[tx[i][:2], tx[i + 1][:3]] for i in range(40)]

    def hot() -> None:
        for r in reqs:
            server.submit("c", r)
        server.flush()
        gc.collect()

    hot()                                # warm up lazy imports and caches
    tracing_py = str(Path(obs.__file__).parent / "tracing.py")
    tracemalloc.start()
    snap0 = tracemalloc.take_snapshot()
    hot()
    snap1 = tracemalloc.take_snapshot()
    tracemalloc.stop()
    grown = [d for d in snap1.compare_to(snap0, "lineno")
             if d.size_diff > 0
             and d.traceback[0].filename == tracing_py]
    assert not grown, [str(d) for d in grown]
    assert TRACER.spans() == []
    assert gc.callbacks == before
