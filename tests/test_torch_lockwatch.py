"""The port's runtime lock-order watcher (``repro_torch.obs.lockwatch``)
against the JAX package's, and against the static lock graph.

The watcher mechanics are the reference's battery (``tests/test_lockwatch.py``)
re-run on the port, plus side-by-side runs of both packages' watchers on the
same acquisition sequences and cycle searches.  The live half instruments
the port's async count servers (on the CPU) and a rule server over one,
races threads against appends, and asserts no order cycle and that every
edge observed live is in the static graph that the JAX package's
``ConcurrencyChecker`` derives from ``src/repro_torch`` (tests may import
both packages; the port imports neither JAX nor the JAX package).  The
static graph of the port is itself acyclic and has the reference's edges.

The inversion test runs its two threads SEQUENTIALLY (thread 1 fully
releases before thread 2 starts): the watcher flags the ordering hazard
without the test ever risking an actual deadlock.
"""
import functools
import threading
from pathlib import Path

import numpy as np
import pytest

import repro.obs.lockwatch as jlw
from repro.analysis import ConcurrencyChecker, analyze_paths
from repro_torch import obs
from repro_torch.obs import (LockOrderError, LockOrderWatcher, WatchedLock,
                             instrument_server)
from repro_torch.obs.lockwatch import _find_cycle
from repro_torch.serve import CountServer, RuleServer

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src" / "repro_torch"
JAX_SRC = REPO / "src" / "repro"

_server = functools.partial(CountServer, device="cpu")


def _db(rng, rows, items, p=0.3):
    return [[int(a) for a in range(items) if rng.random() < p]
            for _ in range(rows)]


def _static(src):
    checker = ConcurrencyChecker()
    findings, _ = analyze_paths([str(src)], [checker], root=str(src))
    return checker.lock_edges, findings


@pytest.fixture(scope="module")
def static_edges():
    edges, _ = _static(SRC)
    return set(edges)


@pytest.fixture
def unwrap_registry():
    """Unwrap the PROCESS-GLOBAL registry lock after the test, so later
    tests see the plain lock again (the server locks die with the
    server)."""
    yield
    while isinstance(obs.REGISTRY._lock, WatchedLock):
        obs.REGISTRY._lock = obs.REGISTRY._lock._lock


# -- watcher mechanics --------------------------------------------------------

def test_nested_acquire_records_edge():
    w = LockOrderWatcher()
    a = w.wrap(threading.Lock(), "A")
    b = w.wrap(threading.Lock(), "B")
    for _ in range(2):
        with a:
            with b:
                pass
    assert w.edges() == {("A", "B"): 2}
    assert w.cycles() == []
    w.check()   # must not raise


def test_reentrant_rlock_adds_no_self_edge():
    w = LockOrderWatcher()
    r = w.wrap(threading.RLock(), "R")
    with r:
        with r:
            with r:
                pass
    assert w.edges() == {}


def test_wrapped_lock_proxies_the_real_lock():
    w = LockOrderWatcher()
    lock = threading.Lock()
    wrapped = w.wrap(lock, "L")
    assert isinstance(wrapped, WatchedLock)
    assert wrapped.acquire(blocking=False)
    assert lock.locked()          # __getattr__ passthrough + real acquire
    wrapped.release()
    assert not lock.locked()


def test_synthetic_abba_inversion_detected():
    w = LockOrderWatcher()
    a = w.wrap(threading.Lock(), "A")
    b = w.wrap(threading.Lock(), "B")

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    # sequential threads: the ORDER hazard is recorded, no deadlock risk
    for target in (forward, backward):
        t = threading.Thread(target=target)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()

    assert w.edges() == {("A", "B"): 1, ("B", "A"): 1}
    cycles = w.cycles()
    assert len(cycles) == 1
    assert set(cycles[0]) == {"A", "B"}
    with pytest.raises(LockOrderError, match="cycle"):
        w.check()
    report = w.report()
    assert report["locks"] == ["A", "B"]
    assert set(report["edges"]) == {"A -> B", "B -> A"}
    w.reset()
    assert w.edges() == {} and w.cycles() == []


# -- side by side with the JAX package's watcher ------------------------------

def _replay(watcher_cls, script):
    """Run one acquisition script (a list of per-thread nestings, each a
    list of lock names acquired in order, released in reverse) through a
    watcher of either package; threads run one after another."""
    w = watcher_cls()
    locks = {}
    for nest in script:
        for name in nest:
            if name not in locks:
                locks[name] = w.wrap(threading.RLock(), name)

    def run(nest):
        for name in nest:
            locks[name].acquire()
        for name in reversed(nest):
            locks[name].release()

    for nest in script:
        t = threading.Thread(target=run, args=(nest,))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    return w


@pytest.mark.parametrize("seed", range(6))
def test_watcher_reports_match_jax(seed):
    rng = np.random.default_rng(seed)
    names = [f"L{i}" for i in range(5)]
    script = [[names[int(i)] for i in rng.integers(0, 5, size=int(n))]
              for n in rng.integers(1, 5, size=8)]
    mine = _replay(LockOrderWatcher, script)
    theirs = _replay(jlw.LockOrderWatcher, script)
    assert mine.edges() == theirs.edges()
    assert mine.cycles() == theirs.cycles()
    assert mine.report() == theirs.report()


@pytest.mark.parametrize("seed", range(8))
def test_find_cycle_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    adj = {}
    for _ in range(int(rng.integers(0, 12))):
        a, b = (f"n{int(x)}" for x in rng.integers(0, 6, size=2))
        adj.setdefault(a, set()).add(b)
    assert _find_cycle(adj) == jlw._find_cycle(adj)


# -- the static graph of the port ----------------------------------------------

def test_static_graph_of_the_port_is_acyclic_and_matches_jax():
    """No CONC001 cycle in the port's sources, and the port's serving
    layer nests its locks exactly as the reference's does."""
    edges, findings = _static(SRC)
    assert [f for f in findings if f.code == "CONC001"] == []
    jax_edges, _ = _static(JAX_SRC)
    assert set(edges) == set(jax_edges)
    assert ("CountServer._lock", "AsyncFlusher._lat_lock") in edges
    assert ("VersionedDB._store_lock", "AsyncCompactor._mu") in edges


# -- the real cross-check: live serving traffic vs the static graph ----------

def _race(threads, timeout=60):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive()


def _check_live(watcher, static_edges, must_see):
    observed = set(watcher.edges())
    assert watcher.cycles() == [], watcher.report()
    for edge in must_see:
        assert edge in observed, (edge, watcher.report())
    assert observed <= static_edges, (
        f"dynamic run observed lock edges the static checker missed: "
        f"{sorted(observed - static_edges)}")


def test_threaded_serving_traffic_has_no_lock_cycles(rng, static_edges,
                                                     unwrap_registry):
    """Instrumented async CountServer under concurrent submit/stats
    traffic: no order cycles, and observed edges ⊆ static lock graph."""
    srv = _server(_db(rng, 96, 12), async_flush=True, max_delay_ms=20,
                  min_batch=4)
    watcher = instrument_server(srv, registry=obs.REGISTRY)
    try:
        def client(i):
            futs = [srv.submit_async(f"c{i}", [(0, 1), (2,)])
                    for _ in range(4)]
            for fut in futs:
                fut.result(timeout=15)
            srv.stats()

        _race([threading.Thread(target=client, args=(i,))
               for i in range(4)], timeout=30)
        srv.flush()
    finally:
        srv.close()
    _check_live(watcher, static_edges,
                [("CountServer._lock", "AsyncFlusher._lat_lock")])


def test_disk_tier_traffic_edges_subset_of_static_graph(rng, tmp_path,
                                                        static_edges,
                                                        unwrap_registry):
    """An async server over a SPILLED store with the background compactor
    on, instrumented on all four serving locks, racing queries against
    appends: no order cycles, every observed edge in the static graph, and
    the store-lock -> compactor-queue nesting exercised."""
    srv = _server(_db(rng, 120, 10), async_flush=True, max_delay_ms=20,
                  min_batch=4, chunk_rows=32, spill_dir=str(tmp_path),
                  spill_threshold_bytes=64, merge_ratio=0.05,
                  min_compact_rows=0, background_compaction=True)
    assert srv.store.resident == "spilled"
    watcher = instrument_server(srv, registry=obs.REGISTRY)
    try:
        def client(i):
            futs = [srv.submit_async(f"c{i}", [(0, 1), (2,)])
                    for _ in range(4)]
            for fut in futs:
                fut.result(timeout=15)
            srv.stats()

        def appender():
            arng = np.random.default_rng(7)
            for _ in range(4):
                srv.append(_db(arng, 30, 10))   # trips the bg compactor

        _race([threading.Thread(target=client, args=(i,))
               for i in range(3)] + [threading.Thread(target=appender)])
        srv.flush()
        srv.store._compactor.drain()
        assert srv.store.last_compaction_error is None
    finally:
        srv.close()
    _check_live(watcher, static_edges,
                [("VersionedDB._store_lock", "AsyncCompactor._mu")])


def test_rule_server_traffic_edges_subset_of_static_graph(static_edges,
                                                          unwrap_registry):
    """A RuleServer over an instrumented async server with background
    compaction: four threads race ``rules_for`` and ``submit_async``
    against 8 appends through the rule server.  No cycles, every edge in
    the static graph, both known nestings exercised, and every verdict and
    future exact at some version between its call and the last append."""
    rng = np.random.default_rng(5)
    tx = _db(rng, 300, 12)
    y = [int(rng.random() < 0.3) for _ in tx]
    srv = _server(tx, classes=y, n_classes=2, async_flush=True,
                  max_delay_ms=5, min_batch=4, merge_ratio=0.05,
                  min_compact_rows=0, background_compaction=True)
    ruler = RuleServer(srv, prefetch_top=4)
    watcher = instrument_server(srv, registry=obs.REGISTRY)
    batches = [(_db(rng, 20, 12), [int(rng.random() < 0.3)
                                   for _ in range(20)]) for _ in range(8)]
    keys = [(0,), (1,), (0, 1), (2, 3), (4, 5, 6), (7,)]
    seen = []
    lock = threading.Lock()
    try:
        def client(c):
            for i in range(6):
                key = keys[(c + i) % len(keys)]
                v0 = srv.store.version
                (rule,) = ruler.rules_for([key], min_conf=0.0)
                fut = srv.submit_async(f"c{c}", [key])
                with lock:
                    seen.append((key, v0, rule, fut))

        def appender():
            for b, yb in batches:
                ruler.append(b, classes=yb)

        _race([threading.Thread(target=client, args=(c,))
               for c in range(4)] + [threading.Thread(target=appender)])
        srv.flush()
        srv.store._compactor.drain()
        assert srv.store.last_compaction_error is None
    finally:
        srv.close()
    _check_live(watcher, static_edges,
                [("CountServer._lock", "AsyncFlusher._lat_lock"),
                 ("VersionedDB._store_lock", "AsyncCompactor._mu")])
    # exact at a version between the call and the last append
    hist = [[list(t) for t in tx]]
    ys = [list(y)]
    for b, yb in batches:
        hist.append(hist[-1] + [list(t) for t in b])
        ys.append(ys[-1] + list(yb))

    def row(key, v):
        cnt = [sum(1 for t, c in zip(hist[v], ys[v])
                   if set(key) <= set(t) and c == k) for k in (0, 1)]
        return cnt

    for key, v0, rule, fut in seen:
        got = fut.result(timeout=5)[0].tolist()
        assert any(got == row(key, v) for v in range(v0, 9)), key
        assert any([rule.g_count, rule.count] == row(key, v)
                   and rule.support == rule.count / len(hist[v])
                   for v in range(v0, 9)), key


def test_instrument_server_wraps_every_shard(static_edges, unwrap_registry):
    """A ShardedDB has no lock of its own: every shard's store lock is
    wrapped under the ``VersionedDB._store_lock`` node, and sharded async
    traffic records the server -> store nesting."""
    rng = np.random.default_rng(9)
    srv = _server(_db(rng, 120, 10), shards=3, async_flush=True,
                  max_delay_ms=10, min_batch=4)
    watcher = instrument_server(srv, registry=obs.REGISTRY)
    assert [s._store_lock.name for s in srv.store.shards] \
        == ["VersionedDB._store_lock"] * 3
    try:
        def client(i):
            futs = [srv.submit_async(f"c{i}", [(0, 1), (2,)])
                    for _ in range(4)]
            for fut in futs:
                fut.result(timeout=15)

        def appender():
            arng = np.random.default_rng(3)
            for _ in range(3):
                srv.append(_db(arng, 10, 10))

        _race([threading.Thread(target=client, args=(i,))
               for i in range(3)] + [threading.Thread(target=appender)])
        srv.flush()
    finally:
        srv.close()
    _check_live(watcher, static_edges,
                [("CountServer._lock", "VersionedDB._store_lock")])


def test_sync_server_keeps_its_null_lock(unwrap_registry):
    """A sync server holds a nullcontext, left alone; its store lock and
    the registry's are still wrapped."""
    srv = _server([[1, 2], [2]], classes=[0, 1])
    watcher = instrument_server(srv, registry=obs.REGISTRY)
    assert not isinstance(srv._lock, WatchedLock)
    assert isinstance(srv.store._store_lock, WatchedLock)
    assert isinstance(obs.REGISTRY._lock, WatchedLock)
    RuleServer(srv).rules_for([(1,), (2,)])
    assert watcher.report()["locks"] == ["MetricsRegistry._lock",
                                         "VersionedDB._store_lock"]
    assert watcher.cycles() == []
