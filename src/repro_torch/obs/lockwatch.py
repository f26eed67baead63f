"""Dynamic lock-order watcher: the runtime twin of the CONC001 checker.

A static concurrency checker (the JAX package's ``analysis.concurrency``,
run over this package's sources) derives the lock-acquisition graph from
the AST; this module records the graph an ACTUAL threaded run exercises, so
the two can cross-check each other: every edge observed live must appear in
the static graph (else the static analysis is blind to a path), and neither
graph may contain a cycle.

Opt-in and zero-cost when unused: wrap the locks you care about and run
traffic —

    watcher = LockOrderWatcher()
    server._lock = watcher.wrap(server._lock, "CountServer._lock")
    ... threaded traffic ...
    assert not watcher.cycles(), watcher.report()

or use :func:`instrument_server` for the standard serving pair.  Wrapped
locks proxy ``acquire``/``release``/context-manager entry to the original
lock and record, per thread, which locks were already held at each
acquisition — every (held, acquired) pair is an order edge.  Re-entrant
re-acquisition of the SAME lock (RLock) is counted but adds no edge.  The
stacks are per thread (``threading.local``), whatever card a thread counts
on: the store's flusher and compactor threads pin the caller's card and
record their edges like any other thread.

Instrument BEFORE starting traffic: swapping a lock attribute while another
thread holds the old lock object briefly leaves two referents for "the"
lock, which is exactly the race this module exists to find.

Stdlib-only, like the rest of ``repro_torch.obs``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple


class LockOrderError(AssertionError):
    """Raised by :meth:`LockOrderWatcher.check` when a cycle was observed."""


class WatchedLock:
    """Transparent proxy around a ``threading.Lock``/``RLock`` that reports
    acquisition order to its watcher.  Unknown attributes forward to the
    wrapped lock."""

    __slots__ = ("_watcher", "_lock", "name")

    def __init__(self, watcher: "LockOrderWatcher", lock, name: str):
        self._watcher = watcher
        self._lock = lock
        self.name = name

    def acquire(self, *args, **kwargs) -> bool:
        ok = self._lock.acquire(*args, **kwargs)
        if ok:
            self._watcher._on_acquired(self.name)
        return ok

    def release(self) -> None:
        self._watcher._on_released(self.name)
        self._lock.release()

    def __enter__(self) -> "WatchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __getattr__(self, attr):
        return getattr(self._lock, attr)


class LockOrderWatcher:
    """Records per-thread lock-acquisition order edges across wrapped locks.

    Thread-safe: the held-lock stack is thread-local; the edge map is
    guarded by the watcher's own (unwatched) mutex."""

    def __init__(self):
        self._mu = threading.Lock()
        self._edges: Dict[Tuple[str, str], int] = {}
        self._names: Set[str] = set()
        self._tls = threading.local()

    # -- instrumentation ------------------------------------------------------

    def wrap(self, lock, name: str) -> WatchedLock:
        """Wrap one lock under a stable display name (conventionally
        ``Class.attr``, matching the static checker's node names)."""
        with self._mu:
            self._names.add(name)
        return WatchedLock(self, lock, name)

    def _stack(self) -> List[List]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _on_acquired(self, name: str) -> None:
        st = self._stack()
        fresh = [(held, name) for held, _ in st if held != name]
        if st and st[-1][0] == name:
            st[-1][1] += 1          # re-entrant re-acquire: no edge
        else:
            st.append([name, 1])
        if fresh:
            with self._mu:
                for e in fresh:
                    self._edges[e] = self._edges.get(e, 0) + 1

    def _on_released(self, name: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] == name:
                st[i][1] -= 1
                if st[i][1] == 0:
                    del st[i]
                return
        # release of a lock acquired before wrapping: ignore silently

    # -- inspection -----------------------------------------------------------

    def edges(self) -> Dict[Tuple[str, str], int]:
        """Observed (held -> acquired) pairs with occurrence counts."""
        with self._mu:
            return dict(self._edges)

    def cycles(self) -> List[List[str]]:
        """Every distinct acquisition-order cycle observed (closed node
        lists, first == last); an ABBA deadlock hazard if non-empty."""
        adj: Dict[str, Set[str]] = {}
        for (a, b) in self.edges():
            adj.setdefault(a, set()).add(b)
        out: List[List[str]] = []
        seen: Set[frozenset] = set()
        while True:
            cycle = _find_cycle(adj)
            if cycle is None:
                return out
            key = frozenset(cycle)
            if key not in seen:
                seen.add(key)
                out.append(cycle)
            adj[cycle[0]].discard(cycle[1])

    def report(self) -> dict:
        with self._mu:
            edges = {f"{a} -> {b}": n for (a, b), n in self._edges.items()}
            names = sorted(self._names)
        return {"locks": names, "edges": edges, "cycles": self.cycles()}

    def check(self) -> None:
        """Raise :class:`LockOrderError` if any order cycle was observed."""
        cycles = self.cycles()
        if cycles:
            raise LockOrderError(
                f"lock-order cycle(s) observed at runtime: "
                f"{[' -> '.join(c) for c in cycles]}")

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()


def instrument_server(server, watcher: Optional[LockOrderWatcher] = None,
                      registry=None) -> LockOrderWatcher:
    """Wrap a :class:`~repro_torch.serve.service.CountServer`'s serving
    locks (and optionally a metrics registry's) under one watcher.  Call
    BEFORE submitting traffic.  Sync servers (``async_flush=False``) hold a
    nullcontext instead of a lock and are left alone.  The store's lock and
    its background compactor's (when present) are wrapped too — the disk
    tier added real cross-thread traffic on both.  A
    :class:`~repro_torch.serve.shard.ShardedDB` holds no lock of its own:
    each of its ``VersionedDB`` shards does, and each is wrapped under the
    same ``VersionedDB._store_lock`` node."""
    w = watcher if watcher is not None else LockOrderWatcher()
    if hasattr(server._lock, "acquire"):
        server._lock = w.wrap(server._lock, "CountServer._lock")
    flusher = getattr(server, "_flusher", None)
    if flusher is not None:
        flusher._lat_lock = w.wrap(flusher._lat_lock,
                                   "AsyncFlusher._lat_lock")
    for store in getattr(server.store, "shards", [server.store]):
        store._store_lock = w.wrap(store._store_lock,
                                   "VersionedDB._store_lock")
        compactor = store._compactor
        if compactor is not None:
            compactor._mu = w.wrap(compactor._mu, "AsyncCompactor._mu")
    if registry is not None:
        registry._lock = w.wrap(registry._lock, "MetricsRegistry._lock")
    return w


def _find_cycle(edges: Dict[str, Set[str]]) -> Optional[List[str]]:
    """First cycle in a directed graph (closed node list), or None.
    Mirror of the static checker's ``find_cycle`` (the JAX package's
    ``analysis.engine``) — duplicated so obs stays dependency-free."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {u: WHITE for u in edges}
    for vs in edges.values():
        for v in vs:
            color.setdefault(v, WHITE)
    for start in sorted(color):
        if color[start] != WHITE:
            continue
        stack = [(start, iter(sorted(edges.get(start, ()))))]
        color[start] = GRAY
        path = [start]
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if color[nxt] == GRAY:
                    return path[path.index(nxt):] + [nxt]
                if color[nxt] == WHITE:
                    color[nxt] = GRAY
                    path.append(nxt)
                    stack.append((nxt, iter(sorted(edges.get(nxt, ())))))
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                path.pop()
                stack.pop()
    return None
