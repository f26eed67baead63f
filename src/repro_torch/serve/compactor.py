"""Background compactor: move the delta fold off the serving path.

``VersionedDB.append`` used to pay the full re-dedup + residency rebuild
inline the moment the delta crossed ``merge_ratio`` — on a big base that is
the single largest stall an appending client can hit.  ``AsyncCompactor``
follows the ``AsyncFlusher`` pattern (one daemon thread, an ``Event`` wake,
``close()`` drains): ``request()`` just wakes the thread and returns; the
thread runs :meth:`~repro_torch.serve.store.VersionedDB._compact_pass`, which

  * SNAPSHOTS the base and the delta's first rows under the store lock,
  * builds the new deduped base from them OFF-lock (the expensive part —
    appends and queries proceed against the old base+delta, which stays
    exact),
  * commits under the lock: the new base, and as the delta the rows
    appended since the snapshot.  Appends never void a build, so the fold
    commits under steady appends; only another fold's commit in between
    does, and that build is discarded (``store_discarded_compactions_total``)
    and retried.

Failure safety is inherited from the synchronous path: the new base is built
BEFORE the delta drops, and a failed build records
``last_compaction_error`` / ``n_failed_compactions`` in ``stats()`` while
the store keeps serving exact counts from base+delta.

Lock discipline (registered with repro-lint's CONC001 graph): the compactor
thread never holds its own ``_mu`` while calling into the store, so the only
cross-object edge is ``VersionedDB._store_lock -> AsyncCompactor._mu``
(``request()``/``stats()`` called from under the store lock) — acyclic
against the serving graph.  The JAX package's
``obs.lockwatch.instrument_server`` wraps both locks for the dynamic
cross-check; its port comes with the rule server.

A base build on this thread that uploads to the card goes to the store's
device, which the store pins to a card index at construction: the thread
does not inherit the caller's current CUDA device.

Telemetry: ``store_bg_compactions_total`` / ``store_bg_compaction_retries_
total`` counters and a ``store_compactor_queue_depth`` gauge.
"""
from __future__ import annotations

import threading

from ..obs import REGISTRY

_M_BG_RUNS = REGISTRY.counter("store_bg_compactions_total")
_M_BG_RETRIES = REGISTRY.counter("store_bg_compaction_retries_total")
_G_QUEUE_DEPTH = REGISTRY.gauge("store_compactor_queue_depth")

# A build voided by another fold's commit is retried at most this many
# times per wake; the NEXT append over the threshold requests the work
# again, so capping only bounds wasted rebuilds.
MAX_RETRIES = 3


class AsyncCompactor:
    """One background thread folding a ``VersionedDB``'s delta off-path."""

    def __init__(self, store, *, max_retries: int = MAX_RETRIES):
        self._store = store
        self.max_retries = max_retries
        self._mu = threading.Lock()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._pending = 0
        self._closed = False
        self.n_runs = 0
        self.n_retries = 0
        self._thread = threading.Thread(target=self._run,
                                        name="store-compactor", daemon=True)
        self._thread.start()

    # -- serving-side API -----------------------------------------------------
    def request(self) -> None:
        """Ask for one compaction pass; returns immediately (the append's
        only cost).  Coalescing is free: N requests before the thread wakes
        still fold into one pass over the latest delta."""
        with self._mu:
            if self._closed:
                return
            self._pending += 1
            depth = self._pending
            self._idle.clear()
        _G_QUEUE_DEPTH.set(depth)
        self._wake.set()

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until every requested pass has run (test/shutdown hook).
        Never call while holding the store lock — the pass needs it."""
        return self._idle.wait(timeout)

    def close(self, timeout: float = 60.0) -> None:
        """Drain outstanding requests, then stop the thread."""
        self.drain(timeout)
        with self._mu:
            self._closed = True
        self._wake.set()
        self._thread.join(timeout=timeout)

    def stats(self) -> dict:
        with self._mu:
            return {"pending": self._pending, "runs": self.n_runs,
                    "retries": self.n_retries, "closed": self._closed,
                    "alive": self._thread.is_alive()}

    # -- the thread -----------------------------------------------------------
    def _run(self) -> None:
        while True:
            self._wake.wait(timeout=0.5)
            with self._mu:
                if self._closed and self._pending == 0:
                    return
                pending = self._pending
                self._pending = 0
                self._wake.clear()
            if pending == 0:
                continue
            _G_QUEUE_DEPTH.set(0)
            committed = False
            retries = 0
            while not committed and retries <= self.max_retries:
                # _compact_pass absorbs build failures (recording them on
                # the store) and returns False only when another fold
                # committed first — worth an immediate retry
                committed = self._store._compact_pass()
                if not committed:
                    retries += 1
                    _M_BG_RETRIES.inc()
            _M_BG_RUNS.inc()
            with self._mu:
                self.n_runs += 1
                self.n_retries += retries
                if self._pending == 0:
                    self._idle.set()
