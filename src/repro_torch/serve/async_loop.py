"""Background flush driver — the async serving loop over ``CountServer``.

The synchronous driver loop (``submit`` / ``flush``) makes every client wait
for an explicit flush.  ``AsyncFlusher`` runs the flush decision in a
background thread with the two standard micro-batching triggers:

* **occupancy**: flush as soon as ``min_batch`` requests are pending — the
  batch is worth a launch;
* **deadline**: flush at most ``max_delay_ms`` after the OLDEST pending
  request was submitted — a lone request is never parked longer than the
  latency budget.

``submit_async()`` returns a :class:`CountFuture`; the result arrives when
some flush (background-triggered, an explicit synchronous ``flush()``, or
the ``close()`` drain) answers the ticket.  Correctness is untouched: the
async loop only decides WHEN the existing synchronous flush runs — every
count is still the exact composed sweep at flush-time version, which the
future's ``version`` names.

Failure discipline matches the synchronous path: a failed flush restores the
drained requests to the batcher (tickets stay answerable), the flusher
counts the error and retries at the next deadline.  ``close()`` stops the
trigger thread and then DRAINS the batcher — a submitted ticket is never
orphaned: its future either carries the counts or (when the final drain
itself fails) the error.

Thread safety: the owning ``CountServer`` serializes every state-touching
operation (submit/flush/query/append/mine) behind one re-entrant lock when
``async_flush`` is enabled; the flusher piggybacks on that lock.

On the card the flusher thread counts on the store's device, which the
store pins to a card index at construction (a thread starts on card 0,
whatever card the caller had made current).  Over a mesh of more than one
rank ``CountServer`` refuses ``async_flush``: each rank's thread would pick
its own flush times, and the ranks' all-reduces would pair different
batches or hang.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Hashable, Optional, Sequence, Tuple

import numpy as np

from ..obs import REGISTRY, TRACER, nearest_rank

Item = Hashable

_M_FLUSH_ERRORS = REGISTRY.counter("serve_flush_errors_total")
_H_FLUSH_WAIT = REGISTRY.histogram("serve_flush_wait_ms")


class CountFuture:
    """Future-like handle for one async-submitted request.

    ``result(timeout)`` blocks until some flush answers the ticket and
    returns the (len(itemsets), C) int32 block — or raises the flush error
    if the serving pass ultimately failed, or ``TimeoutError`` on timeout.
    Once answered, ``version`` is the store version the block was counted
    at (None before).
    """

    __slots__ = ("ticket", "version", "_event", "_result", "_exc")

    def __init__(self, ticket: int):
        self.ticket = ticket
        self.version: Optional[int] = None
        self._event = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"ticket {self.ticket} unanswered after {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result

    def _set_result(self, value: np.ndarray, version: int) -> None:
        self._result = value
        self.version = version
        self._event.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()


class AsyncFlusher:
    """Deadline- and occupancy-triggered background flush loop.

    Owns the ticket -> :class:`CountFuture` map; ``CountServer.flush``
    reports every answered batch back through :meth:`_dispatch`, so futures
    are fulfilled no matter WHO ran the flush (background trigger, a
    synchronous caller, or the ``close()`` drain).
    """

    def __init__(self, server, *, max_delay_ms: float = 5.0,
                 min_batch: int = 8, latency_window: int = 4096):
        if max_delay_ms <= 0:
            raise ValueError("max_delay_ms must be positive")
        if min_batch <= 0:
            raise ValueError("min_batch must be positive")
        self._server = server
        self.max_delay_s = max_delay_ms / 1e3
        self.min_batch = min_batch
        self._futures: Dict[int, CountFuture] = {}
        # sync tickets a background flush answered, with the version they
        # were counted at; handed back by the next flush() call
        self._unclaimed: Dict[int, Tuple[np.ndarray, int]] = {}
        self._oldest: Optional[float] = None   # submit time of oldest pending
        self._backoff_until = 0.0              # no trigger before this time
        self._reason: Optional[str] = None     # consumed by _dispatch
        self._wake = threading.Event()
        self._closed = False
        self.n_flushes = 0
        self.n_flush_errors = 0
        self.last_flush_error: Optional[str] = None
        self.flushes_by_trigger = {"occupancy": 0, "deadline": 0,
                                   "manual": 0, "drain": 0}
        # _lat_lock guards the latency window: appends run inside _dispatch
        # (under the SERVER lock), but stats() is a monitoring call that must
        # not contend for — or wait on — an in-flight flush, so it cannot
        # take the server lock; sorting the deque while _dispatch appends
        # would raise "deque mutated during iteration" without this
        self._lat_lock = threading.Lock()
        self.latencies_ms = deque(maxlen=latency_window)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="count-server-flush")
        self._thread.start()

    # -- client side ----------------------------------------------------------
    def submit(self, client_id: str,
               itemsets: Sequence[Sequence[Item]]) -> CountFuture:
        """Queue one request; returns its future.  Wakes the trigger thread
        when this submit starts the deadline clock or fills the batch."""
        t_enter = time.perf_counter()
        with self._server._lock:
            t_held = time.perf_counter() if TRACER.enabled else None
            if self._closed:
                raise RuntimeError("AsyncFlusher is closed")
            ticket = self._server.batcher.submit(client_id, itemsets, t_enter)
            if t_held is not None:
                TRACER.record("serve.lock_wait", t_enter, t_held,
                              {"ticket": ticket})
            fut = CountFuture(ticket)
            self._futures[ticket] = fut
            first = self._oldest is None
            if first:
                self._oldest = time.monotonic()
            # wake when this submit STARTS the deadline clock (the thread may
            # be parked with no timeout) or fills the batch
            wake = first or self._server.batcher.pending >= self.min_batch
        if wake:
            self._wake.set()
        return fut

    # -- flush plumbing -------------------------------------------------------
    def _dispatch(self, out, started: Optional[float] = None) -> None:
        """Fulfill futures for an answered batch, ``CountServer.flush``'s
        ``Answers`` (called under the server lock).  ``started`` is the
        flush START time: the recorded latency is the queue wait of the
        batch's oldest request — the quantity ``max_delay_ms`` bounds —
        not the wait plus the counting pass itself."""
        if out:
            now = started if started is not None else time.monotonic()
            if self._oldest is not None:
                wait_ms = (now - self._oldest) * 1e3
                with self._lat_lock:
                    self.latencies_ms.append(wait_ms)
                _H_FLUSH_WAIT.observe(wait_ms)
            self.n_flushes += 1
            reason = self._reason or "manual"
            self.flushes_by_trigger[reason] = \
                self.flushes_by_trigger.get(reason, 0) + 1
            REGISTRY.counter("serve_flushes_total", trigger=reason).inc()
            for ticket, block in out.items():
                fut = self._futures.pop(ticket, None)
                if fut is not None:
                    # a manual flush() caller receives the same blocks in its
                    # return dict — the future gets its OWN copy, so neither
                    # consumer can mutate the other's "exact" rows (the same
                    # immutability contract the cache's defensive copy keeps)
                    fut._set_result(np.array(block, np.int32, copy=True),
                                    out.versions[ticket])
                elif reason != "manual":
                    # a synchronously submitted ticket drained by a
                    # background (or drain) flush: its result must not
                    # vanish — the next explicit flush() hands it back
                    self._unclaimed[ticket] = (block, out.versions[ticket])
        # CountServer.flush calls _dispatch under the server lock (see the
        # docstring): the lock IS held here, just not lexically visible
        self._reason = None          # repro-lint: disable=CONC002
        # repro-lint: disable=CONC002 -- caller holds the server lock
        self._oldest = (None if self._server.batcher.pending == 0
                        else time.monotonic())

    def claim_unclaimed(self) -> Dict[int, Tuple[np.ndarray, int]]:
        """Hand back (and forget) results of sync tickets that a background
        flush answered, each with its version (called by
        ``CountServer.flush`` under the lock)."""
        out, self._unclaimed = self._unclaimed, {}
        return out

    def _try_flush(self, reason: str) -> None:
        # ONE lock scope around trigger + failure handling: releasing the
        # lock between an escaping flush error and the handler would let a
        # concurrent manual flush() observe the stale _reason and
        # misclassify itself as a background trigger
        with self._server._lock:
            if not self._server.batcher.pending:
                return
            self._reason = reason
            try:
                self._server.flush()       # _dispatch runs inside
            except Exception as e:
                # requests were restored to the batcher (tickets stay
                # pending); back off one deadline period before retrying —
                # an occupancy trigger would otherwise busy-spin on a
                # persistent failure
                self.n_flush_errors += 1
                self.last_flush_error = f"{type(e).__name__}: {e}"
                _M_FLUSH_ERRORS.inc()
                self._reason = None
                now = time.monotonic()
                self._oldest = now
                self._backoff_until = now + self.max_delay_s

    def _run(self) -> None:
        while True:
            with self._server._lock:
                if self._closed:
                    return
                pending = self._server.batcher.pending
                oldest = self._oldest
            now = time.monotonic()
            if now < self._backoff_until:
                with TRACER.span("serve.batch_wait") as sp:
                    sp.set("ended", "backoff")
                    self._wake.wait(self._backoff_until - now)
                self._wake.clear()
                continue
            if pending >= self.min_batch:
                self._try_flush("occupancy")
                continue
            if pending and oldest is not None \
                    and now - oldest >= self.max_delay_s:
                self._try_flush("deadline")
                continue
            timeout = (None if oldest is None
                       else max(1e-4, oldest + self.max_delay_s - now))
            with TRACER.span("serve.batch_wait") as sp:
                woken = self._wake.wait(timeout)
                sp.set("ended", "woken" if woken else "timeout")
            self._wake.clear()

    # -- shutdown -------------------------------------------------------------
    def close(self) -> None:
        """Stop the trigger thread, then drain: every submitted ticket's
        future is fulfilled — with counts, or with the drain error."""
        with self._server._lock:
            if self._closed:
                return
            self._closed = True
        self._wake.set()
        self._thread.join()
        try:
            with self._server._lock:
                if self._server.batcher.pending:
                    self._reason = "drain"
                    self._server.flush()
        except BaseException as e:
            with self._server._lock:
                orphans = list(self._futures.values())
                self._futures.clear()
            for fut in orphans:
                fut._set_exception(e)
            raise

    @property
    def closed(self) -> bool:
        return self._closed

    def stats(self) -> dict:
        # snapshot under _lat_lock: _dispatch may be appending mid-flush, and
        # iterating a deque during a concurrent append raises.  The copy is
        # O(window), bounded by latency_window.
        with self._lat_lock:
            lat = sorted(self.latencies_ms)

        def pct(p: float) -> Optional[float]:
            # exact nearest-rank (ceil(p*n)-th order statistic): the old
            # ``lat[int(p * n)]`` form over-shot one rank on small samples
            # (p50 of [1, 2] read 2; of a single sample, p95 indexed past
            # the data but for the min() clamp).  See obs.nearest_rank.
            if not lat:
                return None
            return nearest_rank(lat, p)

        return {
            "closed": self._closed,
            "max_delay_ms": self.max_delay_s * 1e3,
            "min_batch": self.min_batch,
            "pending_tickets": len(self._futures),
            "unclaimed_sync_tickets": len(self._unclaimed),
            "flushes": self.n_flushes,
            "flush_errors": self.n_flush_errors,
            "last_flush_error": self.last_flush_error,
            "by_trigger": dict(self.flushes_by_trigger),
            "flush_latency_ms": {
                "p50": pct(0.50), "p95": pct(0.95),
                "max": lat[-1] if lat else None,
            },
        }
