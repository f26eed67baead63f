"""Span tracing of the query lifecycle — ring-buffered, Chrome-dumpable.

A :class:`Span` covers one timed region (``with tracer.span("serve.flush")``)
with per-span attributes (backend chosen, n_masks, chunk index, cache
verdict...).  Parent/child structure comes from a thread-local span stack:
a span opened while another is live on the same thread records that span's
id as its ``parent_id`` — so the full ``submit -> queue wait -> dedup ->
flush -> backend counts -> cache fill -> reply`` chain nests naturally, and
cross-thread handoffs (an async submit answered by the flusher thread)
link through explicit attributes (ticket ids) instead of fake nesting.

Finished spans land in a bounded ring buffer (``deque(maxlen=...)``) — the
store is O(capacity) forever, old spans age out.  Export:

  * :meth:`Tracer.chrome_trace` — Chrome ``trace_event`` JSON (open in
    ``chrome://tracing`` / Perfetto): one ``"ph": "X"`` complete event per
    span, instants as ``"ph": "i"``, span/parent ids in ``args``;
  * :meth:`Tracer.summary` — human per-span-name table (count, total,
    mean, max) for terminal dumps.

Tracing is OFF by default (the ring buffer and per-span objects are real
allocations); ``tracer.enabled = True`` (or ``repro_torch.obs.configure``) turns
it on.  When disabled, ``span()`` returns a shared no-op singleton without
allocating — the same zero-overhead contract as the metrics registry.

While a tracer is enabled it also times Python's collector: a
``gc.callbacks`` hook, installed when ``enabled`` turns true and removed when
it turns false, files each collection as a ``py.gc`` span of the thread that
ran it.  :meth:`Tracer.record` files a span measured elsewhere (a request's
queue wait, stamped at submit and closed at the drain).
"""
from __future__ import annotations

import gc
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

DEFAULT_RING_SPANS = 16384


class _NoopSpan:
    """Shared do-nothing span: returned by a disabled tracer."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, key: str, value) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed region; finished spans are immutable ring entries."""

    __slots__ = ("tracer", "name", "span_id", "parent_id", "tid",
                 "t0", "t1", "attrs")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[dict] = None):
        self.tracer = tracer
        self.name = name
        self.span_id = next(tracer._ids)
        self.parent_id: Optional[int] = None
        self.tid = threading.get_ident()
        self.t0 = 0.0
        self.t1 = 0.0
        self.attrs: Dict[str, object] = dict(attrs) if attrs else {}

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        stack = self.tracer._stack()
        if stack:
            self.parent_id = stack[-1].span_id
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.t1 = time.perf_counter()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        stack = self.tracer._stack()
        # tolerate foreign frames on the stack (an exception unwound past a
        # span): pop down to and including this span
        while stack:
            top = stack.pop()
            if top is self:
                break
        self.tracer._ring.append(self)


class Tracer:
    """Ring-buffered span store with a thread-local nesting stack."""

    def __init__(self, enabled: bool = False,
                 ring_spans: int = DEFAULT_RING_SPANS):
        self._ring: "deque[Span]" = deque(maxlen=ring_spans)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._epoch = time.perf_counter()
        # one collection runs at a time (the collector holds the interpreter
        # lock throughout), so one start stamp serves every thread
        self._gc_t0: Optional[float] = None
        self._enabled = False
        self.enabled = enabled

    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, on: bool) -> None:
        """Switch tracing, and with it the ``py.gc`` hook, on or off."""
        self._enabled = bool(on)
        installed = self._on_gc in gc.callbacks   # bound methods compare equal
        if on and not installed:
            gc.callbacks.append(self._on_gc)
        elif not on and installed:
            gc.callbacks.remove(self._on_gc)
            self._gc_t0 = None

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, attrs: Optional[dict] = None):
        """Open a span (use as a context manager).  ``attrs`` is an optional
        dict — passed positionally, not **kwargs, so a disabled tracer costs
        one call and no allocation."""
        if not self._enabled:
            return NOOP_SPAN
        return Span(self, name, attrs)

    def instant(self, name: str, attrs: Optional[dict] = None) -> None:
        """Zero-duration marker (e.g. one submit): a span with t0 == t1."""
        if self._enabled:
            now = time.perf_counter()
            self.record(name, now, now, attrs)

    def record(self, name: str, t0: float, t1: float,
               attrs: Optional[dict] = None, *, nest: bool = True) -> None:
        """File a finished span over ``[t0, t1]`` (``time.perf_counter``
        stamps taken by the caller).  ``nest`` makes it a child of this
        thread's innermost open span; a span that began on another thread
        (a request's queue wait) passes ``nest=False``."""
        if not self._enabled:
            return
        s = Span(self, name, attrs)
        if nest:
            stack = self._stack()
            if stack:
                s.parent_id = stack[-1].span_id
        s.t0, s.t1 = t0, t1
        self._ring.append(s)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            t0, self._gc_t0 = self._gc_t0, None
            self.record("py.gc", t0, time.perf_counter(),
                        {"generation": info["generation"],
                         "collected": info["collected"]})

    def reset(self) -> None:
        self._ring.clear()
        self._epoch = time.perf_counter()

    def spans(self) -> List[Span]:
        """Current ring contents, oldest first (a copy: stable to iterate)."""
        return list(self._ring)

    # -- export ---------------------------------------------------------------
    def chrome_trace(self) -> dict:
        """Chrome ``trace_event`` JSON object (``{"traceEvents": [...]}``)."""
        pid = os.getpid()
        events = []
        for s in self.spans():
            us0 = (s.t0 - self._epoch) * 1e6
            args = {"span_id": s.span_id}
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            args.update(s.attrs)
            ev = {"name": s.name, "cat": "repro", "pid": pid, "tid": s.tid,
                  "ts": us0, "args": args}
            if s.t1 > s.t0:
                ev["ph"] = "X"
                ev["dur"] = (s.t1 - s.t0) * 1e6
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def summary(self) -> str:
        """Per-span-name rollup: count, total/mean/max ms — the human dump."""
        agg: Dict[str, List[float]] = {}
        for s in self.spans():
            agg.setdefault(s.name, []).append((s.t1 - s.t0) * 1e3)
        lines = [f"{'span':<28} {'count':>7} {'total_ms':>10} "
                 f"{'mean_ms':>9} {'max_ms':>9}"]
        for name in sorted(agg):
            ds = agg[name]
            lines.append(f"{name:<28} {len(ds):>7} {sum(ds):>10.2f} "
                         f"{sum(ds) / len(ds):>9.3f} {max(ds):>9.3f}")
        return "\n".join(lines)
