"""Process-wide metrics registry — counters, gauges, fixed-bucket histograms.

Designed for the serving hot path:

  * **no locks on record** — every recording thread gets its own *shard*
    (a ``threading.local`` dict of plain int/float cells); ``inc()`` /
    ``observe()`` are a couple of dict operations by the owning thread, so
    there are no lost updates and nothing to contend on.  The registry lock
    is taken only to REGISTER a new shard (once per thread) and to snapshot.
  * **exact ledgers** — shards are thread-confined, so ``snapshot()`` (which
    sums across shards under the registry lock) can lag an in-flight bump but
    never double- or under-counts a completed one.  Histograms maintain
    ``count == sum(bucket_counts)`` by construction: each ``observe`` bumps
    exactly one bucket, the count, and the sum.
  * **zero overhead when disabled** — ``enabled`` is checked first in every
    record method and the call returns without allocating; the
    zero-allocation contract on the count path is pinned by
    ``tests/test_obs.py`` with a tracemalloc filter over this package.

Instruments are BOUND: ``registry.counter(name, **labels)`` resolves the
label key once and returns a :class:`Counter` whose ``inc`` is just the
shard bump — create instruments at module/instance setup, not per call.
Gauges are last-write-wins cells written directly on the registry (a single
GIL-atomic dict store; gauges are not hot-path instruments).

Counters here are allowed negative increments (e.g. the batcher rolls back
its dedup counter when a failed flush restores requests) — the registry is
an exact ledger first, a Prometheus exposition second.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]
MetricKey = Tuple[str, LabelKey]

# Default histogram buckets: latencies in milliseconds, log-ish spacing from
# sub-100us dispatches to multi-second mines.  Upper bounds; +inf implicit.
DEFAULT_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                      50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 10000.0)


def label_key(labels: dict) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def nearest_rank(sorted_values: Sequence[float], p: float) -> Optional[float]:
    """Exact nearest-rank percentile of an ascending-sorted sample.

    The nearest-rank definition: the p-th percentile of n samples is the
    value at (1-based) rank ``ceil(p * n)`` — exact on small samples, always
    an observed value, never an interpolation.  ``p`` in (0, 1];
    returns None on an empty sample."""
    n = len(sorted_values)
    if n == 0:
        return None
    if not (0.0 < p <= 1.0):
        raise ValueError("p in (0, 1]")
    return sorted_values[max(0, math.ceil(p * n) - 1)]


class _HistCell:
    """One thread's shard of one histogram: bucket counts + sum + count."""

    __slots__ = ("buckets", "counts", "total", "n")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # +1: the +inf bucket
        self.total = 0.0
        self.n = 0


class _Shard:
    """Per-thread recording surface: plain dicts, touched only by the owner."""

    __slots__ = ("counters", "hists")

    def __init__(self):
        self.counters: Dict[MetricKey, float] = {}
        self.hists: Dict[MetricKey, _HistCell] = {}


class Counter:
    """Bound counter: ``inc(n)`` bumps this thread's shard cell."""

    __slots__ = ("_reg", "key")

    def __init__(self, reg: "MetricsRegistry", key: MetricKey):
        self._reg = reg
        self.key = key

    def inc(self, n: float = 1) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        d = reg._shard().counters
        d[self.key] = d.get(self.key, 0) + n


class Histogram:
    """Bound fixed-bucket histogram: ``observe(v)`` bumps exactly one bucket
    (bisect over the registered upper bounds), the count, and the sum."""

    __slots__ = ("_reg", "key", "buckets")

    def __init__(self, reg: "MetricsRegistry", key: MetricKey,
                 buckets: Tuple[float, ...]):
        self._reg = reg
        self.key = key
        self.buckets = buckets

    def observe(self, v: float) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        hists = reg._shard().hists
        cell = hists.get(self.key)
        if cell is None:
            cell = hists[self.key] = _HistCell(self.buckets)
        # bucket i holds v <= buckets[i]; the last slot is the +inf bucket
        cell.counts[bisect.bisect_left(cell.buckets, v)] += 1
        cell.total += v
        cell.n += 1

    def observe_many(self, values: Sequence[float]) -> None:
        """Bulk observe: ONE shard/cell fetch, then a tight loop.  The
        drain-point companion to :meth:`observe` — per-item latencies
        recorded where a batch is drained cost a fraction of per-item
        ``observe`` calls on the submit path."""
        reg = self._reg
        if not reg.enabled or not values:
            return
        hists = reg._shard().hists
        cell = hists.get(self.key)
        if cell is None:
            cell = hists[self.key] = _HistCell(self.buckets)
        counts, buckets, bl = cell.counts, cell.buckets, bisect.bisect_left
        total = 0.0
        for v in values:
            counts[bl(buckets, v)] += 1
            total += v
        cell.total += total
        cell.n += len(values)


class Gauge:
    """Bound gauge: last-write-wins cell on the registry."""

    __slots__ = ("_reg", "key")

    def __init__(self, reg: "MetricsRegistry", key: MetricKey):
        self._reg = reg
        self.key = key

    def set(self, v: float) -> None:
        if self._reg.enabled:
            self._reg._gauges[self.key] = v


class MetricsRegistry:
    """The process-wide instrument store (see module docstring)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._local = threading.local()
        self._shards: List[_Shard] = []
        self._gauges: Dict[MetricKey, float] = {}
        self._hist_buckets: Dict[str, Tuple[float, ...]] = {}

    # -- shard plumbing -------------------------------------------------------
    def _shard(self) -> _Shard:
        s = getattr(self._local, "shard", None)
        if s is None:
            s = _Shard()
            self._local.shard = s
            with self._lock:
                self._shards.append(s)
        return s

    @property
    def n_shards(self) -> int:
        """Registered per-thread shards (0 until something records)."""
        with self._lock:
            return len(self._shards)

    def reset(self) -> None:
        """Drop every recorded value and shard.  Only safe when no recording
        thread is mid-bump (tests / process teardown); bound instruments keep
        working — their next record re-registers a shard."""
        with self._lock:
            self._shards.clear()
            self._gauges.clear()
        # threads that still hold a threading.local shard must get a fresh
        # one on their next record, or their old (now-unregistered) cells
        # would silently vanish from snapshots
        self._local = threading.local()

    # -- instrument construction ----------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        return Counter(self, (name, label_key(labels)))

    def gauge(self, name: str, **labels) -> Gauge:
        return Gauge(self, (name, label_key(labels)))

    def histogram(self, name: str, buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        """Bound histogram; the FIRST registration fixes the bucket bounds
        for the name (every label set of one name shares one grid, so
        snapshots aggregate and export coherently)."""
        with self._lock:
            have = self._hist_buckets.get(name)
            if have is None:
                have = tuple(sorted(buckets)) if buckets is not None \
                    else DEFAULT_MS_BUCKETS
                self._hist_buckets[name] = have
            elif buckets is not None and tuple(sorted(buckets)) != have:
                raise ValueError(
                    f"histogram {name!r} already registered with different "
                    f"buckets")
        return Histogram(self, (name, label_key(labels)), have)

    def set_gauge(self, name: str, value: float, *, exclusive: bool = False,
                  **labels) -> None:
        """Direct gauge write; ``exclusive=True`` clears every OTHER label
        set of the same name first (a one-hot decision gauge, e.g. the
        chooser's last verdict)."""
        if not self.enabled:
            return
        key = (name, label_key(labels))
        with self._lock:
            if exclusive:
                for k in [k for k in self._gauges if k[0] == name]:
                    del self._gauges[k]
            self._gauges[key] = value

    # -- snapshot -------------------------------------------------------------
    def snapshot(self) -> dict:
        """Merge all shards into one JSON-safe view:

        ``{"counters": {name: {label_str: value}},
           "gauges":   {name: {label_str: value}},
           "histograms": {name: {label_str: {"buckets": [...],
                                             "counts": [...],
                                             "sum": s, "count": n}}}}``

        where ``label_str`` is ``a=1,b=2`` (empty string for no labels).
        """
        counters: Dict[MetricKey, float] = {}
        hists: Dict[MetricKey, dict] = {}
        with self._lock:
            shards = list(self._shards)
            gauges = dict(self._gauges)
        for s in shards:
            for k, v in list(s.counters.items()):
                counters[k] = counters.get(k, 0) + v
            for k, cell in list(s.hists.items()):
                agg = hists.get(k)
                if agg is None:
                    agg = hists[k] = {"buckets": list(cell.buckets),
                                      "counts": [0] * len(cell.counts),
                                      "sum": 0.0, "count": 0}
                for i, c in enumerate(cell.counts):
                    agg["counts"][i] += c
                agg["sum"] += cell.total
                agg["count"] += cell.n
        return {"counters": _nest(counters), "gauges": _nest(gauges),
                "histograms": _nest(hists)}


def _label_str(lk: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in lk)


def _nest(flat: Dict[MetricKey, object]) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for (name, lk), v in sorted(flat.items(), key=lambda kv: kv[0]):
        out.setdefault(name, {})[_label_str(lk)] = v
    return out


# -- snapshot readers (shared by exports, summaries, and tests) --------------

def counter_total(snap: dict, name: str) -> float:
    """Sum of a counter across all label sets (0 when absent)."""
    return sum((snap.get("counters", {}).get(name) or {}).values())


def counter_value(snap: dict, name: str, **labels) -> float:
    return (snap.get("counters", {}).get(name) or {}).get(
        _label_str(label_key(labels)), 0)


def hist_get(snap: dict, name: str, label_str: str = "") -> Optional[dict]:
    return (snap.get("histograms", {}).get(name) or {}).get(label_str)


def hist_merge(snap: dict, name: str) -> Optional[dict]:
    """Aggregate one histogram name across its label sets."""
    sets = snap.get("histograms", {}).get(name)
    if not sets:
        return None
    out = None
    for h in sets.values():
        if out is None:
            out = {"buckets": list(h["buckets"]),
                   "counts": list(h["counts"]),
                   "sum": h["sum"], "count": h["count"]}
        else:
            out["counts"] = [a + b for a, b in zip(out["counts"],
                                                   h["counts"])]
            out["sum"] += h["sum"]
            out["count"] += h["count"]
    return out


def hist_quantile(hist: Optional[dict], p: float) -> Optional[float]:
    """Nearest-rank quantile over a bucketed histogram: the upper bound of
    the bucket holding the ceil(p*n)-th observation (conservative — the true
    value is <= the returned bound; +inf bucket reports the overall mean as
    the best available point estimate)."""
    if not hist or not hist["count"]:
        return None
    rank = max(1, math.ceil(p * hist["count"]))
    seen = 0
    for ub, c in zip(hist["buckets"], hist["counts"]):
        seen += c
        if seen >= rank:
            return ub
    return hist["sum"] / hist["count"]   # landed in the +inf bucket
