"""LRU result caches for served counts and rules, keyed on (identity, version).

The DB version is half the key, so an ``append`` (which bumps the store's
version) invalidates every cached entry BY CONSTRUCTION — a stale hit is
impossible, no flush coordination needed.  Stale-version entries age out of
the LRU naturally; ``purge_stale`` drops them eagerly after an append when
memory matters more than the O(capacity) sweep.

Capacity is dual-budgeted: ``capacity`` bounds the entry COUNT, ``max_bytes``
(optional) bounds the PRICED BYTES of the cached values — the right knob
when entry size varies (multi-class count rows, variable-length rule
antecedents) or when the cache shares a host-memory budget with a
streaming-resident DB.  Eviction is LRU under whichever budget is exceeded.

Admission rule: an entry larger than ``max_bytes`` on its own is REJECTED up
front (counted in ``oversized_rejects``), before any resident entry is
touched — admitting it would evict the entire warm working set only to drop
the oversized entry itself once the budget check ran.

:class:`BudgetedLRU` owns that discipline ONCE (ledger, admission, eviction,
purge, stats); :class:`CountCache` instances it for (C,) int32 count rows
(priced at ``nbytes``, hits return a defensive copy) and
the JAX package's ``serve.rules.RuleCache`` for rule verdicts
(deterministic host-side pricing, ``None`` as a first-class cached value),
whose port comes with the rule server.

Host-only: a copy of the JAX package's module, reporting to the port's
``obs.REGISTRY``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable, Optional, Tuple

import numpy as np

from ..obs import REGISTRY

Key = Tuple[Hashable, ...]


class BudgetedLRU:
    """Dual-budget LRU core: (key, version) -> value with an exact byte
    ledger.  Subclasses define :meth:`_price` (value -> int bytes) and wrap
    :meth:`_lookup` / :meth:`_store` with their value semantics."""

    def __init__(self, capacity: int = 65536,
                 max_bytes: Optional[int] = None):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError("max_bytes must be positive (or None)")
        self.capacity = capacity
        self.max_bytes = max_bytes
        self._d: "OrderedDict[Tuple[Key, int], Any]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.oversized_rejects = 0
        self.inserts = 0        # admitted stores of a NEW key
        self.replacements = 0   # admitted stores over a resident key
        self.purged = 0         # entries dropped by purge_stale, cumulative
        # Registry mirrors, labeled by cache kind (both caches share the
        # metric names; the label keeps them separable in the export).  The
        # per-key hot path touches only the plain int counters above;
        # ``publish_metrics`` pushes the deltas into the registry at drain
        # points (flush end, ``stats()``) so a warm-cache hit costs zero
        # registry work.
        kind = type(self).__name__
        self._mirrors = [
            ("hits", REGISTRY.counter("cache_hits_total", cache=kind)),
            ("misses", REGISTRY.counter("cache_misses_total", cache=kind)),
            ("evictions",
             REGISTRY.counter("cache_evictions_total", cache=kind)),
            ("inserts", REGISTRY.counter("cache_inserts_total", cache=kind)),
            ("oversized_rejects",
             REGISTRY.counter("cache_oversized_rejects_total", cache=kind)),
            ("purged", REGISTRY.counter("cache_purged_total", cache=kind)),
        ]
        self._published = {name: 0 for name, _ in self._mirrors}

    def _price(self, value) -> int:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self._d)

    @property
    def nbytes(self) -> int:
        """Priced resident bytes of the cached values."""
        return self._bytes

    def _over_budget(self) -> bool:
        return (len(self._d) > self.capacity
                or (self.max_bytes is not None
                    and self._bytes > self.max_bytes))

    def _lookup(self, k) -> Tuple[bool, Any]:
        """LRU-touching lookup; counts the hit/miss."""
        if k not in self._d:
            self.misses += 1
            return False, None
        self._d.move_to_end(k)
        self.hits += 1
        return True, self._d[k]

    def _store(self, k, value) -> None:
        size = self._price(value)
        if self.max_bytes is not None and size > self.max_bytes:
            # an entry that can never fit must not touch resident entries:
            # admitting it first would evict the whole warm set before the
            # budget loop finally dropped the oversized entry itself
            self.oversized_rejects += 1
            return
        if k in self._d:
            self._bytes -= self._price(self._d[k])
            self.replacements += 1
        else:
            self.inserts += 1
        self._d[k] = value
        self._bytes += size
        self._d.move_to_end(k)
        while self._d and self._over_budget():
            _, dropped = self._d.popitem(last=False)
            self._bytes -= self._price(dropped)
            self.evictions += 1

    def purge_stale(self, current_version: int) -> int:
        """Eagerly drop entries from superseded versions; returns how many."""
        stale = [k for k in self._d if k[1] != current_version]
        for k in stale:
            self._bytes -= self._price(self._d[k])
            del self._d[k]
        self.purged += len(stale)
        self.publish_metrics()
        return len(stale)

    def publish_metrics(self) -> None:
        """Push the plain-counter deltas since the last publish into the
        registry mirrors.  Called at drain points (flush end, purge,
        ``stats()``) — never on the per-key path.  Deltas are withheld while
        the registry is disabled, so nothing recorded in between is lost
        when it is re-enabled."""
        if not REGISTRY.enabled:
            return
        pub = self._published
        for name, mirror in self._mirrors:
            delta = getattr(self, name) - pub[name]
            if delta:
                mirror.inc(delta)
                pub[name] += delta

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        self.publish_metrics()
        return {"size": len(self._d), "capacity": self.capacity,
                "bytes": self._bytes, "max_bytes": self.max_bytes,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "oversized_rejects": self.oversized_rejects,
                "inserts": self.inserts,
                "replacements": self.replacements,
                "purged": self.purged,
                "hit_rate": round(self.hit_rate, 4)}


def check_cache_ledger(cache: BudgetedLRU, *,
                       miss_driven: bool = False) -> dict:
    """Assert the exact ledger identities every :class:`BudgetedLRU` must
    satisfy at ANY quiescent point; returns ``cache.stats()`` for further
    assertions.  Shared by the count-cache and rule-cache test batteries.

    Internal identities (hold unconditionally):

      * ``inserts - evictions - purged == size`` — every resident entry was
        inserted exactly once and leaves by exactly one of eviction/purge;
      * ``bytes`` equals a from-scratch recount of the resident values, and
        respects ``max_bytes``; ``size`` respects ``capacity``.

    Serving-flow identity (``miss_driven=True``): when every store is
    triggered by a miss (the get-miss-compute-put discipline both serving
    caches follow), ``misses - oversized_rejects == inserts + replacements``.
    A cache populated out-of-band (warmup pre-fill) breaks only this one.

    Raises :class:`AssertionError` explicitly (not via ``assert``) so the
    ledger check still fires under ``python -O``.
    """
    s = cache.stats()
    _require(s["size"] == len(cache._d),
             f"stats size {s['size']} != resident {len(cache._d)}", s)
    _require(s["inserts"] - s["evictions"] - s["purged"] == s["size"],
             "inserts - evictions - purged != size", s)
    recount = sum(cache._price(v) for v in cache._d.values())
    _require(s["bytes"] == recount == cache.nbytes,
             f"byte ledger {s['bytes']} != recount {recount} "
             f"(nbytes {cache.nbytes})", s)
    _require(s["size"] <= s["capacity"], "size exceeds capacity", s)
    if cache.max_bytes is not None:
        _require(s["bytes"] <= cache.max_bytes,
                 "bytes exceed max_bytes budget", s)
    if miss_driven:
        _require(s["misses"] - s["oversized_rejects"]
                 == s["inserts"] + s["replacements"],
                 "misses - oversized_rejects != inserts + replacements", s)
    return s


def _require(cond: bool, detail: str, stats: dict) -> None:
    if not cond:
        raise AssertionError(f"cache ledger violation: {detail} ({stats})")


class CountCache(BudgetedLRU):
    """Bounded LRU: (itemset key, version) -> (C,) int32 count row.

    ``capacity`` caps the entry count; ``max_bytes`` (None = unbounded)
    additionally caps the summed ``nbytes`` of the cached rows.  A hit
    returns a defensive copy: cached rows are immutable serving results,
    never views into a caller's buffer.
    """

    def _price(self, value: np.ndarray) -> int:
        return value.nbytes

    def get(self, key: Key, version: int) -> Optional[np.ndarray]:
        hit, entry = self._lookup((key, version))
        return entry.copy() if hit else None

    def put(self, key: Key, version: int, counts: np.ndarray) -> None:
        self._store((key, version), np.array(counts, np.int32, copy=True))
