"""Micro-batching query planner — many small requests, one kernel launch.

Every counting launch sweeps the whole resident bitmap regardless of how many
targets ride along (up to ``block_k`` per K-block), so per-query launches waste
almost the entire sweep.  The batcher coalesces the queries of many clients
into one padded (K, W) target block:

  * itemsets are canonicalized (sorted, deduped) so identical targets from
    different clients collapse to ONE mask row — cross-client dedup;
  * the block is zero-padded up to a ``block_k`` multiple so the kernel grid
    is full and one compiled executable serves every batch shape bucket;
  * after the launch, the (K, C) result rows are scattered back per request
    in each request's original submission order.

The batcher is pure planning (host, numpy): the device pass and the result
cache live in ``serve.service`` / ``serve.cache``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from ..mining.encode import ItemVocab, encode_targets
from ..obs import REGISTRY, TRACER

Item = Hashable
Key = Tuple[Item, ...]

# Process-wide serving counters (thread-confined shard bumps, see
# repro_torch.obs).
# All three are recorded at the DRAIN point (``take()``), in bulk, and rolled
# back by ``restore()`` — the submit path stays registry-free, which is what
# keeps enabled-metrics overhead inside the obs_overhead bench's gate.
_M_REQUESTS = REGISTRY.counter("serve_requests_total")
_M_QUERIES = REGISTRY.counter("serve_queries_total")
_M_DEDUPED = REGISTRY.counter("serve_deduped_queries_total")
# A request's wait from the entry of the submit call, before the server's
# lock is taken, to the drain: it includes the time the submit waited behind
# an in-flight flush that held the lock.
_H_QUEUE_WAIT = REGISTRY.histogram("serve_queue_wait_ms")


def canonical_itemset(itemset: Sequence[Item]) -> Key:
    """Deterministic identity of an itemset query: sorted, duplicate-free.
    The cache key half and the cross-client dedup key."""
    return tuple(sorted(set(itemset), key=repr))


@dataclass
class QueryRequest:
    """One client's submitted query list (keys already canonical).
    ``t_submit`` (perf_counter at the entry of the submit call, before the
    server's lock) feeds the queue-wait histogram and ``serve.queued``."""
    request_id: int
    client_id: str
    keys: List[Key]
    t_submit: float = 0.0


@dataclass
class BatchPlan:
    """A drained batch: unique targets + the per-request scatter map."""
    unique_keys: List[Key]
    rows: Dict[Key, int]                  # key -> row in unique_keys
    requests: List[QueryRequest] = field(default_factory=list)

    @property
    def n_queries(self) -> int:
        return sum(len(r.keys) for r in self.requests)


class MicroBatcher:
    """Accumulates (client_id, itemsets) requests; ``take()`` drains them into
    one deduplicated :class:`BatchPlan`."""

    def __init__(self, block_k: Optional[int] = None):
        # None = the tuning-table default; explicit values pin the pad size
        if block_k is None:
            from ..roofline import autotune
            block_k = autotune.DEFAULT_BLOCK_K
        if block_k <= 0:
            raise ValueError("block_k must be positive")
        self.block_k = block_k
        self._pending: List[QueryRequest] = []
        self._next_id = 0
        self.n_requests = 0
        self.n_queries = 0
        self.n_deduped = 0     # queries answered by another request's mask row

    @property
    def pending(self) -> int:
        return len(self._pending)

    def submit(self, client_id: str, itemsets: Sequence[Sequence[Item]],
               t_submit: Optional[float] = None) -> int:
        """Queue one request; returns its ticket (the ``flush()`` result
        key).  ``t_submit`` is when the caller's submit call was entered
        (default: now), so that the queue wait counts the wait for the
        server's lock."""
        rid = self._next_id
        self._next_id += 1
        keys = [canonical_itemset(s) for s in itemsets]
        self._pending.append(QueryRequest(
            rid, client_id, keys,
            time.perf_counter() if t_submit is None else t_submit))
        self.n_requests += 1
        self.n_queries += len(keys)
        # instant (not a span): the queue wait is the flush's story, and
        # cross-thread nesting would be fake — the ticket id is the link.
        # Guarded so the disabled path allocates nothing (not even the
        # attrs dict) per submit.
        if TRACER.enabled:
            TRACER.instant("serve.submit",
                           {"ticket": rid, "n_queries": len(keys)})
        return rid

    def take(self) -> BatchPlan:
        """Drain pending requests into one plan (unique keys in first-seen
        order — deterministic, so repeated workloads build identical blocks)."""
        now = time.perf_counter()
        rows: Dict[Key, int] = {}
        unique: List[Key] = []
        total = 0
        for req in self._pending:
            total += len(req.keys)
            for key in req.keys:
                if key not in rows:
                    rows[key] = len(unique)
                    unique.append(key)
        dups = total - len(unique)
        self.n_deduped += dups
        # registry mirrors, recorded once per drain (bulk, not per query)
        _M_REQUESTS.inc(len(self._pending))
        _M_QUERIES.inc(total)
        if dups:
            _M_DEDUPED.inc(dups)
        _H_QUEUE_WAIT.observe_many(
            [(now - req.t_submit) * 1e3 for req in self._pending])
        if TRACER.enabled:
            # begun on the submitting thread: filed unnested, linked by ticket
            for req in self._pending:
                TRACER.record("serve.queued", req.t_submit, now,
                              {"ticket": req.request_id}, nest=False)
        plan = BatchPlan(unique_keys=unique, rows=rows,
                         requests=self._pending)
        self._pending = []
        return plan

    def restore(self, requests: List[QueryRequest]) -> None:
        """Re-queue a taken plan's requests (failed flush): tickets stay
        answerable by a retry.  Requests go back at the FRONT in their
        original order, and the ``n_deduped`` increments their ``take()``
        made are rolled back — a retried flush re-takes the same requests
        and would otherwise double-count every dedup, skewing ``stats()``
        after any retry.  Submit-time stats are untouched."""
        # take() incremented n_deduped once per non-first occurrence of a key
        # within the drained set: total keys minus distinct keys, independent
        # of request order — exactly the amount a re-take will add again
        total = sum(len(r.keys) for r in requests)
        distinct = len({key for r in requests for key in r.keys})
        self.n_deduped -= total - distinct
        # the registry mirrors are drain-time ledgers, so the rollback
        # applies to all of them (negative bumps — exactness over
        # monotonicity): a re-take must leave each request counted once
        _M_REQUESTS.inc(-len(requests))
        _M_QUERIES.inc(-total)
        _M_DEDUPED.inc(-(total - distinct))
        self._pending = list(requests) + self._pending

    def stats(self) -> dict:
        return {"requests": self.n_requests, "queries": self.n_queries,
                "deduped": self.n_deduped, "pending": self.pending,
                "block_k": self.block_k}


def build_masks(
    keys: Sequence[Key],
    vocab: ItemVocab,
    block_k: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode unique targets into a (K_pad, W) block, K_pad a ``block_k``
    multiple (zero rows pad the tail; their counts are sliced off).
    ``block_k=None`` pads to the autotuner's default K-block.

    Returns ``(masks, known)`` where ``known[i]`` is False for keys naming
    items outside the vocab: those get an all-zero mask row, and since an
    empty mask is contained in EVERY row, the caller must zero their counts
    (the exact count of a never-seen item's itemset is 0).
    """
    if block_k is None:
        from ..roofline import autotune
        block_k = autotune.DEFAULT_BLOCK_K
    k = len(keys)
    k_pad = max(block_k, ((k + block_k - 1) // block_k) * block_k)
    masks = np.zeros((k_pad, vocab.n_words), np.uint32)
    known = np.array([all(a in vocab for a in key) for key in keys], bool) \
        if k else np.zeros(0, bool)
    idx = np.flatnonzero(known)
    if idx.size:
        masks[idx] = encode_targets([keys[i] for i in idx], vocab)
    return masks, known
