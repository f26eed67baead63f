"""Sharded serving store — one logical ``VersionedDB`` spanning many shards.

The ROADMAP's multi-host serving item, built by COMPOSITION: each shard is a
full :class:`~repro.serve.store.VersionedDB` (resident dense/streaming base +
delta segment, versioned appends), and the sharded layer adds row
partitioning plus the all-reduce.  Exactness is the same additivity argument
as the base+delta composition inside one store: counts are int32 sums over
disjoint row sets, so

    counts(history) == sum over shards of counts(shard rows)

bit-identically, at every version ("Mining Frequent Itemsets from Secondary
Memory", Grahne & Zhu 2004 — partitioned row sweeps with exact merged
counts).

Routing and the vocab invariant
-------------------------------
Every query's block_k-padded target block is routed to EVERY shard and the
(K, C) int32 partials are all-reduced.  Targets are encoded once under the
GLOBAL vocab; that works because each shard's vocab is maintained as a
PREFIX-CONSISTENT extension snapshot of the global vocab: shards are
constructed with the global vocab, and ``append`` syncs the receiving shard
to the current global vocab before folding the batch (``extend_vocab`` only
ever appends bit columns, so a stale shard's resident rows remain valid and
its segments simply read a prefix of the global mask — bits beyond a
segment's width zero that segment's count, exactly the base+delta ``oob``
rule).

``append`` routes the whole batch to the least-loaded shard (fewest resident
rows) and bumps ONE logical version; a rejected batch (label out of range,
int32 overflow) leaves no trace on any shard.  The int32 overflow guard runs
against the GLOBAL per-class totals — per-shard totals fitting int32 does not
bound their sum.

Two all-reduce paths
--------------------
* **host loop** (``mesh=None``): each shard answers with its own resident
  engine (dense single launch / streaming chunk sweep / composed delta) and
  the host sums the partials — works on a single device, any shard count.
* **mesh** (``mesh=`` a ``torch.distributed`` ``DeviceMesh`` from
  ``launch/mesh.py::make_host_mesh``): the shards' segments are stacked into
  one row-partitioned placement (``mining.distributed.place_rows``, rebuilt
  lazily per version, each rank keeping its own block of rows on its
  device) and every query is ONE ``resident_distributed_counts`` call —
  each rank counts its local rows and one world ``all_reduce`` sums the
  (K, C) block.  This is the ``mining/distributed.py`` composition: serving
  rides the exact same counting call mining uses.

The mesh path is SPMD, like ``mining/distributed.py``: every rank of the
process group builds the same ``ShardedDB`` from the same transactions and
makes the same calls in the same order (an append or a query on one rank
only would leave the others' all-reduce unpaired).  ``stats()["mesh"]``
reports the sizes of the data axes, the rows' partition.

Mining over a sharded store goes through :class:`ShardedCountBackend` — the
:class:`~repro.mining.backend.CountBackend` with one checkpoint chunk PER
SHARD, so ``CountServer.mine``/``versioned_mine_frequent`` kill/resume works
unchanged: the shard grid is part of ``chunk_signature`` and the logical
version pins ``mine_signature`` (a resume across an append restarts cleanly).
"""
from __future__ import annotations

from typing import Hashable, List, Optional, Sequence, Tuple

import numpy as np

from .._device import DeviceLike
from ..mining.encode import ItemVocab, extend_vocab, pad_words
from ..obs import REGISTRY
from ..mining.stream import _host
from .store import (StoreCountBackend, VersionedDB, check_class_labels,
                    counts_for_itemsets, store_device)

Item = Hashable

# all-reduce path taken per counting sweep: mesh = one world all_reduce,
# host_loop = per-shard sweeps summed on the host
_M_SWEEP_MESH = REGISTRY.counter("shard_count_sweeps_total", path="mesh")
_M_SWEEP_HOST = REGISTRY.counter("shard_count_sweeps_total", path="host_loop")
_M_SHARD_APPENDS = REGISTRY.counter("shard_appends_total")


class ShardedDB:
    """Row-partitioned :class:`VersionedDB` shards behind one logical store.

    Mirrors the ``VersionedDB`` serving surface (``version`` / ``n_rows`` /
    ``vocab`` / ``counts`` / ``counts_masks`` / ``append`` / ``compact`` /
    ``stats``), so ``CountServer`` and the mining driver run unchanged on
    top of it.  Every shard and the mesh placement live on ``device``
    (default: the card).
    """

    def __init__(
        self,
        transactions: Sequence[Sequence[Item]] = (),
        classes: Optional[Sequence[int]] = None,
        n_classes: Optional[int] = None,
        *,
        n_shards: int = 2,
        mesh=None,
        data_axes: Tuple[str, ...] = ("data",),
        use_kernel: bool = True,
        streaming: Optional[bool] = None,
        chunk_rows: Optional[int] = None,
        stream_threshold_bytes: Optional[int] = None,
        merge_ratio: float = 0.25,
        min_compact_rows: Optional[int] = None,
        device: DeviceLike = None,
    ):
        if n_shards <= 0:
            raise ValueError("n_shards must be positive")
        transactions = [list(t) for t in transactions]
        if classes is not None and len(classes) != len(transactions):
            # validate BEFORE partitioning: the round-robin slice would
            # silently drop surplus labels (after they widened n_classes)
            # or IndexError on a short list
            raise ValueError("classes length != transactions length")
        self.n_classes = check_class_labels(classes, n_classes)
        self.n_shards = n_shards
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.use_kernel = use_kernel
        self.device = store_device(device)
        self.version = 0
        self.n_appends = 0
        self._mesh_launches = 0
        self._mesh_resident = None   # (bits, weights) device placement, lazy
        # one GLOBAL vocab; every shard starts from it (prefix invariant)
        self.vocab = ItemVocab.from_transactions(transactions)
        self.shards: List[VersionedDB] = []
        for s in range(n_shards):
            part = list(range(s, len(transactions), n_shards))  # round-robin
            self.shards.append(VersionedDB(
                [transactions[i] for i in part],
                classes=[classes[i] for i in part] if classes is not None
                else None,
                n_classes=self.n_classes, vocab=self.vocab,
                use_kernel=use_kernel, streaming=streaming,
                chunk_rows=chunk_rows,
                stream_threshold_bytes=stream_threshold_bytes,
                merge_ratio=merge_ratio,
                min_compact_rows=min_compact_rows, device=self.device))
        # per-shard totals fitting int32 does not bound their SUM — the
        # serving guarantee is on the merged counts, so guard globally
        self._class_totals = VersionedDB._guard_totals(
            sum((s._class_totals for s in self.shards),
                np.zeros(self.n_classes, np.int64)))

    # -- introspection --------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return sum(s.n_rows for s in self.shards)

    @property
    def resident(self) -> str:
        kinds = ",".join(s.resident for s in self.shards)
        return f"sharded[{kinds}]"

    @property
    def base_rows(self) -> int:
        return sum(s.base_rows for s in self.shards)

    @property
    def delta_rows(self) -> int:
        return sum(s.delta_rows for s in self.shards)

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.shards)

    @property
    def kernel_launches(self) -> int:
        return self._mesh_launches + sum(s.kernel_launches
                                         for s in self.shards)

    def stats(self) -> dict:
        return {
            "version": self.version, "n_rows": self.n_rows,
            "n_classes": self.n_classes, "vocab_size": self.vocab.size,
            "resident": self.resident, "n_shards": self.n_shards,
            "shard_rows": [s.n_rows for s in self.shards],
            "base_rows": self.base_rows, "delta_rows": self.delta_rows,
            "nbytes": self.nbytes, "kernel_launches": self.kernel_launches,
            "appends": self.n_appends,
            "compactions": sum(s.n_compactions for s in self.shards),
            "failed_compactions": sum(s.n_failed_compactions
                                      for s in self.shards),
            "mesh": (None if self.mesh is None else {
                a: int(self.mesh.shape[self.mesh.mesh_dim_names.index(a)])
                for a in self.data_axes}),
        }

    # -- append ---------------------------------------------------------------
    def append(
        self,
        transactions: Sequence[Sequence[Item]],
        classes: Optional[Sequence[int]] = None,
    ) -> int:
        """Route the batch to the least-loaded shard; bump ONE logical
        version.  A rejected batch leaves no trace on any shard."""
        transactions = [list(t) for t in transactions]
        if not transactions:
            return self.version
        # validate + guard against the GLOBAL totals before any shard state
        check_class_labels(classes, self.n_classes)
        inc = np.zeros(self.n_classes, np.int64)
        if classes is not None:
            if len(classes) != len(transactions):
                raise ValueError("classes length != transactions length")
            np.add.at(inc, np.asarray(classes, np.int64), 1)
        else:
            if self.n_classes != 1:
                raise ValueError(
                    "classes are required on a multi-class store "
                    f"(n_classes={self.n_classes})")
            inc[0] = len(transactions)
        totals = VersionedDB._guard_totals(self._class_totals + inc)

        shard = min(self.shards, key=lambda s: s.n_rows)
        old_vocab = shard.vocab
        # sync the receiving shard to the current global vocab FIRST: its own
        # extend_vocab then lands on exactly the new global (deterministic),
        # keeping every shard a prefix snapshot of one global column order
        shard.vocab = self.vocab
        try:
            shard.append(transactions, classes=classes)
        except BaseException:
            shard.vocab = old_vocab          # rejected: no trace
            raise
        self.vocab = shard.vocab
        self._class_totals = totals
        self._mesh_resident = None           # placement is version-stale
        self.n_appends += 1
        self.version += 1
        _M_SHARD_APPENDS.inc()
        return self.version

    def compact(self) -> None:
        """Fold every shard's delta into its base (counts unchanged)."""
        for s in self.shards:
            s.compact()
        self._mesh_resident = None           # chunk geometry changed

    # -- counting -------------------------------------------------------------
    def _resident_placement(self):
        """Lazily (re)build the mesh row placement from every shard's
        segments, padded to the current global width.  Rebuilt per version —
        appends invalidate; queries between appends reuse one placement."""
        if self._mesh_resident is None:
            from ..mining.distributed import place_rows

            w_now = self.vocab.n_words
            bit_parts, w_parts = [], []
            for s in self.shards:
                if s.base_rows:
                    bit_parts.append(pad_words(_host(s.base.bits), w_now))
                    w_parts.append(_host(s.base.weights))
                if s.delta_rows:
                    bit_parts.append(pad_words(s._delta.bits, w_now))
                    w_parts.append(s._delta.weights)
            bits = (np.concatenate(bit_parts) if bit_parts
                    else np.zeros((0, w_now), np.uint32))
            weights = (np.concatenate(w_parts) if w_parts
                       else np.zeros((0, self.n_classes), np.int32))
            self._mesh_resident = place_rows(bits, weights, self.mesh,
                                             data_axes=self.data_axes,
                                             device=self.device)
        return self._mesh_resident

    def counts_masks(self, masks: np.ndarray,
                     block_k: Optional[int] = None) -> np.ndarray:
        """(K, C) exact counts for a (K, W_global) target block: the block is
        routed to every shard and the int32 partials are all-reduced — on the
        host when ``mesh`` is None, via one world ``all_reduce`` otherwise."""
        k = int(masks.shape[0])
        if k == 0:
            return np.zeros((0, self.n_classes), np.int32)
        if self.mesh is not None:
            from ..mining.distributed import resident_distributed_counts

            bits_d, w_d = self._resident_placement()
            narrow = masks
            if masks.shape[1] < int(bits_d.shape[1]):
                narrow = pad_words(np.ascontiguousarray(masks),
                                   int(bits_d.shape[1]))
            got = resident_distributed_counts(
                bits_d, narrow, w_d, self.mesh, data_axes=self.data_axes,
                model_axis=None, use_kernel=self.use_kernel)
            self._mesh_launches += 1
            _M_SWEEP_MESH.inc()
            return got
        _M_SWEEP_HOST.inc()
        return self._shard_sweep(masks, block_k=block_k)

    def _shard_sweep(self, masks: np.ndarray, *,
                     block_k: Optional[int] = None, start_chunk: int = 0,
                     init: Optional[np.ndarray] = None,
                     on_chunk=None) -> np.ndarray:
        """The host loop: each shard's composed sweep from shard
        ``start_chunk`` on, summed onto ``init`` (the ``CountBackend``
        resume contract, one chunk per shard)."""
        k = int(masks.shape[0])
        total = (np.zeros((k, self.n_classes), np.int32) if init is None
                 else np.array(np.asarray(init), np.int32))
        if k == 0:
            return total
        # every shard, empty ones included, completes its chunk, so recorded
        # progress always matches the one-chunk-per-shard grid
        for i in range(start_chunk, len(self.shards)):
            total = total + self.shards[i].counts_masks(masks,
                                                        block_k=block_k)
            if on_chunk is not None:
                on_chunk(i, total)
        return total

    def counts(self, itemsets: Sequence[Sequence[Item]]) -> np.ndarray:
        """(K, C) counts for raw itemsets under the global vocab; itemsets
        naming never-seen items count exactly 0 (same contract as
        ``VersionedDB.counts``, same code)."""
        return counts_for_itemsets(self, itemsets)


class ShardedCountBackend(StoreCountBackend):
    """:class:`~repro.mining.backend.CountBackend` over a :class:`ShardedDB`:
    the seam that runs the unified mining driver against the sharded store.

    Checkpoint chunk grid = ONE CHUNK PER SHARD (each chunk is that shard's
    full composed base+delta sweep), so a killed mine resumes after the last
    fully-counted shard.  ``chunk_signature`` carries the shard grid — a
    resume onto a different shard layout restarts the in-flight level from
    chunk 0 (still exact) — and ``mine_signature`` pins the logical version:
    a resume across an ``append`` discards the whole checkpoint.
    """

    @property
    def n_count_chunks(self) -> int:
        return len(self.store.shards)

    def chunk_signature(self) -> dict:
        return {
            "backend": "sharded", "version": self.store.version,
            "n_shards": self.store.n_shards,
            "shard_rows": [s.n_rows for s in self.store.shards],
        }

    def mine_signature(self) -> dict:
        return {"version": self.store.version,
                "n_shards": self.store.n_shards}

    def counts(self, masks: np.ndarray, *, block_k: Optional[int] = None,
               start_chunk: int = 0, init: Optional[np.ndarray] = None,
               on_chunk=None) -> np.ndarray:
        # per-shard sweeps (not the fused mesh launch): the chunk boundary IS
        # the resume point
        return self.store._shard_sweep(masks, block_k=block_k,
                                       start_chunk=start_chunk, init=init,
                                       on_chunk=on_chunk)
