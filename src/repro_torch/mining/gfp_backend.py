"""Device-hybrid GFP-growth counting backend — conditional-pattern-base
counting over the encoded bitmap, batched per tree item.

The level-wise engines pay one kernel launch per candidate level: every
level's (K, W) target block sweeps ALL rows of the DB.  The paper's
GFP-growth (Algorithm 3.1) instead walks a guided FP-tree: each target
itemset is counted against the (much smaller) conditional pattern base of its
deepest item.  This module realizes that walk on the bitmap layout:

  * the support-descending bitmap IS the FP-tree analogue (``encode.py``):
    dedup = prefix compression, column rank = arrangement order.  The
    conditional pattern base of item ``a`` is derived directly — rows with
    bit ``a`` set, masked to the prefix columns ``0..rank(a)`` (items at or
    above ``a`` in the arrangement order), re-deduped.  Counting any itemset
    whose deepest-rank ("tail") item is ``a`` against that block yields its
    exact full-DB count: bits deeper than the tail can never occur in the
    mask, so the projection drops nothing the containment test reads.
  * ``counts(masks)`` groups the target block by tail item and flushes each
    group as ONE conditional block — all of one tree item's conditional
    counting in a single launch, instead of the whole DB once per level.
    Guided data reduction (paper optimization #4) additionally projects the
    block to the union of the group's masks and re-dedups before counting.
  * each flushed block is counted on the HOST (vectorized numpy containment
    over the deduped block) when it has at most ``host_rows`` rows, and
    otherwise copied to the backend's ``device`` and counted through the
    port's ``itemset_counts`` (whose ``accum`` resolves through the tuning
    table, so a tuned block may run K2) — the hybrid: small conditional
    bases never pay launch overhead, large ones keep the device.

Exactness: every path is integer arithmetic over the same per-class weights
the dense kernel sums — dedup aggregation, prefix projection, and host/device
containment all commute with the int32 count, so ``GFPBackend.counts`` is
bit-identical to ``DenseBackend.counts`` and to the host ``core/gfp.py``
g-counts (``tests/test_torch_chooser_gfp.py`` pins all three against each
other and against the JAX package's backend).

Driver integration: flush groups are the backend's count CHUNKS — one chunk
per distinct tail item (the empty mask, if present, is its own leading
chunk), in deterministic ascending-rank order.  ``chunk_signature`` /
``mine_signature`` are wired so the unified driver's ``MiningCheckpoint``
kill/resume (``mining/driver.py``) works unchanged: a killed mine resumes
mid-FLUSH, skipping every conditional block already counted.
``from_store`` builds the backend from a serving store's composed rows
(``CountServer.mine(backend="gfp"|"auto")``).
"""
from __future__ import annotations

from typing import Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..kernels.itemset_count import itemset_counts
from ..obs import REGISTRY, TRACER
from .backend import CountBackend
from .encode import ItemVocab, dedup_rows, encode_targets, pad_words
from .stream import _db_device, _host

Item = Hashable

# hybrid dispatch ledger: which path counted each flushed conditional block
# (obs.summary_line reads the host label), and CPB cache effectiveness
_M_BLOCKS_HOST = REGISTRY.counter("gfp_blocks_total", path="host")
_M_BLOCKS_KERNEL = REGISTRY.counter("gfp_blocks_total", path="kernel")
_M_BLOCKS_EMPTY = REGISTRY.counter("gfp_blocks_total", path="empty")
_M_CPB_BUILDS = REGISTRY.counter("gfp_cpb_builds_total")
_M_CPB_REUSES = REGISTRY.counter("gfp_cpb_reuses_total")

# Conditional blocks at or under this many deduped rows are counted on the
# host (vectorized containment); larger blocks go through the kernel.  The
# crossover favors the host generously: a kernel launch over a few thousand
# rows costs more in dispatch than the numpy sweep does in arithmetic.
# ``host_rows=None`` derives the crossover from the active tuning table's
# measured launch cost (``roofline.autotune.derived_chooser_thresholds``).
DEFAULT_HOST_BLOCK_ROWS = 4096


def _resolve_host_rows(host_rows):
    if host_rows is not None:
        return int(host_rows)
    from ..roofline import autotune
    derived = autotune.derived_chooser_thresholds()
    return int(derived.get("gfp_host_rows", DEFAULT_HOST_BLOCK_ROWS))

# Host containment slab budget (bytes of the (slab, P, W) uint32 broadcast).
_HOST_SLAB_BYTES = 8 << 20


def _prefix_mask(col: int, n_words: int) -> np.ndarray:
    """(W,) uint32 mask selecting bit columns ``0..col`` inclusive."""
    out = np.zeros(n_words, np.uint32)
    full, rem = divmod(col + 1, 32)
    out[:full] = np.uint32(0xFFFFFFFF)
    if rem:
        out[full] = np.uint32((1 << rem) - 1)
    return out


def _tail_columns(masks: np.ndarray) -> np.ndarray:
    """Per-mask index of the highest set bit column (-1 for the empty mask).

    The highest set column is the target's deepest-rank (least-frequent)
    item — the FP-tree item whose conditional pattern base decides the
    target's count."""
    k, w = masks.shape
    tails = np.full(k, -1, np.int64)
    for wi in range(w):
        v = masks[:, wi]
        nz = v != 0
        if not nz.any():
            continue
        # frexp is exact on uint32 values: v in [2**(e-1), 2**e)
        e = np.frexp(v.astype(np.float64))[1].astype(np.int64)
        tails[nz] = 32 * wi + e[nz] - 1
    return tails


class GFPBackend(CountBackend):
    """Guided FP-growth hybrid :class:`CountBackend` (see module docstring).

    Counters: ``kernel_launches`` (device flushes), ``host_blocks`` (host-
    counted flushes), ``blocks_counted`` (total flush groups processed) —
    the kill/resume tests and ``chip_smoke.py`` read these.  ``device`` is
    where kernel-sized blocks are counted: by default the DB's own device
    (``from_arrays``: the card).
    """

    def __init__(self, db, *, use_kernel: bool = True,
                 host_rows: Optional[int] = None,
                 guide: bool = True, device: DeviceLike = None):
        self._setup(db.vocab, _host(db.bits), _host(db.weights),
                    int(db.n_rows), int(db.n_classes),
                    use_kernel=use_kernel, host_rows=host_rows, guide=guide,
                    device=_db_device(db) if device is None else device)

    @classmethod
    def from_arrays(cls, vocab: ItemVocab, bits, weights, n_rows: int,
                    n_classes: int, **kw) -> "GFPBackend":
        self = cls.__new__(cls)
        self._setup(vocab, _host(bits), _host(weights),
                    int(n_rows), int(n_classes), **kw)
        return self

    @classmethod
    def from_store(cls, store, **kw) -> "GFPBackend":
        """Materialize the hybrid backend from a serving ``VersionedDB``:
        base + delta rows at the current vocab width, re-deduped — the same
        composed history the store's own sweep counts (a D2H copy of a dense
        base, every segment of a spilled one).  Kernel-sized blocks count on
        the store's device unless ``device=`` says otherwise.  The
        ``mine_signature`` pins the store ``version``, so a checkpoint
        resumed after an ``append`` is discarded wholesale."""
        w_now = store.vocab.n_words
        bits = pad_words(_host(store.base.bits), w_now)
        wts = _host(store.base.weights)
        if store.delta_rows:
            bits = np.concatenate([bits, pad_words(store._delta.bits, w_now)])
            wts = np.concatenate([wts, store._delta.weights])
        if bits.shape[0]:
            bits, wts = dedup_rows(bits, wts)
        kw.setdefault("device", store.device)
        return cls.from_arrays(
            store.vocab, bits, wts, store.n_rows, store.n_classes,
            mine_sig={"engine": "gfp", "version": store.version}, **kw)

    def _setup(self, vocab, bits, weights, n_rows, n_classes, *,
               use_kernel=True, host_rows=None, guide=True, mine_sig=None,
               device: DeviceLike = None):
        self.vocab = vocab
        self.bits = np.ascontiguousarray(bits, np.uint32)
        self.weights = np.ascontiguousarray(weights, np.int32)
        self.n_rows = n_rows
        self.n_classes = n_classes
        self.use_kernel = use_kernel
        # host arrays here; kernel-sized conditional blocks count on device
        self.device = resolve_device(device)
        self.host_rows = _resolve_host_rows(host_rows)
        self.guide = bool(guide)
        self._mine_sig = dict(mine_sig or {})
        totals = (self.weights.sum(axis=0, dtype=np.int64)
                  if self.bits.shape[0] else np.zeros(n_classes, np.int64))
        # the empty-mask chunk answers with these totals, and every count is
        # bounded by them: int32 must hold them (same guard as streaming)
        if np.any(totals > np.iinfo(np.int32).max):
            raise OverflowError(
                "per-class weight totals exceed int32; counts could wrap — "
                "split the DB")
        self._class_totals = totals.astype(np.int32)
        self._cpb: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.kernel_launches = 0
        self.host_blocks = 0
        self.blocks_counted = 0

    # -- protocol -------------------------------------------------------------
    @property
    def nbytes(self) -> int:
        return int(self.bits.nbytes + self.weights.nbytes)

    @property
    def n_count_chunks(self) -> int:
        # upper bound on a call's flush-group count: one group per vocab item
        # plus the empty-mask group.  A given call's chunk grid is the set of
        # DISTINCT tail items among its masks in ascending-rank order —
        # deterministic from the masks, so the driver's mid-level resume
        # (same itemsets + signature => start_chunk) replays it exactly.
        return self.vocab.size + 1

    def chunk_signature(self) -> dict:
        return {"backend": "gfp", "n_rows": int(self.bits.shape[0]),
                "guide": self.guide}

    def mine_signature(self) -> dict:
        return dict(self._mine_sig)

    def traits(self):
        from .chooser import DatasetTraits
        return DatasetTraits.measure(self.bits, self.weights, self.vocab,
                                     self.n_rows)

    def item_counts(self) -> np.ndarray:
        """Level-1 shortcut: host column sums (paper optimization #2's O(1)
        header consult, bitmap form) — zero launches for the singles pass."""
        rows = np.zeros((self.vocab.size, self.n_classes), np.int64)
        for c in range(self.vocab.size):
            bit = (self.bits[:, c >> 5] >> np.uint32(c & 31)) & 1
            rows[c] = (bit[:, None] * self.weights).sum(axis=0)
        return rows

    def counts(self, masks, *, start_chunk=0, init=None, on_chunk=None):
        masks = np.ascontiguousarray(np.asarray(masks), np.uint32)
        k = int(masks.shape[0])
        acc = (np.zeros((k, self.n_classes), np.int32) if init is None
               else np.array(np.asarray(init), np.int32))
        if k == 0:
            return acc
        groups = self._flush_groups(masks)
        with TRACER.span("gfp.counts",
                         {"n_masks": k, "n_groups": len(groups),
                          "start_chunk": start_chunk}):
            for j in range(start_chunk, len(groups)):
                tail, idx = groups[j]
                acc[idx] += self._count_group(tail, masks[idx])
                self.blocks_counted += 1
                if on_chunk is not None:
                    on_chunk(j, acc)
        return acc

    # -- the guided flush -----------------------------------------------------
    def _flush_groups(self, masks):
        """[(tail_col, mask_row_indices)] in deterministic ascending-rank
        order; np.unique sorts, so an empty-mask group (-1) leads."""
        tails = _tail_columns(masks)
        return [(int(t), np.flatnonzero(tails == t)) for t in np.unique(tails)]

    def _conditional_block(self, col: int):
        """Conditional pattern base of the item at bit column ``col``: rows
        containing it, projected to the prefix columns ``0..col``, re-deduped
        (the FP-tree prefix-path extraction, bitmap form).  Cached per item —
        every mining level with this tail reuses the same block."""
        blk = self._cpb.get(col)
        if blk is None:
            _M_CPB_BUILDS.inc()
            bit = (self.bits[:, col >> 5] >> np.uint32(col & 31)) & np.uint32(1)
            sel = bit.astype(bool)
            rows = self.bits[sel] & _prefix_mask(col, self.bits.shape[1])
            wts = self.weights[sel]
            if rows.shape[0]:
                rows, wts = dedup_rows(rows, wts)
            blk = (rows, wts)
            self._cpb[col] = blk
        else:
            _M_CPB_REUSES.inc()
        return blk

    def _count_group(self, tail: int, gmasks: np.ndarray) -> np.ndarray:
        kg = gmasks.shape[0]
        if tail < 0:
            # the empty itemset is contained in every row
            _M_BLOCKS_EMPTY.inc()
            return np.broadcast_to(self._class_totals,
                                   (kg, self.n_classes))
        rows, wts = self._conditional_block(tail)
        if self.guide and rows.shape[0]:
            # guided data reduction (#4): project the block to the union of
            # this group's target bits (the tail bit is in every mask, so it
            # survives) and re-dedup — fewer distinct conditional paths
            union = np.bitwise_or.reduce(gmasks, axis=0)
            rows, wts = dedup_rows(rows & union, wts)
        p = rows.shape[0]
        if p == 0:
            _M_BLOCKS_EMPTY.inc()
            return np.zeros((kg, self.n_classes), np.int32)
        if p <= self.host_rows:
            self.host_blocks += 1
            _M_BLOCKS_HOST.inc()
            return self._host_count(rows, wts, gmasks)
        self.kernel_launches += 1
        _M_BLOCKS_KERNEL.inc()
        dev = self.device
        return _host(itemset_counts(
            torch.from_numpy(rows).to(dev),
            torch.from_numpy(np.ascontiguousarray(gmasks)).to(dev),
            torch.from_numpy(np.ascontiguousarray(wts)).to(dev),
            use_kernel=self.use_kernel))

    def _host_count(self, rows, wts, gmasks) -> np.ndarray:
        """Vectorized containment over a small deduped block — the same
        integers the kernel would produce, without a launch."""
        kg = gmasks.shape[0]
        p, w = rows.shape
        out = np.empty((kg, self.n_classes), np.int64)
        wts64 = wts.astype(np.int64)
        slab = max(1, _HOST_SLAB_BYTES // max(1, p * w * 4))
        for s in range(0, kg, slab):
            m = gmasks[s:s + slab]
            contain = ((rows[None, :, :] & m[:, None, :])
                       == m[:, None, :]).all(axis=2)
            out[s:s + slab] = contain.astype(np.int64) @ wts64
        return out.astype(np.int32)


def gfp_mine_frequent(
    db,                       # DenseDB | StreamingDB (host views are taken)
    min_count: float,
    *,
    class_column: Optional[int] = None,
    max_len: int = 0,
    use_kernel: bool = True,
    host_rows: Optional[int] = None,
    guide: bool = True,
    checkpoint=None,          # Optional[MiningCheckpoint]
    on_chunk=None,
    device: DeviceLike = None,
) -> Dict[Tuple[Item, ...], int]:
    """Exact frequent-itemset mining through the GFP-hybrid backend — a shim
    over the unified driver (``mining/driver.py``), like every other engine
    entry point.  Kill/resume via ``checkpoint`` works at flush-group
    granularity: a restart skips every conditional block already counted."""
    from .driver import mine_frequent as _driver_mine

    backend = GFPBackend(db, use_kernel=use_kernel, host_rows=host_rows,
                         guide=guide, device=device)
    return _driver_mine(backend, min_count, class_column=class_column,
                        max_len=max_len, checkpoint=checkpoint,
                        on_chunk=on_chunk)


def gfp_multitude_counts(
    tis,                      # repro_torch.core.TISTree
    db,                       # DenseDB | StreamingDB
    *,
    use_kernel: bool = True,
    host_rows: Optional[int] = None,
    guide: bool = True,
    device: DeviceLike = None,
) -> Dict[Tuple[Item, ...], np.ndarray]:
    """The GFP-growth contract on the hybrid backend: {sorted-itemset-tuple
    -> (C,) int32 per-class counts} for every *target* node of the TIS-tree.
    Targets naming items absent from the DB vocab count exactly 0 (the
    paper's note that such targets never appear in the FP-tree) — the same
    unknown-item contract as ``dense_gfp_counts``."""
    targets, keys, zero_keys = [], [], []
    for node in tis.targets():
        itemset = node.itemset()
        key = tuple(sorted(itemset, key=repr))
        if all(a in db.vocab for a in itemset):
            targets.append(itemset)
            keys.append(key)
        else:
            zero_keys.append(key)
    out = {kk: np.zeros(db.n_classes, np.int32) for kk in zero_keys}
    if targets:
        backend = GFPBackend(db, use_kernel=use_kernel, host_rows=host_rows,
                             guide=guide, device=device)
        rows = backend.counts(encode_targets(targets, db.vocab))
        for key, row in zip(keys, rows):
            out[key] = row
    return out
