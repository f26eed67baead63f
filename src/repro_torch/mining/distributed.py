"""Distributed multitude-targeted mining — the GFP-growth engine on a mesh.

Parallel decomposition (maps the paper's workload to a (data, model) mesh):

  * transactions (N axis)  -> sharded over the 'data' mesh axis: each rank
    counts its own rows;
  * targets (K axis)       -> sharded over the 'model' mesh axis: ranks hold
    disjoint target blocks, so no rank counts the whole (K, C) matrix.

Programming model: every rank of a ``torch.distributed`` process group runs
the same call with the same host arrays.  Each rank takes its row shard
(its coordinate on the data axes) and its target block (its coordinate on
the model axis), counts them with the port's ``itemset_counts`` (K1 on the
card, or K2 under a table that resolves ``mxu_f32``), writes the result into
a zero ``(K_pad, C)`` int32 block at its K offset, and makes ONE
``all_reduce`` (SUM) over the whole world: that single call sums the data
shards and assembles the model blocks, and every rank gets the same
``(K, C)`` counts — so the level-wise driver builds the same frontier on
every rank.  Ranks on mesh axes the call does not shard over are replicas:
only the one at coordinate 0 contributes.

The block's device follows the group's backend, chosen up front: NCCL (one
card per rank) reduces it on the card; gloo (the CPU tests, or ranks that
share one card) reduces a host copy.

Scaling: work O(N·K·W / P) per rank, communication one K_pad·C·4-byte
reduce per launch — independent of N.

Fault tolerance: level-synchronous mining checkpoints (level index +
frequent frontier + the in-flight level's partial) via ``MiningCheckpoint``,
written by rank 0 only and read by every rank; the signature names no mesh
shape, so a restart may run on a DIFFERENT mesh, or in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Hashable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from ..kernels.itemset_count import itemset_counts
from .checkpoint import MiningCheckpoint
from .encode import ItemVocab, encode_targets

__all__ = ["distributed_counts", "place_rows", "resident_distributed_counts",
           "DistributedMiner", "MiningCheckpoint"]

Item = Hashable


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class _Place(NamedTuple):
    """This rank's place in a call: its row shard ``d`` of ``dsize``, its
    target block ``m`` of ``msize``, and whether it contributes (the
    replica at coordinate 0 of every axis the call does not shard)."""
    d: int
    dsize: int
    m: int
    msize: int
    lead: bool


def _place(mesh, data_axes: Tuple[str, ...],
           model_axis: Optional[str]) -> _Place:
    names = list(mesh.mesh_dim_names)
    shape = tuple(mesh.shape)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh spans {mesh.size()} ranks, the process "
                         f"group {dist.get_world_size()}: the one all-reduce "
                         "sums over the whole world")
    d, dsize = 0, 1
    for a in data_axes:
        i = names.index(a)
        d, dsize = d * shape[i] + coord[i], dsize * shape[i]
    m, msize = 0, 1
    if model_axis:
        i = names.index(model_axis)
        m, msize = coord[i], shape[i]
    used = set(data_axes) | {model_axis}
    lead = all(coord[i] == 0 for i, a in enumerate(names) if a not in used)
    return _Place(d, dsize, m, msize, lead)


def _reduce_device(count_device: torch.device) -> torch.device:
    """Where the ``(K_pad, C)`` block is reduced, from the group's backend:
    NCCL's on this rank's card, gloo's on the host."""
    if dist.get_backend() == "nccl":
        if count_device.type != "cuda":
            raise ValueError("an NCCL group reduces on the card: count on "
                             f"'cuda', not {count_device}")
        return count_device
    return torch.device("cpu")


def _resolve_shard_config(n_local: int, k_local: int, w: int, c: int):
    """Per-RANK launch config: the table is keyed on the geometry each rank
    actually counts (its row shard and target block), not the global
    problem."""
    from ..roofline import autotune
    cfg = autotune.resolve_launch_config(max(1, n_local), max(1, k_local),
                                         max(1, w), max(1, c))
    return dict(block_k=cfg.block_k, block_n=cfg.block_n, accum=cfg.accum)


def _count_reduce(tx: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor,
                  place: _Place, k: int, k_pad: int, cfg: dict,
                  use_kernel: bool) -> np.ndarray:
    """Count this rank's rows ``tx``/``w`` (on the count device) against its
    block of the ``(k_pad, W)`` targets ``tgt`` into a zero ``(k_pad, C)``
    block, all-reduce it over the world, and return the first ``k`` rows."""
    c = int(w.shape[1])
    red = _reduce_device(tx.device)
    block = torch.zeros((k_pad, c), dtype=torch.int32, device=red)
    kb = k_pad // place.msize
    lo, hi = place.m * kb, min((place.m + 1) * kb, k)
    if place.lead and hi > lo and tx.shape[0] > 0:
        block[lo:hi] = itemset_counts(tx, tgt[lo:hi], w,
                                      use_kernel=use_kernel, **cfg).to(red)
    dist.all_reduce(block)
    return block[:k].cpu().numpy()


def _rows(a: np.ndarray, s: int, e: int, device: torch.device
          ) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a[s:e])).to(device)


def distributed_counts(
    tx_bits: np.ndarray,      # (N, W) uint32, host; the same on every rank
    tgt_bits: np.ndarray,     # (K, W) uint32
    weights: np.ndarray,      # (N, C) int32
    mesh,                     # torch DeviceMesh over the whole world
    *,
    data_axes: Tuple[str, ...] = ("data",),
    model_axis: Optional[str] = "model",
    use_kernel: bool = True,
    chunk_rows: Optional[int] = None,
    start_chunk: int = 0,
    init: Optional[np.ndarray] = None,
    on_chunk=None,
    device: DeviceLike = None,
) -> np.ndarray:              # (K, C) int32, the same on every rank
    """Exact counts on a mesh: N over the data axes, K over the model axis;
    every rank counts its shard and block on ``device`` (default the card).

    ``chunk_rows`` composes sharding-over-ranks with streaming-within-rank:
    the N axis is swept in host-side chunks (each chunk itself sharded over
    the data axes, with one all-reduce per chunk into host int64 totals), so
    per-rank residency is O(chunk_rows / data_size) whatever the total N.
    Counts are integer sums — the chunked sweep is bit-identical to the
    single pass.

    ``start_chunk`` / ``init`` / ``on_chunk`` follow the streaming resume
    discipline (``mining/stream.py``): ``on_chunk(j, acc)`` fires after
    chunk ``j`` with the running int32 accumulator, and a resumed sweep
    seeded with a checkpointed accumulator skips the chunks already
    counted — the driver's mid-level checkpoint hook, on a mesh.
    """
    k, w = tgt_bits.shape
    n, c = weights.shape
    # counts are bounded by the per-class weight-column sums; guard BEFORE any
    # device work or collective — the kernel and the reduce run in int32
    if n and np.any(np.asarray(weights).sum(axis=0, dtype=np.int64)
                    > np.iinfo(np.int32).max):
        raise OverflowError("per-class weight totals exceed int32; counts "
                            "could wrap — split the DB")
    dev = resolve_device(device)
    place = _place(mesh, tuple(data_axes), model_axis)
    k_pad = _round_up(max(k, 1), place.msize)
    tgt_p = np.zeros((k_pad, w), np.uint32)
    tgt_p[:k] = tgt_bits
    tgt_d = torch.from_numpy(tgt_p).to(dev)
    tx_bits = np.asarray(tx_bits, np.uint32)
    weights = np.asarray(weights, np.int32)

    if chunk_rows is not None and 0 < chunk_rows < n:
        from .plan import stream_chunks
        # every chunk's shard has the same padded height: one config
        nb = _round_up(chunk_rows, place.dsize) // place.dsize
        cfg = _resolve_shard_config(nb, k_pad // place.msize, w, c)
        total = (np.zeros((k, c), np.int64) if init is None
                 else np.asarray(init).astype(np.int64))
        chunks = stream_chunks(n, chunk_rows)
        for j in range(start_chunk, len(chunks)):
            s, e = chunks[j]
            lo = min(s + place.d * nb, e)
            hi = min(lo + nb, e)
            # host int64 accumulation of the small (K, C) block; the upfront
            # weight-sum guard bounds every count under int32, so the cast
            # cannot wrap
            total += _count_reduce(_rows(tx_bits, lo, hi, dev),
                                   _rows(weights, lo, hi, dev), tgt_d,
                                   place, k, k_pad, cfg, use_kernel)
            if on_chunk is not None:
                on_chunk(j, total.astype(np.int32))
        return total.astype(np.int32)

    base = (np.zeros((k, c), np.int32) if init is None
            else np.array(np.asarray(init), np.int32))
    if start_chunk >= 1 or k == 0:
        return base                        # single-chunk resume discipline
    nb = _round_up(max(n, 1), place.dsize) // place.dsize
    lo = min(place.d * nb, n)
    hi = min(lo + nb, n)
    cfg = _resolve_shard_config(nb, k_pad // place.msize, w, c)
    out = base + _count_reduce(_rows(tx_bits, lo, hi, dev),
                               _rows(weights, lo, hi, dev), tgt_d, place, k,
                               k_pad, cfg, use_kernel)
    if on_chunk is not None:
        on_chunk(0, out)
    return out


def place_rows(
    bits: np.ndarray,        # (N, W) uint32, host; the same on every rank
    weights: np.ndarray,     # (N, C) int32, host
    mesh,
    *,
    data_axes: Tuple[str, ...] = ("data",),
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's row shard of an encoded DB, placed ONCE on ``device`` for
    reuse by :func:`resident_distributed_counts`.

    The shard is the rank's block of N padded to the data-axis multiple
    (zero rows count nothing), so every rank holds the same height and no
    rank holds another's rows.  The serving hot path calls this once per
    store version and then answers every query against the resident
    placement — no per-query upload of the rows."""
    dev = resolve_device(device)
    place = _place(mesh, tuple(data_axes), None)
    n = int(bits.shape[0])
    nb = _round_up(max(n, 1), place.dsize) // place.dsize
    lo = min(place.d * nb, n)
    hi = min(lo + nb, n)
    bp = np.zeros((nb, bits.shape[1]), np.uint32)
    bp[:hi - lo] = bits[lo:hi]
    wp = np.zeros((nb, weights.shape[1]), np.int32)
    wp[:hi - lo] = weights[lo:hi]
    return torch.from_numpy(bp).to(dev), torch.from_numpy(wp).to(dev)


def resident_distributed_counts(
    tx_dev: torch.Tensor,     # (N_shard, W) uint32, placed by place_rows
    tgt_bits: np.ndarray,     # (K, W) uint32, host
    w_dev: torch.Tensor,      # (N_shard, C) int32, placed by place_rows
    mesh,
    *,
    data_axes: Tuple[str, ...] = ("data",),
    model_axis: Optional[str] = None,
    use_kernel: bool = True,
) -> np.ndarray:              # (K, C) int32
    """:func:`distributed_counts` for a RESIDENT row placement: every rank
    counts its local rows, one all-reduce sums the small (K, C) block.

    The rows and weights stay on the ranks' devices across calls (the
    serving analogue of the resident ``DenseDB``); only the target block is
    padded and uploaded per call.  The int32 overflow guard is the CALLER's
    contract — a serving store guards its per-class row totals on every
    append, before rows ever reach the placement."""
    k, w = tgt_bits.shape
    c = int(w_dev.shape[1])
    if k == 0:
        return np.zeros((0, c), np.int32)
    place = _place(mesh, tuple(data_axes), model_axis)
    k_pad = _round_up(k, place.msize)
    tgt_p = np.zeros((k_pad, w), np.uint32)
    tgt_p[:k] = tgt_bits
    cfg = _resolve_shard_config(int(tx_dev.shape[0]), k_pad // place.msize,
                                w, c)
    return _count_reduce(tx_dev, w_dev,
                         torch.from_numpy(tgt_p).to(tx_dev.device), place, k,
                         k_pad, cfg, use_kernel)


class _RankZeroWrites:
    """A checkpoint the driver may ``save`` on every rank: only rank 0
    writes (every rank would write the same ``path + ".tmp"``), and every
    rank reads.  No rank goes on past ``load_state`` before all have read,
    so rank 0 never overwrites the state another rank is about to load."""

    def __init__(self, checkpoint: MiningCheckpoint, device: torch.device):
        self.checkpoint = checkpoint
        self.device = device

    def save(self, *args, **kwargs) -> None:
        if dist.get_rank() == 0:
            self.checkpoint.save(*args, **kwargs)

    def load_state(self) -> Optional[dict]:
        state = self.checkpoint.load_state()
        dist.all_reduce(torch.zeros(1, dtype=torch.int32,
                                    device=_reduce_device(self.device)))
        return state


class DistributedMiner:
    """Level-synchronous exact frequent-itemset mining over a mesh, with
    optional per-level checkpointing (fault tolerance) and elastic resume.
    Every rank runs the same calls with the same host arrays.

    ``chunk_rows`` enables the streaming composition: every counting launch
    sweeps the N axis in host chunks, each chunk sharded over the data axes
    (sharding-over-ranks x streaming-within-rank).  ``device`` is where
    each rank counts (default the card)."""

    def __init__(self, mesh, *, data_axes: Tuple[str, ...] = ("data",),
                 model_axis: Optional[str] = "model", use_kernel: bool = True,
                 checkpoint: Optional[MiningCheckpoint] = None,
                 chunk_rows: Optional[int] = None,
                 device: DeviceLike = None):
        self.mesh = mesh
        self.data_axes = data_axes
        self.model_axis = model_axis
        self.use_kernel = use_kernel
        self.checkpoint = checkpoint
        self.chunk_rows = chunk_rows
        self.device = resolve_device(device)

    def counts(self, tx_bits, tgt_bits, weights, **resume) -> np.ndarray:
        """``distributed_counts`` with the miner's mesh, axes, chunking and
        device; ``resume`` passes ``start_chunk`` / ``init`` / ``on_chunk``."""
        return distributed_counts(
            tx_bits, tgt_bits, weights, self.mesh, data_axes=self.data_axes,
            model_axis=self.model_axis, use_kernel=self.use_kernel,
            chunk_rows=self.chunk_rows, device=self.device, **resume)

    def gfp_counts(
        self,
        tis,                       # repro_torch.core.TISTree
        tx_bits: np.ndarray,
        weights: np.ndarray,
        vocab: ItemVocab,
    ) -> Dict[Tuple[Item, ...], np.ndarray]:
        """The GFP-growth contract, distributed: counts for all TIS targets."""
        targets, keys, zeros = [], [], []
        for node in tis.targets():
            itemset = node.itemset()
            key = tuple(sorted(itemset, key=repr))
            if all(a in vocab for a in itemset):
                targets.append(itemset)
                keys.append(key)
            else:
                zeros.append(key)
        out = {k: np.zeros(weights.shape[1], np.int32) for k in zeros}
        if targets:
            masks = encode_targets(targets, vocab)
            rows = self.counts(tx_bits, masks, weights)
            for key, row in zip(keys, rows):
                out[key] = row
        return out

    def backend(self, tx_bits: np.ndarray, weights: np.ndarray,
                vocab: ItemVocab):
        """The miner's :class:`~repro_torch.mining.backend.DistributedBackend`
        over host arrays.  With ``chunk_rows`` active the backend exposes
        the N-axis sweep's chunk grid to the driver (one resumable chunk per
        host chunk), so a mesh mine checkpoints MID-level."""
        from .backend import DistributedBackend
        from .plan import stream_chunks

        n = int(tx_bits.shape[0])
        nbytes = int(tx_bits.nbytes + weights.nbytes)
        if self.chunk_rows is not None and 0 < self.chunk_rows < n:
            return DistributedBackend(
                lambda masks, **kw: self.counts(tx_bits, masks, weights,
                                                **kw),
                vocab, n, int(weights.shape[1]), nbytes=nbytes,
                n_chunks=len(stream_chunks(n, self.chunk_rows)),
                chunk_rows=self.chunk_rows)
        return DistributedBackend(
            lambda masks: self.counts(tx_bits, masks, weights),
            vocab, n, int(weights.shape[1]), nbytes=nbytes)

    def mine_frequent(
        self,
        tx_bits: np.ndarray,
        weights: np.ndarray,
        vocab: ItemVocab,
        min_count: float,
        *,
        class_column: Optional[int] = None,
        max_len: int = 0,
        on_chunk=None,
    ) -> Dict[Tuple[Item, ...], int]:
        """Shim over the unified driver (``mining/driver.py``): one mesh
        counting launch per level (singles included), per-level checkpoint
        saves by rank 0 — plus the driver's mid-level partial at N-chunk
        granularity when ``chunk_rows`` is active, so a restart (possibly on
        a DIFFERENT mesh shape: the signature is mesh-independent) skips any
        counted level AND any counted chunk of the in-flight level."""
        from .driver import mine_frequent as _driver_mine

        ckpt = (None if self.checkpoint is None
                else _RankZeroWrites(self.checkpoint, self.device))
        return _driver_mine(self.backend(tx_bits, weights, vocab), min_count,
                            class_column=class_column, max_len=max_len,
                            checkpoint=ckpt, on_chunk=on_chunk)
