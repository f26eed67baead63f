"""Streaming out-of-core counting engine — N unbounded by device memory.

The dense engine (``dense.py``) requires the whole encoded bitmap resident in
one device allocation.  This module removes that limit the way "Mining
Frequent Itemsets from Secondary Memory" (Grahne & Zhu, 2004) does for
host-memory FP-trees:

  * ``StreamingDB`` keeps the (U, W) bitmap + (U, C) class weights HOST-side
    and serves them in N-chunks;
  * ``streaming_counts`` sweeps the chunks through the SAME counting kernel,
    adding each chunk's counts into one (K, C) int32 device accumulator in
    place (``itemset_counts_into``).  Counts are int32 sums, so the sweep is
    bit-identical to a single dense pass for every chunking;
  * ``streaming_mine_frequent`` is the level-synchronous miner on top — a
    shim over the unified driver (``mining/driver.py``) with the
    ``StreamingBackend``, whose per-chunk checkpointing (a
    ``MiningCheckpoint`` records completed levels, the current level's
    itemsets, next chunk, and the partial accumulator) lets a killed mine
    resume MID-LEVEL from the last completed chunk.

Overlap on the card: two pinned host staging buffers, two device buffers and
a side copy stream.  Chunk j+1 is filled on the host and its H2D copy
enqueued on the copy stream before chunk j's kernel runs; events make the
kernel wait for its own chunk's copy, keep a device buffer from being
overwritten before the kernel that reads it has finished, and keep a pinned
buffer from being refilled before its copy has finished.  The kernel masks
the ragged last chunk itself, so nothing is zero-padded.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..kernels.itemset_count import itemset_counts_into
from ..kernels.itemset_count.ref import check_inputs
from .encode import (FlatRows, ItemVocab, class_weights, dedup_rows,
                     encode_bitmap, project_columns)
from .plan import choose_chunk_rows, stream_chunks

Item = Hashable

# Auto-select streaming when the encoded DB exceeds this device footprint.
DEFAULT_STREAM_THRESHOLD_BYTES = 512 << 20


def _host(a) -> np.ndarray:
    """Writable C-contiguous numpy array of a host array or a (possibly
    device) tensor; copies only when it must."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.require(a, requirements=["C", "W"])


def _db_device(db) -> Optional[torch.device]:
    """The device a DB counts on: a StreamingDB's ``device``, a DenseDB's
    tensors'; None (the card, by default) for host arrays."""
    dev = getattr(db, "device", None)
    if dev is None and isinstance(getattr(db, "bits", None), torch.Tensor):
        dev = db.bits.device
    return dev


def streaming_counts(
    tx_bits,                      # (N, W) uint32 (host array or tensor)
    tgt_bits,                     # (K, W) uint32
    weights,                      # (N, C) int32 (or (N,) -> C=1)
    *,
    chunk_rows: Optional[int] = None,
    use_kernel: bool = True,
    accum: Optional[str] = None,
    block_k: Optional[int] = None,
    block_n: Optional[int] = None,
    init: Optional[np.ndarray] = None,     # (K, C) resume accumulator
    start_chunk: int = 0,
    on_chunk: Optional[Callable[[int, np.ndarray], None]] = None,
    device: DeviceLike = None,
) -> torch.Tensor:                # (K, C) int32 on ``device``
    """Chunked sweep of the counting kernel; bit-identical to one dense pass.

    ``init``/``start_chunk`` resume a partially completed sweep; ``on_chunk``
    is called after each chunk with (chunk_idx, host copy of the
    accumulator) — the checkpoint hook (the copy waits for the chunk's
    kernel, so only pass it when you need durability).  The device
    accumulator itself is updated in place by the next chunk, which is why
    the hook gets a copy."""
    dev = resolve_device(device)
    tx = _host(tx_bits)
    w = _host(weights)
    if w.ndim == 1:
        w = w[:, None]
    tgt = _host(tgt_bits)
    n = tx.shape[0]
    k, c = tgt.shape[0], w.shape[1]
    if k == 0:
        return torch.zeros((0, c), dtype=torch.int32, device=dev)
    # the staging copies below would cast silently: check the dtypes first
    check_inputs(torch.from_numpy(tx), torch.from_numpy(tgt),
                 torch.from_numpy(w), "streaming_counts")
    # int32 accumulator guard: the largest possible count is the per-class
    # weight-column sum; "unbounded N" holds only while that fits int32
    if n and np.any(w.sum(axis=0, dtype=np.int64) > np.iinfo(np.int32).max):
        raise OverflowError(
            "per-class weight totals exceed int32; streamed counts could "
            "wrap — split the DB or widen the accumulator")
    if chunk_rows is None:
        chunk_rows = choose_chunk_rows(tx.shape[1], c, n_rows=n)
    chunks = stream_chunks(n, chunk_rows)
    acc = (torch.zeros((k, c), dtype=torch.int32, device=dev) if init is None
           else torch.from_numpy(np.array(init, np.int32)).to(dev))
    if n == 0 or start_chunk >= len(chunks):
        return acc
    tgt_d = torch.from_numpy(tgt).to(dev)
    w = np.ascontiguousarray(w, np.int32)
    kw = dict(block_k=block_k, block_n=block_n, use_kernel=use_kernel,
              accum=accum)

    def _emit(j: int) -> None:
        if on_chunk is not None:
            on_chunk(j, acc.cpu().numpy().copy())

    if dev.type != "cuda":
        for j in range(start_chunk, len(chunks)):
            s, e = chunks[j]
            itemset_counts_into(acc, torch.from_numpy(tx[s:e]), tgt_d,
                                torch.from_numpy(w[s:e]), **kw)
            _emit(j)
        return acc

    rows = max(e - s for s, e in chunks)
    with torch.cuda.device(dev):
        compute = torch.cuda.current_stream(dev)
        copy = torch.cuda.Stream(dev)
        host_tx = [torch.empty((rows, tx.shape[1]), dtype=torch.uint32,
                               pin_memory=True) for _ in range(2)]
        host_w = [torch.empty((rows, c), dtype=torch.int32, pin_memory=True)
                  for _ in range(2)]
        dev_tx = [torch.empty((rows, tx.shape[1]), dtype=torch.uint32,
                              device=dev) for _ in range(2)]
        dev_w = [torch.empty((rows, c), dtype=torch.int32, device=dev)
                 for _ in range(2)]
        copied = [torch.cuda.Event() for _ in range(2)]
        consumed = [torch.cuda.Event() for _ in range(2)]

        def _stage(j: int) -> None:
            b = j % 2
            s, e = chunks[j]
            copied[b].synchronize()      # pinned buffer b's last copy is done
            host_tx[b][:e - s].numpy()[...] = tx[s:e]
            host_w[b][:e - s].numpy()[...] = w[s:e]
            with torch.cuda.stream(copy):
                copy.wait_event(consumed[b])   # kernel reading dev buffer b
                dev_tx[b][:e - s].copy_(host_tx[b][:e - s], non_blocking=True)
                dev_w[b][:e - s].copy_(host_w[b][:e - s], non_blocking=True)
                copied[b].record(copy)

        _stage(start_chunk)
        for j in range(start_chunk, len(chunks)):
            if j + 1 < len(chunks):
                _stage(j + 1)
            b = j % 2
            s, e = chunks[j]
            compute.wait_event(copied[b])
            itemset_counts_into(acc, dev_tx[b][:e - s], tgt_d,
                                dev_w[b][:e - s], **kw)
            consumed[b].record(compute)
            _emit(j)
        # the staging buffers go back to the allocator: wait for the copies
        compute.synchronize()
    return acc


@dataclass
class StreamingDB:
    """Encoded, deduped, class-weighted transaction DB in host-side chunks.

    Mirrors ``DenseDB`` (same encode discipline: support-descending vocab,
    row dedup with per-class weights) but ``bits``/``weights`` stay numpy on
    host and all counting goes through ``streaming_counts`` on ``device``.
    """
    vocab: ItemVocab
    bits: np.ndarray       # (U, W) uint32 unique rows (host)
    weights: np.ndarray    # (U, C) int32 per-class multiplicities (host)
    n_rows: int            # original N (sum of weights)
    n_classes: int
    chunk_rows: int
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))

    @property
    def n_chunks(self) -> int:
        return len(stream_chunks(self.bits.shape[0], self.chunk_rows))

    @property
    def nbytes(self) -> int:
        return int(self.bits.nbytes + self.weights.nbytes)

    @staticmethod
    def encode(
        transactions: Union[Sequence[Sequence[Item]], FlatRows],
        classes: Optional[Sequence[int]] = None,
        n_classes: Optional[int] = None,
        vocab: Optional[ItemVocab] = None,
        min_item_count: int = 1,
        chunk_rows: Optional[int] = None,
        *,
        device: DeviceLike = None,
    ) -> "StreamingDB":
        """``transactions`` may be rows already walked (``FlatRows``), when
        ``vocab`` is given."""
        dev = resolve_device(device)
        if vocab is None:
            vocab = ItemVocab.from_transactions(transactions,
                                                min_count=min_item_count)
        bits = encode_bitmap(transactions, vocab)
        if classes is None:
            w = np.ones((len(transactions), 1), np.int32)
            n_classes = 1
        else:
            n_classes = n_classes or (int(max(classes)) + 1)
            w = class_weights(classes, n_classes)
        ub, uw = dedup_rows(bits, w)
        if chunk_rows is None:
            chunk_rows = choose_chunk_rows(vocab.n_words, n_classes,
                                           n_rows=ub.shape[0])
        return StreamingDB(vocab=vocab, bits=ub, weights=uw,
                           n_rows=len(transactions), n_classes=n_classes,
                           chunk_rows=chunk_rows, device=dev)

    @staticmethod
    def from_dense(db, chunk_rows: Optional[int] = None) -> "StreamingDB":
        """Host view of a ``DenseDB`` (duck-typed to avoid a module cycle);
        counts on the DenseDB's device."""
        bits = _host(db.bits)
        weights = _host(db.weights)
        if chunk_rows is None:
            chunk_rows = choose_chunk_rows(bits.shape[1], weights.shape[1],
                                           n_rows=bits.shape[0])
        return StreamingDB(vocab=db.vocab, bits=bits, weights=weights,
                           n_rows=db.n_rows, n_classes=db.n_classes,
                           chunk_rows=chunk_rows, device=db.bits.device)

    @staticmethod
    def from_arrays(vocab: ItemVocab, bits: np.ndarray, weights: np.ndarray,
                    n_rows: int, n_classes: int,
                    chunk_rows: Optional[int] = None, *,
                    device: DeviceLike = None) -> "StreamingDB":
        """Wrap already-encoded/deduped host arrays."""
        bits, weights = _host(bits), _host(weights)
        if chunk_rows is None:
            chunk_rows = choose_chunk_rows(bits.shape[1], weights.shape[1],
                                           n_rows=bits.shape[0])
        return StreamingDB(vocab=vocab, bits=bits, weights=weights,
                           n_rows=n_rows, n_classes=n_classes,
                           chunk_rows=chunk_rows,
                           device=resolve_device(device))

    def project(self, keep_items: Sequence[Item]) -> "StreamingDB":
        """Column projection + re-dedup (GFP data reduction, host-side)."""
        proj, sub = project_columns(self.bits, self.vocab, keep_items)
        ub, uw = dedup_rows(proj, self.weights)
        return replace(self, vocab=sub, bits=ub, weights=uw)

    def counts(self, tgt_bits, **kwargs) -> torch.Tensor:
        kwargs.setdefault("chunk_rows", self.chunk_rows)
        kwargs.setdefault("device", self.device)
        return streaming_counts(self.bits, tgt_bits, self.weights, **kwargs)


# ---------------------------------------------------------------------------
# Level-synchronous mining over a StreamingDB with mid-level checkpointing.
# ---------------------------------------------------------------------------

def streaming_mine_frequent(
    db: StreamingDB,
    min_count: float,
    *,
    class_column: Optional[int] = None,
    max_len: int = 0,
    use_kernel: bool = True,
    accum: Optional[str] = None,
    checkpoint=None,                 # Optional[MiningCheckpoint]
    on_chunk: Optional[Callable[[int, int], None]] = None,
) -> Dict[Tuple[Item, ...], int]:
    """Exact level-synchronous mining, out-of-core, resumable mid-level.

    A shim over the unified driver (``mining/driver.py``) with the
    out-of-core :class:`~repro_torch.mining.backend.StreamingBackend`.  Same
    contract as ``dense_mine_frequent`` (identical result dict).  With a
    ``checkpoint``, progress is durable per chunk: a restart re-loads the
    completed levels, regenerates the interrupted level's candidate list
    (deterministic), and resumes its sweep from the last completed chunk.
    ``on_chunk(level, chunk_idx)`` is a test/progress hook.
    """
    # function-level import: backend.py consumes this module's sweep
    from .backend import StreamingBackend
    from .driver import mine_frequent as _driver_mine

    return _driver_mine(
        StreamingBackend(db, use_kernel=use_kernel, accum=accum), min_count,
        class_column=class_column, max_len=max_len, checkpoint=checkpoint,
        on_chunk=on_chunk)
