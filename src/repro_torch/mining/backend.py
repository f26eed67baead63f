"""The ``CountBackend`` protocol — one counting seam under one mining loop.

The level-synchronous singles -> candidate-generation -> absorb loop lives
ONCE in ``mining/driver.py``; what varies per counting engine is captured
here:

  ``counts(masks, *, block_k=None, start_chunk=0, init=None, on_chunk=None)``
      Exact (K, C) per-class counts of a (K, W) uint32 target block.
      ``block_k`` is the kernel's K-block size where the engine launches the
      kernel over the caller's block (None resolves it through the tuning
      table, as every miner does).  The sweep is
      CHUNKED at whatever granularity the engine naturally has
      (``n_count_chunks``): the streaming engine sweeps N-chunks, the
      versioned store sweeps base chunks + a delta chunk, the dense and
      distributed engines are a single chunk.  ``on_chunk(j, acc)`` fires
      after chunk ``j`` with a host (numpy) copy of the running (K, C)
      accumulator — the driver's mid-level checkpoint hook.  ``start_chunk``/``init``
      resume a partially completed sweep; with ``start_chunk >=
      n_count_chunks`` the call returns ``init`` untouched (a fully-counted
      level resumes without recounting).

  ``chunk_signature() -> dict``
      JSON-able identity of the chunk geometry.  A checkpointed mid-level
      partial is only resumed when the saved signature matches — chunk
      indices never transfer between geometries (e.g. a changed
      ``chunk_rows`` restarts the level from chunk 0, still exact).

  ``mine_signature() -> dict``
      JSON-able identity of the counted DB *state*.  A mismatch discards the
      ENTIRE checkpoint (completed levels included): counts taken from a
      different logical DB are not valid progress.  The dense/streaming/
      distributed backends return ``{}`` (one checkpoint path per DB is the
      caller's contract, as before); the versioned store pins its
      ``version`` so a resume across an ``append`` restarts cleanly.

  ``item_counts() -> Optional[(V, C) array]``
      Optional level-1 shortcut: per-item per-class counts for every vocab
      item, outside the driver's ``mine.level`` spans (the dense engine
      counts the V single-item masks on the device in one ``counts`` call;
      the GFP hybrid sums host columns).  ``None`` means level 1 is counted
      through ``counts`` like any level.

  ``traits() -> Optional[DatasetTraits]``
      Measured dataset characteristics
      (:class:`~repro_torch.mining.chooser.DatasetTraits`: row count,
      footprint, density, item skew, dedup ratio) for the adaptive backend
      chooser, taken on host copies of the rows.  ``None`` means the engine
      cannot cheaply inspect its rows.

plus ``vocab`` / ``n_rows`` / ``n_classes`` / ``nbytes`` for introspection.

This module implements the protocol for the dense, streaming and
mesh-distributed engines; the GFP hybrid lives in ``mining/gfp_backend.py``,
the disk tier in ``mining/spill.py``, and ``mining/chooser.py`` picks among
them.  ``backend_of`` maps each DB form (dense, streaming, spilled) to the
one backend that counts it, and ``count_resident`` is the one launch over
rows already on the device: every count of a DB, the serving store's
included, reaches the kernel through them.
"""
from __future__ import annotations

from typing import Callable, Hashable, Optional

import numpy as np
import torch

from ..kernels.itemset_count import itemset_counts
from .encode import ItemVocab
from .stream import StreamingDB, _host, streaming_counts

Item = Hashable
ChunkHook = Optional[Callable[[int, np.ndarray], None]]


class CountBackend:
    """Base (and documentation) of the counting protocol above.

    Subclasses must set ``vocab``, ``n_rows``, ``n_classes`` and implement
    ``counts``/``nbytes``; the chunking defaults model a single-chunk engine.
    """

    vocab: ItemVocab
    n_rows: int
    n_classes: int

    @property
    def nbytes(self) -> int:
        raise NotImplementedError

    @property
    def n_count_chunks(self) -> int:
        return 1

    def chunk_signature(self) -> dict:
        raise NotImplementedError

    def mine_signature(self) -> dict:
        return {}

    def item_counts(self) -> Optional[np.ndarray]:
        return None

    def traits(self):
        """Measured dataset characteristics for the adaptive chooser, or
        ``None`` when the engine cannot cheaply inspect its rows."""
        return None

    def counts(self, masks: np.ndarray, *, block_k: Optional[int] = None,
               start_chunk: int = 0, init: Optional[np.ndarray] = None,
               on_chunk: ChunkHook = None) -> np.ndarray:
        raise NotImplementedError

    # single-chunk engines share this resume discipline
    def _single_chunk(self, count_fn, masks, start_chunk, init, on_chunk
                      ) -> np.ndarray:
        k = int(masks.shape[0])
        base = (np.zeros((k, self.n_classes), np.int32) if init is None
                else np.array(_host(init), np.int32))
        if start_chunk >= 1 or k == 0:
            return base              # already counted: resume skips the launch
        out = base + _host(count_fn(masks))
        if on_chunk is not None:
            on_chunk(0, out)
        return out


def count_resident(bits: torch.Tensor, weights: torch.Tensor,
                   masks: np.ndarray, *, use_kernel: bool = True,
                   block_k: Optional[int] = None) -> np.ndarray:
    """One launch over device-resident (bits, weights): the masks go up,
    the (K, C) int32 counts come back to the host."""
    tgt = torch.from_numpy(np.ascontiguousarray(masks, np.uint32))
    return itemset_counts(bits, tgt.to(bits.device), weights,
                          use_kernel=use_kernel, block_k=block_k).cpu().numpy()


def backend_of(db, *, use_kernel: bool = True) -> CountBackend:
    """The backend that counts a DB form where it lives: a ``DenseDB`` in
    one launch, a ``StreamingDB`` chunk by chunk from the host, a
    ``SpilledDB`` segment by segment from disk."""
    from .dense import DenseDB
    from .spill import SpilledBackend, SpilledDB
    if isinstance(db, SpilledDB):
        return SpilledBackend(db, use_kernel=use_kernel)
    if isinstance(db, StreamingDB):
        return StreamingBackend(db, use_kernel=use_kernel)
    if isinstance(db, DenseDB):
        return DenseBackend(db, use_kernel=use_kernel)
    raise TypeError(f"no counting backend for {type(db).__name__}")


class DenseBackend(CountBackend):
    """Device-resident single-launch counting over a :class:`DenseDB`."""

    def __init__(self, db, *, use_kernel: bool = True):
        self.db = db
        self.use_kernel = use_kernel
        self.vocab = db.vocab
        self.n_rows = db.n_rows
        self.n_classes = db.n_classes

    @property
    def nbytes(self) -> int:
        return int(self.db.bits.nbytes + self.db.weights.nbytes)

    def chunk_signature(self) -> dict:
        return {"backend": "dense", "n_rows": int(self.db.bits.shape[0])}

    def traits(self):
        from .chooser import DatasetTraits
        return DatasetTraits.of_db(self.db)

    def item_counts(self) -> np.ndarray:
        """Level-1 shortcut: the V single-item masks (row c is bit ``c & 31``
        of word ``c >> 5``) counted in one launch over the device-resident
        rows; the bitmap never leaves the device."""
        v = self.vocab.size
        c = np.arange(v)
        masks = np.zeros((v, int(self.db.bits.shape[1])), np.uint32)
        masks[c, c >> 5] = np.uint32(1) << (c & 31).astype(np.uint32)
        return self.counts(masks).astype(np.int64)

    def counts(self, masks, *, block_k=None, start_chunk=0, init=None,
               on_chunk=None):
        return self._single_chunk(
            lambda m: count_resident(self.db.bits, self.db.weights, m,
                                     use_kernel=self.use_kernel,
                                     block_k=block_k),
            masks, start_chunk, init, on_chunk)


class StreamingBackend(CountBackend):
    """Out-of-core chunked sweep over a :class:`StreamingDB` (host-resident);
    the only backend with sub-level chunk granularity on a single device."""

    def __init__(self, db: StreamingDB, *, use_kernel: bool = True,
                 accum: Optional[str] = None):
        # accum=None defers to the tuning-table resolution in the kernel seam
        self.db = db
        self.use_kernel = use_kernel
        self.accum = accum
        self.vocab = db.vocab
        self.n_rows = db.n_rows
        self.n_classes = db.n_classes

    @property
    def nbytes(self) -> int:
        return self.db.nbytes

    @property
    def n_count_chunks(self) -> int:
        return self.db.n_chunks

    def chunk_signature(self) -> dict:
        # exactly the keys the pre-driver streaming checkpoints wrote, so
        # existing on-disk partials stay resumable
        return {"chunk_rows": self.db.chunk_rows,
                "n_rows": int(self.db.bits.shape[0])}

    def traits(self):
        from .chooser import DatasetTraits
        return DatasetTraits.of_db(self.db)

    def counts(self, masks, *, block_k=None, start_chunk=0, init=None,
               on_chunk=None):
        rows = streaming_counts(
            self.db.bits, masks, self.db.weights,
            chunk_rows=self.db.chunk_rows, use_kernel=self.use_kernel,
            accum=self.accum, block_k=block_k, start_chunk=start_chunk,
            init=init, on_chunk=on_chunk, device=self.db.device)
        return _host(rows)


class DistributedBackend(CountBackend):
    """Mesh-sharded counting: wraps a sharded launch closure (see
    :class:`~repro_torch.mining.distributed.DistributedMiner`, which shards
    N over the data axes and K over the model axis, and sums the ranks'
    blocks with one all-reduce).

    With ``n_chunks == 1`` (the default) the closure is ``(masks) -> (K, C)``
    and the single-chunk resume discipline applies.  With ``chunk_rows``
    set, the closure must accept the resume keywords (``start_chunk`` /
    ``init`` / ``on_chunk`` — ``distributed_counts`` with its ``chunk_rows``
    sweep) and the backend exposes the sweep's chunk grid to the driver, so
    a mesh mine checkpoints mid-level.  The signature names no mesh shape,
    so a partial resumes on another mesh, and in the JAX package."""

    def __init__(self, count_fn: Callable[..., np.ndarray],
                 vocab: ItemVocab, n_rows: int, n_classes: int,
                 nbytes: int = 0, *, n_chunks: int = 1,
                 chunk_rows: Optional[int] = None):
        self._count_fn = count_fn
        self.vocab = vocab
        self.n_rows = n_rows
        self.n_classes = n_classes
        self._nbytes = nbytes
        self._n_chunks = int(n_chunks)
        self.chunk_rows = chunk_rows

    @property
    def nbytes(self) -> int:
        return self._nbytes

    @property
    def n_count_chunks(self) -> int:
        return self._n_chunks

    def chunk_signature(self) -> dict:
        sig = {"backend": "distributed", "n_rows": self.n_rows}
        if self._n_chunks > 1:
            # chunked geometry: mid-level partials only transfer between
            # identical chunk_rows sweeps
            sig["chunk_rows"] = self.chunk_rows
        return sig

    def counts(self, masks, *, start_chunk=0, init=None, on_chunk=None):
        if self._n_chunks == 1:
            return self._single_chunk(self._count_fn, masks, start_chunk,
                                      init, on_chunk)
        k = int(masks.shape[0])
        if k == 0:
            return (np.zeros((0, self.n_classes), np.int32) if init is None
                    else np.array(_host(init), np.int32))
        return _host(self._count_fn(masks, start_chunk=start_chunk,
                                    init=init, on_chunk=on_chunk))
