"""The ``CountBackend`` protocol — one counting seam under one mining loop.

The level-synchronous singles -> candidate-generation -> absorb loop lives
ONCE in ``mining/driver.py``; what varies per counting engine is captured
here:

  ``counts(masks, *, start_chunk=0, init=None, on_chunk=None) -> (K, C)``
      Exact per-class counts of a (K, W) uint32 target block.  The sweep is
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
      item without a kernel launch (the dense engine's host column sums).
      ``None`` means level 1 is counted through ``counts`` like any level.

  ``traits() -> Optional[DatasetTraits]``
      Measured dataset characteristics
      (:class:`~repro_torch.mining.chooser.DatasetTraits`: row count,
      footprint, density, item skew, dedup ratio) for the adaptive backend
      chooser, taken on host copies of the rows.  ``None`` means the engine
      cannot cheaply inspect its rows.

plus ``vocab`` / ``n_rows`` / ``n_classes`` / ``nbytes`` for introspection.

This module implements the protocol for the dense and streaming engines;
the GFP hybrid lives in ``mining/gfp_backend.py`` and ``mining/chooser.py``
picks among the three.  The mesh-distributed backend arrives with the
distributed runtime.
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

    def counts(self, masks: np.ndarray, *, start_chunk: int = 0,
               init: Optional[np.ndarray] = None,
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
        """Level-1 shortcut: per-item counts from host column sums (exact,
        no kernel launch — the same integers the kernel would produce)."""
        bits = _host(self.db.bits)
        w = _host(self.db.weights)
        rows = np.zeros((self.vocab.size, self.n_classes), np.int64)
        for c in range(self.vocab.size):
            bit = (bits[:, c >> 5] >> np.uint32(c & 31)) & 1
            rows[c] = (bit[:, None] * w).sum(axis=0)
        return rows

    def counts(self, masks, *, start_chunk=0, init=None, on_chunk=None):
        return self._single_chunk(
            lambda m: itemset_counts(
                self.db.bits,
                torch.from_numpy(np.ascontiguousarray(m, np.uint32)).to(
                    self.db.bits.device),
                self.db.weights, use_kernel=self.use_kernel),
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

    def counts(self, masks, *, start_chunk=0, init=None, on_chunk=None):
        rows = streaming_counts(
            self.db.bits, masks, self.db.weights,
            chunk_rows=self.db.chunk_rows, use_kernel=self.use_kernel,
            accum=self.accum, start_chunk=start_chunk, init=init,
            on_chunk=on_chunk, device=self.db.device)
        return _host(rows)
