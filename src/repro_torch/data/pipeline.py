"""Sharded, deterministic, restartable data pipeline for LM training (the
JAX package's ``data/pipeline.py``, numpy only: the same batches, byte for
byte, for the same ``(seed, step)``).

Determinism + elasticity: batch content is a pure function of (seed, step,
global batch size), not of topology.  A job restarted on another number of
ranks re-derives exactly the remaining stream from the checkpointed step
counter, so no sample is lost or repeated.

Each rank materializes only its slice (``host_slice``): the rank and world
size of ``torch.distributed`` when a group is initialised, else 0 and 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from .._device import process_index_and_count


@dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The full logical batch for ``step`` (pure function)."""
        rng = np.random.default_rng((self.seed, step))
        toks = rng.zipf(self.zipf_a,
                        size=(self.global_batch, self.seq_len + 1)) - 1
        toks = (toks % self.vocab_size).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def host_slice(self, step: int, process_index: Optional[int] = None,
                   process_count: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        rank, world = process_index_and_count()
        pi = rank if process_index is None else process_index
        pc = world if process_count is None else process_count
        if self.global_batch % pc != 0:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {pc} ranks")
        per = self.global_batch // pc
        batch = self.batch_at(step)
        return {k: v[pi * per:(pi + 1) * per] for k, v in batch.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.host_slice(step)
            step += 1


@dataclass
class TransactionPipeline:
    """Sharded transaction-bitmap stream for the distributed mining engine:
    block ``i`` of the database is a pure function of (seed, i), so mining
    restarts (see ``MiningCheckpoint``) re-derive identical blocks."""
    n_items: int
    p_x: float
    p_y: float
    block_rows: int
    seed: int = 0

    def block(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        from ..mining.encode import ItemVocab, class_weights, encode_bitmap
        rng = np.random.default_rng((self.seed, index))
        mat = rng.random((self.block_rows, self.n_items)) < self.p_x
        y = (rng.random(self.block_rows) < self.p_y).astype(np.int32)
        vocab = ItemVocab(tuple(range(self.n_items)))
        tx = [np.flatnonzero(r).tolist() for r in mat]
        return encode_bitmap(tx, vocab), class_weights(y, 2)
