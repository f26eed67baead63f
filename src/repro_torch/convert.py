"""Carry an encoded database from the JAX package into the port.

The JAX package's ``DenseDB`` state is its vocabulary items, its (U, W)
uint32 bitmap and its (U, C) int32 weights.  Handed over as plain Python and
numpy values (``vocab.items``, ``np.asarray(db.bits)``,
``np.asarray(db.weights)``), it becomes the port's ``DenseDB`` on ``device``
byte for byte, so both packages can count the same encoded rows.
"""
from __future__ import annotations

from typing import Hashable, Sequence

import numpy as np

from ._device import DeviceLike
from .mining.dense import DenseDB
from .mining.encode import ItemVocab


def dense_db_from_reference(vocab_items: Sequence[Hashable], bits: np.ndarray,
                            weights: np.ndarray, n_rows: int, n_classes: int,
                            *, device: DeviceLike = None) -> DenseDB:
    bits = np.asarray(bits)
    weights = np.asarray(weights)
    if bits.dtype != np.uint32 or weights.dtype != np.int32:
        raise TypeError(f"dense_db_from_reference: expected uint32 bits and "
                        f"int32 weights, got {bits.dtype} / {weights.dtype}")
    if bits.shape[0] != weights.shape[0] or weights.shape[1] != n_classes:
        raise ValueError(f"dense_db_from_reference: bits {bits.shape} and "
                         f"weights {weights.shape} do not match "
                         f"n_classes={n_classes}")
    return DenseDB.from_arrays(ItemVocab(tuple(vocab_items)), bits, weights,
                               n_rows, n_classes, device=device)
