"""The paper's §4.3 simulation model, frozen for the benchmark.

Each of ``n_items`` items is in a transaction with probability ``p_x``, and
the class is 1 with probability ``p_y``, independently.  The draws are those
of the port's ``data.synth.bernoulli_db`` (one (N, M) uniform matrix, then N
uniforms for the class), so a seed gives the same table; only the building of
the row lists is vectorised.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def bernoulli_db(n_transactions: int, n_items: int, p_x: float, p_y: float,
                 seed: int) -> Tuple[List[List[int]], np.ndarray]:
    """(transactions, classes): item lists in increasing item order and an
    (N,) int32 class vector."""
    rng = np.random.default_rng(seed)
    mat = rng.random((n_transactions, n_items)) < p_x
    y = (rng.random(n_transactions) < p_y).astype(np.int32)
    rows, cols = np.nonzero(mat)
    ends = np.cumsum(np.bincount(rows, minlength=n_transactions)).tolist()
    flat = cols.tolist()
    starts = [0] + ends[:-1]
    return [flat[a:b] for a, b in zip(starts, ends)], y


def generate(cfg: dict, seed: int) -> Tuple[List[List[int]], np.ndarray]:
    return bernoulli_db(cfg["n_transactions"], cfg["n_items"], cfg["p_x"],
                        cfg["p_y"], seed)
