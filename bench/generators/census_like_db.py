"""A table of the shape of the paper's preprocessed UCI "Census Income"
(Adult) data, frozen for the benchmark.

Every row holds one item per column (``column=category``), 12 columns and 115
items in all, with Zipf(1.7)-skewed category popularity; in a positive row
each column moves to the next category with probability
``target_correlation``, so that rules exist.  This is the distribution of the
port's ``data.synth.census_like_db``, drawn in bulk rather than row by row,
and with the class sizes exact: the paper resamples the positive class to a
set share, so a table has ``round(p_y * n_rows)`` positive rows wherever the
seed puts them.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

# the paper's census preprocessing: 12 categorical columns, 115 items in all
CENSUS_COLUMNS: Tuple[Tuple[str, int], ...] = (
    ("age", 5), ("workclass", 7), ("fnlwgt", 10), ("education", 16),
    ("marital.status", 7), ("occupation", 14), ("relationship", 6),
    ("race", 5), ("sex", 2), ("hours.per.week", 6), ("native.country", 32),
    ("salary_proxy_bin", 5),
)


def census_like_db(n_rows: int, p_y: float, seed: int,
                   target_correlation: float = 0.35
                   ) -> Tuple[List[List[str]], np.ndarray]:
    """(transactions, classes): 12 ``column=category`` items per row and an
    (N,) int32 class vector with ``round(p_y * n_rows)`` ones."""
    rng = np.random.default_rng(seed)
    y = np.zeros(n_rows, np.int32)
    y[rng.choice(n_rows, int(round(p_y * n_rows)), replace=False)] = 1
    sizes = np.array([k for _, k in CENSUS_COLUMNS], np.int64)
    base = rng.zipf(1.7, size=(n_rows, len(sizes))) % sizes
    shift = (rng.random((n_rows, len(sizes))) < target_correlation) \
        & (y[:, None] == 1)
    cats = ((base + shift) % sizes).tolist()
    names = [[f"{col}={c}" for c in range(k)] for col, k in CENSUS_COLUMNS]
    return [[names[j][c] for j, c in enumerate(row)] for row in cats], y


def generate(cfg: dict, seed: int) -> Tuple[List[List[str]], np.ndarray]:
    return census_like_db(cfg["n_rows"], cfg["p_y"], seed,
                          cfg["target_correlation"])
