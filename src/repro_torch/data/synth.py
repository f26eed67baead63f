"""Synthetic data generators.

``bernoulli_db``   — the paper's §4.3 simulation model: each item is Bernoulli
(p_X) per transaction; the class label is Bernoulli(p_Y).
``census_like_db`` — a categorical dataset matching the paper's preprocessed
UCI 'Census income' schema (12 columns, 115 distinct items, imbalanced target
via p_Y resampling).  The real UCI file isn't downloadable offline; the
generator reproduces the *shape* of the experiment (items-per-row = #columns,
several categories per column, correlated target) so the Fig-6 benchmark
exercises the same workload pattern.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

# the paper's census preprocessing: 12 categorical columns, 115 items total
CENSUS_COLUMNS: Tuple[Tuple[str, int], ...] = (
    ("age", 5), ("workclass", 7), ("fnlwgt", 10), ("education", 16),
    ("marital.status", 7), ("occupation", 14), ("relationship", 6),
    ("race", 5), ("sex", 2), ("hours.per.week", 6), ("native.country", 32),
    ("salary_proxy_bin", 5),
)
assert sum(k for _, k in CENSUS_COLUMNS) == 115


def bernoulli_db(n_transactions: int, n_items: int, p_x: float, p_y: float,
                 seed: int = 0) -> Tuple[List[List[int]], np.ndarray]:
    """Paper §4.3 simulation: returns (transactions, classes)."""
    rng = np.random.default_rng(seed)
    mat = rng.random((n_transactions, n_items)) < p_x
    y = (rng.random(n_transactions) < p_y).astype(np.int32)
    tx = [np.flatnonzero(row).tolist() for row in mat]
    return tx, y


def census_like_db(n_rows: int, p_y: float, seed: int = 0,
                   target_correlation: float = 0.35
                   ) -> Tuple[List[List[str]], np.ndarray]:
    """Imbalanced categorical rows: every row has one item per column (the
    paper's transaction encoding of a table); the target class tilts a subset
    of columns' category distributions so that real rules exist."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n_rows) < p_y).astype(np.int32)
    rows: List[List[str]] = []
    for i in range(n_rows):
        row = []
        for col, k in CENSUS_COLUMNS:
            base = rng.zipf(1.7) % k  # skewed category popularity
            if y[i] and rng.random() < target_correlation:
                cat = (base + 1) % k  # class-correlated shift => minable rules
            else:
                cat = base
            row.append(f"{col}={cat}")
        rows.append(row)
    return rows, y


def token_stream(n_tokens: int, vocab_size: int, seed: int = 0,
                 zipf_a: float = 1.3) -> np.ndarray:
    """Zipfian token ids (LM training data)."""
    rng = np.random.default_rng(seed)
    toks = rng.zipf(zipf_a, size=n_tokens) - 1
    return (toks % vocab_size).astype(np.int32)
