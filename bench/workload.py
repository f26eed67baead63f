"""The benchmark's one traffic generator: it reads a mix's parameters
(``bench/traffic/<mix>.json``) and makes, from ``--seed``, the jobs or
requests of a run.  Nothing here is tied to one mix: a new mix of a known
``kind`` is a new data file.

Open-loop arrivals keep the same set of gaps for every seed: the ``n``
quantiles of the exponential law at the mix's rate, scaled to fill the window
exactly, in an order drawn from the seed.  So every seed offers the same load
in a different order.
"""
from __future__ import annotations

from math import comb
from typing import Hashable, List, Sequence, Tuple

import numpy as np

Item = Hashable


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per use of the seed (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def arrivals(rate_per_s: float, seconds: float, rng: np.random.Generator
             ) -> np.ndarray:
    """Due times in [0, seconds) of ``round(rate * seconds)`` requests."""
    n = max(1, int(round(rate_per_s * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-q))
    gaps *= seconds / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def unrank_combinations(ranks: np.ndarray, n_items: int, size: int
                        ) -> np.ndarray:
    """(R,) ranks in [0, C(n_items, size)) -> (R, size) increasing item
    indices (the combinatorial number system)."""
    out = np.empty((len(ranks), size), np.int64)
    r = ranks.astype(np.int64).copy()
    for i in range(size, 0, -1):
        table = np.array([comb(c, i) for c in range(n_items + 1)], np.int64)
        c = np.searchsorted(table, r, side="right") - 1
        out[:, i - 1] = c
        r -= table[c]
    return out


def distinct_itemsets(items: Sequence[Item], sizes: Tuple[int, int],
                      count: int, rng: np.random.Generator
                      ) -> List[Tuple[Item, ...]]:
    """``count`` different itemsets drawn uniformly, without repetition,
    from all itemsets of ``sizes[0]`` to ``sizes[1]`` items."""
    m = len(items)
    per_size = [(s, comb(m, s)) for s in range(sizes[0], sizes[1] + 1)]
    total = sum(n for _, n in per_size)
    if count > total:
        raise ValueError(f"{count} distinct itemsets asked of {total}")
    ranks = np.sort(rng.choice(total, size=count, replace=False))
    order = rng.permutation(count)
    out: List[Tuple[Item, ...]] = [()] * count
    lo = 0
    for s, n in per_size:
        sel = (ranks >= lo) & (ranks < lo + n)
        combos = unrank_combinations(ranks[sel] - lo, m, s).tolist()
        for slot, c in zip(order[sel].tolist(), combos):
            out[slot] = tuple(items[j] for j in c)
        lo += n
    return out


def count_requests(mix: dict, items: Sequence[Item], seed: int,
                   seconds: float):
    """(warm-up requests, due times, timed requests) of an open-loop count
    mix.  Each request is a list of ``itemsets_per_request`` itemsets.

    ``popularity`` ``"distinct"``: every itemset of the run, warm-up
    included, differs from every other.  ``"zipf"``: itemsets drawn from a
    catalogue of ``catalogue`` distinct itemsets by a Zipf law of exponent
    ``zipf_s`` over a popularity order drawn from the seed."""
    per = mix["itemsets_per_request"]
    due = arrivals(mix["rate_per_s"], seconds, rng_for(seed, 1))
    n_warm = int(round(mix["rate_per_s"] * mix["warmup_seconds"]))
    n_keys = (n_warm + len(due)) * per
    sizes = tuple(mix["itemset_sizes"])
    rng = rng_for(seed, 2)
    if mix["popularity"] == "distinct":
        keys = distinct_itemsets(items, sizes, n_keys, rng)
    elif mix["popularity"] == "zipf":
        cat = distinct_itemsets(items, sizes, mix["catalogue"], rng)
        p = np.arange(1, len(cat) + 1, dtype=np.float64) ** -mix["zipf_s"]
        picks = rng.choice(len(cat), size=n_keys, p=p / p.sum()).tolist()
        keys = [cat[j] for j in picks]
    else:
        raise ValueError(f"unknown popularity {mix['popularity']!r}")
    reqs = [keys[i:i + per] for i in range(0, n_keys, per)]
    return reqs[:n_warm], due, reqs[n_warm:]
