"""Apriori baseline (Agrawal & Srikant 1994) + brute-force counting oracle.

The paper positions FP-growth/GFP-growth against Apriori-like candidate
generation; we ship Apriori both as a benchmark baseline and as the candidate
generator for the §5.1 extension (per-level GFP counting).
"""
from __future__ import annotations

from itertools import combinations
from typing import Dict, FrozenSet, Hashable, Iterable, List, Sequence, Set, Tuple

Item = Hashable


def brute_force_counts(
    transactions: Sequence[Sequence[Item]],
    itemsets: Iterable[Sequence[Item]],
    weights: Sequence[int] = None,
) -> Dict[Tuple[Item, ...], int]:
    """Oracle: exact count of each itemset by direct subset tests."""
    tsets = [frozenset(t) for t in transactions]
    if weights is None:
        weights = [1] * len(tsets)
    out: Dict[Tuple[Item, ...], int] = {}
    for its in itemsets:
        key = tuple(sorted(set(its), key=repr))
        s = frozenset(its)
        out[key] = sum(w for t, w in zip(tsets, weights) if s <= t)
    return out


def apriori_gen(frequent_k: Set[FrozenSet], k: int) -> List[FrozenSet]:
    """Candidate generation with prefix join + anti-monotone prune."""
    cands: Set[FrozenSet] = set()
    freq = sorted(frequent_k, key=lambda s: tuple(sorted(map(repr, s))))
    for i, a in enumerate(freq):
        for b in freq[i + 1:]:
            u = a | b
            if len(u) == k + 1:
                if all(frozenset(c) in frequent_k for c in combinations(u, k)):
                    cands.add(u)
    return sorted(cands, key=lambda s: tuple(sorted(map(repr, s))))


def apriori(
    transactions: Sequence[Sequence[Item]],
    min_count: int,
) -> Dict[Tuple[Item, ...], int]:
    """Classic Apriori.  Returns {sorted-tuple itemset -> count}."""
    tsets = [frozenset(t) for t in transactions]
    counts: Dict[Item, int] = {}
    for t in tsets:
        for a in t:
            counts[a] = counts.get(a, 0) + 1
    out: Dict[Tuple[Item, ...], int] = {}
    frequent: Set[FrozenSet] = set()
    for a, c in counts.items():
        if c >= min_count:
            frequent.add(frozenset([a]))
            out[(a,)] = c
    k = 1
    while frequent:
        cands = apriori_gen(frequent, k)
        if not cands:
            break
        ccount = {c: 0 for c in cands}
        for t in tsets:
            for c in cands:
                if c <= t:
                    ccount[c] += 1
        frequent = set()
        for c, n in ccount.items():
            if n >= min_count:
                frequent.add(c)
                out[tuple(sorted(c, key=repr))] = n
        k += 1
    return out
