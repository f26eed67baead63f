"""The Minority-Report rule list, worked out plainly: the benchmark's
reference for the mine cells.

From the transactions and classes alone: keep the items frequent in the
rare class (support at least ``min_support * N``), mine the itemsets over
them that are frequent in the rare class (count at least
``ceil(min_support * N)``) level by level (a k+1 candidate joins two
frequent k-sets that share their first k-1 items and has every k-subset
frequent), count every such antecedent in both classes, and keep those whose
confidence ``c1 / (c1 + c0)`` reaches ``min_confidence``.

It also records the counting passes that these inputs need (``Pass``), from
which the frozen roofline count (``bench/metrics/_roofline.py``) takes the
least time of a job: each level's candidates over the distinct rows that hold
a rare-class row, and the antecedents over every distinct row.

``multiplicity=False`` is the control: it breaks the exactness that the
configuration states by counting every distinct (row, class) once, as a
counter that dropped the rows' multiplicities would.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Hashable, List, Sequence, Tuple

import numpy as np

from .table import PackedTable, distinct_rows, item_matrix, pack_rows

Item = Hashable
Antecedent = FrozenSet[Item]


@dataclass(frozen=True)
class Pass:
    """One counting pass the inputs need: ``k`` targets of the given sizes
    over ``rows`` distinct rows of ``w`` 32-bit words and ``c`` classes."""
    rows: int
    k: int
    w: int
    c: int
    target_sizes: Tuple[int, ...]


@dataclass
class RuleList:
    # antecedent -> (c1, c0, support, confidence)
    rules: Dict[Antecedent, Tuple[int, int, float, float]]
    n_antecedents: int
    passes: List[Pass] = field(default_factory=list)


def _next_level(frequent: List[Tuple[int, ...]]) -> List[Tuple[int, ...]]:
    """Apriori candidates of size k+1 from the sorted frequent k-sets."""
    have = set(frequent)
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for s in frequent:
        groups.setdefault(s[:-1], []).append(s[-1])
    out = []
    for prefix, lasts in groups.items():
        lasts.sort()
        for i, a in enumerate(lasts):
            for b in lasts[i + 1:]:
                cand = prefix + (a, b)
                if all(cand[:j] + cand[j + 1:] in have
                       for j in range(len(cand) - 2)):
                    out.append(cand)
    out.sort()
    return out


def minority_report(transactions: Sequence[Sequence[Item]],
                    classes: Sequence[int], *, min_support: float,
                    min_confidence: float, target_class: int = 1,
                    multiplicity: bool = True) -> RuleList:
    mat, items = item_matrix(transactions)
    rare = np.asarray(classes) == target_class
    n = len(transactions)
    if not multiplicity:
        key = np.concatenate([pack_rows(mat), rare[:, None]], axis=1)
        _, first = np.unique(key, axis=0, return_index=True)
        mat, rare = mat[np.sort(first)], rare[np.sort(first)]

    c1_items = mat[rare].sum(axis=0)
    kept = [j for j in range(len(items)) if c1_items[j] >= min_support * n]
    min_count = max(1, math.ceil(min_support * n - 1e-9))
    sub = mat[:, kept]
    names = [items[j] for j in kept]
    w = max(1, -(-len(kept) // 32))
    rare_table = PackedTable(sub[rare], np.zeros(int(rare.sum()), np.int64),
                             1, names)
    rare_rows = distinct_rows(sub[rare])

    found: Dict[Tuple[int, ...], int] = {
        (j,): int(c1_items[kept[j]]) for j in range(len(kept))
        if c1_items[kept[j]] >= min_count}
    passes: List[Pass] = []
    level = sorted(found)
    while level:
        cands = _next_level(level)
        if not cands:
            break
        c1 = rare_table.count_index(np.array(cands, np.int64), [0])[:, 0]
        passes.append(Pass(rare_rows, len(cands), w, 1,
                           (len(cands[0]),) * len(cands)))
        level = [s for s, c in zip(cands, c1.tolist()) if c >= min_count]
        found.update((s, c) for s, c in zip(cands, c1.tolist())
                     if c >= min_count)

    table = PackedTable(sub, rare.astype(np.int64), 2, names)
    rules: Dict[Antecedent, Tuple[int, int, float, float]] = {}
    by_size: Dict[int, List[Tuple[int, ...]]] = {}
    for s in found:
        by_size.setdefault(len(s), []).append(s)
    for size, sets in sorted(by_size.items()):
        counts = table.count_index(np.array(sets, np.int64), [1, 0])
        for s, (c1, c0) in zip(sets, counts.tolist()):
            conf = c1 / (c1 + c0) if c1 + c0 else 0.0
            if conf >= min_confidence:
                rules[frozenset(names[j] for j in s)] = (c1, c0, c1 / n, conf)
    if found:
        passes.append(Pass(distinct_rows(sub), len(found), w, 2,
                           tuple(len(s) for s in found)))
    return RuleList(rules, len(found), passes)
