"""Paper §5.1 — per-level Apriori candidate counting via a single GFP call.

"At each level, use the Apriori candidate-generation procedure and create a
tree representing the candidates.  Count the frequency of all the candidates by
applying a single invocation of the guided FP-growth procedure with the
candidate-representing TIS-tree as its guide."

This replaces the per-candidate (or per-itemset) targeted-mining invocations of
[5]/[6] with one guided pass per level, eliminating repeated overlapping walks
of the tree.  The FP-tree over the dataset is built once and reused each level.
"""
from __future__ import annotations

from typing import Dict, Hashable, Sequence, Set, Tuple, FrozenSet

from .apriori import apriori_gen
from .fptree import FPTree, ItemOrder
from .gfp import GFPStats, gfp_growth
from .tis import TISTree

Item = Hashable


def apriori_gfp(
    transactions: Sequence[Sequence[Item]],
    min_count: int,
) -> Tuple[Dict[Tuple[Item, ...], int], GFPStats]:
    """Level-wise frequent-itemset mining: Apriori generation + GFP counting.

    Returns ({sorted-tuple itemset -> count}, aggregated GFPStats).
    Exactly equivalent to FP-growth / Apriori output (tested).
    """
    counts: Dict[Item, int] = {}
    for t in transactions:
        for a in set(t):
            counts[a] = counts.get(a, 0) + 1
    order = ItemOrder.from_counts(counts, min_count=min_count)
    tree = FPTree.build(transactions, order)

    out: Dict[Tuple[Item, ...], int] = {}
    frequent: Set[FrozenSet] = set()
    for a in order.items_by_rank:
        out[(a,)] = counts[a]
        frequent.add(frozenset([a]))

    total_stats = GFPStats()
    k = 1
    while frequent:
        cands = apriori_gen(frequent, k)
        cands = [c for c in cands if all(a in order for a in c)]
        if not cands:
            break
        tis = TISTree(order)
        for c in cands:
            tis.insert(sorted(c, key=repr), target=True)
        stats = gfp_growth(tis, tree)  # ONE guided pass counts all candidates
        total_stats.merge(stats)
        frequent = set()
        for node in tis.targets():
            if node.g_count >= min_count:
                itemset = node.itemset()
                frequent.add(frozenset(itemset))
                out[tuple(sorted(itemset, key=repr))] = node.g_count
        k += 1
    return out, total_stats
