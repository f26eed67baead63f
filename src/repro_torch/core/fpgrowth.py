"""Classic FP-growth (Han et al.) — the paper's baseline and MRA sub-procedure.

``fp_growth`` enumerates all frequent itemsets of an FP-tree (min_count
threshold) in pattern-growth order.  The MRA variant (``fp_growth_into_tis``)
inserts every discovered itemset (with its count) into a TIS-tree, which the
paper assumes: "We assume an implementation of the FP-growth procedure which
inserts each discovered frequent-itemset, along with its frequency-count, into
TIS-tree" (§4.1).  Because itemsets are discovered in pattern-growth order, the
TIS insertion is an O(depth) attach, matching the paper's §4.1 discussion.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, Iterable, Optional, Sequence, Tuple

from .fptree import FPTree, ItemOrder
from .tis import TISTree

Item = Hashable
Collector = Callable[[Tuple[Item, ...], int], None]


def fp_growth(tree: FPTree, min_count: int, collector: Collector,
              suffix: Tuple[Item, ...] = ()) -> None:
    """Mine ``tree``; call ``collector(itemset_in_pg_order, count)`` per
    frequent itemset.  ``itemset`` tuples grow left-to-right in pattern-growth
    order: (a_i, a_j, ...) where a_i is less frequent than a_j.
    """
    for item in tree.items_ascending():
        count = tree.item_count(item)
        if count < min_count:
            continue
        found = suffix + (item,) if not suffix else suffix + (item,)
        # NOTE: pattern-growth order — new item appended after its prefix.
        collector(found, count)
        ctree = tree.conditional_tree(item, min_count=min_count)
        if not ctree.is_empty():
            fp_growth(ctree, min_count, collector, found)


def mine_frequent(
    transactions: Iterable[Sequence[Item]],
    min_count: int,
    order: Optional[ItemOrder] = None,
) -> Dict[Tuple[Item, ...], int]:
    """End-to-end classic FP-growth: two DB passes + mining.

    Returns {sorted-tuple itemset -> count}.
    """
    transactions = [list(t) for t in transactions]
    if order is None:
        counts: Dict[Item, int] = {}
        for t in transactions:
            for a in set(t):
                counts[a] = counts.get(a, 0) + 1
        order = ItemOrder.from_counts(counts, min_count=min_count)
    tree = FPTree.build(transactions, order)
    out: Dict[Tuple[Item, ...], int] = {}

    def collect(itemset: Tuple[Item, ...], count: int) -> None:
        out[tuple(sorted(itemset, key=repr))] = count

    fp_growth(tree, min_count, collect)
    return out


def fp_growth_into_tis(tree: FPTree, min_count: int, tis: TISTree) -> None:
    """FP-growth that records every frequent itemset into ``tis`` with its
    count (sets node.count; marks node as target).  Used by MRA step 3."""

    def collect(itemset: Tuple[Item, ...], count: int) -> None:
        node = tis.insert(itemset, target=True)
        node.count = count

    fp_growth(tree, min_count, collect)
