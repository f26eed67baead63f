"""GFP-growth — the paper's Algorithm 3.1, with all six §3.1 optimizations.

    GFP-GROWTH(TIS-tree, FP-tree):
      for each item a_i in TIS-tree (direct children of the TIS root):
        if (a_i in FP-tree):                       # O(1) header consult   (#2)
          if (TIS-tree(a_i).target):               # skip non-targets      (#6)
            TIS-tree(a_i).g-count = a_i.count in FP-tree
          if (TIS-tree(a_i) has children):         # leaf => no recursion  (#3)
            construct a_i's conditional FP-tree c-Tree   # item_filter     (#4)
            if c-Tree != empty:
              call GFP-growth(TIS-tree(a_i), c-Tree)

Results are written into TIS-tree node counters in place (#5).  The procedure
applies no min-support constraint (per paper §3.2 — required for the MRA and
other use-cases); `min_count` may still be passed for constrained use-cases,
affecting conditional-tree pruning exactly as in [10].

Instrumentation counters are kept on the side so benchmarks can report how much
of the FP-tree the guided walk actually touched (conditional trees built,
header consults, link-list traversals) versus classic FP-growth.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Hashable, Optional

from .fptree import FPTree
from .tis import TISNode, TISTree

Item = Hashable


@dataclass
class GFPStats:
    header_consults: int = 0
    count_computations: int = 0
    conditional_trees: int = 0
    recursive_calls: int = 0
    nodes_visited: int = 0

    def merge(self, other: "GFPStats") -> None:
        self.header_consults += other.header_consults
        self.count_computations += other.count_computations
        self.conditional_trees += other.conditional_trees
        self.recursive_calls += other.recursive_calls
        self.nodes_visited += other.nodes_visited


def gfp_growth(
    tis: TISTree,
    fp: FPTree,
    *,
    use_data_reduction: bool = True,
    min_count: int = 0,
    stats: Optional[GFPStats] = None,
) -> GFPStats:
    """Run GFP-growth; fills ``g_count`` on every reachable TIS node.

    ``use_data_reduction=False`` disables optimization #4 (conditional trees
    keep all items) — used by benchmarks to quantify the optimization, and to
    mirror the paper's own "partial GFP-growth implementation" note in §4.3.
    """
    if stats is None:
        stats = GFPStats()
    tis.finalize()  # compute subtree_items for data reduction
    _gfp(tis.root, fp, use_data_reduction, min_count, stats)
    return stats


def _gfp(tnode: TISNode, fp: FPTree, reduce_items: bool, min_count: int,
         stats: GFPStats) -> None:
    for item, child in tnode.children.items():
        stats.nodes_visited += 1
        stats.header_consults += 1
        if item not in fp:                                   # (#2) O(1)
            continue
        if child.target:                                     # (#6)
            stats.count_computations += 1
            child.g_count = fp.item_count(item)
        if child.has_children():                             # (#3)
            item_filter = child.subtree_items if reduce_items else None
            ctree = fp.conditional_tree(item, min_count=min_count,
                                        item_filter=item_filter)  # (#4)
            stats.conditional_trees += 1
            if not ctree.is_empty():
                stats.recursive_calls += 1
                _gfp(child, ctree, reduce_items, min_count, stats)
