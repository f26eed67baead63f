"""Paper-faithful FP-tree (Han et al. 2000/2004), as used by FP-growth and GFP-growth.

This is the host-side reference implementation: pointer/dict-based nodes with a
header table of per-item linked lists, exactly as described in [10] of the
paper.  The GPU engine (repro_torch.mining) is derived from this reference and
is cross-validated against it in tests.

Item identity is an arbitrary hashable (int or str).  Item *order* is explicit:
an ``ItemOrder`` maps item -> rank, rank 0 being the item that sits closest to
the root (support-descending order in classic FP-growth).  The Minority-Report
algorithm requires the same order for both of its trees (paper §4.1), so the
order is a first-class object here rather than something recomputed per tree.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Hashable, Iterable, Iterator, List, Optional, Sequence, Tuple

Item = Hashable
Transaction = Sequence[Item]


class ItemOrder:
    """Explicit item ordering: rank 0 = first when inserting paths (root side).

    Classic FP-growth uses support-descending order so that frequent items share
    prefixes near the root.  ``rank`` is a dense dict item -> int.
    """

    def __init__(self, items_by_rank: Sequence[Item]):
        self.items_by_rank: List[Item] = list(items_by_rank)
        self.rank: Dict[Item, int] = {a: i for i, a in enumerate(self.items_by_rank)}
        if len(self.rank) != len(self.items_by_rank):
            raise ValueError("duplicate items in order")

    def __contains__(self, item: Item) -> bool:
        return item in self.rank

    def __len__(self) -> int:
        return len(self.items_by_rank)

    def sort_transaction(self, t: Iterable[Item]) -> List[Item]:
        """Project to ordered items and sort by rank (root side first)."""
        kept = [a for a in set(t) if a in self.rank]
        kept.sort(key=self.rank.__getitem__)
        return kept

    @staticmethod
    def from_counts(counts: Dict[Item, int], min_count: int = 1) -> "ItemOrder":
        """Support-descending order (ties broken by repr for determinism)."""
        items = [a for a, c in counts.items() if c >= min_count]
        items.sort(key=lambda a: (-counts[a], repr(a)))
        return ItemOrder(items)


class FPNode:
    __slots__ = ("item", "count", "parent", "children", "next")

    def __init__(self, item: Optional[Item], parent: Optional["FPNode"]):
        self.item = item
        self.count = 0
        self.parent = parent
        self.children: Dict[Item, FPNode] = {}
        self.next: Optional[FPNode] = None  # header-table linked list

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"FPNode({self.item}:{self.count})"


class HeaderEntry:
    __slots__ = ("item", "count", "head", "tail")

    def __init__(self, item: Item):
        self.item = item
        self.count = 0  # total count of item in the tree (sum over linked list)
        self.head: Optional[FPNode] = None
        self.tail: Optional[FPNode] = None

    def link(self, node: FPNode) -> None:
        if self.head is None:
            self.head = self.tail = node
        else:
            assert self.tail is not None
            self.tail.next = node
            self.tail = node

    def nodes(self) -> Iterator[FPNode]:
        n = self.head
        while n is not None:
            yield n
            n = n.next


class FPTree:
    """FP-tree with header table.  ``order`` fixes the path arrangement."""

    def __init__(self, order: ItemOrder):
        self.order = order
        self.root = FPNode(None, None)
        self.header: Dict[Item, HeaderEntry] = {}
        self.n_transactions = 0  # total weight inserted (incl. empty projections)

    # -- construction -------------------------------------------------------
    def insert(self, sorted_items: Sequence[Item], weight: int = 1) -> None:
        """Insert a transaction already projected+sorted by ``order``."""
        self.n_transactions += weight
        node = self.root
        for a in sorted_items:
            child = node.children.get(a)
            if child is None:
                child = FPNode(a, node)
                node.children[a] = child
                entry = self.header.get(a)
                if entry is None:
                    entry = self.header[a] = HeaderEntry(a)
                entry.link(child)
            child.count += weight
            self.header[a].count += weight
            node = child

    @staticmethod
    def build(
        transactions: Iterable[Transaction],
        order: ItemOrder,
        weights: Optional[Sequence[int]] = None,
    ) -> "FPTree":
        tree = FPTree(order)
        if weights is None:
            for t in transactions:
                tree.insert(order.sort_transaction(t))
        else:
            for t, w in zip(transactions, weights):
                tree.insert(order.sort_transaction(t), w)
        return tree

    # -- queries ------------------------------------------------------------
    def __contains__(self, item: Item) -> bool:
        return item in self.header

    def item_count(self, item: Item) -> int:
        """Count of ``item`` in the represented database.

        Paper: "follow the linked list starting at the entry of a_i in the
        header table, summing the counts from the visited nodes".  We keep the
        running total in the header entry (equivalent, O(1)); ``recount=True``
        paths in tests verify the linked-list sum matches.
        """
        e = self.header.get(item)
        return 0 if e is None else e.count

    def item_count_via_links(self, item: Item) -> int:
        e = self.header.get(item)
        return 0 if e is None else sum(n.count for n in e.nodes())

    def is_empty(self) -> bool:
        return not self.root.children

    def items_ascending(self) -> List[Item]:
        """Header items in support-ascending processing order (pattern-growth
        order = reverse of the tree arrangement order)."""
        items = list(self.header.keys())
        items.sort(key=self.order.rank.__getitem__, reverse=True)
        return items

    # -- conditional trees ---------------------------------------------------
    def prefix_paths(self, item: Item) -> Iterator[Tuple[List[Item], int]]:
        """(path items root->parent, count) for every node of ``item``."""
        e = self.header.get(item)
        if e is None:
            return
        for node in e.nodes():
            path: List[Item] = []
            p = node.parent
            while p is not None and p.item is not None:
                path.append(p.item)
                p = p.parent
            path.reverse()
            yield path, node.count

    def conditional_tree(
        self,
        item: Item,
        min_count: int = 0,
        item_filter: Optional[frozenset] = None,
    ) -> "FPTree":
        """Build the conditional FP-tree for ``item``.

        ``item_filter`` implements the paper's GFP data-reduction optimization
        (#4): items not present in the current TIS sub-tree are skipped when the
        conditional tree is constructed.  ``min_count`` > 0 additionally prunes
        items infrequent in the projected database (classic FP-growth behaviour;
        GFP-growth passes 0 = no min-support, per paper §3.2).
        """
        # First pass over prefix paths: projected item counts.
        counts: Dict[Item, int] = defaultdict(int)
        paths = list(self.prefix_paths(item))
        for path, c in paths:
            for a in path:
                if item_filter is None or a in item_filter:
                    counts[a] += c
        keep = {a for a, c in counts.items() if c >= min_count}
        # The conditional tree reuses the parent ordering restricted to `keep`
        # (same relative order — required for coordinated TIS traversal).
        sub_order = ItemOrder([a for a in self.order.items_by_rank if a in keep])
        ctree = FPTree(sub_order)
        for path, c in paths:
            ctree.insert([a for a in path if a in keep], c)
        return ctree
