"""TIS-tree (Target Item-Set tree) — paper §3.2.

A trie of target itemsets arranged in *pattern-growth order*: the reverse of
the FP-tree arrangement order, i.e. support-ascending.  For a child a_j of a_i,
C(a_j) >= C(a_i) (paper: "TIS-tree should be arranged such that ... C(a_j) >=
C(a_i)").  Following the TIS-tree top-down therefore explores the FP-tree
bottom-up, exactly as FP-growth does.

Each node carries:
  * ``target``  — whether the node represents a target itemset (paper flag);
  * ``g_count`` — the counter filled by GFP-growth (paper: g-count);
  * ``count``   — the counter filled by FP-growth in the MRA (paper: count, =C1);
  * ``subtree_items`` — the set of items appearing in the node's sub-tree,
    supporting GFP data-reduction optimization #4.  The paper suggests a
    bit-map / hash-table / linked-list; we use a frozenset (host reference) —
    the device engine uses actual packed bitmaps.
"""
from __future__ import annotations

from typing import Dict, Hashable, Iterator, List, Optional, Sequence, Tuple

from .fptree import ItemOrder

Item = Hashable


class TISNode:
    __slots__ = ("item", "children", "target", "g_count", "count", "subtree_items", "parent")

    def __init__(self, item: Optional[Item], parent: Optional["TISNode"]):
        self.item = item
        self.parent = parent
        self.children: Dict[Item, TISNode] = {}
        self.target = False
        self.g_count = 0
        self.count = 0
        self.subtree_items: frozenset = frozenset()

    def has_children(self) -> bool:
        return bool(self.children)

    def itemset(self) -> Tuple[Item, ...]:
        """The itemset this node represents (path from root), in PG order."""
        path: List[Item] = []
        n: Optional[TISNode] = self
        while n is not None and n.item is not None:
            path.append(n.item)
            n = n.parent
        path.reverse()
        return tuple(path)


class TISTree:
    """Target itemset trie in pattern-growth (support-ascending) order.

    ``order`` is the FP-tree arrangement order (support-descending).  Paths in
    the TIS-tree are sorted by *descending* rank, i.e. least-frequent item at
    the root side, which is the pattern-growth order.
    """

    def __init__(self, order: ItemOrder):
        self.order = order
        self.root = TISNode(None, None)
        self.n_targets = 0

    def pg_sort(self, itemset: Sequence[Item]) -> List[Item]:
        """Sort an itemset into pattern-growth order (reverse arrangement order)."""
        items = [a for a in set(itemset)]
        for a in items:
            if a not in self.order:
                raise KeyError(f"item {a!r} not in item order")
        items.sort(key=self.order.rank.__getitem__, reverse=True)
        return items

    def insert(self, itemset: Sequence[Item], count: int = 0, target: bool = True) -> TISNode:
        """Insert a target itemset; returns its node.

        Intermediate nodes created on the way are *not* targets (paper: the
        TIS-tree may contain non-target internal prefixes, for which
        optimization #6 skips the count computation).
        """
        node = self.root
        for a in self.pg_sort(itemset):
            child = node.children.get(a)
            if child is None:
                child = TISNode(a, node)
                node.children[a] = child
            node = child
        if node is self.root:
            raise ValueError("cannot insert the empty itemset")
        if target and not node.target:
            self.n_targets += 1
        node.target = node.target or target
        if count:
            node.count = count
        return node

    def finalize(self) -> None:
        """Compute ``subtree_items`` bottom-up (GFP data-reduction support)."""

        def rec(node: TISNode) -> frozenset:
            acc = set()
            for item, child in node.children.items():
                acc.add(item)
                acc |= rec(child)
            node.subtree_items = frozenset(acc)
            return node.subtree_items

        rec(self.root)

    # -- queries -------------------------------------------------------------
    def find(self, itemset: Sequence[Item]) -> Optional[TISNode]:
        node = self.root
        for a in self.pg_sort(itemset):
            node = node.children.get(a)
            if node is None:
                return None
        return node

    def walk(self) -> Iterator[TISNode]:
        """All non-root nodes, DFS preorder."""
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def targets(self) -> Iterator[TISNode]:
        for n in self.walk():
            if n.target:
                yield n

    def as_dict(self, which: str = "g_count") -> Dict[Tuple[Item, ...], int]:
        """{frozenset-like sorted tuple -> counter} for every *target* node."""
        out: Dict[Tuple[Item, ...], int] = {}
        for n in self.targets():
            key = tuple(sorted(n.itemset(), key=repr))
            out[key] = getattr(n, which)
        return out

    def levels(self) -> List[List[TISNode]]:
        """Nodes grouped by depth (1-based level 0 = root children) — used by
        the device level-synchronous scheduler."""
        out: List[List[TISNode]] = []
        frontier = list(self.root.children.values())
        while frontier:
            out.append(frontier)
            frontier = [c for n in frontier for c in n.children.values()]
        return out
