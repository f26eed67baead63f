"""Paper §5.2 — incremental frequent-itemset mining via GFP-growth.

Setting: a (potentially huge) original dataset already mined at relative
threshold theta, plus a new increment batch.  The paper's idea: "perform guided
mining of the (potentially huge) original FP-growth tree, focusing only on
itemsets which may potentially become frequent" — i.e. those frequent in the
increment but not previously frequent — plus a guided pass over the (small)
increment tree to refresh counts of the previously-frequent itemsets.

Pigeonhole guarantee (exactness): if an itemset is frequent in the combined
dataset, C(α) >= θ(n₀+n₁), then C₀(α) >= θ·n₀ or C₁(α) >= θ·n₁ — so the
candidate set {frequent in original} ∪ {frequent in increment} is complete.

Note on the FP-tree item universe: as the paper discusses, a min-support-built
FP-tree drops globally-infrequent items, which breaks incremental exactness
when such an item becomes frequent.  ``IncrementalMiner`` therefore keeps its
base FP-tree over the *full* item universe (min_count=1 at the item level, as
itemset trees do); the frequent-itemset *mining* threshold is still theta.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Dict, Hashable, Iterable, List, Optional, Sequence,
                    Tuple)

from .fpgrowth import mine_frequent
from .fptree import FPTree, ItemOrder
from .gfp import GFPStats, gfp_growth
from .tis import TISTree

Item = Hashable
Key = Tuple[Item, ...]


def incremental_candidates(
    prev_frequent: Iterable[Key],
    inc_frequent: Iterable[Key],
) -> Tuple[List[Key], List[Key]]:
    """§5.2 pigeonhole candidate set, partitioned.

    Returns ``(previously, newly)``: the itemsets frequent before the
    increment, and those frequent in the increment but not before — disjoint,
    each repr-sorted (deterministic).  Their union is COMPLETE: if
    C(α) >= θ(n₀+n₁) then C₀(α) >= θ·n₀ or C₁(α) >= θ·n₁, so any
    combined-frequent itemset is in one of the two lists.  Shared by the host
    ``IncrementalMiner`` (guided FP-tree recounts per partition) and the
    engine-backed recount in the serving layer (one dense/streaming batch over
    the union).
    """
    prev = set(prev_frequent)
    previously = sorted(prev, key=repr)
    newly = sorted((k for k in inc_frequent if k not in prev), key=repr)
    return previously, newly


@dataclass
class IncrementalState:
    order: ItemOrder
    tree: FPTree                       # FP-tree over all data seen so far
    n: int                             # transactions so far
    frequent: Dict[Tuple[Item, ...], int]  # current frequent set with counts
    stats: GFPStats


class IncrementalMiner:
    """Maintains the frequent-itemset set of a growing dataset using GFP-guided
    recounts instead of full re-mining."""

    def __init__(self, theta: float):
        if not (0.0 < theta <= 1.0):
            raise ValueError("theta in (0, 1]")
        self.theta = theta
        self.state: Optional[IncrementalState] = None

    def _require_state(self) -> IncrementalState:
        if self.state is None:
            raise RuntimeError("call fit() first")
        return self.state

    @property
    def frequent(self) -> Dict[Tuple[Item, ...], int]:
        """Current frequent set with counts (requires ``fit()``)."""
        return dict(self._require_state().frequent)

    @property
    def n_seen(self) -> int:
        """Transactions folded in so far (requires ``fit()``)."""
        return self._require_state().n

    # -- bootstrap -----------------------------------------------------------
    def fit(self, transactions: Sequence[Sequence[Item]]) -> Dict[Tuple[Item, ...], int]:
        db = [list(t) for t in transactions]
        counts: Dict[Item, int] = {}
        for t in db:
            for a in set(t):
                counts[a] = counts.get(a, 0) + 1
        order = ItemOrder.from_counts(counts, min_count=1)  # full item universe
        tree = FPTree.build(db, order)
        n = len(db)
        min_count = _ceil(self.theta * n)
        frequent = mine_frequent(db, min_count, order=order)
        self.state = IncrementalState(order, tree, n, frequent, GFPStats())
        return dict(frequent)

    # -- increment -----------------------------------------------------------
    def update(self, new_transactions: Sequence[Sequence[Item]]) -> Dict[Tuple[Item, ...], int]:
        st = self._require_state()
        inc = [list(t) for t in new_transactions]
        n1 = len(inc)
        n_total = st.n + n1

        # Items possibly unseen before: extend the order (appended at the tail;
        # relative order of existing items is preserved so the existing tree
        # remains valid).
        new_items = []
        seen = set(st.order.rank)
        for t in inc:
            for a in set(t):
                if a not in seen:
                    seen.add(a)
                    new_items.append(a)
        if new_items:
            order = ItemOrder(st.order.items_by_rank + sorted(new_items, key=repr))
            st.tree.order = order  # tail extension: existing paths unaffected
            st.order = order

        # 1) Mine the small increment at the combined-threshold-compatible
        #    level: candidates must reach theta*n1 in the increment (pigeonhole).
        inc_min = _ceil(self.theta * n1)
        inc_frequent = mine_frequent(inc, inc_min, order=st.order)
        previously, newly = incremental_candidates(st.frequent, inc_frequent)

        # 2) Guided recount of previously-frequent itemsets in the increment
        #    (small tree) — refresh their counts.
        inc_tree = FPTree.build(inc, st.order)
        if previously:
            tis_old = TISTree(st.order)
            for itemset in previously:
                tis_old.insert(itemset, target=True)
            st.stats.merge(gfp_growth(tis_old, inc_tree))
            old_updated = {
                k: st.frequent[k] + cnt
                for k, cnt in tis_old.as_dict("g_count").items()
            }
        else:
            old_updated = {}

        # 3) Guided recount, in the HUGE original tree, of itemsets newly
        #    frequent in the increment only — the paper's §5.2 focus.
        new_counts: Dict[Tuple[Item, ...], int] = {}
        if newly:
            tis_new = TISTree(st.order)
            for itemset in newly:
                tis_new.insert(itemset, target=True)
            st.stats.merge(gfp_growth(tis_new, st.tree))
            for k, c_orig in tis_new.as_dict("g_count").items():
                new_counts[k] = c_orig + inc_frequent[k]

        # 4) Merge + final threshold over the combined dataset.
        min_total = _ceil(self.theta * n_total)
        merged = {**old_updated, **new_counts}
        frequent = {k: c for k, c in merged.items() if c >= min_total}

        # 5) Fold the increment into the base tree for future updates.
        for t in inc:
            st.tree.insert(st.order.sort_transaction(t))
        st.n = n_total
        st.frequent = frequent
        return dict(frequent)


def ceil_count(x: float) -> int:
    """The repo-wide frequency threshold rule: ``count >= x`` with a float
    threshold, epsilon-guarded against FP noise, floored at 1.  Shared by the
    host miners, the incremental miner, and the serving engine's theta ->
    min_count conversion (``CountServer.mine``); the unified level-wise
    driver (``mining/driver.py``) takes the resulting ``min_count`` directly,
    so every engine applies ONE rule — the parity tests assume it."""
    import math
    return max(1, math.ceil(x - 1e-9))


_ceil = ceil_count  # internal alias
