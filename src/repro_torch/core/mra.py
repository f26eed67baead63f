"""Minority-Report Algorithm (MRA) — paper Algorithm 4.1.

Mines class-association rules `alpha -> target_class` for a rare class from
imbalanced data:

  1. first DB pass: I' = items frequent *within the rare class*
     (C1(a_k) >= C* = xi * |DB|);
  2. second pass: build FP0 (common class) and FP1 (rare class) over I' with a
     *shared* item order (support-descending over the entire DB — the paper's
     performance-optimized choice, §4.1);
  3. FP-growth(FP1, min-count=C*) -> TIS-tree with .count = C1(alpha);
  4. GFP-growth(TIS-tree, FP0)    ->              .g_count = C0(alpha);
  5. confidence = C1/(C1+C0) >= minconf -> emit rule.

Exactness (Theorems 2-3) is cross-checked in tests against a brute-force oracle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, Iterable, List, Optional, Sequence, Tuple

from .fpgrowth import fp_growth_into_tis
from .fptree import FPTree, ItemOrder
from .gfp import GFPStats, gfp_growth
from .tis import TISTree

Item = Hashable


@dataclass(frozen=True)
class Rule:
    antecedent: Tuple[Item, ...]  # sorted by repr for determinism
    consequent: Item
    support: float                # support(antecedent ∪ {class}) in DB
    confidence: float
    count: int                    # C1(antecedent)
    g_count: int                  # C0(antecedent)

    def __str__(self) -> str:  # pragma: no cover - display helper
        lhs = ",".join(map(str, self.antecedent))
        return (f"{{{lhs}}} -> {self.consequent} "
                f"(sup={self.support:.4g}, conf={self.confidence:.4g})")


@dataclass
class MRAResult:
    rules: List[Rule]
    tis: TISTree
    order: ItemOrder
    n_db: int
    n_rare: int
    stats: GFPStats
    items_kept: List[Item]


def minority_report(
    transactions: Iterable[Sequence[Item]],
    classes: Sequence[int],
    *,
    target_class: int = 1,
    min_support: float,
    min_confidence: float,
    use_data_reduction: bool = True,
) -> MRAResult:
    """Run MRA on (transactions, classes).

    ``classes[i]`` is the class label of transaction i; ``target_class`` plays
    the paper's class '1' (rare).  The class item itself must NOT appear inside
    the transactions (callers using a class-item encoding should strip it).
    """
    db: List[List[Item]] = [list(t) for t in transactions]
    if len(db) != len(classes):
        raise ValueError("transactions/classes length mismatch")
    n_db = len(db)
    from .incremental import ceil_count
    # ONE threshold rule end to end (the repo-wide epsilon-guarded ceil):
    # filtering I' on the raw float product would exclude an item whose count
    # sits exactly on a threshold that carries upward FP noise (e.g.
    # 0.07 * 100 = 7.000000000000001) while the FP-growth min-count below —
    # and every engine-side miner — accepts it
    min_count = ceil_count(min_support * n_db)

    # ---- first pass: per-item counts in rare class and overall -------------
    c1: Dict[Item, int] = {}
    c_all: Dict[Item, int] = {}
    n_rare = 0
    for t, y in zip(db, classes):
        rare = y == target_class
        n_rare += rare
        for a in set(t):
            c_all[a] = c_all.get(a, 0) + 1
            if rare:
                c1[a] = c1.get(a, 0) + 1
    items_kept = [a for a, c in c1.items() if c >= min_count]

    # Shared support-descending order over the *entire DB* (paper §4.1).
    order = ItemOrder(sorted(items_kept, key=lambda a: (-c_all[a], repr(a))))

    # ---- second pass: build FP0 / FP1 over I' -------------------------------
    fp0 = FPTree(order)
    fp1 = FPTree(order)
    for t, y in zip(db, classes):
        proj = order.sort_transaction(t)
        (fp1 if y == target_class else fp0).insert(proj)

    # ---- FP-growth on the small (rare) tree -> TIS-tree ---------------------
    tis = TISTree(order)
    fp_growth_into_tis(fp1, min_count, tis)

    # ---- GFP-growth on the big (common) tree --------------------------------
    stats = gfp_growth(tis, fp0, use_data_reduction=use_data_reduction)

    # ---- rule generation -----------------------------------------------------
    rules: List[Rule] = []
    for node in tis.targets():
        cnt, gcnt = node.count, node.g_count
        conf = cnt / (cnt + gcnt) if (cnt + gcnt) else 0.0
        if conf >= min_confidence:
            rules.append(Rule(
                antecedent=tuple(sorted(node.itemset(), key=repr)),
                consequent=target_class,
                support=cnt / n_db,
                confidence=conf,
                count=cnt,
                g_count=gcnt,
            ))
    rules.sort(key=lambda r: (-r.confidence, -r.support, r.antecedent))
    return MRAResult(rules=rules, tis=tis, order=order, n_db=n_db,
                     n_rare=n_rare, stats=stats, items_kept=items_kept)


# ---------------------------------------------------------------------------
# Baseline for benchmarking: the "well-known solution" the paper compares MRA
# against — run full FP-growth over the entire DB (class items included) with
# the same min-support, then post-filter itemsets containing the class item.
# ---------------------------------------------------------------------------

def full_fpgrowth_rules(
    transactions: Iterable[Sequence[Item]],
    classes: Sequence[int],
    *,
    target_class: int = 1,
    min_support: float,
    min_confidence: float,
    class_item: str = "__class__",
) -> List[Rule]:
    from .fpgrowth import mine_frequent

    db = []
    for t, y in zip(transactions, classes):
        t = list(t)
        if y == target_class:
            t.append(class_item)
        db.append(t)
    n_db = len(db)
    import math
    min_count = max(1, math.ceil(min_support * n_db - 1e-9))
    freq = mine_frequent(db, min_count)
    rules: List[Rule] = []
    for itemset, cnt in freq.items():
        if class_item not in itemset:
            continue
        ante = tuple(sorted((a for a in itemset if a != class_item), key=repr))
        if not ante:
            continue
        total = freq.get(ante)
        if total is None:  # antecedent itself frequent by anti-monotonicity
            continue
        conf = cnt / total
        if conf >= min_confidence:
            rules.append(Rule(ante, target_class, cnt / n_db, conf, cnt, total - cnt))
    rules.sort(key=lambda r: (-r.confidence, -r.support, r.antecedent))
    return rules
