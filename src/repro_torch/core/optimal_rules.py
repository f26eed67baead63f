"""Optimal class-association rule set (Li, Shen & Topor 2002 — the paper's
§5.1 reference [26]) over Minority-Report output.

A rule α→c is in the optimal set iff no rule β→c with β ⊂ α has confidence
>= confidence(α→c): supersets that don't improve confidence are redundant for
classification (Li et al. prove the optimal set has the same predictive power
as the complete set).  The paper suggests GFP-growth as the counting engine
for per-level optimal-rule discovery ([7], [8]); here the filter runs over the
complete MRA rule set, whose counts GFP-growth already collected in one pass —
no further tree mining is needed.
"""
from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Sequence, Tuple

from .mra import Rule


def optimal_rule_set(rules: Sequence[Rule], eps: float = 1e-12) -> List[Rule]:
    """Filter to the optimal set: drop α→c if some proper subset β→c has
    confidence(β) >= confidence(α)."""
    by_ante: Dict[Tuple, float] = {r.antecedent: r.confidence for r in rules}
    out: List[Rule] = []
    for r in rules:
        ante = r.antecedent
        dominated = False
        for k in range(1, len(ante)):
            for sub in combinations(ante, k):
                c = by_ante.get(tuple(sub))
                if c is not None and c >= r.confidence - eps:
                    dominated = True
                    break
            if dominated:
                break
        if not dominated:
            out.append(r)
    return out


def is_optimal_set(rules: Sequence[Rule], universe: Sequence[Rule]) -> bool:
    """Check the optimality invariant (for property tests)."""
    by_ante = {r.antecedent: r.confidence for r in universe}
    for r in rules:
        for k in range(1, len(r.antecedent)):
            for sub in combinations(r.antecedent, k):
                c = by_ante.get(tuple(sub))
                if c is not None and c >= r.confidence + 1e-12:
                    return False
    return True
