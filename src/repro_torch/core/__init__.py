# The paper's primary contribution — paper-faithful host implementations of
# the FP-tree, FP-growth, TIS-tree, GFP-growth (Algorithm 3.1) and the
# Minority-Report Algorithm (Algorithm 4.1).  The GPU engine derived from
# these lives in repro_torch.mining + repro_torch.kernels.
from .fptree import FPTree, ItemOrder
from .tis import TISTree, TISNode
from .fpgrowth import fp_growth, fp_growth_into_tis, mine_frequent
from .gfp import GFPStats, gfp_growth
from .mra import MRAResult, Rule, full_fpgrowth_rules, minority_report
from .apriori import apriori, apriori_gen, brute_force_counts

__all__ = [
    "FPTree", "ItemOrder", "TISTree", "TISNode",
    "fp_growth", "fp_growth_into_tis", "mine_frequent",
    "GFPStats", "gfp_growth",
    "MRAResult", "Rule", "full_fpgrowth_rules", "minority_report",
    "apriori", "apriori_gen", "brute_force_counts",
]
from .optimal_rules import is_optimal_set, optimal_rule_set
