"""TIS scheduling for the dense engine.

The paper's GFP-growth walks the TIS-tree depth-first, recursively; the
counting kernel wants big homogeneous batches.  The schedule below converts the same TIS-tree into a
LEVEL-SYNCHRONOUS plan: level l holds the masks of all depth-(l+1) TIS nodes.
Correctness is unchanged (Theorem 1's argument is independent across siblings);
the guidance survives as:

  * only target-node masks are materialized at all (opt. #6: non-target
    internal prefixes get counted only when a min-support prune needs them);
  * levels allow early termination: children of below-threshold (or zero)
    parents are dropped host-side before their kernel launch — the dense
    analogue of the O(1) header consult + empty-conditional-tree check;
  * the union of live items per level drives column projection (opt. #4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np

from ..core.tis import TISNode, TISTree
from .encode import ItemVocab, encode_targets

Item = Hashable


@dataclass
class LevelPlan:
    """One TIS level: nodes + their (K, W) masks in a fixed row order."""
    nodes: List[TISNode]
    itemsets: List[Tuple[Item, ...]]
    masks: np.ndarray             # (K, W) uint32
    parent_rows: np.ndarray       # (K,) int32 row of parent in previous level (-1 = root child)
    is_target: np.ndarray         # (K,) bool


@dataclass
class TISSchedule:
    vocab: ItemVocab
    levels: List[LevelPlan]
    n_nodes: int

    @property
    def max_depth(self) -> int:
        return len(self.levels)


def build_schedule(tis: TISTree, vocab: ItemVocab) -> TISSchedule:
    """Flatten a TIS-tree into level-synchronous mask batches."""
    levels_nodes = tis.levels()
    levels: List[LevelPlan] = []
    prev_row: Dict[int, int] = {}  # id(node) -> row in previous level
    n_nodes = 0
    for depth, nodes in enumerate(levels_nodes):
        itemsets = [n.itemset() for n in nodes]
        masks = encode_targets(itemsets, vocab)
        parent_rows = np.full(len(nodes), -1, dtype=np.int32)
        if depth > 0:
            for i, n in enumerate(nodes):
                parent_rows[i] = prev_row[id(n.parent)]
        is_target = np.array([n.target for n in nodes], dtype=bool)
        levels.append(LevelPlan(list(nodes), itemsets, masks, parent_rows, is_target))
        prev_row = {id(n): i for i, n in enumerate(nodes)}
        n_nodes += len(nodes)
    return TISSchedule(vocab=vocab, levels=levels, n_nodes=n_nodes)


# --------------------------------------------------------------------------
# Streaming chunk planning (the out-of-core N axis).
#
# The counting kernel is oblivious to N-chunking: counts are int32 sums, so a
# sweep over row-chunks accumulated on device is bit-identical to one pass.
# The planner only decides WHERE to cut: chunk_rows from a host->device
# staging budget (two in-flight buffers of bits+weights), aligned to 1024 rows.
# --------------------------------------------------------------------------

DEFAULT_STREAM_BUDGET_BYTES = 64 << 20   # per staging buffer (x2 in flight)


def choose_chunk_rows(n_words: int, n_classes: int, *,
                      budget_bytes: int = DEFAULT_STREAM_BUDGET_BYTES,
                      align: int = 1024,
                      n_rows: Optional[int] = None) -> int:
    """Rows per streamed chunk so one buffer (bits + weights) fits the budget.

    The staging-budget heuristic, aligned to ``align`` rows.  When the caller
    knows the total row count (``n_rows``) the result is CLAMPED to the
    align-rounded row count, so a small DB is swept as one chunk of its own
    size rather than a budget-sized staging buffer."""
    cap = None
    if n_rows is not None and n_rows > 0:
        cap = max(align, -(-int(n_rows) // align) * align)
    row_bytes = 4 * (max(1, n_words) + max(1, n_classes))
    rows = budget_bytes // row_bytes
    rows = max(align, (rows // align) * align)
    return rows if cap is None else min(cap, rows)


def stream_chunks(n_rows: int, chunk_rows: int) -> List[Tuple[int, int]]:
    """(start, stop) spans covering [0, n_rows); the last may be ragged."""
    if n_rows <= 0:
        return []
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    return [(s, min(s + chunk_rows, n_rows))
            for s in range(0, n_rows, chunk_rows)]


def canonical_itemsets(cands) -> List[Tuple[Item, ...]]:
    """Frozenset candidates -> repr-sorted tuples in a deterministic list
    order — the repo-wide canonical level layout (checkpoint partials store
    this exact list, so resume can regenerate and compare it)."""
    return [tuple(sorted(s, key=repr)) for s in cands]


def live_items(level: LevelPlan, vocab: ItemVocab) -> List[Item]:
    """Union of items appearing in a level's masks (column-projection driver)."""
    union = np.zeros(level.masks.shape[1], dtype=np.uint32)
    for w in range(level.masks.shape[1]):
        union[w] = np.bitwise_or.reduce(level.masks[:, w]) if level.masks.shape[0] else 0
    out = []
    for c, a in enumerate(vocab.items):
        if (int(union[c >> 5]) >> (c & 31)) & 1:
            out.append(a)
    return out
