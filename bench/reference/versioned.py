"""A plain itemset count over a table that grows: the benchmark's reference
for a store that takes appends.

The history is the base table's rows followed by each increment's, in the
order they were appended.  Version 0 is the base alone, and version ``v`` is
the base and every increment acknowledged up to ``v``: its first ``n(v)``
rows.  A count at a version is ``PackedTable``'s arithmetic over the whole
history with each class's row mask cut to that prefix.  Nothing here comes
from the program under test.
"""
from __future__ import annotations

import copy
from typing import Dict, Hashable, Sequence

import numpy as np

from bench.reference.table import PackedTable, pack_rows

Item = Hashable


class VersionedTable:
    """Counts over the first ``rows_at[v]`` rows of an (N, M) membership
    matrix, for a version ``v``."""

    def __init__(self, mat: np.ndarray, classes: np.ndarray, n_classes: int,
                 items: Sequence[Item], rows_at: Dict[int, int]):
        self.table = PackedTable(mat, classes, n_classes, items)
        self.rows_at = dict(rows_at)

    def prefix(self, n_rows: int) -> PackedTable:
        """The table whose class masks hold only the first ``n_rows`` rows."""
        keep = np.zeros((1, self.table.n_rows), bool)
        keep[0, :n_rows] = True
        cut = copy.copy(self.table)
        cut.class_masks = self.table.class_masks & pack_rows(keep)
        return cut

    def counts_at(self, version: int,
                  itemsets: Sequence[Sequence[Item]]) -> np.ndarray:
        """(K, C) int64 counts at ``version``; a version that no acknowledged
        append produced raises ``KeyError``."""
        return self.prefix(self.rows_at[version]).counts(itemsets)
