"""A plain itemset count over packed bits: the benchmark's reference.

A table is held item by item: column ``j`` has bit ``n`` set when row ``n``
holds item ``j``, in uint64 words of 64 rows.  The count of an itemset in a
class is the population count of the AND of its columns and the class's row
mask.  Nothing here comes from the program under test: the items, their
order, the distinct rows and the counts are all worked out from the
transactions and classes that the benchmark made.
"""
from __future__ import annotations

from itertools import chain
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

Item = Hashable

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)
# AND temporaries are cut to blocks of this many words
_BLOCK_WORDS = 1 << 22


def popcount_rows(words: np.ndarray) -> np.ndarray:
    """(K, L) uint64 -> (K,) int64 set bits per row."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(words).sum(axis=1, dtype=np.int64)
    return _POPCOUNT8[words.view(np.uint8)].sum(axis=1, dtype=np.int64)


def pack_rows(mat: np.ndarray) -> np.ndarray:
    """(R, N) bool -> (R, ceil(N / 64)) uint64, bit n of row r at word
    n // 64, bit n % 64."""
    r, n = mat.shape
    words = -(-n // 64)
    out = np.zeros((r, words * 8), np.uint8)
    out[:, :-(-n // 8)] = np.packbits(mat, axis=1, bitorder="little")
    return out.view(np.uint64)


def item_matrix(transactions: Sequence[Sequence[Item]],
                items: Optional[Sequence[Item]] = None
                ) -> Tuple[np.ndarray, Tuple[Item, ...]]:
    """(N, M) bool membership matrix and its item order (sorted by ``repr``
    unless ``items`` is given; items outside ``items`` are dropped)."""
    lengths = np.fromiter(map(len, transactions), np.int64,
                          count=len(transactions))
    flat = list(chain.from_iterable(transactions))
    if items is None:
        items = tuple(sorted(set(flat), key=repr))
    index = {a: j for j, a in enumerate(items)}
    cols = np.fromiter((index.get(a, -1) for a in flat), np.int64,
                       count=len(flat))
    rows = np.repeat(np.arange(len(transactions)), lengths)
    keep = cols >= 0
    mat = np.zeros((len(transactions), len(items)), bool)
    mat[rows[keep], cols[keep]] = True
    return mat, tuple(items)


def distinct_rows(mat: np.ndarray) -> int:
    """Number of distinct rows of an (N, M) bool matrix."""
    if mat.shape[0] == 0:
        return 0
    packed = pack_rows(mat)
    return int(np.unique(packed, axis=0).shape[0])


class PackedTable:
    """Item columns of an (N, M) membership matrix and one row mask per
    class, bit-packed over rows."""

    def __init__(self, mat: np.ndarray, classes: np.ndarray, n_classes: int,
                 items: Sequence[Item]):
        self.items = tuple(items)
        self.index: Dict[Item, int] = {a: j for j, a in enumerate(self.items)}
        self.n_rows = mat.shape[0]
        self.columns = pack_rows(np.ascontiguousarray(mat.T))
        y = np.asarray(classes)
        self.class_masks = pack_rows(
            np.stack([y == c for c in range(n_classes)]))
        self.n_classes = n_classes

    @staticmethod
    def from_transactions(transactions, classes, n_classes: int = 2,
                          items: Optional[Sequence[Item]] = None
                          ) -> "PackedTable":
        mat, items = item_matrix(transactions, items)
        return PackedTable(mat, classes, n_classes, items)

    def _and(self, cols: np.ndarray) -> np.ndarray:
        """(K, s) column indices -> (K, L) AND of each row's columns."""
        acc = self.columns[cols[:, 0]]
        for j in range(1, cols.shape[1]):
            acc &= self.columns[cols[:, j]]
        return acc

    def count_index(self, cols: np.ndarray,
                    classes: Sequence[int]) -> np.ndarray:
        """(K, s) column indices (one size s) -> (K, len(classes)) int64
        counts."""
        k = cols.shape[0]
        out = np.zeros((k, len(classes)), np.int64)
        step = max(1, _BLOCK_WORDS // max(1, self.columns.shape[1]))
        for a in range(0, k, step):
            both = self._and(cols[a:a + step])
            for j, c in enumerate(classes):
                out[a:a + step, j] = popcount_rows(both & self.class_masks[c])
        return out

    def counts(self, itemsets: Sequence[Sequence[Item]]) -> np.ndarray:
        """(K, C) int64 counts of every itemset in every class; an itemset
        with an item the table lacks counts 0, the empty itemset counts
        every row."""
        out = np.zeros((len(itemsets), self.n_classes), np.int64)
        by_size: Dict[int, List[int]] = {}
        idx: List[List[int]] = []
        for i, s in enumerate(itemsets):
            s = set(s)
            if not s:
                out[i] = popcount_rows(self.class_masks)
                idx.append([])
                continue
            if all(a in self.index for a in s):
                by_size.setdefault(len(s), []).append(i)
            idx.append(sorted(self.index.get(a, -1) for a in s))
        for size, rows in by_size.items():
            cols = np.array([idx[i] for i in rows], np.int64).reshape(-1, size)
            out[rows] = self.count_index(cols, range(self.n_classes))
        return out
