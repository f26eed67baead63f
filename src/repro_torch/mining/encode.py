"""Bitmap encoding of transaction databases — the device data layout.

The FP-tree's two benefits are (a) prefix compression (shared work across
transactions sharing prefixes) and (b) frequency-ordered arrangement.  On the
device we realize the same benefits in a dense layout:

  * each transaction -> a packed row of ``W = ceil(M/32)`` uint32 words, items
    mapped to bit positions in support-DESCENDING order (same discipline as the
    FP-tree arrangement; makes equal-prefix rows byte-identical early, so the
    dedup below collapses exactly the paths an FP-tree would merge);
  * duplicate rows are collapsed into a single row with an integer weight
    (per class: an (U, C) weight matrix) — the FP-tree compression analogue;
  * column projection drops items absent from the target set before any device
    work — the GFP-growth conditional-tree data reduction (#4) analogue.

All functions are host-side numpy (data-pipeline stage); the arrays they
produce are the device inputs of the counting kernel.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from itertools import chain
from typing import (Dict, Hashable, Iterable, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np

Item = Hashable


@dataclass(frozen=True)
class ItemVocab:
    """item -> bit column, support-descending (column 0 = most frequent)."""

    items: Tuple[Item, ...]

    @property
    def size(self) -> int:
        return len(self.items)

    @property
    def n_words(self) -> int:
        return max(1, (len(self.items) + 31) // 32)

    def col(self, item: Item) -> int:
        return self._index()[item]

    def _index(self) -> Dict[Item, int]:
        idx = getattr(self, "_idx", None)
        if idx is None:
            idx = {a: i for i, a in enumerate(self.items)}
            object.__setattr__(self, "_idx", idx)
        return idx

    def __contains__(self, item: Item) -> bool:
        return item in self._index()

    @staticmethod
    def from_transactions(
        transactions: Iterable[Sequence[Item]],
        min_count: int = 1,
        counts: Optional[Dict[Item, int]] = None,
    ) -> "ItemVocab":
        if counts is None:
            counts = {}
            for t in transactions:
                for a in set(t):
                    counts[a] = counts.get(a, 0) + 1
        items = [a for a, c in counts.items() if c >= min_count]
        items.sort(key=lambda a: (-counts[a], repr(a)))
        return ItemVocab(tuple(items))


@dataclass(frozen=True)
class FlatRows:
    """Rows walked once into flat arrays: occurrence ``k`` is the item
    ``items[ids[k]]`` in row ``rows[k]``.  ``encode_bitmap`` (and so
    ``DenseDB.encode`` / ``StreamingDB.encode``, given a vocab) takes one in
    place of the rows and walks nothing again."""

    ids: np.ndarray              # (T,) dense item id of each occurrence
    rows: np.ndarray             # (T,) int64 row of each occurrence
    items: Tuple[Item, ...]      # id -> item: the first object seen of each
    n_rows: int
    source: Sequence[Iterable[Item]]  # the rows as walked

    def __len__(self) -> int:
        return self.n_rows


@dataclass(frozen=True)
class WalkedRows:
    """The walk alone: row ``r`` holds the items ``items[ids[k]]`` for
    ``k`` in ``[o, o + lengths[r])``, ``o`` the sum of the lengths before
    ``r``."""

    ids: np.ndarray              # (T,) int32 dense item id of each occurrence
    lengths: np.ndarray          # (N,) int64 items per row
    items: Tuple[Item, ...]      # id -> item: the first object seen of each
    source: Sequence[Iterable[Item]]  # the rows as walked

    def flat(self) -> FlatRows:
        """The walk with each occurrence's row spelt out."""
        n = len(self.lengths)
        return FlatRows(ids=self.ids, rows=np.repeat(np.arange(n), self.lengths),
                        items=self.items, n_rows=n, source=self.source)


def walk_rows(transactions: Iterable[Iterable[Item]]) -> WalkedRows:
    """One walk over the rows: each item to a dense id (first seen, first
    numbered) into an int32 array, all in C.  Rows without a length
    (generators) are read into tuples first."""
    rows = transactions if isinstance(transactions, (list, tuple)) \
        else list(transactions)
    try:
        lengths = np.fromiter(map(len, rows), np.int64, len(rows))
    except TypeError:
        rows = [t if hasattr(t, "__len__") else tuple(t) for t in rows]
        lengths = np.fromiter(map(len, rows), np.int64, len(rows))
    index: Dict[Item, int] = defaultdict()
    index.default_factory = index.__len__    # an unseen item: the next id
    ids = np.fromiter(map(index.__getitem__, chain.from_iterable(rows)),
                      np.int32, int(lengths.sum()))
    return WalkedRows(ids=ids, lengths=lengths, items=tuple(index),
                      source=rows)


def flatten_rows(transactions: Iterable[Iterable[Item]]) -> FlatRows:
    """``walk_rows``, with each occurrence's row spelt out."""
    return walk_rows(transactions).flat()


def encode_bitmap(
    transactions: Union[Iterable[Iterable[Item]], FlatRows],
    vocab: ItemVocab,
) -> np.ndarray:
    """-> (N, W) uint32 packed bitmap (items outside vocab are dropped).
    An item repeated in a row sets its bit once."""
    flat = transactions if isinstance(transactions, FlatRows) \
        else flatten_rows(transactions)
    idx = vocab._index()
    lut = np.fromiter((idx.get(a, -1) for a in flat.items), np.int64,
                      len(flat.items))
    cols = lut[flat.ids]
    hit = cols >= 0
    cols = cols[hit]
    w = vocab.n_words
    out = np.zeros((flat.n_rows, w), dtype=np.uint32)
    bit = np.left_shift(np.uint32(1), (cols & 31).astype(np.uint32))
    np.bitwise_or.at(out.reshape(-1), flat.rows[hit] * w + (cols >> 5), bit)
    return out


def encode_targets(
    itemsets: Sequence[Sequence[Item]],
    vocab: ItemVocab,
) -> np.ndarray:
    """-> (K, W) uint32 target masks.  Raises if a target item is outside the
    vocab (the TIS-tree 'does not need to include itemsets ... containing items
    which do not appear in the FP-tree'; callers filter first)."""
    k = len(itemsets)
    w = vocab.n_words
    out = np.zeros((k, w), dtype=np.uint32)
    idx = vocab._index()
    for i, s in enumerate(itemsets):
        for a in set(s):
            c = idx[a]
            out[i, c >> 5] |= np.uint32(1) << np.uint32(c & 31)
    return out


def dedup_rows(
    bits: np.ndarray,
    weights: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """FP-compression analogue: collapse identical rows, summing weights.

    bits: (N, W) uint32;  weights: (N, C) int — defaults to ones (C=1).
    -> (unique_bits (U, W), weights (U, C) int32), the rows in ascending
    order by word 0, then word 1, ... (``np.unique(bits, axis=0)``'s).

    Numeric sorts, gathers and sums only: each lets go of the interpreter
    lock, so a fold of a million rows on the store's compactor thread does
    not stall the threads that serve counts (``np.unique(axis=0)`` sorts a
    structured view and holds the lock throughout).
    """
    n = bits.shape[0]
    if weights is None:
        weights = np.ones((n, 1), dtype=np.int32)
    if weights.ndim == 1:
        weights = weights[:, None]
    if n == 0:
        return (np.zeros(bits.shape, np.uint32),
                np.zeros((0, weights.shape[1]), np.int32))
    # np.lexsort's primary key is its last: word 0
    order = (np.lexsort(bits.T[::-1]) if bits.shape[1]
             else np.arange(n))
    rows = bits[order]
    first = np.ones(n, dtype=bool)
    np.any(rows[1:] != rows[:-1], axis=1, out=first[1:])
    starts = np.flatnonzero(first)
    agg = np.add.reduceat(weights[order].astype(np.int64), starts, axis=0)
    if np.any(agg > np.iinfo(np.int32).max):
        raise OverflowError("per-row class weights exceed int32")
    return rows[starts].astype(np.uint32), agg.astype(np.int32)


def class_weights(classes: Sequence[int], n_classes: int = 2) -> np.ndarray:
    """One-hot (N, C) int32 class indicator — the multi-class counter columns
    (paper §4.1: 'per class counters on each node of a single tree')."""
    y = np.asarray(classes, dtype=np.int64)
    if y.min() < 0 or y.max() >= n_classes:
        raise ValueError("class id out of range")
    out = np.zeros((y.shape[0], n_classes), dtype=np.int32)
    out[np.arange(y.shape[0]), y] = 1
    return out


def project_columns(
    bits: np.ndarray,
    vocab: ItemVocab,
    keep_items: Sequence[Item],
) -> Tuple[np.ndarray, ItemVocab]:
    """GFP data-reduction (#4) analogue: repack keeping only ``keep_items``.

    Preserves the relative (support-descending) order of the kept items.
    -> (projected (N, W') uint32, sub-vocab)
    """
    keep = [a for a in vocab.items if a in set(keep_items)]
    sub = ItemVocab(tuple(keep))
    cols = np.array([vocab.col(a) for a in keep], dtype=np.int64)
    n = bits.shape[0]
    out = np.zeros((n, sub.n_words), dtype=np.uint32)
    for new_c, old_c in enumerate(cols):
        bit = (bits[:, old_c >> 5] >> np.uint32(old_c & 31)) & np.uint32(1)
        out[:, new_c >> 5] |= bit.astype(np.uint32) << np.uint32(new_c & 31)
    return out, sub


def pad_words(bits: np.ndarray, n_words: int) -> np.ndarray:
    """Zero-extend packed rows (N, W) -> (N, n_words).

    A tail-extended vocab (``extend_vocab``) only APPENDS bit columns, so rows
    encoded under the old vocab stay valid at the new width with zero bits in
    the new columns — this is the re-encode-free append path of the serving
    store."""
    w = bits.shape[1]
    if w == n_words:
        return bits
    if w > n_words:
        raise ValueError(f"cannot shrink packed rows from {w} to {n_words} words")
    out = np.zeros((bits.shape[0], n_words), dtype=np.uint32)
    out[:, :w] = bits
    return out


def extend_vocab(
    transactions: Sequence[Sequence[Item]],
    vocab: ItemVocab,
) -> ItemVocab:
    """Tail-extend ``vocab`` with items unseen so far (incremental appends).

    Existing items keep their bit columns (already-encoded rows stay valid —
    see ``pad_words``); new items are appended batch-frequency-descending,
    mirroring the ``IncrementalMiner`` tail extension of its ``ItemOrder``.
    Returns ``vocab`` itself when the batch introduces nothing new.
    """
    # one set operation finds what is new; rows are walked item by item only
    # when something is (an append of known items costs no per-item lookup)
    new = set(chain.from_iterable(transactions)).difference(vocab._index())
    if not new:
        return vocab
    counts: Dict[Item, int] = dict.fromkeys(new, 0)
    for t in transactions:
        for a in new.intersection(t):
            counts[a] += 1
    new = sorted(counts, key=lambda a: (-counts[a], repr(a)))
    return ItemVocab(vocab.items + tuple(new))


def decode_row(row: np.ndarray, vocab: ItemVocab) -> List[Item]:
    """Inverse of encode for tests/debug."""
    out: List[Item] = []
    for c, a in enumerate(vocab.items):
        if (int(row[c >> 5]) >> (c & 31)) & 1:
            out.append(a)
    return out
