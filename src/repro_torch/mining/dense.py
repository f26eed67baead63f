"""Dense (device-resident) GFP-growth engine and dense Minority-Report.

Three entry points:

  * ``dense_gfp_counts``     — the GFP-growth contract: given a TIS-tree and an
    encoded database, return the exact count of every target (per class).
    One fused kernel pass over a column-projected, deduped bitmap.
  * ``dense_mine_frequent``  — level-synchronous frequent-itemset mining on the
    device (Apriori-shaped candidate levels, kernel counting, host pruning);
    used for antecedent discovery on the (small) rare class.
  * ``minority_report_dense``— the MRA pipeline on the dense engine: one fused
    two-class counting pass replaces the separate FP-growth(FP1)+GFP(FP0)
    mining of the big tree.

All counts are exact; tests cross-validate against the host-faithful core and
the brute-force oracle.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Hashable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.mra import Rule
from ..core.tis import TISTree
from ..obs import TRACER
from .backend import DenseBackend, backend_of
from .encode import (FlatRows, ItemVocab, class_weights, dedup_rows,
                     encode_bitmap, encode_targets, flatten_rows,
                     project_columns)
from .stream import (DEFAULT_STREAM_THRESHOLD_BYTES, StreamingDB, _host,
                     streaming_mine_frequent)

Item = Hashable


def _stream_decision(streaming: Optional[bool], chunk_rows: Optional[int],
                     checkpoint, nbytes: Optional[int]) -> bool:
    """The engine choice, made here for every caller: an explicit flag
    wins, then ``chunk_rows`` or a checkpoint opt in, then ``nbytes`` (the
    encoded size, known or estimated before encoding; None for rows already
    on the device) past the size threshold."""
    if checkpoint is not None and streaming is False:
        raise ValueError("per-chunk checkpointing requires the streaming "
                         "engine; drop streaming=False or the checkpoint")
    if streaming is not None:
        return streaming
    if chunk_rows is not None or checkpoint is not None:
        return True
    return nbytes is not None and nbytes > DEFAULT_STREAM_THRESHOLD_BYTES


def _resolve_streaming(db, streaming: Optional[bool],
                       chunk_rows: Optional[int] = None,
                       checkpoint=None) -> bool:
    """Engine selection over an encoded DB.  A StreamingDB always streams;
    otherwise ``_stream_decision``, sized only for host-resident (numpy)
    bits.  A DenseDB (tensor bits) never auto-streams: its allocation
    already succeeded, and streaming it would only add a D2H copy +
    re-upload (size-based selection belongs BEFORE encoding — see
    ``mra_encode``)."""
    nbytes = ((db.bits.size + db.weights.size) * 4
              if isinstance(db.bits, np.ndarray) else None)
    stream = _stream_decision(streaming, chunk_rows, checkpoint, nbytes)
    return stream or isinstance(db, StreamingDB)


def _streaming_form(db, chunk_rows: Optional[int]) -> StreamingDB:
    """``db`` as a StreamingDB swept at ``chunk_rows`` (None keeps a
    StreamingDB's own grid, or sizes one for a host view of a DenseDB)."""
    sdb = (db if isinstance(db, StreamingDB)
           else StreamingDB.from_dense(db, chunk_rows))
    if chunk_rows and sdb.chunk_rows != chunk_rows:
        sdb = replace(sdb, chunk_rows=chunk_rows)
    return sdb


def _to(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_host(a)).to(device)


@dataclass
class DenseDB:
    """Encoded, deduped, class-weighted transaction database on device."""
    vocab: ItemVocab
    bits: torch.Tensor     # (U, W) uint32 unique rows
    weights: torch.Tensor  # (U, C) int32 per-class multiplicities
    n_rows: int            # original N (sum of weights)
    n_classes: int

    @staticmethod
    def encode(
        transactions: Union[Sequence[Sequence[Item]], FlatRows],
        classes: Optional[Sequence[int]] = None,
        n_classes: Optional[int] = None,
        vocab: Optional[ItemVocab] = None,
        min_item_count: int = 1,
        *,
        device: DeviceLike = None,
    ) -> "DenseDB":
        """``transactions`` may be rows already walked (``FlatRows``), when
        ``vocab`` is given."""
        dev = resolve_device(device)
        if vocab is None:
            vocab = ItemVocab.from_transactions(transactions, min_count=min_item_count)
        with TRACER.span("encode.bitmap"):
            bits = encode_bitmap(transactions, vocab)
            if classes is None:
                w = np.ones((len(transactions), 1), np.int32)
                n_classes = 1
            else:
                n_classes = n_classes or (int(max(classes)) + 1)
                w = class_weights(classes, n_classes)
        with TRACER.span("encode.dedup") as sp:
            ub, uw = dedup_rows(bits, w)
            sp.set("rows_in", bits.shape[0])
            sp.set("rows_out", ub.shape[0])
        with TRACER.span("encode.upload"):
            db_bits, db_weights = _to(ub, dev), _to(uw, dev)
        return DenseDB(vocab=vocab, bits=db_bits, weights=db_weights,
                       n_rows=len(transactions), n_classes=n_classes)

    @staticmethod
    def from_arrays(vocab: ItemVocab, bits, weights, n_rows: int,
                    n_classes: int, *, device: DeviceLike = None
                    ) -> "DenseDB":
        """Wrap already-encoded/deduped arrays: uploads host arrays to the
        device without re-encoding."""
        dev = resolve_device(device)
        return DenseDB(vocab=vocab, bits=_to(bits, dev),
                       weights=_to(weights, dev), n_rows=n_rows,
                       n_classes=n_classes)

    def project(self, keep_items: Sequence[Item]) -> "DenseDB":
        """Column projection + re-dedup (GFP data reduction, dense form)."""
        dev = self.bits.device
        proj, sub = project_columns(_host(self.bits), self.vocab, keep_items)
        ub, uw = dedup_rows(proj, _host(self.weights))
        return DenseDB(vocab=sub, bits=_to(ub, dev), weights=_to(uw, dev),
                       n_rows=self.n_rows, n_classes=self.n_classes)


def dense_gfp_counts(
    tis: TISTree,
    db,                       # DenseDB | StreamingDB
    *,
    use_kernel: bool = True,
    project: bool = True,
    streaming: Optional[bool] = None,
    chunk_rows: Optional[int] = None,
) -> Dict[Tuple[Item, ...], np.ndarray]:
    """GFP-growth contract on the dense engine.

    Returns {sorted-itemset-tuple -> (C,) int32 per-class counts} for every
    *target* node of the TIS-tree (items missing from the DB vocab yield 0,
    matching the paper's note that such targets never appear in the FP-tree).
    ``streaming`` selects the out-of-core chunked sweep (None = auto by DB
    size; always on for a ``StreamingDB``) — counts are bit-identical.
    """
    targets: List[Tuple[Item, ...]] = []
    keys: List[Tuple[Item, ...]] = []
    zero_keys: List[Tuple[Item, ...]] = []
    for node in tis.targets():
        itemset = node.itemset()
        key = tuple(sorted(itemset, key=repr))
        if all(a in db.vocab for a in itemset):
            targets.append(itemset)
            keys.append(key)
        else:
            zero_keys.append(key)

    out: Dict[Tuple[Item, ...], np.ndarray] = {
        k: np.zeros(db.n_classes, np.int32) for k in zero_keys
    }
    if not targets:
        return out

    work_db = db
    if project:
        union: set = set()
        for t in targets:
            union |= set(t)
        work_db = db.project(sorted(union, key=repr))

    if _resolve_streaming(db, streaming, chunk_rows):
        work_db = _streaming_form(work_db, chunk_rows)
    masks = encode_targets(targets, work_db.vocab)
    counts = backend_of(work_db, use_kernel=use_kernel).counts(masks)
    for key, row in zip(keys, counts):
        out[key] = row
    return out


def dense_mine_frequent(
    db,                       # DenseDB | StreamingDB
    min_count: float,
    *,
    class_column: Optional[int] = None,
    max_len: int = 0,
    use_kernel: bool = True,
    streaming: Optional[bool] = None,
    chunk_rows: Optional[int] = None,
    checkpoint=None,          # Optional[MiningCheckpoint] (streaming path)
    on_chunk=None,            # streaming progress hook: (level, chunk_idx)
) -> Dict[Tuple[Item, ...], int]:
    """Level-synchronous exact frequent-itemset mining on the device.

    A shim over the unified driver (``mining/driver.py``): candidate level
    k+1 is generated (host) from frequent level k via prefix join +
    anti-monotone prune; each level is counted in ONE kernel launch — the
    §5.1 'single guided invocation per level' realized densely (level 1
    too: the V single-item masks in one launch).  ``class_column`` restricts
    support to one weight column (rare class).

    The streaming path (``streaming=True``, a ``StreamingDB`` input, an
    auto-selected large DB, or any ``checkpoint``) runs the same driver over
    the out-of-core backend: each level's counts sweep in N-chunks with
    per-chunk durable progress, so a killed mine resumes mid-level (see
    ``streaming_mine_frequent``).
    """
    from .driver import mine_frequent as _driver_mine

    if _resolve_streaming(db, streaming, chunk_rows, checkpoint):
        return streaming_mine_frequent(
            _streaming_form(db, chunk_rows), min_count,
            class_column=class_column, max_len=max_len,
            use_kernel=use_kernel, checkpoint=checkpoint, on_chunk=on_chunk)

    return _driver_mine(DenseBackend(db, use_kernel=use_kernel), min_count,
                        class_column=class_column, max_len=max_len)


@dataclass
class DenseMRAResult:
    rules: List[Rule]
    items_kept: List[Item]
    n_db: int
    n_rare: int
    kernel_launches: int
    engine: str = "dense"


def _crosscheck_fused(itemset, fused_count: int, discovered_count: int,
                      engine: str) -> None:
    """Exactness cross-check: the fused two-class count of an antecedent
    must equal the count the discovery mine produced for the same itemset.
    A mismatch means a kernel/engine exactness bug, not bad user input — a
    raised error, so it survives ``python -O``."""
    if fused_count != discovered_count:
        raise RuntimeError(
            f"minority_report_dense: fused C1 count {fused_count} for "
            f"antecedent {itemset!r} != discovery count "
            f"{discovered_count} (engine={engine}) — exactness violation")


def mra_encode(
    transactions: Sequence[Sequence[Item]],
    classes: Sequence[int],
    *,
    target_class: int = 1,
    min_support: float,
    streaming: Optional[bool] = None,
    chunk_rows: Optional[int] = None,
    checkpoint=None,
    device: DeviceLike = None,
):
    """Passes 1 and 2 of the MRA: keep the items frequent in the rare class
    (ordered by descending total count) and encode the DB once with two
    weight columns (C0, C1).  Returns ``(db, items_kept, n_rare)``: a
    ``StreamingDB`` when the engine streams, else a ``DenseDB``.  The rows
    are walked once (``flatten_rows``); both passes work on the flat
    arrays.  The whole encode, freeing those arrays included, is the span
    ``mra.encode``."""
    with TRACER.span("mra.encode"):
        return _mra_encode(transactions, classes, target_class, min_support,
                           streaming, chunk_rows, checkpoint, device)


def _first_equal(row, item):
    """The first object of ``row`` equal to ``item``, as a set of the row
    keeps it."""
    return next(a for a in row if a is item or a == item)


def _mra_encode(transactions, classes, target_class, min_support, streaming,
                chunk_rows, checkpoint, device):
    dev = resolve_device(device)
    # ---- pass 1: I' = items frequent in the rare class ----------------------
    with TRACER.span("mra.scan") as sp:
        flat = flatten_rows(transactions)
        n_db, n_ids = flat.n_rows, len(flat.items)
        rare = np.asarray(classes) == target_class
        n_rare = int(rare.sum())
        y01 = rare.astype(np.int64)
        # set semantics: each distinct (item, row) pair once, sorted by item
        # (a sort, not np.unique: NumPy 2.3's np.unique takes 60x as long on
        # a 1M-row table's keys)
        pairs = flat.ids.astype(np.int64)
        pairs *= n_db
        pairs += flat.rows
        pairs.sort()
        new = np.ones(pairs.size, bool)
        np.not_equal(pairs[1:], pairs[:-1], out=new[1:])
        pairs = pairs[new]
        ids, rows = np.divmod(pairs, max(n_db, 1))
        in_rare = rare[rows]
        c_all = np.bincount(ids, minlength=n_ids)
        rare_ids, rare_rows = ids[in_rare], rows[in_rare]
        c1 = np.bincount(rare_ids, minlength=n_ids)
        kept = np.flatnonzero((c1 > 0) & (c1 >= min_support * n_db))
        # each kept item as the object first seen in a rare-class row
        head = np.ones(rare_ids.size, bool)
        head[1:] = rare_ids[1:] != rare_ids[:-1]
        first_rare = np.zeros(n_ids, np.int64)
        first_rare[rare_ids[head]] = rare_rows[head]
        kept_obj = {k: _first_equal(flat.source[first_rare[k]], flat.items[k])
                    for k in kept.tolist()}
        order = sorted(kept_obj, key=lambda k: (-int(c_all[k]),
                                                repr(kept_obj[k])))
        items_kept = [kept_obj[k] for k in order]  # global order
        vocab = ItemVocab(tuple(items_kept))
        sp.set("items_kept", len(items_kept))
        sp.set("items_in", int(flat.ids.size))
        sp.set("repeats_dropped", int(flat.ids.size - pairs.size))
        flat = replace(flat, ids=ids, rows=rows)

    # ---- pass 2: one encoded DB, two weight columns (C0, C1) ---------------
    # the engine is chosen before encoding, on an estimate of the size
    est = n_db * 4 * (max(1, (len(items_kept) + 31) // 32) + 2)
    if _stream_decision(streaming, chunk_rows, checkpoint, est):
        db = StreamingDB.encode(flat, classes=y01, n_classes=2, vocab=vocab,
                                chunk_rows=chunk_rows, device=dev)
    else:
        db = DenseDB.encode(flat, classes=y01, n_classes=2, vocab=vocab,
                            device=dev)
    return db, items_kept, n_rare


def minority_report_dense(
    transactions: Sequence[Sequence[Item]],
    classes: Sequence[int],
    *,
    target_class: int = 1,
    min_support: float,
    min_confidence: float,
    use_kernel: bool = True,
    streaming: Optional[bool] = None,
    chunk_rows: Optional[int] = None,
    checkpoint=None,          # Optional[MiningCheckpoint] (streaming path)
    device: DeviceLike = None,
) -> DenseMRAResult:
    """MRA on the dense engine (see module docstring).

    ``streaming=True`` (or auto, by encoded size) runs both the antecedent
    mine and the fused two-class pass as chunked out-of-core sweeps — the
    rule list is identical to the single-pass engine.  ``device`` is where
    the counts run (default: the card).  The whole job is the span
    ``mra.job``.
    """
    with TRACER.span("mra.job"):
        return _minority_report_dense(
            transactions, classes, target_class, min_support, min_confidence,
            use_kernel, streaming, chunk_rows, checkpoint, device)


def _minority_report_dense(transactions, classes, target_class, min_support,
                           min_confidence, use_kernel, streaming, chunk_rows,
                           checkpoint, device) -> DenseMRAResult:
    db, items_kept, n_rare = mra_encode(
        transactions, classes, target_class=target_class,
        min_support=min_support, streaming=streaming, chunk_rows=chunk_rows,
        checkpoint=checkpoint, device=device)
    stream = isinstance(db, StreamingDB)
    vocab = db.vocab
    n_db = db.n_rows
    min_count = max(1, math.ceil(min_support * n_db - 1e-9))

    # ---- antecedent discovery on the rare class (small) ---------------------
    launches = 0
    chunk_counter = [0]
    freq1 = dense_mine_frequent(
        db, min_count, class_column=1, use_kernel=use_kernel, streaming=stream,
        chunk_rows=chunk_rows, checkpoint=checkpoint,
        on_chunk=(lambda lvl, j: chunk_counter.__setitem__(
            0, chunk_counter[0] + 1)) if stream else None)
    if stream:
        launches += chunk_counter[0]  # exact: one launch per swept chunk
    else:
        # as the JAX package computes it, so results compare equal; it
        # misses level 1's launch and, when that level has no frequent
        # itemset, the last counted level's too (ROADMAP §3) —
        # ``ops.KERNEL_LAUNCHES`` is the measured count
        launches += max(0, max((len(k) for k in freq1), default=1) - 1)
    engine = "streaming" if stream else "dense"

    if not freq1:
        return DenseMRAResult([], items_kept, n_db, n_rare, launches, engine)

    # ---- fused counting of (C0, C1) for all antecedents ----------------------
    with TRACER.span("mra.fused", {"n_antecedents": len(freq1)}):
        itemsets = sorted(freq1.keys())
        masks = encode_targets(itemsets, vocab)
        fused = backend_of(db, use_kernel=use_kernel)
        counts = fused.counts(masks)
    launches += fused.n_count_chunks

    with TRACER.span("mra.rules"):
        rules: List[Rule] = []
        for itemset, row in zip(itemsets, counts):
            c0_, c1_ = int(row[0]), int(row[1])
            _crosscheck_fused(itemset, c1_, freq1[itemset], engine)
            conf = c1_ / (c1_ + c0_) if (c0_ + c1_) else 0.0
            if conf >= min_confidence:
                rules.append(Rule(itemset, target_class, c1_ / n_db, conf,
                                  c1_, c0_))
        rules.sort(key=lambda r: (-r.confidence, -r.support, r.antecedent))
    return DenseMRAResult(rules, items_kept, n_db, n_rare, launches, engine)
