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
import time
from dataclasses import dataclass, replace
from typing import (Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.mra import Rule
from ..core.tis import TISTree
from ..kernels import mra_encode as mra_kernels
from ..obs import REGISTRY, TRACER
from .backend import DenseBackend, backend_of
from .encode import (FlatRows, ItemVocab, class_weights, dedup_rows,
                     encode_bitmap, encode_targets, flatten_rows,
                     project_columns, walk_rows)
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
    use_kernel: bool = True,
    device: DeviceLike = None,
):
    """Passes 1 and 2 of the MRA: keep the items frequent in the rare class
    (ordered by descending total count) and encode the DB once with two
    weight columns (C0, C1).  Returns ``(db, items_kept, n_rare)``: a
    ``StreamingDB`` when the engine streams, else a ``DenseDB``.  The rows
    are walked once; both passes work on the flat arrays.

    On a CUDA device (unless ``use_kernel`` is False) the host only walks
    the rows and the card does the rest with the kernels of
    ``kernels/mra_encode``: pass 1 (``_scan_on_device``) and, when the
    dense engine is chosen, pass 2's pack and the row dedup
    (``_dense_on_device``).  Otherwise numpy runs pass 1 (``_scan_on_host``)
    and pass 2 is ``DenseDB.encode`` or ``StreamingDB.encode`` on the host
    (a streaming job on the card reads pass 1's distinct pairs back for
    it).  Every route gives the same DB byte for byte.  The whole encode,
    freeing the arrays included, is the span ``mra.encode``; its attribute
    ``route`` and the counter ``mra_encode_route_total{route=...}`` name
    where the DB was built: "device" or "host"."""
    with TRACER.span("mra.encode") as sp:
        db, items_kept, n_rare, route = _mra_encode(
            transactions, classes, target_class, min_support, streaming,
            chunk_rows, checkpoint, use_kernel, device)
        sp.set("route", route)
        _M_ROUTE[route].inc()
        return db, items_kept, n_rare


_M_ROUTE = {r: REGISTRY.counter("mra_encode_route_total", route=r)
            for r in ("device", "host")}


def _first_equal(row, item):
    """The first object of ``row`` equal to ``item``, as a set of the row
    keeps it."""
    return next(a for a in row if a is item or a == item)


def _mra_encode(transactions, classes, target_class, min_support, streaming,
                chunk_rows, checkpoint, use_kernel, device):
    dev = resolve_device(device)
    rare = np.asarray(classes) == target_class
    n_rare = int(rare.sum())
    on_card = dev.type == "cuda" and use_kernel
    # ---- pass 1: I' = items frequent in the rare class ----------------------
    scan = (_scan_on_device(transactions, rare, min_support, dev) if on_card
            else _scan_on_host(transactions, rare, min_support))
    items_kept, n_db = scan.items_kept, scan.n_rows

    # ---- pass 2: one encoded DB, two weight columns (C0, C1) ---------------
    # the engine is chosen before encoding, on an estimate of the size
    vocab = ItemVocab(tuple(items_kept))
    est = n_db * 4 * (max(1, (len(items_kept) + 31) // 32) + 2)
    y01 = rare.astype(np.int64)
    if _stream_decision(streaming, chunk_rows, checkpoint, est):
        db = StreamingDB.encode(scan.flat(), classes=y01, n_classes=2,
                                vocab=vocab, chunk_rows=chunk_rows, device=dev)
    elif on_card:
        return _dense_on_device(scan, vocab, dev), items_kept, n_rare, \
            "device"
    else:
        db = DenseDB.encode(scan.flat(), classes=y01, n_classes=2,
                            vocab=vocab, device=dev)
    return db, items_kept, n_rare, "host"


@dataclass
class _Scan:
    """Pass 1's result: the kept items' ids (in the walk's numbering) in
    the global order, the items, the rows counted, the distinct (item, row)
    pairs sorted by item then row as host ``FlatRows`` (``flat()``) and,
    when pass 1 ran on the card, the walked arrays there for pass 2."""
    order: List[int]
    items_kept: List[Item]
    n_rows: int
    n_ids: int                       # walked ids
    flat: Callable[[], FlatRows]
    card: Optional[Tuple[torch.Tensor, ...]] = None   # ids, offsets, rare


def _kept_items(c_all, c1, first_rare, items, source, n_db: int,
                min_support: float) -> Tuple[List[int], List[Item]]:
    """Pass 1's verdict from its per-item counts (host arrays over every
    walked id: all rows, rare-class rows, the first rare-class row holding
    it): I' = the items frequent in the rare class, in the global order
    (total count descending, then ``repr``).  -> (their ids, the items),
    each item as the object first seen in a rare-class row."""
    kept = np.flatnonzero((c1 > 0) & (c1 >= min_support * n_db))
    kept_obj = {k: _first_equal(source[first_rare[k]], items[k])
                for k in kept.tolist()}
    order = sorted(kept_obj, key=lambda k: (-int(c_all[k]),
                                            repr(kept_obj[k])))
    return order, [kept_obj[k] for k in order]


def _distinct_pairs(flat: FlatRows) -> FlatRows:
    """``flat`` holding each distinct (item, row) pair once, sorted by item
    then row: set semantics.  (A sort of the keys ``id * N + row``, not
    np.unique: NumPy 2.3's np.unique takes 60x as long on a 1M-row table's
    keys.)"""
    keys = flat.ids.astype(np.int64)
    keys *= flat.n_rows
    keys += flat.rows
    keys.sort()
    new = np.ones(keys.size, bool)
    np.not_equal(keys[1:], keys[:-1], out=new[1:])
    ids, rows = np.divmod(keys[new], max(flat.n_rows, 1))
    return replace(flat, ids=ids, rows=rows)


def _scan_attrs(items_kept, items_in: int, n_pairs: int) -> dict:
    return {"items_kept": len(items_kept), "items_in": items_in,
            "repeats_dropped": items_in - n_pairs}


def _scan_on_host(transactions, rare: np.ndarray, min_support: float
                  ) -> _Scan:
    """Pass 1 in numpy, the walk included: the span ``mra.scan``."""
    with TRACER.span("mra.scan") as sp:
        flat = flatten_rows(transactions)
        n_db, n_ids, items_in = flat.n_rows, len(flat.items), flat.ids.size
        flat = _distinct_pairs(flat)
        ids, rows = flat.ids, flat.rows
        in_rare = rare[rows]
        c_all = np.bincount(ids, minlength=n_ids)
        rare_ids, rare_rows = ids[in_rare], rows[in_rare]
        c1 = np.bincount(rare_ids, minlength=n_ids)
        head = np.ones(rare_ids.size, bool)
        head[1:] = rare_ids[1:] != rare_ids[:-1]
        first_rare = np.zeros(n_ids, np.int64)
        first_rare[rare_ids[head]] = rare_rows[head]
        order, items_kept = _kept_items(c_all, c1, first_rare, flat.items,
                                        flat.source, n_db, min_support)
        for k, v in _scan_attrs(items_kept, items_in, ids.size).items():
            sp.set(k, v)
    return _Scan(order, items_kept, n_db, n_ids, lambda: flat)


def _scan_on_device(transactions, rare: np.ndarray, min_support: float,
                    dev: torch.device) -> _Scan:
    """Pass 1 after the host's walk, on ``dev`` (``kernels/mra_encode``):
    the walked ids, the row offsets and the rare-class flags are copied
    once (``encode.upload``); each row's ids are sorted in place and its
    distinct items counted, read back to choose the items on the host
    (``mra.scan``, filed from the walk's start: it spans the upload).
    Memory grows with the occurrences, not with the walked vocabulary."""
    t0 = time.perf_counter()
    walk = walk_rows(transactions)
    n_db, n_ids = len(walk.lengths), len(walk.items)
    if n_db > np.iinfo(np.int32).max:    # a row weighs 1 in one class
        raise OverflowError("per-row class weights exceed int32")
    with TRACER.span("encode.upload"):
        offsets = np.zeros(n_db + 1, np.int64)
        np.cumsum(walk.lengths, out=offsets[1:])
        ids = torch.from_numpy(walk.ids).to(dev)
        offsets = torch.from_numpy(offsets).to(dev)
        rare_d = torch.from_numpy(rare.view(np.uint8)).to(dev)
    counts = mra_kernels.count_rows(ids, offsets, rare_d, n_ids)
    c_all, c1, tag = counts.cpu().numpy()
    order, items_kept = _kept_items(c_all, c1, n_db - tag, walk.items,
                                    walk.source, n_db, min_support)
    TRACER.record("mra.scan", t0, time.perf_counter(),
                  _scan_attrs(items_kept, int(walk.ids.size),
                              int(c_all.sum())))
    # a streaming pass 2 takes the host's pairs
    return _Scan(order, items_kept, n_db, n_ids,
                 lambda: _distinct_pairs(walk.flat()), (ids, offsets, rare_d))


def _sync(dev: torch.device) -> None:
    """Ends a span with the device work it enqueued."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _dense_on_device(scan: _Scan, vocab: ItemVocab, dev: torch.device
                     ) -> DenseDB:
    """Pass 2 and the row dedup on ``dev``, from ``_scan_on_device``'s
    walked arrays: each row's kept items are packed into bits, the kept
    columns in their order (``encode.bitmap``); the rows are sorted, and
    each run of equal rows is kept once with its class weights
    (``encode.dedup``).  Each span ends when its device work has.  The DB
    equals ``DenseDB.encode``'s over the same vocabulary byte for byte,
    rows in ``dedup_rows``' order.  A kernel a stage: a table of 20,000
    rows costs as many launches as one of a million."""
    ids, offsets, rare_d = scan.card
    n_db = scan.n_rows
    with TRACER.span("encode.bitmap"):
        cols = np.full(scan.n_ids, -1, np.int32)     # walked id -> column
        cols[scan.order] = np.arange(len(scan.order), dtype=np.int32)
        words, keys = mra_kernels.pack_rows(ids, offsets,
                                            torch.from_numpy(cols).to(dev),
                                            vocab.n_words)
        _sync(dev)
    with TRACER.span("encode.dedup") as sp:
        # ascending by word 0, then word 1, ... as unsigned (``dedup_rows``'
        # order): stable sorts by each key (a pair of words), last pair first
        perm = None
        for p in range(keys.shape[0] - 1, -1, -1):
            idx = torch.argsort(keys[p] if perm is None else keys[p][perm],
                                stable=True)
            perm = idx if perm is None else perm[idx]
        head = mra_kernels.row_heads(words, perm)
        run = head.cumsum(0, dtype=torch.int32)
        runs = int(run[-1]) if n_db else 0
        bits, weights = mra_kernels.gather_rows(words, perm, run, head,
                                                rare_d, runs)
        _sync(dev)
        sp.set("rows_in", n_db)
        sp.set("rows_out", runs)
    return DenseDB(vocab=vocab, bits=bits.view(torch.uint32),
                   weights=weights, n_rows=n_db, n_classes=2)


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
        checkpoint=checkpoint, use_kernel=use_kernel, device=device)
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
