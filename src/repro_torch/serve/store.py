"""Versioned resident encoded DB — the serving-side state of the count server.

The paper frames multitude-targeted mining as answering "the count of a given
large list of itemsets" — a query workload.  ``VersionedDB`` keeps one encoded
bitmap RESIDENT between queries (the serving analogue of the encoded-DB
technique of Danessh et al. 2010) instead of re-encoding per call:

  * the **base** segment is a device ``DenseDB``, host ``StreamingDB``, or
    disk ``SpilledDB`` (``mining/spill.py``: mmap segment files + async
    prefetch), selected by encoded size (same threshold discipline as the
    mining stack; the spill tier needs a configured ``spill_dir`` and engages
    past ``spill_threshold_bytes`` of host RAM);
  * ``append(transactions)`` encodes a new batch under a TAIL-EXTENDED vocab
    (existing bit columns never move, so resident rows stay valid without
    re-encoding), dedups it within itself, adds it to the tail **delta**
    segment (:class:`DeltaSegment`, a growing host buffer whose device mirror
    grows by the rows appended since the last count), and bumps the
    monotonically increasing ``version``.  An append costs its batch, never
    the delta: rows repeated across batches are merged at the fold;
  * the delta is folded into the base (full re-dedup + residency reselection)
    once its row count (appended rows, each batch deduped within itself)
    passes ``merge_ratio`` of the base's distinct rows AND the
    ``min_compact_rows`` floor (a cold store must not pay a full rebuild per
    tiny append) — until then every counting sweep COMPOSES base + delta:
    counts are int32 sums, so the composition is bit-identical to a fresh
    encode of the concatenated history.  With ``background_compaction=True``
    the fold runs on an :class:`~repro_torch.serve.compactor.AsyncCompactor`
    thread: it snapshots the base and the delta's first rows under
    ``_store_lock``, builds the new base from them off-lock, and at commit
    installs it and keeps as the delta only the rows appended meanwhile, so
    ``append`` returns without paying it and the fold commits under steady
    appends;
  * ``counts`` / ``counts_masks`` answer a (K, W) target block with (K, C)
    per-class counts, exact at the current version.

``version`` is the cache key half of the serving cache (``serve.cache``): any
append invalidates by construction, and pure compaction does NOT bump the
version because it cannot change any count.

The device: every base, the delta's mirror and every count run on the
store's ``device`` (the card unless the caller passes ``"cpu"``), pinned to
a card index at construction so that the compactor and flusher threads count
on the same card as the caller.  A dense base and the delta mirror are
tensors there; a flush copies its (K, C) block back to the host explicitly,
and a compaction copies the whole base back (a D2H copy of a dense base, a
read of every segment of a spilled one).  The spill root, when none is
given, is ``$REPRO_TORCH_SPILL_DIR`` (the JAX package reads
``$REPRO_SPILL_DIR``).

``serve.shard.ShardedDB`` scales this store past one device: row-partitioned
``VersionedDB`` shards behind one logical version, counts all-reduced — the
same additivity argument that makes the base+delta composition below exact.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Hashable, Optional, Sequence

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..mining.backend import CountBackend, backend_of, count_resident
from ..obs import REGISTRY, TRACER
from ..mining.dense import DenseDB
from ..mining.encode import (ItemVocab, class_weights, dedup_rows,
                             encode_bitmap, extend_vocab, pad_words)
from ..mining.spill import DEFAULT_SPILL_THRESHOLD_BYTES, SpilledDB
from ..mining.stream import StreamingDB, _host
from .compactor import AsyncCompactor

Item = Hashable

# Auto-compaction floor: below this many delta rows an append never triggers
# the fold, whatever merge_ratio says — a cold/tiny base would otherwise pay
# a full re-dedup + residency rebuild on EVERY append (bootstrap thrash).
# Explicit compact() calls ignore the floor.
DEFAULT_MIN_COMPACT_ROWS = 1024

_M_APPENDS = REGISTRY.counter("store_appends_total")
_M_APPEND_ROWS = REGISTRY.counter("store_appended_rows_total")
_M_COMPACTIONS = REGISTRY.counter("store_compactions_total")
_M_FAILED_COMPACTIONS = REGISTRY.counter("store_failed_compactions_total")
_M_DISCARDED_COMPACTIONS = REGISTRY.counter(
    "store_discarded_compactions_total")
_G_DELTA_ROWS = REGISTRY.gauge("store_delta_rows")
_H_APPEND_MS = REGISTRY.histogram("store_append_ms")


def check_class_labels(classes: Optional[Sequence[int]],
                       n_classes: Optional[int]) -> int:
    """Validate class labels BEFORE any store state is touched; returns the
    resolved ``n_classes``.

    A negative label (or a label ≥ an explicitly passed ``n_classes``) must
    raise the documented no-trace ``ValueError`` here, at the store boundary —
    not deep inside ``class_weights`` after vocab/total bookkeeping has begun,
    and never by scattering out of bounds or silently truncating a
    non-integral label."""
    if n_classes is not None and n_classes <= 0:
        raise ValueError(f"n_classes must be positive, got {n_classes}")
    if classes is not None and len(classes):
        y = np.asarray(classes)
        yi = y.astype(np.int64)
        if not np.array_equal(yi, y):
            raise ValueError("class labels must be integers")
        lo, hi = int(yi.min()), int(yi.max())
        if lo < 0:
            raise ValueError(f"negative class label {lo}")
        if n_classes is None:
            n_classes = hi + 1
        elif hi >= n_classes:
            raise ValueError(
                f"class label {hi} out of range for n_classes={n_classes}")
    return n_classes or 1


def store_device(device: DeviceLike = None) -> torch.device:
    """``resolve_device`` with a card index: ``"cuda"`` becomes the caller's
    current card, so threads that count for the store (which start on card
    0) reach the same one."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeltaSegment:
    """The rows appended since the last fold, each batch deduped within
    itself, in a host buffer that grows by doubling, and their mirror on
    ``device``, which grows by the rows appended since the last count.

    Rows below ``rows`` are never written again: a background fold reads a
    prefix of ``bits`` off the store lock while appends write past it (a
    full buffer or a wider vocabulary moves the rows to a new buffer and
    leaves the old one as it was)."""

    def __init__(self, n_words: int, n_classes: int, device: torch.device):
        self.rows = 0
        self.device = device
        self._bits = np.zeros((0, n_words), np.uint32)
        self._weights = np.zeros((0, n_classes), np.int32)
        self._mirror: Optional[tuple] = None   # (bits, weights) on device
        self._mirrored = 0

    @property
    def n_words(self) -> int:
        return int(self._bits.shape[1])

    @property
    def bits(self) -> np.ndarray:
        return self._bits[:self.rows]

    @property
    def weights(self) -> np.ndarray:
        return self._weights[:self.rows]

    def add(self, bits: np.ndarray, weights: np.ndarray) -> None:
        """Append a batch encoded at the store's current width (never
        narrower than the segment's)."""
        need = self.rows + int(bits.shape[0])
        w = max(self.n_words, int(bits.shape[1]))
        if w != self.n_words or need > self._bits.shape[0]:
            cap = max(need, 2 * self._bits.shape[0], 256)
            grown = np.zeros((cap, w), np.uint32)
            grown[:self.rows, :self.n_words] = self.bits
            gw = np.zeros((cap, self._weights.shape[1]), np.int32)
            gw[:self.rows] = self.weights
            if w != self.n_words:
                self._mirror, self._mirrored = None, 0   # re-laid in full
            self._bits, self._weights = grown, gw
        self._bits[self.rows:need, :bits.shape[1]] = bits
        self._weights[self.rows:need] = weights
        self.rows = need

    def tail(self, start: int) -> "DeltaSegment":
        """A new segment holding this one's rows from ``start`` on."""
        out = DeltaSegment(self.n_words, self._weights.shape[1], self.device)
        if start < self.rows:
            out.add(self.bits[start:], self.weights[start:])
        return out

    def on_device(self) -> tuple:
        """The rows as (bits, weights) tensors on the device: the mirror
        takes the rows appended since the last call, and is laid anew only
        when the host buffer was (it grew, or the vocabulary widened)."""
        if self._mirror is None or self._mirror[0].shape != self._bits.shape:
            bits = torch.empty(self._bits.shape, dtype=torch.uint32,
                               device=self.device)
            weights = torch.empty(self._weights.shape, dtype=torch.int32,
                                  device=self.device)
            if self._mirror is not None:
                bits[:self._mirrored].copy_(self._mirror[0][:self._mirrored])
                weights[:self._mirrored].copy_(
                    self._mirror[1][:self._mirrored])
            self._mirror = (bits, weights)
        if self._mirrored < self.rows:
            lo, hi = self._mirrored, self.rows
            self._mirror[0][lo:hi].copy_(torch.from_numpy(self._bits[lo:hi]))
            self._mirror[1][lo:hi].copy_(
                torch.from_numpy(self._weights[lo:hi]))
            self._mirrored = hi
        return self._mirror[0][:self.rows], self._mirror[1][:self.rows]


class VersionedDB:
    """Resident encoded bitmap + vocab with versioned incremental appends,
    counting on ``device`` (default: the card)."""

    def __init__(
        self,
        transactions: Sequence[Sequence[Item]] = (),
        classes: Optional[Sequence[int]] = None,
        n_classes: Optional[int] = None,
        vocab: Optional[ItemVocab] = None,
        *,
        use_kernel: bool = True,
        streaming: Optional[bool] = None,
        chunk_rows: Optional[int] = None,
        stream_threshold_bytes: Optional[int] = None,
        merge_ratio: float = 0.25,
        min_compact_rows: Optional[int] = None,
        spill: Optional[bool] = None,
        spill_dir: Optional[str] = None,
        spill_threshold_bytes: Optional[int] = None,
        background_compaction: bool = False,
        device: DeviceLike = None,
    ):
        self.device = store_device(device)
        self.n_classes = check_class_labels(classes, n_classes)
        self.use_kernel = use_kernel
        self.chunk_rows = chunk_rows
        self.merge_ratio = merge_ratio
        self.min_compact_rows = (DEFAULT_MIN_COMPACT_ROWS
                                 if min_compact_rows is None
                                 else int(min_compact_rows))
        self._streaming = streaming
        self._stream_threshold = stream_threshold_bytes
        # disk tier: spill=None engages past spill_threshold_bytes when a
        # directory is configured; True forces it; False disables it
        self._spill = spill
        self._spill_dir = (spill_dir if spill_dir is not None
                           else os.environ.get("REPRO_TORCH_SPILL_DIR"))
        self._spill_threshold = spill_threshold_bytes
        self._spill_gen = 0
        # one re-entrant lock over base/delta/counter state: cheap when
        # uncontended, required once the background compactor can race an
        # append or a composed sweep
        self._store_lock = threading.RLock()
        self.version = 0
        self.n_rows = 0
        self.kernel_launches = 0
        self.n_appends = 0
        self.n_compactions = 0
        self.n_failed_compactions = 0
        self.last_compaction_error: Optional[str] = None
        self._class_totals = np.zeros(self.n_classes, np.int64)
        # the adaptive chooser's residency decision for the CURRENT base
        # (None when residency was explicitly forced by the caller)
        self.backend_choice = None
        self._base_be: Optional[CountBackend] = None

        transactions = [list(t) for t in transactions]
        t0 = time.perf_counter()
        self.vocab = vocab if vocab is not None else \
            ItemVocab.from_transactions(transactions)
        t_vocab = time.perf_counter() - t0
        self._delta = DeltaSegment(self.vocab.n_words, self.n_classes,
                                   self.device)
        timings = {}
        ub, uw = self._encode_batch(transactions, classes, timings=timings)
        self._class_totals = self._guard_totals(
            self._class_totals + uw.sum(axis=0, dtype=np.int64))
        self.n_rows = len(transactions)
        t0 = time.perf_counter()
        self.base = self._make_base(ub, uw)
        # seconds of the construction's steps: the vocab and the bitmap
        # (encode), the row dedup, and the base (the residency choice and
        # the upload of a dense base, the spill of a spilled one)
        self.build_seconds = {"encode": t_vocab + timings["encode"],
                              "dedup": timings["dedup"],
                              "base": time.perf_counter() - t0}
        self._compactor: Optional[AsyncCompactor] = (
            AsyncCompactor(self) if background_compaction else None)

    def close(self) -> None:
        """Drain and stop the background compactor (if any).  The store
        stays fully usable afterwards (compaction reverts to inline)."""
        if self._compactor is not None:
            self._compactor.close()
            self._compactor = None

    @staticmethod
    def _guard_totals(totals: np.ndarray) -> np.ndarray:
        # largest possible count = per-class weight-column total; the int32
        # accumulator must hold it (construction AND every append)
        if np.any(totals > np.iinfo(np.int32).max):
            raise OverflowError(
                "per-class row totals would exceed int32; served counts "
                "could wrap — shard the store instead")
        return totals

    # -- encode ---------------------------------------------------------------
    def _encode_batch(self, transactions, classes, vocab=None, timings=None):
        if classes is None or len(transactions) == 0:
            if self.n_classes != 1 and len(transactions):
                # ones in EVERY class column would count each row per class
                raise ValueError(
                    "classes are required on a multi-class store "
                    f"(n_classes={self.n_classes})")
            w = np.ones((len(transactions), self.n_classes), np.int32)
        else:
            if len(classes) != len(transactions):
                raise ValueError("classes length != transactions length")
            w = class_weights(classes, self.n_classes)
        t0 = time.perf_counter()
        bits = encode_bitmap(transactions,
                             self.vocab if vocab is None else vocab)
        t1 = time.perf_counter()
        out = dedup_rows(bits, w)
        if timings is not None:
            timings["encode"] = t1 - t0
            timings["dedup"] = time.perf_counter() - t1
        return out

    def _spill_threshold_resolved(self) -> Optional[int]:
        """The host-RAM budget past which the base spills, or ``None`` when
        the disk tier is unavailable (no directory configured / disabled)."""
        if self._spill is False or self._spill_dir is None:
            return None
        return (DEFAULT_SPILL_THRESHOLD_BYTES if self._spill_threshold is None
                else int(self._spill_threshold))

    def _residency_for(self, bits, weights, vocab) -> str:
        """Pick ``"dense"`` / ``"streaming"`` / ``"spilled"`` for a candidate
        base.  Explicit ``spill=True`` wins; otherwise a configured spill
        budget caps host residency (even forced-streaming bases), and with
        nothing explicit the adaptive chooser decides from measured traits."""
        if self._spill is True:
            if self._spill_dir is None:
                raise ValueError("spill=True requires spill_dir= (or "
                                 "$REPRO_TORCH_SPILL_DIR)")
            self.backend_choice = None
            return "spilled"
        spill_thr = self._spill_threshold_resolved()
        stream = self._streaming
        if stream is None and self.chunk_rows is not None:
            # explicit chunk_rows opts in, mirroring _resolve_streaming in
            # the mining stack
            stream = True
        if stream is None:
            # adaptive residency: the chooser measures the encoded rows
            # (footprint, density, skew, compressibility) instead of the old
            # bare size threshold.  Non-residency verdicts (gfp/dense) keep
            # the base device-dense — the measured choice itself is kept
            # (stats + CountServer.mine consult it for the engine pick)
            from ..mining.chooser import DatasetTraits, choose_backend
            traits = DatasetTraits.measure(bits, weights, vocab, self.n_rows)
            self.backend_choice = choose_backend(
                traits, stream_threshold_bytes=self._stream_threshold,
                spill_threshold_bytes=spill_thr)
            if self.backend_choice.name in ("streaming", "spilled"):
                return self.backend_choice.name
            return "dense"
        self.backend_choice = None
        if spill_thr is not None and \
                int(bits.nbytes + weights.nbytes) > spill_thr:
            return "spilled"
        return "streaming" if stream else "dense"

    def _make_base(self, bits: np.ndarray, weights: np.ndarray, vocab=None):
        vocab = self.vocab if vocab is None else vocab
        residency = self._residency_for(bits, weights, vocab)
        if residency == "spilled":
            # generation directories: the new base lands in a fresh gen, the
            # replaced one is deleted AFTER the swap (build-before-drop on
            # disk too); the counter bump is atomic so a background build
            # and an explicit compact() never share a directory
            gen_dir = self._claim_generation()
            return SpilledDB.spill(vocab, bits, weights, self.n_rows,
                                   self.n_classes, gen_dir,
                                   chunk_rows=self.chunk_rows,
                                   device=self.device)
        if residency == "streaming":
            return StreamingDB.from_arrays(vocab, bits, weights,
                                           self.n_rows, self.n_classes,
                                           chunk_rows=self.chunk_rows,
                                           device=self.device)
        return DenseDB.from_arrays(vocab, bits, weights,
                                   self.n_rows, self.n_classes,
                                   device=self.device)

    def _claim_generation(self) -> str:
        """A generation directory under the spill root that no other
        store holds: the counter's next ``gen%05d`` that ``os.mkdir`` can
        create (another store over the same root, in this process or
        another, has made the ones it skips).  The JAX package counts from
        0 in every store and re-spills into another store's ``gen00000``."""
        os.makedirs(self._spill_dir, exist_ok=True)
        while True:
            with self._store_lock:
                gen = self._spill_gen
                self._spill_gen += 1
            gen_dir = os.path.join(self._spill_dir, f"gen{gen:05d}")
            try:
                os.mkdir(gen_dir)
            except FileExistsError:
                continue
            return gen_dir

    # -- introspection --------------------------------------------------------
    @property
    def resident(self) -> str:
        if isinstance(self.base, SpilledDB):
            return "spilled"
        return "streaming" if isinstance(self.base, StreamingDB) else "dense"

    @property
    def base_rows(self) -> int:
        # a spilled base answers from its manifest — never touch the disk
        # just to report a row count
        u = getattr(self.base, "n_unique", None)
        return int(u) if u is not None else int(self.base.bits.shape[0])

    def _base_width(self) -> int:
        w = getattr(self.base, "n_words", None)
        return int(w) if w is not None else int(self.base.bits.shape[1])

    @property
    def delta_rows(self) -> int:
        """Rows in the delta: appended rows, each batch deduped within
        itself (rows repeated across batches merge at the fold)."""
        return self._delta.rows

    @property
    def nbytes(self) -> int:
        # .nbytes is metadata on numpy arrays and tensors — and a manifest
        # fact on a spilled base: no D2H copy or disk read just to report a
        # size
        return (self._base_backend().nbytes + self._delta.bits.nbytes +
                self._delta.weights.nbytes)

    def stats(self) -> dict:
        # compactor stats are read BEFORE taking the store lock: its own _mu
        # orders after _store_lock (request() under append), and a
        # stats-name-resolved call under the held lock would hand repro-lint
        # a reversed edge
        comp = None if self._compactor is None else self._compactor.stats()
        with self._store_lock:
            out = {
                "version": self.version, "n_rows": self.n_rows,
                "n_classes": self.n_classes, "vocab_size": self.vocab.size,
                "resident": self.resident, "base_rows": self.base_rows,
                "delta_rows": self.delta_rows, "nbytes": self.nbytes,
                "kernel_launches": self.kernel_launches,
                "appends": self.n_appends, "compactions": self.n_compactions,
                "failed_compactions": self.n_failed_compactions,
                "last_compaction_error": self.last_compaction_error,
                "min_compact_rows": self.min_compact_rows,
                "backend_choice": (None if self.backend_choice is None
                                   else self.backend_choice.name),
                "spill": (None if not isinstance(self.base, SpilledDB) else {
                    "directory": self.base.directory,
                    "segments": self.base.n_chunks,
                    "chunk_rows": self.base.chunk_rows,
                    "disk_bytes": self.base.nbytes,
                }),
                "compactor": comp,
                "device": str(self.device),
            }
        return out

    # -- append ---------------------------------------------------------------
    def _wants_fold(self) -> bool:
        """``merge_ratio`` decides WHEN the fold pays, over the delta's rows
        against the base's distinct rows; ``min_compact_rows`` keeps a
        cold/tiny base from re-deduping the world on every append."""
        return (self.delta_rows >= self.min_compact_rows and
                self.delta_rows > self.merge_ratio * max(1, self.base_rows))

    def append(
        self,
        transactions: Sequence[Sequence[Item]],
        classes: Optional[Sequence[int]] = None,
    ) -> int:
        """Fold a new batch in; returns the new (bumped) ``version``.

        The batch is encoded under the tail-extended vocab, deduped within
        itself, and added to the delta segment until the ``merge_ratio``
        compaction threshold folds it into the base: an append sorts its
        own rows only, whatever the delta holds.
        An empty batch is a no-op (version unchanged: no count can differ).
        """
        transactions = [list(t) for t in transactions]
        if not transactions:
            return self.version
        t0 = time.perf_counter()
        with TRACER.span("store.append", {"rows": len(transactions)}) as sp:
            # validate + encode BEFORE touching any store state: a rejected
            # batch must leave no trace (no vocab tail, no totals, no
            # version bump).  Label-range validation comes first — the
            # store's n_classes is fixed, so an out-of-range label can never
            # be folded in
            with TRACER.span("store.encode_batch"):
                check_class_labels(classes, self.n_classes)
                vocab = extend_vocab(transactions, self.vocab)
                ub, uw = self._encode_batch(transactions, classes, vocab)
            # store.delta_add covers the wait for the store lock too
            with TRACER.span("store.delta_add"), self._store_lock:
                totals = self._guard_totals(
                    self._class_totals + uw.sum(axis=0, dtype=np.int64))
                self.vocab = vocab
                self._class_totals = totals
                self._delta.add(ub, uw)
                self.n_rows += len(transactions)
                self.n_appends += 1
                self.version += 1
                version, delta_rows = self.version, self.delta_rows
                _M_APPENDS.inc()
                _M_APPEND_ROWS.inc(len(transactions))
                _G_DELTA_ROWS.set(delta_rows)
                if self._wants_fold():
                    if self._compactor is not None:
                        # off the serving path: the append returns now, the
                        # compactor thread snapshots/builds/commits behind
                        # _store_lock (failure-safe)
                        self._compactor.request()
                    else:
                        try:
                            self.compact()
                        except Exception as e:
                            # compaction is a pure optimization and
                            # compact() is failure-safe (the new base is
                            # built BEFORE the delta drops), so the store
                            # still serves exact counts from base+delta.
                            # The batch IS committed at this point — an
                            # escaping compactor error would masquerade as a
                            # rejected append and invite a double-counting
                            # retry.
                            self.n_failed_compactions += 1
                            self.last_compaction_error = \
                                f"{type(e).__name__}: {e}"
                            _M_FAILED_COMPACTIONS.inc()
            sp.set("delta_rows", delta_rows)
            sp.set("version", version)
        _H_APPEND_MS.observe((time.perf_counter() - t0) * 1e3)
        return version

    def _base_rows_host(self, base, w_now: int):
        """The whole base as host arrays at width ``w_now``: a D2H copy of a
        dense base, every segment of a spilled one."""
        return pad_words(_host(base.bits), w_now), _host(base.weights)

    def compact(self) -> None:
        """Fold the delta into the base: full re-dedup at the current vocab
        width, then residency reselection (dense vs streaming vs spilled) by
        size.  Pure compaction — counts (and therefore ``version``) are
        unchanged.  Explicit calls ignore the ``min_compact_rows`` floor
        (the floor gates only append-triggered auto-compaction)."""
        with self._store_lock, \
                TRACER.span("store.compact",
                            {"base_rows": self.base_rows,
                             "delta_rows": self.delta_rows}):
            w_now = self.vocab.n_words
            base_bits, base_w = self._base_rows_host(self.base, w_now)
            had_delta = self.delta_rows > 0
            if had_delta:
                base_bits = np.concatenate(
                    [base_bits, pad_words(self._delta.bits, w_now)])
                base_w = np.concatenate([base_w, self._delta.weights])
            ub, uw = dedup_rows(base_bits, base_w)
            # build the new base BEFORE dropping the delta: a failure here
            # (e.g. device OOM at residency reselection) must leave the
            # composed base+delta counts intact, not silently lose the
            # delta rows
            old = self.base
            self.base = self._make_base(ub, uw)
            if had_delta:
                self._delta = self._delta.tail(self.delta_rows)
                self.n_compactions += 1
                _M_COMPACTIONS.inc()
                _G_DELTA_ROWS.set(0)
        self._drop_spilled(old)

    def _drop_spilled(self, old_base) -> None:
        """Delete a REPLACED spilled generation's segment directory.  Only
        after the swap (on-disk build-before-drop), and never fatally — a
        leaked directory is recoverable garbage, a crashed serve path is
        not."""
        if old_base is self.base or not isinstance(old_base, SpilledDB):
            return
        try:
            old_base.delete()
        except OSError as e:
            with self._store_lock:
                self.last_compaction_error = f"spill cleanup: {e}"

    def _compact_pass(self) -> bool:
        """One background compaction attempt (the ``AsyncCompactor``'s unit
        of work).  Snapshot the base and the delta's first ``n`` rows under
        the lock, fold them off-lock, and commit under the lock: the new
        base, and as the delta the rows appended since the snapshot.
        Appends in between never void the build (their rows are kept), so
        the fold commits under steady appends; another fold's commit in
        between does, and the build is discarded.

        Returns ``True`` when done (committed, nothing to do, or build
        failed — failures are absorbed into ``last_compaction_error`` /
        ``n_failed_compactions``, the delta stays intact) and ``False`` when
        another fold committed first (caller may retry)."""
        with self._store_lock:
            if not self.delta_rows or not self._wants_fold():
                return True
            epoch = self.n_compactions
            vocab = self.vocab
            base = self.base
            n_snap = self.delta_rows
            # rows below n_snap are never rewritten: views stay valid
            dbits, dw = self._delta.bits, self._delta.weights
        with TRACER.span("store.bg_compact",
                         {"base_rows": self.base_rows,
                          "folded_rows": n_snap}) as sp:
            try:
                w_now = vocab.n_words
                with TRACER.span("compact.fetch"):
                    base_bits, base_w = self._base_rows_host(base, w_now)
                with TRACER.span("compact.dedup", {"folded_rows": n_snap}):
                    ub, uw = dedup_rows(
                        np.concatenate([base_bits, pad_words(dbits, w_now)]),
                        np.concatenate([base_w, dw]))
                with TRACER.span("compact.build"):
                    new_base = self._make_base(ub, uw, vocab=vocab)
            except Exception as e:
                with self._store_lock:
                    self.n_failed_compactions += 1
                    self.last_compaction_error = f"{type(e).__name__}: {e}"
                _M_FAILED_COMPACTIONS.inc()
                return True
            # compact.commit covers the wait for the store lock too
            with TRACER.span("compact.commit") as cs, self._store_lock:
                committed = self.n_compactions == epoch
                if committed:
                    self.base = new_base
                    self._delta = self._delta.tail(n_snap)
                    self.n_compactions += 1
                    kept = self.delta_rows
                    _G_DELTA_ROWS.set(kept)
                    cs.set("kept_rows", kept)
                    sp.set("kept_rows", kept)
        if committed:
            _M_COMPACTIONS.inc()
            self._drop_spilled(base)
            return True
        # another fold committed first: this build counts rows that are
        # already in the base — discard it (and its on-disk gen)
        _M_DISCARDED_COMPACTIONS.inc()
        if isinstance(new_base, SpilledDB):
            new_base.delete()
        return False

    # -- counting -------------------------------------------------------------
    def _narrow(self, masks: np.ndarray, w_seg: int):
        """Truncate (K, W_now) masks to a segment's width.  Targets with bits
        beyond the segment width reference items the segment predates — their
        count over that segment is exactly 0 (returned as ``oob``)."""
        if masks.shape[1] <= w_seg:
            return masks, None
        oob = masks[:, w_seg:].any(axis=1)
        return np.ascontiguousarray(masks[:, :w_seg]), oob

    @staticmethod
    def _zero_oob(got: np.ndarray, oob: Optional[np.ndarray]) -> np.ndarray:
        if oob is None:
            return got
        got = np.array(got)   # a copy: never write into a view of a result
        got[oob] = 0
        return got

    def _base_backend(self) -> CountBackend:
        # made anew only when a fold has installed another base
        be = self._base_be
        if be is None or be.db is not self.base:
            be = self._base_be = backend_of(self.base,
                                            use_kernel=self.use_kernel)
        return be

    def _count_delta(self, masks: np.ndarray,
                     block_k: Optional[int] = None) -> np.ndarray:
        """One launch over the delta's device mirror (grown first by the
        rows appended since the last count), copied back to the host, with
        targets wider than the delta zeroed.  Caller holds the lock."""
        with TRACER.span("store.count_delta", {"delta_rows": self.delta_rows}):
            narrow, oob = self._narrow(masks, self._delta.n_words)
            d_bits, d_weights = self._delta.on_device()
            got = count_resident(d_bits, d_weights, narrow,
                                 use_kernel=self.use_kernel, block_k=block_k)
            self.kernel_launches += 1
            return self._zero_oob(got, oob)

    def _sweep(self, masks: np.ndarray, *, block_k: Optional[int] = None,
               start_chunk: int = 0, init: Optional[np.ndarray] = None,
               on_chunk=None) -> np.ndarray:
        """The composed count of a (K, W_now) block: the base's chunks
        through the base's backend, then one chunk for the delta, from
        ``start_chunk`` on, added to ``init`` (the ``CountBackend`` resume
        contract; ``on_chunk(j, acc)`` after chunk ``j``).  Only the chunks
        swept add to ``kernel_launches``."""
        k = int(masks.shape[0])
        total = (np.zeros((k, self.n_classes), np.int32) if init is None
                 else np.array(np.asarray(init), np.int32))
        if k == 0:
            return total
        # the whole sweep runs under the store lock so a background commit
        # cannot swap the base mid-composition (base counted pre-compaction
        # + delta counted post-compaction would double-count the fold)
        with self._store_lock:
            base = self._base_backend() if self.base_rows else None
            nb = 0 if base is None else base.n_count_chunks
            if start_chunk < nb:
                narrow, oob = self._narrow(masks, self._base_width())
                hook = None
                if on_chunk is not None:
                    def hook(i, acc):
                        # the base's last accumulator is its finished block
                        # (oob rows zeroed): a resume at nb adds the delta
                        on_chunk(i, self._zero_oob(acc, oob) if i == nb - 1
                                 else acc)
                # the caller's init, not total: a fresh sweep uploads no
                # zero accumulator
                total = self._zero_oob(
                    base.counts(narrow, block_k=block_k,
                                start_chunk=start_chunk, init=init,
                                on_chunk=hook), oob)
                self.kernel_launches += nb - start_chunk
            if self.delta_rows and start_chunk <= nb:
                total = total + self._count_delta(masks, block_k=block_k)
                if on_chunk is not None:
                    on_chunk(nb, total)
            elif nb == 0 and start_chunk == 0 and on_chunk is not None:
                # empty store: n_count_chunks still claims a 1-chunk grid, so
                # the (trivially exact, all-zero) sweep must COMPLETE that
                # chunk — otherwise a checkpointed mine records zero chunk
                # progress against a claimed chunk and the partial never
                # becomes resumable
                on_chunk(0, total)
        return total

    def counts_masks(self, masks: np.ndarray,
                     block_k: Optional[int] = None) -> np.ndarray:
        """(K, C) exact per-class counts for a (K, W_now) target block,
        composed over base + delta segments (bit-identical to a fresh encode
        of the full history: int32 sums commute with row partitioning).
        ``block_k`` forwards the caller's K-block size to the kernel so a
        block that was padded for it launches as one K-block."""
        return self._sweep(masks, block_k=block_k)

    def counts(self, itemsets: Sequence[Sequence[Item]]) -> np.ndarray:
        """(K, C) counts for raw itemsets.  Itemsets naming items absent from
        the vocab count 0 (the paper's note: such targets never appear in the
        FP-tree), matching ``dense_gfp_counts``.  One unknown-target contract,
        shared with the flush path: ``build_masks`` + zeroing."""
        return counts_for_itemsets(self, itemsets)


def counts_for_itemsets(store, itemsets: Sequence[Sequence[Item]]
                        ) -> np.ndarray:
    """The ONE raw-itemset counting contract over any serving store (a
    ``VersionedDB`` or a ``ShardedDB``: anything with ``vocab`` /
    ``n_classes`` / ``counts_masks``): encode under the store vocab, count,
    and zero targets naming never-seen items — whose exact count is 0."""
    from .batcher import build_masks

    if not len(itemsets):
        return np.zeros((0, store.n_classes), np.int32)
    masks, known = build_masks([tuple(s) for s in itemsets], store.vocab,
                               block_k=1)
    out = np.array(store.counts_masks(masks)[:len(itemsets)], np.int32)
    out[~known] = 0
    return out


class StoreCountBackend(CountBackend):
    """The part every backend over a serving store shares: the store's
    vocab, rows, classes and bytes, read at call time (an append changes
    them)."""

    def __init__(self, store):
        self.store = store

    @property
    def vocab(self) -> ItemVocab:
        return self.store.vocab

    @property
    def n_rows(self) -> int:
        return self.store.n_rows

    @property
    def n_classes(self) -> int:
        return self.store.n_classes

    @property
    def nbytes(self) -> int:
        return self.store.nbytes


class VersionedCountBackend(StoreCountBackend):
    """:class:`~repro_torch.mining.backend.CountBackend` over a
    :class:`VersionedDB` — the seam that lets the unified mining driver
    (``mining/driver.py``) run against the serving store's composed
    base+delta sweep, so it is exact mid-append without compaction.

    Chunk layout for mid-level checkpoint resume: the base segment's chunks
    first (the ``StreamingDB`` chunk grid when the base is host-resident, one
    chunk when device-dense), then one chunk for the delta segment.  The
    ``mine_signature`` pins the store ``version``: a checkpoint resumed after
    an ``append`` is discarded wholesale (levels counted at an older version
    are not valid progress), while pure compaction — which changes the chunk
    geometry but no count — only restarts the in-flight level from chunk 0.
    """

    @property
    def n_count_chunks(self) -> int:
        store = self.store
        base = store._base_backend().n_count_chunks if store.base_rows else 0
        return max(1, base + (1 if store.delta_rows else 0))

    def chunk_signature(self) -> dict:
        base = self.store._base_backend().chunk_signature()
        return {
            "backend": "versioned", "version": self.store.version,
            "base_rows": self.store.base_rows,
            "delta_rows": self.store.delta_rows,
            "chunk_rows": base.get("chunk_rows"),
        }

    def mine_signature(self) -> dict:
        return {"version": self.store.version}

    def traits(self):
        """Measured traits over the composed base+delta rows (the same rows
        every sweep counts), for the adaptive engine pick in
        ``CountServer.mine``."""
        from dataclasses import replace as _dc_replace

        from ..mining.chooser import (TRAIT_SAMPLE_ROWS, DatasetTraits,
                                      sample_index)

        store = self.store
        with store._store_lock:
            w_now = store.vocab.n_words
            if isinstance(store.base, SpilledDB):
                # sample rows spread over every segment and the delta (the
                # rows measure() would pick from the composed bitmap)
                # instead of materializing the whole spilled base from disk;
                # patch in the TRUE footprint so the chooser sees real
                # size, not the sample's
                nb, u = store.base_rows, store.base_rows + store.delta_rows
                idx = sample_index(u, min(u, TRAIT_SAMPLE_ROWS))
                bits, wts = store.base.rows_at(idx[idx < nb])
                bits = pad_words(bits, w_now)
                if store.delta_rows:
                    rest = idx[idx >= nb] - nb
                    bits = np.concatenate(
                        [bits, pad_words(store._delta.bits[rest], w_now)])
                    wts = np.concatenate([wts, store._delta.weights[rest]])
                t = DatasetTraits.measure(bits, wts, store.vocab,
                                          store.n_rows)
                return _dc_replace(
                    t, nbytes=store.nbytes, n_unique=u,
                    dedup_ratio=(u / store.n_rows if store.n_rows else 1.0))
            bits, wts = store._base_rows_host(store.base, w_now)
            if store.delta_rows:
                bits = np.concatenate(
                    [bits, pad_words(store._delta.bits, w_now)])
                wts = np.concatenate([wts, store._delta.weights])
            return DatasetTraits.measure(bits, wts, store.vocab, store.n_rows)

    def counts(self, masks: np.ndarray, *, block_k: Optional[int] = None,
               start_chunk: int = 0, init: Optional[np.ndarray] = None,
               on_chunk=None) -> np.ndarray:
        return self.store._sweep(masks, block_k=block_k,
                                 start_chunk=start_chunk, init=init,
                                 on_chunk=on_chunk)
