"""Disk-tier chunk store: spill the encoded bitmap to mmap'd segment files.

``StreamingDB`` broke the DEVICE memory ceiling but still keeps every chunk
in host RAM, so real N is bounded by the host.  This module extends the same
chunked-sweep discipline one tier down, the way "Mining Frequent Itemsets
from Secondary Memory" (Grahne & Zhu, 2004) partitions the database on disk
and overlaps IO with computation:

  * ``SpilledDB`` persists the (U, W) bitmap + (U, C) class weights as
    per-chunk ``.npy`` SEGMENT files under one directory, described by a
    ``MANIFEST.json`` written last (tmp + fsync + ``os.replace``), after a
    previous store's manifest was removed — a crashed spill leaves no
    manifest, never a torn store.
    ``SpilledDB.open(directory)`` reopens the store after a process death:
    the segments ARE the durable chunk grid, so a killed mine resumes from
    disk (pair with a ``MiningCheckpoint`` for the level/chunk cursor).  The
    format is the JAX package's (``repro-spill-v1``), file for file, so each
    package opens a store the other wrote.
  * ``spilled_counts`` sweeps the segments through the same counting kernel
    as ``streaming_counts``, adding each segment's counts into one (K, C)
    int32 accumulator in place (``itemset_counts_into``): counts are int32
    sums, so the sweep is bit-identical to the all-RAM streaming sweep and
    to one dense pass.  A PREFETCH thread stages segments ahead of the
    kernel (below).  The host-RAM high-water mark stays at a few segments
    whatever the total N.
  * ``SpilledBackend`` adapts the store to the ``CountBackend`` protocol so
    the unified mining driver checkpoints per SEGMENT — the chunk files are
    the natural checkpoint unit.

Staging on the card: a ring of ``PREFETCH_DEPTH + 2`` slots, each a pinned
host buffer and a device buffer (``PREFETCH_DEPTH`` segments queued, one
read by the kernel, one being filled).  For segment j the prefetch thread
copies the mmap'd rows into slot j's pinned buffer (after that buffer's
last host-to-device copy has finished), enqueues the copy to the device
buffer on a side copy stream (after the kernel that last read that device
buffer), and records a ``copied`` event; the consumer makes the compute
stream wait on ``copied`` before the kernel launch and records
``consumed`` after it.  A slot is reused only after the consumer took the
segment behind it from the queue, so ``consumed`` is always recorded
before the thread waits on it.  Exact rows are copied: the kernel masks the
ragged last segment itself.  On the CPU the thread hands over tensors over
the mapped files and the plain version counts them.

Reads go through ``np.load(mmap_mode=...)``: the OS page cache, not the
process heap, holds the bytes, and a re-read after restart touches only the
pages the sweep actually walks.

Telemetry: ``spill_bytes_written_total`` / ``spill_bytes_read_total`` /
``spill_segments_written_total`` counters, the ``spill_prefetch_hits_total``
/ ``spill_prefetch_misses_total`` pair (a hit means the next segment was
already staged when the consumer asked — the overlap worked), a
``spill_prefetch_hit_ratio`` gauge per sweep, and the ``spill.write`` and
``spill.sweep`` spans.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from dataclasses import dataclass, field
from typing import Callable, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..kernels.itemset_count import itemset_counts_into
from ..obs import REGISTRY, TRACER
from .backend import CountBackend
from .chooser import sample_index
from .encode import ItemVocab
from .plan import choose_chunk_rows, stream_chunks
from .stream import _db_device, _host

Item = Hashable

MANIFEST_NAME = "MANIFEST.json"
_FORMAT = "repro-spill-v1"

# Host-RAM budget past which the chooser (when a spill budget is passed)
# moves the DB to disk.
DEFAULT_SPILL_THRESHOLD_BYTES = int(
    os.environ.get("REPRO_TORCH_SPILL_THRESHOLD_BYTES", 2 << 30))

# How many staged segments the prefetcher may run ahead of the kernel.
PREFETCH_DEPTH = 2
# Staging slots: PREFETCH_DEPTH queued, one read by the kernel, one filling.
_SLOTS = PREFETCH_DEPTH + 2

_M_SEGS_WRITTEN = REGISTRY.counter("spill_segments_written_total")
_M_BYTES_WRITTEN = REGISTRY.counter("spill_bytes_written_total")
_M_BYTES_READ = REGISTRY.counter("spill_bytes_read_total")
_M_PREFETCH_HITS = REGISTRY.counter("spill_prefetch_hits_total")
_M_PREFETCH_MISSES = REGISTRY.counter("spill_prefetch_misses_total")
_M_PREFETCH_ERRORS = REGISTRY.counter("spill_prefetch_errors_total")


def default_spill_dir() -> str:
    """The spill root when none was configured: ``$REPRO_TORCH_SPILL_DIR``
    or a fresh tmp directory (callers own cleanup of explicit dirs)."""
    return spill_root()[0]


def spill_root() -> Tuple[str, bool]:
    """``(directory, made)``: ``$REPRO_TORCH_SPILL_DIR`` (``made`` False:
    the caller's, never deleted here), or a fresh ``mkdtemp`` directory
    (``made`` True: whoever spills into it deletes it, see
    ``own_directory``)."""
    root = os.environ.get("REPRO_TORCH_SPILL_DIR")
    if root:
        return root, False
    import tempfile
    return tempfile.mkdtemp(prefix="repro-spill-"), True


def own_directory(db: "SpilledDB") -> None:
    """Delete ``db.directory`` once ``db`` is garbage-collected, or at
    ``SpilledBackend.close()``: for a store in a temporary directory made
    for it (``spill_root``), which nothing else would delete."""
    import weakref
    db._owned = weakref.finalize(db, shutil.rmtree, db.directory, True)


def _atomic_save(path: str, arr: np.ndarray) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# ``os.close`` by another name: the static lock-order checker resolves
# method calls by name alone, and would take ``os.close`` for the async
# flusher's ``close`` (which takes the server's lock) and report a cycle
_close_fd = os.close


def _fsync_dir(directory: str) -> None:
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        _close_fd(fd)


def _drop_manifest(directory: str) -> None:
    """Remove a store's manifest, durably, before its segments are
    overwritten: without it ``open`` refuses the directory."""
    path = os.path.join(directory, MANIFEST_NAME)
    if os.path.exists(path):
        os.remove(path)
        _fsync_dir(directory)


def _check_items_jsonable(items: Sequence[Item]) -> list:
    """The manifest persists the vocab; items must survive a JSON
    round-trip IDENTICALLY or a reopened store would mis-key every mask."""
    as_list = list(items)
    try:
        back = json.loads(json.dumps(as_list))
    except TypeError as e:
        raise TypeError(
            f"vocab items must be JSON-serializable to spill to disk: {e}"
        ) from e
    if back != as_list:
        raise TypeError(
            "vocab items do not round-trip through JSON (e.g. tuples become "
            "lists); re-key the items as strings/ints before spilling")
    return as_list


@dataclass
class SpilledDB:
    """Encoded, deduped, class-weighted DB persisted as on-disk segments.

    Mirrors ``StreamingDB`` (same encode discipline, same chunk grid for a
    given ``chunk_rows``, counts on ``device``) but the rows live in ``.npy``
    segment files under ``directory`` and every sweep goes through
    ``spilled_counts``.  The ``bits`` / ``weights`` properties MATERIALIZE
    the full arrays; steady-state counting never does.
    """
    vocab: ItemVocab
    directory: str
    n_rows: int              # original logical N (sum of weights)
    n_classes: int
    chunk_rows: int
    seg_rows: Tuple[int, ...] = field(default_factory=tuple)
    n_words: int = 1
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))

    # -- shape facts (no disk IO) ---------------------------------------------
    @property
    def n_unique(self) -> int:
        return int(sum(self.seg_rows))

    @property
    def n_chunks(self) -> int:
        return len(self.seg_rows)

    @property
    def nbytes(self) -> int:
        """Logical encoded footprint (what the rows would occupy in RAM)."""
        return 4 * (self.n_words + self.n_classes) * self.n_unique

    def _seg_paths(self, j: int) -> Tuple[str, str]:
        return (os.path.join(self.directory, f"seg{j:05d}.bits.npy"),
                os.path.join(self.directory, f"seg{j:05d}.w.npy"))

    # -- construction ---------------------------------------------------------
    @classmethod
    def spill(cls, vocab: ItemVocab, bits, weights, n_rows: int,
              n_classes: int, directory: str,
              chunk_rows: Optional[int] = None, *,
              device: DeviceLike = None) -> "SpilledDB":
        """Write already-encoded/deduped arrays (host arrays or tensors) as
        segment files; the store counts on ``device``.

        Segments first, ``MANIFEST.json`` last — each via tmp + fsync +
        ``os.replace`` — so a crash mid-spill never leaves an openable but
        torn store.  Spilling over an existing store first removes its
        manifest and fsyncs the directory: a crash while the new segments
        replace the old ones leaves no manifest, never the old one over a
        mix of segments (a deliberate difference from the JAX package,
        which writes the segments over the old manifest).  Raises
        ``OverflowError`` if per-class totals exceed int32 (the same
        accumulator guard as the streaming sweep, checked once here instead
        of re-reading every segment per sweep)."""
        dev = resolve_device(device)
        bits = np.ascontiguousarray(_host(bits), np.uint32)
        weights = np.ascontiguousarray(_host(weights), np.int32)
        if weights.ndim == 1:
            weights = weights[:, None]
        u, n_words = bits.shape
        totals = weights.sum(axis=0, dtype=np.int64)
        if np.any(totals > np.iinfo(np.int32).max):
            raise OverflowError(
                "per-class weight totals exceed int32; spilled counts could "
                "wrap — split the DB or widen the accumulator")
        if chunk_rows is None:
            chunk_rows = choose_chunk_rows(n_words, n_classes, n_rows=u)
        items = _check_items_jsonable(vocab.items)
        os.makedirs(directory, exist_ok=True)
        _drop_manifest(directory)
        chunks = stream_chunks(u, chunk_rows)
        db = cls(vocab=vocab, directory=directory, n_rows=int(n_rows),
                 n_classes=int(n_classes), chunk_rows=int(chunk_rows),
                 seg_rows=tuple(e - s for s, e in chunks),
                 n_words=int(n_words), device=dev)
        with TRACER.span("spill.write", {"segments": len(chunks),
                                         "rows": u}):
            for j, (s, e) in enumerate(chunks):
                bp, wp = db._seg_paths(j)
                _atomic_save(bp, bits[s:e])
                _atomic_save(wp, weights[s:e])
                _M_SEGS_WRITTEN.inc()
                _M_BYTES_WRITTEN.inc(bits[s:e].nbytes + weights[s:e].nbytes)
            manifest = {
                "format": _FORMAT,
                "n_rows": int(n_rows), "n_classes": int(n_classes),
                "chunk_rows": int(chunk_rows), "n_words": int(n_words),
                "seg_rows": [int(r) for r in db.seg_rows],
                "items": items,
                "class_totals": [int(t) for t in totals],
            }
            tmp = os.path.join(directory, MANIFEST_NAME + ".tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(directory, MANIFEST_NAME))
        return db

    @classmethod
    def from_streaming(cls, db, directory: str,
                       chunk_rows: Optional[int] = None) -> "SpilledDB":
        """Spill a ``StreamingDB`` (or any DB exposing
        bits/weights/vocab/n_rows/n_classes) keeping its chunk grid and its
        device."""
        return cls.spill(db.vocab, db.bits, db.weights, int(db.n_rows),
                         int(db.n_classes), directory,
                         chunk_rows=chunk_rows if chunk_rows is not None
                         else getattr(db, "chunk_rows", None),
                         device=_db_device(db))

    @classmethod
    def open(cls, directory: str, *, device: DeviceLike = None
             ) -> "SpilledDB":
        """Reopen a spilled store from its manifest (the kill/resume seam),
        counting on ``device``.

        Validates format and that every listed segment file exists with the
        advertised row count, the weights files as well as the bits files
        (the JAX package checks the bits files only) — a torn or truncated
        store must fail loudly here, not miscount later."""
        dev = resolve_device(device)
        path = os.path.join(directory, MANIFEST_NAME)
        with open(path) as f:
            m = json.load(f)
        if m.get("format") != _FORMAT:
            raise ValueError(
                f"{path}: unknown spill format {m.get('format')!r} "
                f"(expected {_FORMAT!r})")
        db = cls(vocab=ItemVocab(tuple(m["items"])), directory=directory,
                 n_rows=int(m["n_rows"]), n_classes=int(m["n_classes"]),
                 chunk_rows=int(m["chunk_rows"]),
                 seg_rows=tuple(int(r) for r in m["seg_rows"]),
                 n_words=int(m["n_words"]), device=dev)
        for j, rows in enumerate(db.seg_rows):
            bp, wp = db._seg_paths(j)
            for p in (bp, wp):
                if not os.path.exists(p):
                    raise FileNotFoundError(
                        f"spilled store at {directory} is torn: manifest "
                        f"lists {p} but the file is missing")
            for p in (bp, wp):
                got = np.load(p, mmap_mode="r").shape[0]
                if got != rows:
                    raise ValueError(
                        f"{p}: manifest says {rows} rows, file has {got}")
        return db

    # -- IO -------------------------------------------------------------------
    def segment(self, j: int, mode: str = "r"
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Memory-mapped (rows_j, W) bits + (rows_j, C) weights of segment j
        — pages fault in lazily as the sweep (or prefetcher) walks them.
        ``mode="c"`` maps copy-on-write: writable views, the files
        untouched."""
        bp, wp = self._seg_paths(j)
        return np.load(bp, mmap_mode=mode), np.load(wp, mmap_mode=mode)

    @property
    def bits(self) -> np.ndarray:
        """Full (U, W) bitmap, MATERIALIZED from disk.  Counting sweeps
        stream segments instead."""
        if not self.seg_rows:
            return np.zeros((0, self.n_words), np.uint32)
        return np.concatenate([np.asarray(self.segment(j)[0])
                               for j in range(self.n_chunks)])

    @property
    def weights(self) -> np.ndarray:
        """Full (U, C) weights, MATERIALIZED from disk (see ``bits``)."""
        if not self.seg_rows:
            return np.zeros((0, self.n_classes), np.int32)
        return np.concatenate([np.asarray(self.segment(j)[1])
                               for j in range(self.n_chunks)])

    def rows_at(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The rows at ascending global indices ``idx`` as host arrays,
        read from the segments that hold them — the trait-sampling hook
        (``chooser.sample_index``), so the chooser never materializes the
        whole store."""
        idx = np.asarray(idx, np.int64)
        bits = np.empty((len(idx), self.n_words), np.uint32)
        w = np.empty((len(idx), self.n_classes), np.int32)
        starts = np.cumsum((0,) + self.seg_rows)
        seg = np.searchsorted(starts, idx, side="right") - 1
        for j in np.unique(seg):
            pick = seg == j
            b, wj = self.segment(int(j))
            local = idx[pick] - starts[j]
            bits[pick] = b[local]
            w[pick] = wj[local]
        return bits, w

    def delete(self) -> None:
        """Remove the segment directory (a replaced spilled base is dead
        weight on disk the moment its successor's manifest lands)."""
        shutil.rmtree(self.directory, ignore_errors=True)

    def counts(self, tgt_bits, **kwargs) -> torch.Tensor:
        return spilled_counts(self, tgt_bits, **kwargs)


class _Staging:
    """Where segments land for the kernel (see the module docstring): on
    the card, the ring of pinned host buffers, device buffers and their
    ``copied`` / ``consumed`` events, with the side copy stream; on the
    CPU, nothing but the mapped files."""

    def __init__(self, db: SpilledDB, first: int):
        self.db = db
        self.dev = db.device
        if self.dev.type != "cuda":
            return
        rows = max(db.seg_rows[first:])
        w, c = db.n_words, db.n_classes
        with torch.cuda.device(self.dev):
            self.copy = torch.cuda.Stream(self.dev)
            self.host = [(torch.empty((rows, w), dtype=torch.uint32,
                                      pin_memory=True),
                          torch.empty((rows, c), dtype=torch.int32,
                                      pin_memory=True))
                         for _ in range(_SLOTS)]
            self.dev_bufs = [
                (torch.empty((rows, w), dtype=torch.uint32, device=self.dev),
                 torch.empty((rows, c), dtype=torch.int32, device=self.dev))
                for _ in range(_SLOTS)]
            self.copied = [torch.cuda.Event() for _ in range(_SLOTS)]
            self.consumed = [torch.cuda.Event() for _ in range(_SLOTS)]

    def stage(self, j: int, slot: int):
        """Read segment ``j`` into ``slot``; returns its (bits, weights)
        tensors on the store's device (on the card: enqueued, not yet
        copied — ``consume`` waits).  Runs on the prefetch thread during
        overlapped sweeps and on the consumer in the synchronous one."""
        if self.dev.type != "cuda":
            bits, w = self.db.segment(j, mode="c")
            _M_BYTES_READ.inc(bits.nbytes + w.nbytes)
            return torch.from_numpy(bits), torch.from_numpy(w)
        bits, w = self.db.segment(j)
        _M_BYTES_READ.inc(bits.nbytes + w.nbytes)
        r = bits.shape[0]
        host_tx, host_w = self.host[slot]
        dev_tx, dev_w = self.dev_bufs[slot]
        with torch.cuda.device(self.dev):   # the current device is per thread
            self.copied[slot].synchronize()  # this pinned buffer's last copy
            host_tx[:r].numpy()[...] = bits
            host_w[:r].numpy()[...] = w
            with torch.cuda.stream(self.copy):
                # the kernel that last read this device buffer
                self.copy.wait_event(self.consumed[slot])
                dev_tx[:r].copy_(host_tx[:r], non_blocking=True)
                dev_w[:r].copy_(host_w[:r], non_blocking=True)
                self.copied[slot].record(self.copy)
        return dev_tx[:r], dev_w[:r]

    def consume(self, slot: int, launch: Callable[[], None]) -> None:
        """Run ``launch`` (the kernel reading ``slot``) after the slot's
        copy, on the consumer's current stream."""
        if self.dev.type != "cuda":
            launch()
            return
        compute = torch.cuda.current_stream(self.dev)
        compute.wait_event(self.copied[slot])
        launch()
        self.consumed[slot].record(compute)

    def finish(self) -> None:
        """Wait for every enqueued copy before the buffers are freed."""
        if self.dev.type == "cuda":
            self.copy.synchronize()


class _SegmentPrefetcher:
    """Background stager: stages up to ``PREFETCH_DEPTH`` segments ahead of
    the consuming sweep, segment i into staging slot ``i % _SLOTS``.

    All cross-thread state flows through one bounded ``queue.Queue`` (items
    ``("ok", j, tensors)`` / ``("err", exc)``) plus a stop ``Event`` — the
    thread assigns no shared attributes, so there is nothing for a lock to
    guard.  ``get(j)`` counts a prefetch HIT when the segment was already
    staged and queued at request time (the read truly overlapped the
    previous segment's kernel work) and a MISS when the consumer had to
    wait."""

    def __init__(self, staging: _Staging, order: Sequence[int]):
        self.hits = 0
        self.misses = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(staging, list(order)),
            name="spill-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, staging: _Staging, order: List[int]) -> None:
        try:
            for i, j in enumerate(order):
                if self._stop.is_set():
                    return
                if not self._put(("ok", j, staging.stage(j, i % _SLOTS))):
                    return
        except Exception as e:   # surfaces on the consumer, never lost
            _M_PREFETCH_ERRORS.inc()
            self._put(("err", e))

    def get(self, j: int):
        """The consumer's handoff for segment ``j`` (segments are consumed
        strictly in the order the prefetcher was given)."""
        if not self._q.empty():
            self.hits += 1
            _M_PREFETCH_HITS.inc()
        else:
            self.misses += 1
            _M_PREFETCH_MISSES.inc()
        while True:
            try:
                kind, *rest = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    raise RuntimeError(
                        f"spill prefetch thread ended before segment {j}")
        if kind == "err":
            raise rest[0]
        got_j, bufs = rest
        if got_j != j:
            raise RuntimeError(
                f"prefetch order diverged: wanted segment {j}, got {got_j}")
        return bufs

    def shutdown(self) -> None:
        self._stop.set()
        # unblock a producer stuck in put(): drain whatever is queued
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10)


def spilled_counts(
    db: SpilledDB,
    tgt_bits,                     # (K, W) uint32
    *,
    use_kernel: bool = True,
    accum: Optional[str] = None,
    block_k: Optional[int] = None,
    block_n: Optional[int] = None,
    init: Optional[np.ndarray] = None,     # (K, C) resume accumulator
    start_chunk: int = 0,
    on_chunk: Optional[Callable[[int, np.ndarray], None]] = None,
    prefetch: bool = True,
    chunk_rows: Optional[int] = None,      # accepted for StreamingDB parity
) -> torch.Tensor:                # (K, C) int32 on ``db.device``
    """Disk-tier chunked sweep; bit-identical to the all-RAM streaming sweep.

    Same resume contract as ``streaming_counts`` (``init`` / ``start_chunk``
    / ``on_chunk``, which gets a host copy of the accumulator), with segment
    files as the chunk grid.  With ``prefetch=True`` a background thread
    stages segment i+1 (and up to ``PREFETCH_DEPTH`` ahead) while the kernel
    counts segment i; ``prefetch=False`` is the synchronous ablation.
    ``chunk_rows`` is accepted for call-site parity with
    ``StreamingDB.counts`` but must match the on-disk grid — segments are
    immutable once spilled."""
    if chunk_rows is not None and int(chunk_rows) != db.chunk_rows:
        raise ValueError(
            f"spilled segments are fixed at chunk_rows={db.chunk_rows}; "
            f"re-spill to change the grid (got {chunk_rows})")
    dev = db.device
    tgt = _host(tgt_bits)
    k, c = int(tgt.shape[0]), db.n_classes
    if k == 0:
        return torch.zeros((0, c), dtype=torch.int32, device=dev)
    acc = (torch.zeros((k, c), dtype=torch.int32, device=dev) if init is None
           else torch.from_numpy(np.array(init, np.int32)).to(dev))
    nseg = db.n_chunks
    if db.n_unique == 0 or start_chunk >= nseg:
        return acc
    tgt_d = torch.from_numpy(tgt).to(dev)
    kw = dict(block_k=block_k, block_n=block_n, use_kernel=use_kernel,
              accum=accum)
    order = range(start_chunk, nseg)
    staging = _Staging(db, start_chunk)
    fetcher = (_SegmentPrefetcher(staging, order) if prefetch and
               nseg - start_chunk > 1 else None)
    try:
        with TRACER.span("spill.sweep", {"segments": nseg - start_chunk,
                                         "k": k, "prefetch": bool(fetcher)}):
            for i, j in enumerate(order):
                slot = i % _SLOTS
                tx, w = (fetcher.get(j) if fetcher is not None
                         else staging.stage(j, slot))
                staging.consume(slot, lambda: itemset_counts_into(
                    acc, tx, tgt_d, w, **kw))
                if on_chunk is not None:
                    on_chunk(j, acc.cpu().numpy().copy())
    finally:
        if fetcher is not None:
            fetcher.shutdown()
            total = fetcher.hits + fetcher.misses
            if total:
                REGISTRY.set_gauge("spill_prefetch_hit_ratio",
                                   fetcher.hits / total)
        staging.finish()
    return acc


class SpilledBackend(CountBackend):
    """:class:`~repro_torch.mining.backend.CountBackend` over a
    :class:`SpilledDB` — segment files are the checkpoint unit, so a mine
    killed mid-level resumes from the last durable segment after
    ``SpilledDB.open``."""

    def __init__(self, db: SpilledDB, *, use_kernel: bool = True,
                 accum: Optional[str] = None, prefetch: bool = True):
        self.db = db
        self.use_kernel = use_kernel
        self.accum = accum
        self.prefetch = prefetch
        self.vocab = db.vocab
        self.n_rows = db.n_rows
        self.n_classes = db.n_classes

    @property
    def nbytes(self) -> int:
        return self.db.nbytes

    @property
    def n_count_chunks(self) -> int:
        return self.db.n_chunks

    def chunk_signature(self) -> dict:
        return {"backend": "spilled", "chunk_rows": self.db.chunk_rows,
                "n_rows": self.db.n_unique}

    def close(self) -> None:
        """Delete the store's directory now where the backend's maker owns
        it (``backend_for_db`` without ``$REPRO_TORCH_SPILL_DIR``); else
        nothing.  The backend counts no more after it."""
        owned = getattr(self.db, "_owned", None)
        if owned is not None:
            owned()

    def traits(self):
        """Traits of rows sampled over every segment, with the TRUE on-disk
        footprint — the chooser must see the full nbytes, not the
        sample's."""
        from dataclasses import replace as _dc_replace

        from .chooser import TRAIT_SAMPLE_ROWS, DatasetTraits
        u = self.db.n_unique
        bits, w = self.db.rows_at(sample_index(u, min(u, TRAIT_SAMPLE_ROWS)))
        t = DatasetTraits.measure(bits, w, self.vocab, self.n_rows)
        return _dc_replace(t, nbytes=self.db.nbytes,
                           n_unique=self.db.n_unique,
                           dedup_ratio=(self.db.n_unique / self.n_rows
                                        if self.n_rows else 1.0))

    def counts(self, masks, *, block_k: Optional[int] = None,
               start_chunk: int = 0, init: Optional[np.ndarray] = None,
               on_chunk=None):
        rows = spilled_counts(
            self.db, masks, use_kernel=self.use_kernel, accum=self.accum,
            block_k=block_k, start_chunk=start_chunk, init=init,
            on_chunk=on_chunk, prefetch=self.prefetch)
        return _host(rows)
