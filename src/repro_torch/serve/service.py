"""The GFP count server: micro-batched count serving, sync or async/sharded.

``CountServer`` ties the serving subsystem together:

  * :class:`~repro_torch.serve.store.VersionedDB` — the resident encoded DB
    (device-dense or host-streaming by size) with versioned appends — or,
    with ``shards=``, a :class:`~repro_torch.serve.shard.ShardedDB` spanning
    row-partitioned shards (optionally laid out over a device mesh), counts
    all-reduced exactly;
  * :class:`~repro_torch.serve.batcher.MicroBatcher` — ``submit()`` queues
    (client_id, itemsets) requests, ``flush()`` answers them all with ONE
    composed counting pass (cross-client deduped, block_k-padded);
  * :class:`~repro_torch.serve.cache.CountCache` — (itemset, version)-keyed
    LRU so repeated hot queries skip the device entirely; ``append``
    invalidates by bumping the version;
  * with ``async_flush=True``, an
    :class:`~repro_torch.serve.async_loop.AsyncFlusher` — ``submit_async()``
    returns a future, a background thread flushes on occupancy
    (``min_batch``) or deadline (``max_delay_ms``), and ``close()`` drains
    every pending ticket.  All state-touching operations then serialize
    behind one re-entrant lock.  Over a mesh of more than one rank the
    server refuses ``async_flush`` (``ValueError``): every rank's thread
    would pick its own flush times, so the ranks' all-reduces would pair
    different batches or hang.  The JAX package, one process over its mesh,
    has no such limit.

Everything counts on ``device`` (default: the card; ``"cpu"`` runs the
plain PyTorch version on the host), passed down to every store, delta
mirror and placement the server builds.

Served counts are EXACT: every row equals a fresh ``dense_gfp_counts`` /
brute-force run over the full transaction history at the same version.
Each answer names that version: ``CountFuture.version`` on the async path,
``Answers.versions[ticket]`` beside the blocks ``flush()`` returns.  A
flush counts at the store version current when it starts; appends through
``CountServer.append`` and flushes serialize on the server, so an answer's
version is at least that of every append acknowledged before its request
was submitted.

Incremental re-mining (paper §5.2): ``mine(theta)`` bootstraps the frequent
set on the resident engine; after each ``append`` the server re-establishes
it from the pigeonhole candidate set (``incremental_candidates`` — the same
pure function the host ``IncrementalMiner`` uses), recounting the candidates
through the dense/streaming engine in one guided batch instead of host
FP-tree walks.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Hashable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import obs
from ..core.fpgrowth import mine_frequent
from ..core.incremental import ceil_count, incremental_candidates
from .._device import DeviceLike
from ..mining.chooser import _mesh_size
from ..obs import REGISTRY, TRACER
from .async_loop import AsyncFlusher, CountFuture
from .batcher import MicroBatcher, build_masks, canonical_itemset
from .cache import CountCache
from .shard import ShardedCountBackend, ShardedDB
from .store import VersionedDB

Item = Hashable
Key = Tuple[Item, ...]

_H_FLUSH_MS = REGISTRY.histogram("serve_flush_ms")
_M_APPENDS = REGISTRY.counter("serve_appends_total")


class Answers(dict):
    """What ``flush()`` returns: {ticket -> (len(itemsets), C) int32 block},
    and ``versions``: {ticket -> the store version the block was counted
    at}.  A manual flush of an async server also hands back blocks that a
    background flush counted earlier, each with its own version."""

    def __init__(self):
        super().__init__()
        self.versions: Dict[int, int] = {}


class MiningRefreshError(RuntimeError):
    """Raised by ``CountServer.append`` when the batch WAS committed to the
    store (``version`` is the new version) but the §5.2 frequent-set refresh
    failed and incremental maintenance was disarmed.  Distinguishes
    'committed, re-mine needed' from a rejected append (which raises
    ``ValueError``/``OverflowError`` and leaves no trace) — do NOT retry the
    append, the rows would be double-counted."""

    def __init__(self, version: int, cause: BaseException):
        super().__init__(
            f"batch committed at version {version}, but the frequent-set "
            f"refresh failed ({cause!r}); incremental mining disarmed — "
            "call mine() to re-arm, do not retry the append")
        self.version = version


def versioned_mine_frequent(
    store: Union[VersionedDB, ShardedDB],
    min_count: float,
    *,
    class_column: Optional[int] = None,
    max_len: int = 0,
    checkpoint=None,                 # Optional[MiningCheckpoint]
    on_chunk=None,
) -> Dict[Key, int]:
    """Level-synchronous exact mining over a :class:`VersionedDB` (or a
    :class:`~repro_torch.serve.shard.ShardedDB`) — a shim over the unified driver
    (``mining/driver.py``) with the store-composed
    :class:`~repro_torch.serve.store.VersionedCountBackend` (resp.
    :class:`~repro_torch.serve.shard.ShardedCountBackend`): the same contract as
    ``dense_mine_frequent`` but counting through the store's composed
    base+delta sweep, so it is correct mid-append without compaction.

    With a ``checkpoint``, progress is durable at the store's chunk
    granularity (base chunks + delta chunk, or one chunk per shard) and
    PINNED to the store version: a killed mine resumes mid-level at the same
    version, while a resume after an ``append`` discards the stale state and
    restarts cleanly."""
    from ..mining.driver import mine_frequent as _driver_mine
    from .store import VersionedCountBackend

    backend = (ShardedCountBackend(store) if isinstance(store, ShardedDB)
               else VersionedCountBackend(store))
    return _driver_mine(backend, min_count,
                        class_column=class_column, max_len=max_len,
                        checkpoint=checkpoint, on_chunk=on_chunk)


class CountServer:
    """Driver loop: ``submit`` / ``flush`` / ``append`` / ``stats`` — plus
    ``submit_async`` / ``close`` when ``async_flush`` is on."""

    def __init__(
        self,
        transactions: Sequence[Sequence[Item]] = (),
        classes: Optional[Sequence[int]] = None,
        n_classes: Optional[int] = None,
        *,
        use_kernel: bool = True,
        streaming: Optional[bool] = None,
        chunk_rows: Optional[int] = None,
        cache_size: int = 65536,
        cache_bytes: Optional[int] = None,
        cache: bool = True,
        block_k: Optional[int] = None,
        merge_ratio: float = 0.25,
        min_compact_rows: Optional[int] = None,
        spill_dir: Optional[str] = None,
        spill_threshold_bytes: Optional[int] = None,
        background_compaction: bool = False,
        shards: Optional[int] = None,
        mesh=None,
        async_flush: bool = False,
        max_delay_ms: float = 5.0,
        min_batch: int = 8,
        device: DeviceLike = None,
    ):
        if async_flush and mesh is not None and _mesh_size(mesh) > 1:
            raise ValueError(
                "async_flush over a mesh of more than one rank: each rank's "
                "flusher would pick its own flush times and the ranks' "
                "all-reduces would pair different batches; flush "
                "synchronously (the same calls on every rank)")
        if shards is not None:
            if spill_dir is not None or spill_threshold_bytes is not None:
                # shards ARE the residency decision: rows too big for one
                # device get partitioned, not spilled per-shard
                raise ValueError("spill_dir/spill_threshold_bytes require "
                                 "an unsharded store (shards=None)")
            self.store: Union[VersionedDB, ShardedDB] = ShardedDB(
                transactions, classes=classes, n_classes=n_classes,
                n_shards=shards, mesh=mesh, use_kernel=use_kernel,
                streaming=streaming, chunk_rows=chunk_rows,
                merge_ratio=merge_ratio, min_compact_rows=min_compact_rows,
                device=device)
        elif mesh is not None:
            raise ValueError("mesh= requires shards=")
        else:
            self.store = VersionedDB(
                transactions, classes=classes, n_classes=n_classes,
                use_kernel=use_kernel, streaming=streaming,
                chunk_rows=chunk_rows, merge_ratio=merge_ratio,
                min_compact_rows=min_compact_rows, spill_dir=spill_dir,
                spill_threshold_bytes=spill_threshold_bytes,
                background_compaction=background_compaction, device=device)
        if block_k is None:
            # tune the serve pad size to the resident geometry: the table is
            # keyed on the bucket the store's sweeps will actually launch
            from ..roofline import autotune
            block_k = autotune.resolve_serve_block_k(self.store)
        self.batcher = MicroBatcher(block_k=block_k)
        self.cache: Optional[CountCache] = \
            CountCache(cache_size, max_bytes=cache_bytes) if cache else None
        self.n_flushes = 0
        self.n_queries_served = 0
        self.last_backend_choice = None   # BackendChoice of the last mine()
        self._theta: Optional[float] = None
        self._frequent: Dict[Key, int] = {}
        # every state-touching op serializes behind ONE re-entrant lock when
        # a background flusher can race it; sync-only servers pay nothing
        self._lock = (threading.RLock() if async_flush
                      else contextlib.nullcontext())
        self._flusher: Optional[AsyncFlusher] = (
            AsyncFlusher(self, max_delay_ms=max_delay_ms,
                         min_batch=min_batch) if async_flush else None)

    # -- query path -----------------------------------------------------------
    def submit(self, client_id: str,
               itemsets: Sequence[Sequence[Item]]) -> int:
        """Queue one client request; returns the ticket ``flush()`` keys on."""
        t_enter = time.perf_counter()
        with self._lock:
            t_held = time.perf_counter() if TRACER.enabled else None
            ticket = self.batcher.submit(client_id, itemsets, t_enter)
            if t_held is not None:
                TRACER.record("serve.lock_wait", t_enter, t_held,
                              {"ticket": ticket})
            return ticket

    def submit_async(self, client_id: str,
                     itemsets: Sequence[Sequence[Item]]) -> CountFuture:
        """Queue one request on the background flush loop; returns a
        :class:`~repro_torch.serve.async_loop.CountFuture` whose ``result()``
        blocks until an occupancy-/deadline-triggered (or explicit) flush
        answers the ticket.  Requires ``async_flush=True``."""
        if self._flusher is None:
            raise RuntimeError(
                "submit_async requires CountServer(async_flush=True)")
        return self._flusher.submit(client_id, itemsets)

    def close(self) -> None:
        """Stop the background flush loop (if any) and drain every pending
        ticket.  The server stays usable synchronously afterwards."""
        if self._flusher is not None:
            self._flusher.close()
        closer = getattr(self.store, "close", None)
        if closer is not None:
            closer()   # drain + stop the store's background compactor

    def __enter__(self) -> "CountServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def flush(self) -> Answers:
        """Answer every pending request with one composed counting pass.

        Returns {ticket -> (len(itemsets), C) int32}, rows in each request's
        submission order, as :class:`Answers`, whose ``versions`` name the
        store version each block was counted at.  Unique uncached targets
        are counted in ONE block_k-padded launch per resident segment;
        cached targets (same itemset, same version) never touch the device.
        Async-submitted tickets in the batch have their futures fulfilled
        too, whoever triggered the flush — and symmetrically, a
        synchronously submitted ticket that a BACKGROUND flush drained is
        returned by the next ``flush()`` call rather than dropped.
        """
        with self._lock:
            started = time.monotonic()
            # _reason is set => this call IS the background/drain trigger,
            # whose return value is discarded — only a manual caller can
            # claim the stash of background-answered sync tickets
            manual = self._flusher is None or self._flusher._reason is None
            trigger = ("sync" if self._flusher is None
                       else (self._flusher._reason or "manual"))
            t0 = time.perf_counter()
            with TRACER.span("serve.flush", {"trigger": trigger}) as sp:
                out = self._flush_impl()
                sp.set("n_tickets", len(out))
            if out:
                _H_FLUSH_MS.observe((time.perf_counter() - t0) * 1e3)
                if self._flusher is None:
                    # async servers count flushes (by trigger) in _dispatch;
                    # the sync-only path owns its own increment
                    REGISTRY.counter("serve_flushes_total",
                                     trigger="sync").inc()
            if self._flusher is not None:
                # serve.dispatch follows serve.flush, which times the
                # flush alone
                with TRACER.span("serve.dispatch", {"n_tickets": len(out)}):
                    self._flusher._dispatch(out, started=started)
                if manual:
                    for ticket, (block, version) in \
                            self._flusher.claim_unclaimed().items():
                        out[ticket] = block
                        out.versions[ticket] = version
            return out

    def _flush_impl(self) -> Answers:
        with TRACER.span("serve.dedup") as sp:
            plan = self.batcher.take()
            sp.set("n_requests", len(plan.requests))
            sp.set("n_queries", plan.n_queries)
            sp.set("n_unique", len(plan.unique_keys))
            if plan.requests:
                sp.set("first_ticket", plan.requests[0].request_id)
                sp.set("last_ticket", plan.requests[-1].request_id)
        out = Answers()
        if not plan.requests:
            return out
        try:
            resolved, version = self._resolve(plan.unique_keys)
        except BaseException:
            self.batcher.restore(plan.requests)  # failed flush is retryable
            raise
        with TRACER.span("serve.reply", {"n_requests": len(plan.requests)}):
            for req in plan.requests:
                block = (np.stack([resolved[k] for k in req.keys])
                         if req.keys
                         else np.zeros((0, self.store.n_classes), np.int32))
                out[req.request_id] = block.astype(np.int32, copy=False)
                out.versions[req.request_id] = version
        self.n_flushes += 1
        self.n_queries_served += plan.n_queries
        if self.cache is not None:
            # drain point: push the cache's plain-counter deltas into the
            # registry mirrors (the per-key get/put path is registry-free)
            self.cache.publish_metrics()
        return out

    def _resolve(self, keys: Sequence[Key]
                 ) -> Tuple[Dict[Key, np.ndarray], int]:
        """({key -> (C,) counts}, version) at the CURRENT version: cache
        hits first, one block_k-padded composed counting pass for the
        rest."""
        version = self.store.version
        resolved: Dict[Key, np.ndarray] = {}
        missing: List[Key] = []
        with TRACER.span("serve.cache_lookup"):
            for key in keys:
                hit = self.cache.get(key, version) if self.cache is not None \
                    else None
                if hit is not None:
                    resolved[key] = hit
                else:
                    missing.append(key)
        if missing:
            with TRACER.span("serve.count",
                             {"n_masks": len(missing), "version": version,
                              "cache_hits": len(keys) - len(missing)}):
                with TRACER.span("serve.masks"):
                    masks, known = build_masks(missing, self.store.vocab,
                                               self.batcher.block_k)
                rows = self.store.counts_masks(
                    masks, block_k=self.batcher.block_k)[:len(missing)]
                rows[~known] = 0     # unknown-item targets count exactly 0
            with TRACER.span("serve.cache_fill", {"n": len(missing)}):
                for key, row in zip(missing, rows):
                    resolved[key] = row
                    if self.cache is not None:
                        self.cache.put(key, version, row)
        elif keys:
            TRACER.instant("serve.count_skipped",
                           {"cache_hits": len(keys), "version": version})
        return resolved, version

    def query(self, itemsets: Sequence[Sequence[Item]],
              client_id: str = "_local") -> np.ndarray:
        """Answer one request immediately, WITHOUT draining the batcher:
        other clients' pending requests stay queued and are answered by the
        next ``flush()`` at whatever version is current then — an interleaved
        ``query()`` can neither orphan their tickets nor freeze their counts
        at an older version."""
        with self._lock, \
                TRACER.span("serve.query", {"n_itemsets": len(itemsets)}):
            keys = [canonical_itemset(s) for s in itemsets]
            resolved, _ = self._resolve(list(dict.fromkeys(keys)))
            self.n_queries_served += len(keys)
            if not keys:
                return np.zeros((0, self.store.n_classes), np.int32)
            return np.stack([resolved[k] for k in keys]).astype(np.int32,
                                                                copy=False)

    # -- growth path ----------------------------------------------------------
    def append(self, transactions: Sequence[Sequence[Item]],
               classes: Optional[Sequence[int]] = None) -> int:
        """Fold a new batch into the resident DB (version bump ⇒ cache
        invalidation) and, if mining is active, refresh the frequent set via
        the §5.2 guided recount on the engine."""
        # the store copies each row once; this list only lets the §5.2
        # refresh walk the batch a second time
        transactions = list(transactions)
        with self._lock, \
                TRACER.span("serve.append",
                            {"n_rows": len(transactions)}) as sp:
            old_version = self.store.version
            version = self.store.append(transactions, classes=classes)
            sp.set("version", version)
            _M_APPENDS.inc()
            if version != old_version and self.cache is not None:
                self.cache.purge_stale(version)  # every old-version row dead
            if self._theta is not None and transactions:
                try:
                    self._refresh_frequent(transactions)
                except Exception as e:
                    # §5.2 completeness needs the PREVIOUS exact frequent
                    # set; after a failed refresh that baseline is lost for
                    # the new version — serving the stale set would be
                    # silently wrong, so disarm and require a fresh mine().
                    # The batch itself IS committed; MiningRefreshError tells
                    # the caller not to retry.
                    self._theta = None
                    self._frequent = {}
                    raise MiningRefreshError(version, e) from e
            return version

    def _mining_backend(self, which: str):
        """Resolve the counting backend for ``mine``: the adaptive chooser
        over measured store traits (``which == "auto"``), or an explicit
        engine name.  A sharded store always mines through its own
        all-reduced backend (shards are the residency decision).  Returns
        ``(backend, BackendChoice)``."""
        from ..mining.chooser import BackendChoice, choose_backend
        from .store import VersionedCountBackend

        if isinstance(self.store, ShardedDB):
            return ShardedCountBackend(self.store), BackendChoice(
                "store", "sharded store: mine through the all-reduced "
                "composed sweep")
        composed = VersionedCountBackend(self.store)
        if which == "store":
            return composed, BackendChoice(
                "store", "explicitly requested: composed base+delta sweep")
        if which == "auto":
            choice = choose_backend(composed.traits())
        elif which in ("dense", "streaming", "spilled", "gfp", "distributed"):
            choice = BackendChoice(which, "explicitly requested")
        else:
            raise ValueError(
                f"unknown mining backend {which!r}: expected auto, store, "
                "dense, streaming, spilled, or gfp")
        if choice.name == "gfp":
            from ..mining.gfp_backend import GFPBackend
            return GFPBackend.from_store(
                self.store, use_kernel=self.store.use_kernel), choice
        # dense / streaming / spilled / distributed verdicts all mine through
        # the store's composed sweep: residency is the STORE's decision (its
        # base is already dense, streaming, or spilled by the same traits),
        # and a serving store has no mesh to shard over
        return composed, choice

    def mine(self, theta: float, *, checkpoint=None,
             class_column: Optional[int] = None,
             backend: str = "auto") -> Dict[Key, int]:
        """Bootstrap exact frequent-itemset mining at relative threshold
        ``theta``; subsequent ``append`` calls maintain it incrementally.

        ``checkpoint`` (a ``MiningCheckpoint``) makes the bootstrap RESUMABLE
        through the unified driver: over a disk-sized streaming-backed store
        the mine persists per-chunk progress, so a killed server process can
        restart and finish the bootstrap from the last completed chunk.  The
        durable state is pinned to the store version — a resume after further
        appends restarts the mine cleanly instead of serving stale levels.

        ``class_column`` restricts support to ONE class's count column (the
        MRA antecedent discovery behind ``RuleServer.top_rules``: itemsets
        with C_class >= ceil_count(theta * n_rows)).  A class-guided mine is
        a QUERY, not a baseline: it returns the frequent set without arming
        §5.2 incremental maintenance, whose pigeonhole argument is stated on
        total counts.

        ``backend`` picks the counting engine: ``"auto"`` (default) consults
        the adaptive chooser over measured store traits — the GFP-growth
        hybrid on dense/compressible/skewed data, the store's composed sweep
        otherwise; ``"store"`` forces the composed base+delta sweep;
        ``"gfp"``/``"dense"``/``"streaming"`` force an engine.  Every engine
        is exact, so the choice never changes the result (pinned by
        ``tests/test_torch_serving.py``); the decision taken is recorded on
        ``last_backend_choice``."""
        if not (0.0 < theta <= 1.0):
            raise ValueError("theta in (0, 1]")
        if class_column is not None and \
                not (0 <= class_column < self.store.n_classes):
            raise ValueError(
                f"class_column {class_column} out of range for "
                f"n_classes={self.store.n_classes}")
        with self._lock, \
                TRACER.span("serve.mine", {"theta": theta}) as sp:
            be, choice = self._mining_backend(backend)
            self.last_backend_choice = choice
            sp.set("backend", choice.name)
            mc = ceil_count(theta * self.store.n_rows)
            if choice.name == "gfp":
                from ..mining.driver import mine_frequent as _driver_mine
                frequent = _driver_mine(be, mc, class_column=class_column,
                                        checkpoint=checkpoint)
            else:
                # every composed verdict mines through the module-level shim
                # (module-level on purpose: it is the failure-injection seam)
                frequent = versioned_mine_frequent(
                    self.store, mc, class_column=class_column,
                    checkpoint=checkpoint)
            if class_column is None:
                # commit only after the mine succeeds: a failed mine must not
                # arm incremental maintenance over an empty/stale baseline
                self._theta, self._frequent = theta, frequent
            return dict(frequent)

    def _refresh_frequent(self, increment: List[List[Item]]) -> None:
        # Pigeonhole candidates (complete: combined-frequent ⇒ frequent in the
        # old data or in the increment), then ONE guided engine recount of all
        # candidates over the full resident history — no host FP-tree walk.
        inc_frequent = mine_frequent(
            increment, ceil_count(self._theta * len(increment)))
        previously, newly = incremental_candidates(self._frequent,
                                                   inc_frequent)
        candidates = previously + newly
        if not candidates:
            self._frequent = {}
            return
        rows = self.store.counts(candidates).sum(axis=1)
        min_total = ceil_count(self._theta * self.store.n_rows)
        self._frequent = {k: int(c) for k, c in zip(candidates, rows)
                          if int(c) >= min_total}

    @property
    def frequent(self) -> Dict[Key, int]:
        if self._theta is None:
            raise RuntimeError("call mine() first")
        return dict(self._frequent)

    # -- introspection --------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "store": self.store.stats(),
                "batcher": self.batcher.stats(),
                "cache": (self.cache.stats() if self.cache is not None
                          else None),
                "async": (self._flusher.stats() if self._flusher is not None
                          else None),
                "flushes": self.n_flushes,
                "queries_served": self.n_queries_served,
                "mining_theta": self._theta,
                "frequent_itemsets": (len(self._frequent)
                                      if self._theta is not None else None),
                # registry-backed process-wide telemetry: the raw metrics
                # snapshot plus the kernel measured-vs-predicted report
                "telemetry": obs.telemetry_section(),
            }
