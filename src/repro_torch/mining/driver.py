"""The ONE level-wise mining loop, parameterized on a :class:`CountBackend`.

Every engine entry point (``dense_mine_frequent``,
``streaming_mine_frequent``) is a thin shim over :func:`mine_frequent` below: the
driver owns candidate generation (``apriori_gen`` + canonical ordering),
threshold absorption, the level-1 singles pass (with the backend's
``item_counts`` shortcut when it has one), and ``MiningCheckpoint`` save/load —
including the MID-LEVEL partial state generalized from the streaming engine,
so kill/resume works on every backend at that backend's chunk granularity.

The paper-faithful host baselines (``core.apriori``, ``core.apriori_gfp``)
deliberately keep their own independent loops: they are the oracles the
engine parity tests validate this driver against.

Checkpoint format (shared with the pre-driver streaming engine, forward and
backward compatible):

  * completed levels: ``{level, frequent, meta}`` where ``meta`` carries the
    backend's ``mine_signature()`` — a mismatch on load discards the whole
    state (e.g. a ``VersionedDB`` resume across an ``append``);
  * mid-level partial: ``{level, itemsets, next_chunk, acc}`` merged with the
    backend's ``chunk_signature()`` — resumed only when the signature AND the
    regenerated candidate list match, else the level restarts from chunk 0.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np

from ..obs import REGISTRY, TRACER
from .backend import CountBackend
from .encode import encode_targets
from .plan import canonical_itemsets

Item = Hashable
Key = Tuple[Item, ...]

_M_LEVELS = REGISTRY.counter("mine_levels_total")
_M_CANDIDATES = REGISTRY.counter("mine_candidates_total")
_M_FREQUENT = REGISTRY.counter("mine_frequent_total")
_M_CHUNKS = REGISTRY.counter("mine_chunks_total")


def mine_frequent(
    backend: CountBackend,
    min_count: float,
    *,
    class_column: Optional[int] = None,
    max_len: int = 0,
    checkpoint=None,                 # Optional[MiningCheckpoint]
    on_level: Optional[Callable[[int, int, int], None]] = None,
    on_chunk: Optional[Callable[[int, int], None]] = None,
    level1_shortcut: Optional[bool] = None,
) -> Dict[Key, int]:
    """Exact level-synchronous frequent-itemset mining over any backend.

    Returns ``{sorted-itemset-tuple -> count}`` with ``count >= min_count``
    (``class_column`` restricts support to one weight column; ``max_len``
    caps the itemset length; 0 = unbounded).  The threshold comparison is
    ``count >= min_count`` with ``min_count`` as given — use
    ``repro_torch.core.incremental.ceil_count(theta * n)`` to turn a relative
    threshold into a count.

    With a ``checkpoint``, progress is durable at the backend's chunk
    granularity: each completed level is saved, and each completed chunk of
    an in-flight level saves a partial ``(itemsets, next_chunk, accumulator)``
    record, so a killed mine resumes mid-level — on a multi-chunk backend
    from the last completed chunk, on a single-chunk backend by skipping any
    fully-counted level.  Hooks: ``on_chunk(level, chunk_idx)`` after each
    chunk's durable save (without a checkpoint: once per swept chunk, after
    the level's sweep), ``on_level(level, n_candidates, n_frequent)``
    after each level's absorb.  ``level1_shortcut`` controls the backend's
    ``item_counts`` fast path for singles (None = use it when available).
    The whole loop is the span ``mine.driver``.
    """
    with TRACER.span("mine.driver", {"class_column": class_column}):
        return _mine_frequent(
            backend, min_count, class_column=class_column, max_len=max_len,
            checkpoint=checkpoint, on_level=on_level, on_chunk=on_chunk,
            level1_shortcut=level1_shortcut)


def _mine_frequent(backend: CountBackend, min_count: float, *,
                   class_column: Optional[int], max_len: int, checkpoint,
                   on_level, on_chunk,
                   level1_shortcut: Optional[bool]) -> Dict[Key, int]:
    out: Dict[Key, int] = {}
    partial: Optional[dict] = None
    level = 0
    # the checkpoint identity is the backend state AND the mining parameters:
    # a saved total-count mine must not answer a class-guided resume (or a
    # different threshold/cap) at the same store version — the absorbed
    # levels would be silently wrong for the new query
    msig = dict(backend.mine_signature())
    msig.update(min_count=float(min_count), class_column=class_column,
                max_len=max_len)
    if checkpoint is not None:
        state = checkpoint.load_state()
        if state is not None and all(
                state.get("meta", {}).get(k) == v for k, v in msig.items()):
            level = int(state["level"])
            out = dict(state["frequent"])
            partial = state.get("partial")

    csig = backend.chunk_signature()

    def _count_level(itemsets: List[Key], masks: np.ndarray,
                     lvl: int) -> np.ndarray:
        nonlocal partial
        # JSON-stable level identity; only materialized when durability or
        # progress hooks are in play (the hot path skips it)
        wire = ([list(t) for t in itemsets]
                if (checkpoint is not None or partial) else None)
        start, init = 0, None
        if (partial and partial.get("level") == lvl
                and partial.get("itemsets") == wire
                and all(partial.get(k) == v for k, v in csig.items())):
            start = int(partial["next_chunk"])
            init = np.asarray(partial["acc"], np.int32)
        partial = None

        def _ckpt(j: int, acc) -> None:
            if checkpoint is not None:
                checkpoint.save(lvl - 1, out, meta=msig, partial={
                    "level": lvl, "itemsets": wire, "next_chunk": j + 1,
                    "acc": np.asarray(acc).tolist(), **csig,
                })
            if on_chunk is not None:  # after the save: a crash resumes at j+1
                on_chunk(lvl, j)

        # only a checkpoint needs the per-chunk accumulator: handing it over
        # copies it to the host after every chunk, which waits for that
        # chunk's launch and so stops a pipelined sweep
        hook = _ckpt if checkpoint is not None else None
        # chunk accounting without forcing the hook on (the hot path skips
        # the per-chunk callback entirely): the sweep covers exactly the
        # chunks from the resume point to the end of the grid
        _M_CHUNKS.inc(backend.n_count_chunks - start)
        with TRACER.span("mine.level",
                         {"level": lvl, "n_candidates": len(itemsets),
                          "start_chunk": start}):
            rows = np.asarray(backend.counts(masks, start_chunk=start,
                                             init=init, on_chunk=hook))
        if checkpoint is None and on_chunk is not None and len(itemsets):
            for j in range(start, backend.n_count_chunks):
                on_chunk(lvl, j)      # progress only: after the level's sweep
        return rows

    def _absorb(itemsets: List[Key], rows: np.ndarray) -> set:
        frequent = set()
        for itemset, row in zip(itemsets, rows):
            cnt = (int(row.sum()) if class_column is None
                   else int(row[class_column]))
            if cnt >= min_count:
                frequent.add(frozenset(itemset))
                out[itemset] = cnt
        return frequent

    if level == 0:
        singles: List[Key] = [(a,) for a in backend.vocab.items]
        frequent: set = set()
        if singles:
            with TRACER.span("mine.singles", {"n_candidates": len(singles)}):
                shortcut = (backend.item_counts()
                            if level1_shortcut is not False else None)
                if level1_shortcut is True and shortcut is None:
                    raise ValueError(
                        "backend has no level-1 item_counts shortcut")
                rows = shortcut if shortcut is not None else _count_level(
                    singles, encode_targets(singles, backend.vocab), 1)
                frequent = _absorb(singles, rows)
        level = 1
        _M_LEVELS.inc()
        _M_CANDIDATES.inc(len(singles))
        _M_FREQUENT.inc(len(frequent))
        if checkpoint is not None:
            checkpoint.save(level, out, meta=msig)
        if on_level is not None:
            on_level(1, len(singles), len(frequent))
    else:
        frequent = {frozenset(t) for t in out if len(t) == level}

    from ..core.apriori import apriori_gen

    while frequent and (max_len == 0 or level < max_len):
        with TRACER.span("mine.candidates", {"level": level + 1}) as sp:
            itemsets = canonical_itemsets(apriori_gen(frequent, level))
            masks = encode_targets(itemsets, backend.vocab)
            sp.set("n_candidates", len(itemsets))
        if not itemsets:
            break
        rows = _count_level(itemsets, masks, level + 1)
        with TRACER.span("mine.absorb", {"level": level + 1}):
            frequent = _absorb(itemsets, rows)
        level += 1
        _M_LEVELS.inc()
        _M_CANDIDATES.inc(len(itemsets))
        _M_FREQUENT.inc(len(frequent))
        if checkpoint is not None:
            checkpoint.save(level, out, meta=msig)
        if on_level is not None:
            on_level(level, len(itemsets), len(frequent))
    return out
