"""Adaptive backend chooser: pick a counting engine from MEASURED dataset
characteristics instead of a fixed size threshold.

``DatasetTraits.measure`` samples rows spread evenly over the encoded
bitmap (``sample_index``) and derives:

  * ``density``     — mean fraction of vocab bits set per (sampled) unique
                      row.  Dense rows mean long frequent patterns and deep
                      level-wise sweeps — FP-growth's home turf.
  * ``skew``        — ratio of the top item's weighted support to the median
                      item's.  Heavy skew concentrates rows under a few tree
                      items, so conditional pattern bases stay small and the
                      guided walk wins even at moderate density.
  * ``dedup_ratio`` — unique rows / logical rows.  Low ratio = heavy prefix
                      compression = the bitmap behaves like a compact
                      FP-tree; conditional blocks are tiny.
  * ``n_rows`` / ``nbytes`` / ``vocab_size`` / ``n_classes`` — the scale
                      facts the residency rules already used.

``choose_backend(traits, ...)`` maps those to one of the four engines
(decision order, first match wins; thresholds are keyword-tunable):

  1. ``distributed`` — a multi-device mesh was handed in: shard the sweep.
  2. ``spilled``     — ``nbytes`` beyond the HOST-RAM spill budget (only when
                       the caller passes ``spill_threshold_bytes``, i.e. a
                       disk tier is configured): mmap segment files + async
                       prefetch (``mining/spill.py``).
  3. ``streaming``   — ``nbytes`` beyond the device-residency threshold:
                       correctness of residency beats per-launch efficiency.
  4. ``dense``       — tiny row counts: launch overhead dwarfs everything;
                       one resident sweep per level is unbeatable.
  5. ``gfp``         — a deep mine (unbounded ``max_len`` or >= ``min_depth``)
                       over a dense-and-compressible or heavily skewed DB:
                       the guided conditional walk replaces one whole-DB
                       launch per level with per-tree-item blocks.
  6. ``dense``       — otherwise: shallow mines and sparse uniform data keep
                       the level-wise sweep.

Every engine is exact, so the chooser is a pure performance policy — the
pins in ``tests/test_torch_chooser_gfp.py`` hold the port's verdicts to the
JAX package's and assert identical mining results whichever backend it
selects.  ``distributed`` needs a mesh of more than one rank (a
``torch.distributed`` ``DeviceMesh``, whose ``size()`` is a method, or
anything with an int ``size``) and ``spilled`` an opt-in spill budget.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..obs import REGISTRY
from .stream import DEFAULT_STREAM_THRESHOLD_BYTES, _db_device, _host

# Decision thresholds (first-match order documented above).  These are the
# hand-tuned FALLBACKS: thresholds passed as None resolve through the active
# tuning table's measured launch throughput first
# (``roofline.autotune.derived_chooser_thresholds``), so a tuned box derives
# its dense-vs-streaming and gfp-depth crossovers from evidence.
DEFAULT_TINY_ROWS = 2048        # below: dense, always
DEFAULT_DENSE_DENSITY = 0.25    # mean set-bit fraction marking a "dense" DB
DEFAULT_DEDUP_RATIO = 0.6       # unique/logical rows marking compressibility
DEFAULT_SKEW = 4.0              # top/median item support marking heavy skew
DEFAULT_MIN_DEPTH = 4           # pattern depth where per-level launches hurt


def _resolved_thresholds(stream_threshold_bytes, tiny_rows, min_depth):
    """Fill None thresholds from the tuning table's measured-throughput
    derivations, then from the hand-tuned defaults."""
    derived = None
    if stream_threshold_bytes is None or tiny_rows is None or min_depth is None:
        from ..roofline import autotune
        derived = autotune.derived_chooser_thresholds()
    if stream_threshold_bytes is None:
        stream_threshold_bytes = derived.get("stream_threshold_bytes",
                                             DEFAULT_STREAM_THRESHOLD_BYTES)
    if tiny_rows is None:
        tiny_rows = derived.get("tiny_rows", DEFAULT_TINY_ROWS)
    if min_depth is None:
        min_depth = derived.get("min_depth", DEFAULT_MIN_DEPTH)
    return int(stream_threshold_bytes), int(tiny_rows), int(min_depth)

# Trait measurement samples at most this many unique rows / columns.
TRAIT_SAMPLE_ROWS = 4096
_TRAIT_SAMPLE_COLS = 4096


def sample_index(u: int, s: int) -> np.ndarray:
    """``s`` row indices spread evenly over ``u`` rows (``s <= u``): row
    ``(i * u) // s`` for i < s, so ``s == u`` is every row.

    ``dedup_rows`` returns its rows sorted, so the first rows of a
    deduplicated bitmap are the emptiest ones; a head sample of a large DB
    reads its density and skew far off (a deliberate difference from the
    JAX package, which samples ``bits[:s]``)."""
    if s <= 0:
        return np.zeros(0, np.int64)
    return (np.arange(s, dtype=np.int64) * int(u)) // int(s)


@dataclass(frozen=True)
class DatasetTraits:
    """Measured characteristics of an encoded DB (see module docstring)."""
    n_rows: int          # logical rows (pre-dedup, weight total)
    n_unique: int        # deduped bitmap rows
    vocab_size: int
    n_classes: int
    nbytes: int          # bitmap + weights footprint
    density: float       # mean set-bit fraction per sampled unique row
    skew: float          # top weighted item support / median
    dedup_ratio: float   # n_unique / n_rows

    @classmethod
    def measure(cls, bits, weights, vocab, n_rows: int, *,
                sample_rows: int = TRAIT_SAMPLE_ROWS) -> "DatasetTraits":
        """Traits of host copies of the bits and weights (arrays or
        tensors on any device)."""
        bits = _host(bits)
        weights = _host(weights)
        u = int(bits.shape[0])
        nbytes = int(bits.nbytes + weights.nbytes)
        if u == 0 or vocab.size == 0 or n_rows == 0:
            return cls(n_rows=int(n_rows), n_unique=u, vocab_size=vocab.size,
                       n_classes=int(weights.shape[1]) if weights.ndim == 2
                       else 1,
                       nbytes=nbytes, density=0.0, skew=1.0, dedup_ratio=1.0)
        s = min(u, sample_rows)
        idx = sample_index(u, s)
        sample = np.ascontiguousarray(bits[idx], np.uint32)
        # mean bits-set per sampled unique row, as a fraction of the vocab
        popcnt = np.unpackbits(sample.view(np.uint8), axis=1).sum(axis=1)
        density = float(popcnt.mean()) / vocab.size
        # weighted per-item supports over the sample (stride-capped columns)
        wtot = weights[idx].sum(axis=1, dtype=np.int64)
        ncols = min(vocab.size, _TRAIT_SAMPLE_COLS)
        sup = np.empty(ncols, np.int64)
        for c in range(ncols):
            bit = (sample[:, c >> 5] >> np.uint32(c & 31)) & 1
            sup[c] = int((bit.astype(np.int64) * wtot).sum())
        top = float(sup.max())
        med = float(np.median(sup))
        skew = top / med if med > 0 else (float("inf") if top > 0 else 1.0)
        return cls(n_rows=int(n_rows), n_unique=u, vocab_size=vocab.size,
                   n_classes=int(weights.shape[1]), nbytes=nbytes,
                   density=density, skew=skew,
                   dedup_ratio=u / float(n_rows))

    @classmethod
    def of_db(cls, db) -> "DatasetTraits":
        return cls.measure(db.bits, db.weights, db.vocab, int(db.n_rows))


@dataclass(frozen=True)
class BackendChoice:
    """A chooser decision: engine ``name``, human-readable ``reason``, and
    the ``traits`` it was derived from (None for forced/explicit picks)."""
    name: str
    reason: str
    traits: Optional[DatasetTraits] = field(default=None)


def _record_choice(choice: BackendChoice) -> BackendChoice:
    """Publish one chooser verdict: a per-engine decision counter plus a
    one-hot ``chooser_last_decision`` gauge (``exclusive=True`` clears the
    previous engine's label, so exactly one label set reads 1)."""
    REGISTRY.counter("chooser_decisions_total", backend=choice.name).inc()
    REGISTRY.set_gauge("chooser_last_decision", 1, exclusive=True,
                       backend=choice.name)
    return choice


def choose_backend(
    traits: DatasetTraits,
    *,
    mesh=None,
    max_len: int = 0,
    stream_threshold_bytes: Optional[int] = None,
    spill_threshold_bytes: Optional[int] = None,
    tiny_rows: Optional[int] = None,
    dense_density: float = DEFAULT_DENSE_DENSITY,
    dedup_ratio: float = DEFAULT_DEDUP_RATIO,
    skew: float = DEFAULT_SKEW,
    min_depth: Optional[int] = None,
) -> BackendChoice:
    """Map measured traits to an engine name (decision order in the module
    docstring; first match wins).  Every verdict — whichever of the return
    points produced it — is recorded through :func:`_record_choice`."""
    return _record_choice(_choose_backend(
        traits, mesh=mesh, max_len=max_len,
        stream_threshold_bytes=stream_threshold_bytes,
        spill_threshold_bytes=spill_threshold_bytes, tiny_rows=tiny_rows,
        dense_density=dense_density, dedup_ratio=dedup_ratio, skew=skew,
        min_depth=min_depth))


def _mesh_size(mesh) -> int:
    """Ranks in ``mesh``: ``DeviceMesh.size()`` is a method, a plain int
    attribute elsewhere; no mesh is one device."""
    if mesh is None:
        return 1
    size = getattr(mesh, "size", 1)
    return int(size() if callable(size) else size)


def _choose_backend(
    traits: DatasetTraits,
    *,
    mesh=None,
    max_len: int = 0,
    stream_threshold_bytes: Optional[int] = None,
    spill_threshold_bytes: Optional[int] = None,
    tiny_rows: Optional[int] = None,
    dense_density: float = DEFAULT_DENSE_DENSITY,
    dedup_ratio: float = DEFAULT_DEDUP_RATIO,
    skew: float = DEFAULT_SKEW,
    min_depth: Optional[int] = None,
) -> BackendChoice:
    stream_threshold_bytes, tiny_rows, min_depth = _resolved_thresholds(
        stream_threshold_bytes, tiny_rows, min_depth)
    devices = _mesh_size(mesh)
    if devices > 1:
        return BackendChoice(
            "distributed",
            f"multi-device mesh ({devices} devices): shard the sweep", traits)
    # spill_threshold_bytes is opt-in (None = no disk tier configured): past
    # the host-RAM budget the rows cannot stay resident ANYWHERE, so disk
    # wins before the device-residency question is even asked
    if spill_threshold_bytes is not None and \
            traits.nbytes > int(spill_threshold_bytes):
        return BackendChoice(
            "spilled",
            f"{traits.nbytes} bytes exceeds the {int(spill_threshold_bytes)}"
            "-byte host-RAM spill budget: mmap disk segments + async "
            "prefetch", traits)
    if traits.nbytes > stream_threshold_bytes:
        return BackendChoice(
            "streaming",
            f"{traits.nbytes} bytes exceeds the {stream_threshold_bytes}-byte "
            "device-residency threshold", traits)
    deep = max_len == 0 or max_len >= min_depth
    if traits.n_rows < tiny_rows:
        return BackendChoice(
            "dense",
            f"tiny DB ({traits.n_rows} rows < {tiny_rows}): launch overhead "
            "dominates, one resident sweep per level", traits)
    if deep and traits.density >= dense_density \
            and traits.dedup_ratio <= dedup_ratio:
        return BackendChoice(
            "gfp",
            f"dense ({traits.density:.2f} >= {dense_density}) and "
            f"compressible ({traits.dedup_ratio:.2f} <= {dedup_ratio}) with "
            "deep patterns: guided conditional counting beats per-level "
            "launches", traits)
    if deep and traits.skew >= skew:
        return BackendChoice(
            "gfp",
            f"skewed item supports ({traits.skew:.1f}x >= {skew}x): "
            "conditional pattern bases stay small", traits)
    return BackendChoice(
        "dense",
        "shallow mine or sparse uniform data: level-wise resident sweep",
        traits)


def backend_for_db(db, *, mesh=None, max_len: int = 0, use_kernel: bool = True,
                   name: Optional[str] = None, **thresholds):
    """Construct the chosen (or ``name``-forced) backend over ``db`` — a
    :class:`~repro_torch.mining.dense.DenseDB`, a
    :class:`~repro_torch.mining.stream.StreamingDB`, a
    :class:`~repro_torch.mining.spill.SpilledDB`, or anything exposing
    bits/weights/vocab/n_rows/n_classes.  Returns ``(backend, choice)``.
    Every backend counts on the DB's device; ``spilled`` writes the DB into
    ``$REPRO_TORCH_SPILL_DIR`` unless it is a ``SpilledDB`` already, or,
    without the variable, into a temporary directory that is deleted with
    the store (garbage collection or ``SpilledBackend.close()``; the JAX
    package leaves it behind).

    Engine imports stay function-level: the chooser is imported by the
    backends' ``traits()`` hook, so module-level engine imports would cycle.
    """
    if name is None or name == "auto":
        traits = DatasetTraits.of_db(db)
        choice = choose_backend(traits, mesh=mesh, max_len=max_len,
                                **thresholds)
    else:
        choice = BackendChoice(name, "explicitly requested")

    device = _db_device(db)
    if choice.name == "distributed":
        from .distributed import DistributedMiner
        miner = DistributedMiner(mesh, use_kernel=use_kernel, device=device)
        return miner.backend(_host(db.bits), _host(db.weights),
                             db.vocab), choice
    from .backend import backend_of
    if choice.name == "spilled":
        from .spill import SpilledDB, own_directory, spill_root
        sdb = db
        if not isinstance(db, SpilledDB):
            root, made = spill_root()
            sdb = SpilledDB.spill(
                db.vocab, _host(db.bits), _host(db.weights), int(db.n_rows),
                int(db.n_classes), root, device=device)
            if made:
                own_directory(sdb)
        return backend_of(sdb, use_kernel=use_kernel), choice
    if choice.name == "streaming":
        from .stream import StreamingDB
        sdb = db if isinstance(db, StreamingDB) else StreamingDB.from_arrays(
            db.vocab, _host(db.bits), _host(db.weights), int(db.n_rows),
            int(db.n_classes), device=device)
        return backend_of(sdb, use_kernel=use_kernel), choice
    if choice.name == "gfp":
        from .gfp_backend import GFPBackend
        return GFPBackend(db, use_kernel=use_kernel), choice
    if choice.name == "dense":
        from .dense import DenseDB
        ddb = db if isinstance(db, DenseDB) else DenseDB.from_arrays(
            db.vocab, _host(db.bits), _host(db.weights),
            n_rows=int(db.n_rows), n_classes=int(db.n_classes), device=device)
        return backend_of(ddb, use_kernel=use_kernel), choice
    raise ValueError(f"unknown backend {choice.name!r}")
