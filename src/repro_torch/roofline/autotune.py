"""Kernel autotuner: per-device tuned launch configs for the counting kernels.

Every eager launch of the counting kernels already records its device time
against the roofline model per geometry bucket (``kernel_model.
record_launch`` -> ``obs.kernel_efficiency``).  This module closes the loop,
as the JAX package's ``roofline/autotune.py`` does, with the same table
format (schema 1, the same JSON):

  * **offline sweep** (:func:`sweep`, driven by ``launch/autotune.py``):
    time the candidate lattice — ``block_k`` in {64, 128, 256, 512} x
    ``accum`` in {vpu_int32 (K1), mxu_f32 (K2)} (geometries of N >= 2^24
    rows get no K2 candidate), and a ``chunk_rows`` grid for the streaming
    sweep — over bucketized launch geometries, and keep the winner per
    (device kind, geometry bucket) in a :class:`TuningTable`.  On the card
    every candidate is timed with CUDA events around the launch: a launch
    returns before its kernel ends, so a host clock alone would time the
    enqueue.
  * **resolution seam** (:func:`resolve_launch_config`): the counting
    wrappers pass ``None`` for ``block_k`` / ``block_n`` / ``accum`` and
    this function looks the geometry's bucket up in the active table,
    falling back to the compiled-in defaults (K1 with 128 targets per CTA
    and 512 staged rows) when there is no table, no matching entry, or a
    tuned ``mxu_f32`` entry hit by a launch of N >= 2^24 rows (then the
    entry's accum falls back to ``vpu_int32``).
  * **online staleness** (:func:`staleness_report`): the live per-bucket
    efficiency is compared with the sweep-time efficiency of the recorded
    runner-up candidate; an entry that drifts below it (x ``STALE_MARGIN``)
    is stale — the signal to sweep again.

Config choice never changes counts: every candidate is exact (the lattice
battery in ``tests/test_torch_autotune.py``), so a bad table can only cost
speed.

Table discovery: ``$REPRO_TORCH_TUNE_TABLE`` (an explicit path), then the
user cache ``~/.cache/repro_torch/autotune/<device-kind>.json`` (root
overridden by ``$REPRO_CACHE_DIR``), then a table committed under
``roofline/tables/<device-kind>.json`` (none is committed yet).
``$REPRO_TORCH_AUTOTUNE=0`` turns discovery off.  Tables are schema-checked
on load; an invalid one is skipped (``autotune_table_errors_total``).
"""
from __future__ import annotations

import json
import math
import os
import re
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

from .. import obs
from .kernel_model import bucket_shape, geometry_bucket, predicted_seconds

__all__ = [
    "LaunchConfig", "TuningTable", "TableEntry", "TableError",
    "DEFAULT_BLOCK_K", "DEFAULT_BLOCK_N", "DEFAULT_ACCUM", "DEFAULT_CONFIG",
    "TABLE_LOOKUP_BLOCK_K", "BLOCK_K_LATTICE", "ACCUM_LATTICE",
    "CHUNK_ROWS_GRID", "MXU_MAX_ROWS", "SCHEMA_VERSION", "STALE_MARGIN",
    "resolve_launch_config", "resolve_serve_block_k", "candidate_configs",
    "sweep", "save_table", "load_table", "table_to_dict", "table_from_dict",
    "set_active_table", "clear_active_table", "active_table",
    "describe_active", "device_kind", "repo_table_path", "cache_table_path",
    "default_table_paths", "staleness_report", "derived_chooser_thresholds",
]

# The kernels' compiled-in launch shape, the fallback of every resolution.
DEFAULT_BLOCK_K = 128
DEFAULT_BLOCK_N = 512
DEFAULT_ACCUM = "vpu_int32"

# The nominal K under which the chunk planner and the serve seam look the
# table up.  The JAX package keys both under its own default block_k, 256;
# keying them the same way gives one table the same chunk sizes in both
# packages, whatever the port's kernel default is.
TABLE_LOOKUP_BLOCK_K = 256

# The candidate lattice the sweep measures.
BLOCK_K_LATTICE = (64, 128, 256, 512)
ACCUM_LATTICE = ("vpu_int32", "mxu_f32")
CHUNK_ROWS_GRID = (0, 4096, 16384)      # 0 = the staging-budget heuristic

# The mxu_f32 route's contract: fewer than 2^24 rows per launch.
MXU_MAX_ROWS = 1 << 24

# The serve seam's reference micro-batch: a flush of <= block_k queries is
# padded up to block_k, so each candidate is timed at k = block_k.
SERVE_REF_BATCH = 64

SCHEMA_VERSION = 1

# A non-default winner must beat the default by >3% to displace it.
KEEP_DEFAULT_WITHIN = 0.97

# Staleness: flag when live efficiency < alternative's sweep efficiency x this.
STALE_MARGIN = 0.9

# The launch overhead (us) the hand-tuned chooser crossovers assume; the
# measured overhead scales the derived thresholds relative to it.
REF_LAUNCH_OVERHEAD_US = 100.0


@dataclass(frozen=True)
class LaunchConfig:
    """One launch configuration.  ``chunk_rows`` is None for the planner's
    staging-budget heuristic; ``source`` says where the config came from."""
    block_k: int = DEFAULT_BLOCK_K
    block_n: int = DEFAULT_BLOCK_N
    accum: str = DEFAULT_ACCUM
    chunk_rows: Optional[int] = None
    source: str = "default"


DEFAULT_CONFIG = LaunchConfig()


class TableError(ValueError):
    """A tuning table failed schema validation (load falls back to defaults)."""


@dataclass
class TableEntry:
    """Winner + evidence for one geometry bucket.  ``serve_block_k`` is the
    serve-seam winner (timed at k = block_k per candidate); None means no
    serve view was swept."""
    config: LaunchConfig
    us: float                                  # winner, best-of-repeats
    efficiency: float                          # predicted_s / measured_s
    candidates: Dict[str, float] = field(default_factory=dict)
    chunk_candidates: Dict[str, float] = field(default_factory=dict)
    serve_block_k: Optional[int] = None
    serve_candidates: Dict[str, float] = field(default_factory=dict)


@dataclass
class TuningTable:
    device_kind: str
    entries: Dict[str, TableEntry]
    created: str = ""
    schema: int = SCHEMA_VERSION
    source: str = "<memory>"


_M_RESOLVE_DEFAULT = obs.REGISTRY.counter("autotune_resolutions_total",
                                          source="default")
_M_RESOLVE_TABLE = obs.REGISTRY.counter("autotune_resolutions_total",
                                        source="table")
_M_MXU_FALLBACKS = obs.REGISTRY.counter("autotune_mxu_row_fallbacks_total")
_M_TABLE_ERRORS = obs.REGISTRY.counter("autotune_table_errors_total")

# last swallowed error per fallback site, surfaced in the telemetry section
LAST_FALLBACKS: Dict[str, str] = {}


def _note_fallback(site: str, exc: BaseException) -> None:
    LAST_FALLBACKS[site] = f"{type(exc).__name__}: {exc}"
    obs.REGISTRY.counter("autotune_fallbacks_total", site=site).inc()


# -- active-table state ------------------------------------------------------
# pinned: an explicit set_active_table() call (tests pin None = defaults).
# resolved: lazy discovery already ran (clear_active_table() re-arms it).
_STATE = {"pinned": False, "resolved": False, "table": None}


def device_kind() -> str:
    """Normalized device-kind token for table file names: the CUDA card's
    name (``nvidia_h100_80gb_hbm3``) or ``cpu`` without one."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    kind = torch.cuda.get_device_name()
    return re.sub(r"[^a-z0-9_.-]+", "_", str(kind).lower()).strip("_") or "cpu"


def repo_table_path(kind: Optional[str] = None) -> str:
    return os.path.join(os.path.dirname(__file__), "tables",
                        f"{kind or device_kind()}.json")


def cache_table_path(kind: Optional[str] = None) -> str:
    root = os.environ.get("REPRO_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(root, "repro_torch", "autotune",
                        f"{kind or device_kind()}.json")


def default_table_paths() -> Tuple[str, ...]:
    """Discovery precedence: env override, user cache, committed table."""
    env = os.environ.get("REPRO_TORCH_TUNE_TABLE")
    paths = [env] if env else []
    paths += [cache_table_path(), repo_table_path()]
    return tuple(paths)


def set_active_table(table: Optional[TuningTable]) -> None:
    """Pin the active table (None = pin to the defaults, discovery off)."""
    _STATE.update(pinned=True, resolved=True, table=table)


def clear_active_table() -> None:
    """Unpin and re-arm lazy discovery (the process-start state)."""
    _STATE.update(pinned=False, resolved=False, table=None)


def active_table() -> Optional[TuningTable]:
    """The table ``resolve_launch_config`` consults (lazy discovery)."""
    if not _STATE["resolved"]:
        _STATE["table"] = _discover_table()
        _STATE["resolved"] = True
    return _STATE["table"]


def _discover_table() -> Optional[TuningTable]:
    if os.environ.get("REPRO_TORCH_AUTOTUNE", "1").lower() in (
            "0", "off", "false"):
        return None
    for path in default_table_paths():
        if not os.path.isfile(path):
            continue
        try:
            return load_table(path)
        except (TableError, OSError):
            _M_TABLE_ERRORS.inc()
    return None


def describe_active() -> str:
    """One-line banner text for the launchers: which table (if any) is live."""
    t = active_table()
    if t is None:
        return "default launch configs (no tuning table)"
    return (f"tuning table [{t.device_kind}] {len(t.entries)} entries "
            f"from {t.source}")


# -- the seam ----------------------------------------------------------------

def resolve_launch_config(n: int, k: int, w: int, c: int) -> LaunchConfig:
    """Launch config for one (N, K, W, C) geometry: the active table's entry
    for its bucket, or :data:`DEFAULT_CONFIG`.  A tuned ``mxu_f32`` entry
    hit by N >= 2^24 rows (buckets round up, so a real N can exceed the
    swept one) keeps its block shape and falls back to ``vpu_int32``."""
    t = active_table()
    if t is None:
        _M_RESOLVE_DEFAULT.inc()
        return DEFAULT_CONFIG
    entry = t.entries.get(geometry_bucket(n, k, w, c))
    if entry is None:
        _M_RESOLVE_DEFAULT.inc()
        return DEFAULT_CONFIG
    cfg = entry.config
    if cfg.accum == "mxu_f32" and n >= MXU_MAX_ROWS:
        _M_MXU_FALLBACKS.inc()
        cfg = replace(cfg, accum=DEFAULT_ACCUM)
    _M_RESOLVE_TABLE.inc()
    return cfg


def resolve_serve_block_k(store) -> int:
    """Serve-path block_k for a count store (its resident rows, vocab width
    and classes): the bucket's padding-aware ``serve_block_k``, looked up at
    the nominal K :data:`TABLE_LOOKUP_BLOCK_K`; the default block otherwise.
    ``serve.service.CountServer`` pads its micro-batches to it."""
    try:
        n = int(getattr(store, "base_rows", 0) or getattr(store, "n_rows", 0))
        w = int(store.vocab.n_words)
        c = int(store.n_classes)
    except Exception as e:
        _note_fallback("serve_block_k", e)
        return DEFAULT_BLOCK_K
    t = active_table()
    if t is None:
        return DEFAULT_BLOCK_K
    entry = t.entries.get(geometry_bucket(max(n, 1), TABLE_LOOKUP_BLOCK_K,
                                          max(w, 1), max(c, 1)))
    if entry is None or not entry.serve_block_k:
        return DEFAULT_BLOCK_K
    return int(entry.serve_block_k)


# -- persistence -------------------------------------------------------------

def table_to_dict(table: TuningTable) -> dict:
    return {
        "schema": table.schema,
        "device_kind": table.device_kind,
        "created": table.created,
        "entries": {
            bucket: {
                "block_k": e.config.block_k,
                "block_n": e.config.block_n,
                "accum": e.config.accum,
                "chunk_rows": int(e.config.chunk_rows or 0),
                "us": e.us,
                "efficiency": e.efficiency,
                "candidates": e.candidates,
                "chunk_candidates": e.chunk_candidates,
                "serve_block_k": int(e.serve_block_k or 0),
                "serve_candidates": e.serve_candidates,
            }
            for bucket, e in table.entries.items()
        },
    }


def table_from_dict(doc: dict, source: str = "<memory>") -> TuningTable:
    """Schema-checked deserialization; raises :class:`TableError` on any
    violation (discovery then skips the table)."""
    if not isinstance(doc, dict):
        raise TableError("tuning table must be a JSON object")
    if doc.get("schema") != SCHEMA_VERSION:
        raise TableError(f"unsupported tuning-table schema "
                         f"{doc.get('schema')!r} (want {SCHEMA_VERSION})")
    kind = doc.get("device_kind")
    if not isinstance(kind, str) or not kind:
        raise TableError("device_kind must be a non-empty string")
    raw = doc.get("entries")
    if not isinstance(raw, dict):
        raise TableError("entries must be an object")
    entries: Dict[str, TableEntry] = {}
    for bucket, e in raw.items():
        try:
            bucket_shape(bucket)
        except ValueError as exc:
            raise TableError(str(exc)) from exc
        if not isinstance(e, dict):
            raise TableError(f"{bucket}: entry must be an object")
        bk, bn = e.get("block_k"), e.get("block_n", DEFAULT_BLOCK_N)
        accum = e.get("accum")
        cr = e.get("chunk_rows", 0)
        us = e.get("us")
        if bk not in BLOCK_K_LATTICE:
            raise TableError(f"{bucket}: block_k {bk!r} outside the lattice "
                             f"{BLOCK_K_LATTICE}")
        if not isinstance(bn, int) or bn <= 0:
            raise TableError(f"{bucket}: block_n must be a positive int")
        if accum not in ACCUM_LATTICE:
            raise TableError(f"{bucket}: accum {accum!r} outside "
                             f"{ACCUM_LATTICE}")
        if not isinstance(cr, int) or cr < 0:
            raise TableError(f"{bucket}: chunk_rows must be an int >= 0")
        if not isinstance(us, (int, float)) or us <= 0:
            raise TableError(f"{bucket}: us must be a positive number")
        sbk = e.get("serve_block_k", 0)
        if sbk not in (0, None) and sbk not in BLOCK_K_LATTICE:
            raise TableError(f"{bucket}: serve_block_k {sbk!r} outside the "
                             f"lattice {BLOCK_K_LATTICE}")
        entries[bucket] = TableEntry(
            config=LaunchConfig(block_k=bk, block_n=bn, accum=accum,
                                chunk_rows=cr or None, source="table"),
            us=float(us),
            efficiency=float(e.get("efficiency", 0.0)),
            candidates={str(kk): float(v)
                        for kk, v in (e.get("candidates") or {}).items()},
            chunk_candidates={str(kk): float(v)
                              for kk, v in
                              (e.get("chunk_candidates") or {}).items()},
            serve_block_k=sbk or None,
            serve_candidates={str(kk): float(v)
                              for kk, v in
                              (e.get("serve_candidates") or {}).items()},
        )
    return TuningTable(device_kind=kind, entries=entries,
                       created=str(doc.get("created", "")),
                       schema=SCHEMA_VERSION, source=source)


def save_table(table: TuningTable, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(table_to_dict(table), f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_table(path: str) -> TuningTable:
    try:
        with open(path) as f:
            doc = json.load(f)
    except json.JSONDecodeError as exc:
        raise TableError(f"{path}: not valid JSON ({exc})") from exc
    return table_from_dict(doc, source=path)


# -- the offline sweep -------------------------------------------------------

def candidate_configs(n: int) -> Tuple[Tuple[int, str], ...]:
    """(block_k, accum) lattice for a bucket, MXU guard applied."""
    return tuple((bk, acc) for bk in BLOCK_K_LATTICE for acc in ACCUM_LATTICE
                 if not (acc == "mxu_f32" and n >= MXU_MAX_ROWS))


def _cand_key(block_k: int, accum: str) -> str:
    return f"bk{block_k}/{accum}"


def _time_best_of(fn: Callable[[], object], repeats: int, device) -> float:
    """Best-of-N time in microseconds after one warm-up call.  On the card
    CUDA events on the current stream bracket the call and the host waits
    for the end event; on the host the wall clock does."""
    import torch

    fn()
    best = math.inf
    for _ in range(max(1, repeats)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _synthetic_problem(n: int, k: int, w: int, c: int):
    """Deterministic synthetic workload for one bucket: random bitmap rows,
    targets derived from row pairs (plausible containment density), unit
    weights — the JAX package's sweep inputs."""
    import numpy as np

    rng = np.random.default_rng([0x7A11, n, k, w, c])
    tx = rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64) \
        .astype(np.uint32)
    picks = rng.integers(0, n, size=(2, k))
    tgt = (tx[picks[0]] & tx[picks[1]]).astype(np.uint32)
    wts = np.ones((n, c), np.int32)
    return tx, tgt, wts


def _keep_default(cands: Dict[str, float], best: str, default: str) -> str:
    """A non-default winner must beat the default decisively."""
    if (default in cands and best != default
            and cands[best] > cands[default] * KEEP_DEFAULT_WITHIN):
        return default
    return best


def sweep(geometries: Iterable[Tuple[int, int, int, int]], *,
          repeats: int = 3,
          block_ks: Sequence[int] = BLOCK_K_LATTICE,
          accums: Sequence[str] = ACCUM_LATTICE,
          chunk_grid: Sequence[int] = CHUNK_ROWS_GRID,
          kind: Optional[str] = None,
          created: str = "",
          log: Optional[Callable[[str], None]] = None,
          device=None) -> TuningTable:
    """Time the candidate lattice over each geometry's BUCKET on ``device``
    (default the card) and return the winning :class:`TuningTable` (not yet
    active or saved).  Kernel timing telemetry is off meanwhile: losing
    candidates must not pollute the live efficiency ledger."""
    import torch

    from .._device import resolve_device
    from ..kernels.itemset_count import itemset_counts
    from ..mining.plan import choose_chunk_rows
    from ..mining.stream import streaming_counts

    dev = resolve_device(device)
    buckets = []
    for g in geometries:
        b = geometry_bucket(*g)
        if b not in buckets:
            buckets.append(b)

    def on_dev(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    entries: Dict[str, TableEntry] = {}
    prev_timing = obs.KERNEL_TIMING
    obs.configure(kernel_timing=False)
    try:
        for bucket in buckets:
            n, k, w, c = bucket_shape(bucket)
            tx, tgt, wts = _synthetic_problem(n, k, w, c)
            txd, tgtd, wtsd = on_dev(tx, tgt, wts)

            cands: Dict[str, float] = {}
            for bk in block_ks:
                for acc in accums:
                    if acc == "mxu_f32" and n >= MXU_MAX_ROWS:
                        continue
                    cands[_cand_key(bk, acc)] = _time_best_of(
                        lambda bk=bk, acc=acc: itemset_counts(
                            txd, tgtd, wtsd, block_k=bk,
                            block_n=DEFAULT_BLOCK_N, accum=acc),
                        repeats, dev)
            best_key = _keep_default(
                cands, min(cands, key=cands.get),  # type: ignore[arg-type]
                _cand_key(DEFAULT_BLOCK_K, DEFAULT_ACCUM))
            win_bk, win_acc = best_key.split("/")
            win_bk = int(win_bk[2:])

            # chunk_rows grid with the winning block config (0 = heuristic)
            chunk_cands: Dict[str, float] = {}
            heuristic = choose_chunk_rows(w, c)
            if n > 1024:
                for cr in chunk_grid:
                    eff = int(cr) or heuristic
                    if cr and (eff >= n and heuristic >= n):
                        continue    # indistinguishable from the heuristic
                    chunk_cands[str(int(cr))] = _time_best_of(
                        lambda eff=eff: streaming_counts(
                            tx, tgt, wts, chunk_rows=eff, block_k=win_bk,
                            block_n=DEFAULT_BLOCK_N, accum=win_acc,
                            device=dev),
                        max(1, repeats - 1), dev)
            win_cr = 0
            if chunk_cands:
                win_cr = int(_keep_default(
                    chunk_cands,
                    min(chunk_cands, key=chunk_cands.get),  # type: ignore[arg-type]
                    "0"))

            # serve view: a flush of <= block_k queries costs a k = block_k
            # launch, so each candidate is timed at its own padded geometry
            serve_cands: Dict[str, float] = {}
            serve_bk = 0
            if k > min(block_ks):
                for bk in block_ks:
                    stxd, stgtd, swtsd = on_dev(
                        *_synthetic_problem(n, int(bk), w, c))
                    flushes = max(1, -(-SERVE_REF_BATCH // int(bk)))
                    serve_cands[str(int(bk))] = flushes * _time_best_of(
                        lambda: itemset_counts(
                            stxd, stgtd, swtsd, block_k=int(bk),
                            block_n=DEFAULT_BLOCK_N, accum=win_acc),
                        max(1, repeats - 1), dev)
                serve_bk = int(_keep_default(
                    serve_cands,
                    min(serve_cands, key=serve_cands.get),  # type: ignore[arg-type]
                    str(DEFAULT_BLOCK_K)))

            us = cands[best_key]
            entries[bucket] = TableEntry(
                config=LaunchConfig(block_k=win_bk, block_n=DEFAULT_BLOCK_N,
                                    accum=win_acc, chunk_rows=win_cr or None,
                                    source="table"),
                us=us,
                efficiency=predicted_seconds(n, k, w, c, accum=win_acc)
                / (us * 1e-6),
                candidates=cands,
                chunk_candidates=chunk_cands,
                serve_block_k=serve_bk or None,
                serve_candidates=serve_cands,
            )
            if log is not None:
                log(f"autotune: {bucket}: {best_key} "
                    f"({us:.0f}us, chunk_rows={win_cr or 'auto'}, "
                    f"serve_block_k={serve_bk or 'default'}, "
                    f"{len(cands)} candidates)")
    finally:
        obs.configure(kernel_timing=prev_timing)
    return TuningTable(device_kind=kind or device_kind(), entries=entries,
                       created=created)


# -- the online feedback loop ------------------------------------------------

def staleness_report(table: Optional[TuningTable] = None,
                     snap: Optional[dict] = None) -> Dict[str, dict]:
    """Per-bucket staleness verdicts from the live efficiency ledger: an
    entry is STALE when its live efficiency has drifted below the recorded
    runner-up's sweep-time efficiency (x :data:`STALE_MARGIN`).  Buckets with
    no live launches report ``stale: False`` with a reason."""
    t = table if table is not None else active_table()
    if t is None:
        return {}
    live = obs.kernel_efficiency(snap)
    out: Dict[str, dict] = {}
    for bucket, entry in t.entries.items():
        win_key = _cand_key(entry.config.block_k, entry.config.accum)
        alts = {kk: us for kk, us in entry.candidates.items()
                if kk != win_key and us > 0}
        row = {"stale": False, "config": win_key,
               "sweep_efficiency": entry.efficiency,
               "live_efficiency": None, "launches": 0,
               "alternative": None, "alternative_efficiency": None}
        if alts:
            alt_key = min(alts, key=alts.get)  # type: ignore[arg-type]
            row["alternative"] = alt_key
            row["alternative_efficiency"] = (entry.efficiency * entry.us
                                             / alts[alt_key])
        ledger = live.get(bucket)
        if ledger and ledger.get("efficiency") is not None:
            row["live_efficiency"] = ledger["efficiency"]
            row["launches"] = ledger["launches"]
            if row["alternative_efficiency"] is not None:
                row["stale"] = bool(
                    ledger["efficiency"]
                    < row["alternative_efficiency"] * STALE_MARGIN)
        else:
            row["reason"] = "no live launches recorded for this bucket"
        out[bucket] = row
    return out


def _telemetry_section() -> dict:
    """The ``telemetry_section()["autotune"]`` block (registered below)."""
    t = active_table()
    if t is None:
        return {"active": False, "source": "default", "entries": {},
                "stale": {}, "fallbacks": dict(LAST_FALLBACKS)}
    return {
        "active": True,
        "source": t.source,
        "fallbacks": dict(LAST_FALLBACKS),
        "device_kind": t.device_kind,
        "entries": {
            bucket: {"block_k": e.config.block_k, "block_n": e.config.block_n,
                     "accum": e.config.accum,
                     "chunk_rows": e.config.chunk_rows,
                     "serve_block_k": e.serve_block_k, "us": e.us}
            for bucket, e in t.entries.items()
        },
        "stale": staleness_report(t),
    }


obs.register_section("autotune", _telemetry_section)


# -- measured chooser crossovers ---------------------------------------------

def _launch_cost_fit(table: TuningTable) -> Optional[Tuple[float, float]]:
    """Least-squares fit ``us ~ overhead + per_row * n`` over the winners'
    timings (needs >= 2 distinct row buckets): ``(overhead_us,
    per_row_us)`` with floors, or None."""
    pts = []
    for bucket, e in table.entries.items():
        try:
            n, _, _, _ = bucket_shape(bucket)
        except ValueError:
            continue
        pts.append((float(n), e.us))
    if len({p[0] for p in pts}) < 2:
        return None
    mx = sum(p[0] for p in pts) / len(pts)
    my = sum(p[1] for p in pts) / len(pts)
    var = sum((p[0] - mx) ** 2 for p in pts)
    cov = sum((p[0] - mx) * (p[1] - my) for p in pts)
    per_row = max(cov / var, 1e-6) if var > 0 else 1e-6
    overhead = max(my - per_row * mx, 1.0)
    return overhead, per_row


def _stream_ratio(table: TuningTable) -> Optional[float]:
    """Median measured single-pass/chunked throughput ratio (None without
    chunk evidence)."""
    ratios = []
    for e in table.entries.values():
        chunked = [us for cr, us in e.chunk_candidates.items()
                   if cr != "0" and us > 0]
        if chunked and e.us > 0:
            ratios.append(e.us / min(chunked))
    if not ratios:
        return None
    ratios.sort()
    return ratios[len(ratios) // 2]


def derived_chooser_thresholds(
        table: Optional[TuningTable] = None) -> Dict[str, int]:
    """Chooser crossovers derived from the table's measured throughput, as
    the JAX package derives them (empty without a table or evidence: the
    chooser then keeps its hand-tuned constants), each clamped to a sane
    range:

      * ``tiny_rows``      — ``overhead / per_row``: below it, dense wins;
      * ``min_depth``      — ``4 - log2(overhead / 100 us)``: pricier
                             launches make guided counting pay off sooner;
      * ``stream_threshold_bytes`` — the residency crossover scaled by the
                             measured chunking penalty;
      * ``gfp_host_rows``  — the GFP hybrid's host/kernel crossover, the
                             same quantity as ``tiny_rows`` on its own
                             clamp, never below the hybrid's default 4096.
    """
    t = table if table is not None else active_table()
    if t is None:
        return {}
    out: Dict[str, int] = {}
    fit = _launch_cost_fit(t)
    if fit is not None:
        overhead_us, per_row_us = fit
        crossover = int(round(overhead_us / per_row_us))
        out["tiny_rows"] = min(65536, max(512, crossover))
        out["gfp_host_rows"] = min(16384, max(4096, crossover))
        shift = math.log2(max(overhead_us, 1.0) / REF_LAUNCH_OVERHEAD_US)
        out["min_depth"] = min(8, max(2, round(4 - shift)))
    rho = _stream_ratio(t)
    if rho is not None:
        from ..mining.stream import DEFAULT_STREAM_THRESHOLD_BYTES
        scaled = int(DEFAULT_STREAM_THRESHOLD_BYTES / (2 * max(rho, 0.25)))
        out["stream_threshold_bytes"] = min(
            2 * DEFAULT_STREAM_THRESHOLD_BYTES,
            max(DEFAULT_STREAM_THRESHOLD_BYTES // 2, scaled))
    return out
