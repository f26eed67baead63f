"""Unified telemetry layer: one process-wide metrics registry + span tracer.

The mining driver's level/chunk loop and the kernel wrapper's per-launch
device time against the roofline model's prediction record here.  Exports:
``snapshot()`` (JSON-safe), Chrome trace dumps (``obs.tracing``), and the
``summary_line()`` one-liner every entry point prints on exit.

State model:

  * ``REGISTRY`` (metrics) is ENABLED by default: counters/histograms are
    thread-confined dict bumps, cheap enough for the hot path.
  * ``TRACER`` (spans) is DISABLED by default: ring-buffer traces are an
    opt-in debugging surface (``--trace`` in the launchers).
  * ``KERNEL_TIMING`` gates the per-launch device-time measurement in
    ``kernels/itemset_count/ops.py``: it brackets each launch with CUDA
    events and reads them later without waiting, so a pipelined launch
    stream stays pipelined; ``snapshot()`` first runs the registered flush
    hooks (``register_flush``), which wait for the launches still in
    flight.
  * ``configure(metrics=..., tracing=..., kernel_timing=...)`` flips any
    subset; ``disable_all()`` is the zero-overhead escape hatch (pinned by
    the no-allocation contract of the tracer and registry).

Import discipline: this package imports only the stdlib — mining/,
kernels/ and roofline/ import it, never the reverse.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .metrics import (MetricsRegistry, counter_total, counter_value,
                      hist_get, hist_merge, hist_quantile, nearest_rank)
from .tracing import Tracer

__all__ = [
    "REGISTRY", "TRACER", "configure", "disable_all", "enabled",
    "snapshot", "reset", "summary_line", "kernel_timing_enabled",
    "register_flush",
    "kernel_efficiency", "telemetry_section", "register_section",
    "counter_total", "counter_value", "hist_get", "hist_merge",
    "hist_quantile", "nearest_rank", "MetricsRegistry", "Tracer",
]

REGISTRY = MetricsRegistry(enabled=True)
TRACER = Tracer(enabled=False)
KERNEL_TIMING = True


def configure(metrics: Optional[bool] = None, tracing: Optional[bool] = None,
              kernel_timing: Optional[bool] = None) -> None:
    """Flip any subset of the three telemetry switches (None = leave)."""
    global KERNEL_TIMING
    if metrics is not None:
        REGISTRY.enabled = metrics
    if tracing is not None:
        TRACER.enabled = tracing
    if kernel_timing is not None:
        KERNEL_TIMING = kernel_timing


def disable_all() -> None:
    configure(metrics=False, tracing=False, kernel_timing=False)


def enabled() -> bool:
    return REGISTRY.enabled


def kernel_timing_enabled() -> bool:
    return KERNEL_TIMING and REGISTRY.enabled


# Hooks that publish deferred measurements (the kernel wrapper's pending
# launch timings) before the registry is read.
_FLUSH_HOOKS: List[Callable[[], None]] = []


def register_flush(hook: Callable[[], None]) -> None:
    """Run ``hook()`` before every :func:`snapshot`."""
    if hook not in _FLUSH_HOOKS:
        _FLUSH_HOOKS.append(hook)


def snapshot() -> dict:
    for hook in _FLUSH_HOOKS:
        hook()
    return REGISTRY.snapshot()


def reset() -> None:
    """Drop all recorded telemetry and restore default switches (tests)."""
    global KERNEL_TIMING
    REGISTRY.reset()
    REGISTRY.enabled = True
    TRACER.reset()
    TRACER.enabled = False
    KERNEL_TIMING = True


# -- derived views -----------------------------------------------------------

def kernel_efficiency(snap: Optional[dict] = None) -> dict:
    """Measured-vs-predicted kernel report per launch geometry.

    ``{geometry: {launches, measured_s, predicted_s, efficiency}}`` where
    ``efficiency = predicted / measured`` — 1.0 means the launch ran at the
    roofline model's bound for the TARGET hardware; far below 1.0 on this
    CPU/interpret container is expected (the trend, not the absolute, is
    the signal there).  Geometries come from the per-launch recording in
    ``kernels/itemset_count/ops.py`` via ``roofline.kernel_model``."""
    snap = snap if snap is not None else snapshot()
    launches = snap.get("counters", {}).get("kernel_launches_total", {})
    measured = snap.get("counters", {}).get("kernel_measured_s_total", {})
    predicted = snap.get("counters", {}).get("kernel_predicted_s_total", {})
    out = {}
    for ls, n in launches.items():
        geom = ls.replace("geometry=", "", 1) if ls else ""
        m = measured.get(ls, 0.0)
        p = predicted.get(ls, 0.0)
        out[geom] = {
            "launches": int(n),
            "measured_s": m,
            "predicted_s": p,
            "efficiency": (p / m) if m > 0 else None,
        }
    return out


# Extension sections: higher layers (which import obs — never the reverse)
# contribute named blocks to the telemetry report by registering a provider.
# Keeps this package stdlib-only while letting e.g. roofline.autotune expose
# its active-table + staleness state through CountServer.stats().
_SECTIONS: Dict[str, Callable[[], dict]] = {}


def register_section(name: str, provider: Callable[[], dict]) -> None:
    """Register (or replace) a named provider merged into every
    :func:`telemetry_section` result.  Provider errors are captured per
    section, never propagated — telemetry must not take down serving."""
    _SECTIONS[name] = provider


def telemetry_section(snap: Optional[dict] = None) -> dict:
    """The registry-backed block ``CountServer.stats()`` embeds: the raw
    snapshot plus the derived kernel measured-vs-predicted report, plus any
    registered extension sections (e.g. ``autotune``)."""
    snap = snap if snap is not None else snapshot()
    out = {"enabled": REGISTRY.enabled, "metrics": snap,
           "kernel_efficiency": kernel_efficiency(snap)}
    for name, provider in _SECTIONS.items():
        try:
            out[name] = provider()
        except Exception as e:  # pragma: no cover - defensive
            # section names come from register_section callers — a fixed,
            # code-defined vocabulary, so the label set is bounded
            out[name] = {"error": f"{type(e).__name__}: {e}"}
            REGISTRY.counter("telemetry_section_errors_total",
                             section=name).inc()
    return out


def summary_line(snap: Optional[dict] = None) -> str:
    """One-line telemetry rollup for entry-point exit banners:
    launches, host blocks, cache hit rate, p95 flush latency — each part
    shown only when something actually recorded it."""
    snap = snap if snap is not None else snapshot()
    parts = []
    launches = counter_total(snap, "kernel_launches_total")
    if launches:
        parts.append(f"{int(launches)} kernel launches")
    chunks = counter_total(snap, "mine_chunks_total")
    if chunks:
        levels = counter_total(snap, "mine_levels_total")
        parts.append(f"{int(chunks)} chunk counts over {int(levels)} levels")
    gfp_host = counter_value(snap, "gfp_blocks_total", path="host")
    if gfp_host:
        parts.append(f"{int(gfp_host)} host blocks")
    hits = counter_total(snap, "cache_hits_total")
    misses = counter_total(snap, "cache_misses_total")
    if hits + misses:
        parts.append(f"cache hit rate {hits / (hits + misses):.2f}")
    p95 = hist_quantile(hist_merge(snap, "serve_flush_wait_ms"), 0.95)
    if p95 is not None:
        parts.append(f"p95 flush wait <={p95:g}ms")
    else:
        p95q = hist_quantile(hist_merge(snap, "serve_queue_wait_ms"), 0.95)
        if p95q is not None:
            parts.append(f"p95 queue wait <={p95q:g}ms")
    if not REGISTRY.enabled:
        return "telemetry: disabled"
    return "telemetry: " + (", ".join(parts) if parts else "no activity")
