"""Helpers for the readers of the program's spans inside a layer.  Each
returns None where the program records no span of the name, so that a
program without the span gives no number rather than a zero."""
from __future__ import annotations

from typing import Optional

from bench.metrics._common import spans_in_jobs


def _recorded(rec, name: str) -> bool:
    return rec.trace and any(n == name for n, _, _ in rec.spans)


def per_job_s(rec, name: str) -> Optional[float]:
    """Seconds a job spends in the program's ``name`` spans (those that
    start inside a job), summed per job."""
    if not rec.jobs or not _recorded(rec, name):
        return None
    return spans_in_jobs(rec, name) / len(rec.jobs)


def _in_window(rec, name: str) -> list:
    return [t1 - t0 for n, t0, t1 in rec.spans if n == name
            and rec.window_t0 <= t0 <= rec.window_t1]


def window_mean_ms(rec, name: str) -> Optional[float]:
    """Mean milliseconds of the program's ``name`` spans that start in the
    traced window."""
    d = _in_window(rec, name) if rec.trace else []
    return 1e3 * sum(d) / len(d) if d else None


def window_share_pct(rec, name: str) -> Optional[float]:
    """Share of the traced window, in %, inside the program's ``name``
    spans that start in it (spans of the name must not overlap)."""
    span = rec.window_t1 - rec.window_t0
    if span <= 0 or not _recorded(rec, name):
        return None
    return 100.0 * sum(_in_window(rec, name)) / span
