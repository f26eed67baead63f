"""Small helpers the metric readers share."""
from __future__ import annotations

import math
from typing import Optional, Sequence


def nearest_rank(values: Sequence[float], p: float) -> Optional[float]:
    """The ceil(p * n)-th smallest value (1-based), or None."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, min(len(s) - 1, math.ceil(p * len(s)) - 1))]


def job_mean(rec, key: str) -> Optional[float]:
    """Mean of ``job[key]`` over the traced jobs that recorded it."""
    vals = [j[key] for j in rec.jobs if key in j]
    if not rec.trace or not vals:
        return None
    return sum(vals) / len(vals)


def spans_in_jobs(rec, name: str) -> float:
    """Seconds of the program's ``name`` spans that start inside a job."""
    return sum(t1 - t0 for n, t0, t1 in rec.spans if n == name
               and any(j["t0"] <= t0 < j["t1"] for j in rec.jobs))
