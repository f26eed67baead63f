"""The jobs' counting at its roofline, in %: the least time of the counting
passes the inputs need (``_roofline.least_seconds`` over the reference's
passes) over the summed device time of every kernel that ran in the jobs."""
from bench.metrics._roofline import least_seconds


def read(rec):
    tl = rec.timeline
    if tl is None:
        return None
    least = sum(least_seconds(j["passes"]) for j in rec.jobs if "passes" in j)
    spent = sum(tl.kernel_seconds(j["t0"], j["t1"]) for j in rec.jobs
                if "passes" in j)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
