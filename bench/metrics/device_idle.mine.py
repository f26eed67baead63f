"""Share of the jobs' wall, in %, in which the card ran no operation
(kernel, copy or set), from the profiler's timeline."""


def read(rec):
    tl = rec.timeline
    if tl is None or not rec.jobs:
        return None
    wall = sum(j["t1"] - j["t0"] for j in rec.jobs)
    busy = sum(tl.busy_s(j["t0"], j["t1"]) for j in rec.jobs)
    return 100.0 * (1.0 - busy / wall)
