"""Seconds a mine job takes: from the window's start to the end of the last
job (every job that starts in the window runs to its end), over the number
of jobs."""


def read(rec):
    if not rec.jobs:
        return None
    return (rec.jobs[-1]["t1"] - rec.window_t0) / len(rec.jobs)
