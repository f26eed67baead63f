"""Seconds a job spends on level 1 of the level driver, the program's
``mine.singles`` spans (the singles' counts and their absorb), summed per
job."""
from bench.metrics._layer_spans import per_job_s


def read(rec):
    return per_job_s(rec, "mine.singles")
