"""Seconds a job spends absorbing counted levels into the frequent set,
the program's ``mine.absorb`` spans, summed per job."""
from bench.metrics._layer_spans import per_job_s


def read(rec):
    return per_job_s(rec, "mine.absorb")
