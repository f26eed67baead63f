"""Seconds a job spends in Python's collector, the program's ``py.gc``
spans (one a collection, on any thread), summed per job."""
from bench.metrics._layer_spans import per_job_s


def read(rec):
    return per_job_s(rec, "py.gc")
