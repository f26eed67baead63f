"""Seconds a job spends collapsing identical rows, the program's
``encode.dedup`` span (``dedup_rows``)."""
from bench.metrics._layer_spans import per_job_s


def read(rec):
    return per_job_s(rec, "encode.dedup")
