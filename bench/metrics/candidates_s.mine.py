"""Seconds a job spends building candidate levels, the program's
``mine.candidates`` spans (``apriori_gen``, the canonical order and the
target masks), summed per job."""
from bench.metrics._layer_spans import per_job_s


def read(rec):
    return per_job_s(rec, "mine.candidates")
