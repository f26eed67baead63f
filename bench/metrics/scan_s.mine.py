"""Seconds a job spends in the MRA's pass 1, the program's ``mra.scan``
span: class and item counts over the rows, the kept items and their order."""
from bench.metrics._layer_spans import per_job_s


def read(rec):
    return per_job_s(rec, "mra.scan")
