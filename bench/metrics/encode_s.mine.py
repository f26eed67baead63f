"""Seconds a job spends in ``repro_torch.mining.dense.mra_encode`` (the
MRA's passes 1 and 2: the rare-class items and the encoded table), timed by
the harness around each call."""
from bench.metrics._common import job_mean


def read(rec):
    return job_mean(rec, "encode_s")
