"""Launches of the counting kernels a job makes: the delta of the kernel
wrapper's ``ops.KERNEL_LAUNCHES`` over each job."""
from bench.metrics._common import job_mean


def read(rec):
    return job_mean(rec, "launches") if rec.timeline is not None else None
