"""Seconds a job spends inside the program's ``mine.level`` spans (each
level's counting call), summed per job."""
from bench.metrics._common import spans_in_jobs


def read(rec):
    if not rec.trace or not rec.jobs:
        return None
    return spans_in_jobs(rec, "mine.level") / len(rec.jobs)
