"""Seconds a job spends in the level driver,
``repro_torch.mining.driver.mine_frequent`` (candidates, counting and
absorbing, level by level), timed by the harness around each call."""
from bench.metrics._common import job_mean


def read(rec):
    return job_mean(rec, "driver_s")
