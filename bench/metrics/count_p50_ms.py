"""Median (nearest rank) of the latency of every request due in the
window, from when it was due to when the client held its answer."""
from bench.metrics._common import nearest_rank


def read(rec):
    return nearest_rank(rec.latencies_ms, 0.50)
