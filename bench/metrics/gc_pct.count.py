"""Share of the traced window, in %, inside Python's collector, the
program's ``py.gc`` spans (one a collection, on any thread)."""
from bench.metrics._layer_spans import window_share_pct


def read(rec):
    return window_share_pct(rec, "py.gc")
