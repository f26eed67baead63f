"""Mean milliseconds a flush spends looking its keys up in the count
cache, the program's ``serve.cache_lookup`` spans in the traced window."""
from bench.metrics._layer_spans import window_mean_ms


def read(rec):
    return window_mean_ms(rec, "serve.cache_lookup")
