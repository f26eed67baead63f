"""Mean milliseconds spent fulfilling a flushed batch's futures, the
program's ``serve.dispatch`` spans in the traced window."""
from bench.metrics._layer_spans import window_mean_ms


def read(rec):
    return window_mean_ms(rec, "serve.dispatch")
