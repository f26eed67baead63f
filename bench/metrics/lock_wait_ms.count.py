"""Mean milliseconds a submit waits for the count server's lock, the
program's ``serve.lock_wait`` spans in the traced window."""
from bench.metrics._layer_spans import window_mean_ms


def read(rec):
    return window_mean_ms(rec, "serve.lock_wait")
