"""Mean milliseconds of the program's ``serve.append`` spans (one append
through the count server, under its lock) in the traced window."""
from bench.metrics._layer_spans import window_mean_ms


def read(rec):
    return window_mean_ms(rec, "serve.append")
