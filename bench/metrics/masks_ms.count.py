"""Mean milliseconds a flush spends encoding its missed keys into target
masks, the program's ``serve.masks`` spans in the traced window."""
from bench.metrics._layer_spans import window_mean_ms


def read(rec):
    return window_mean_ms(rec, "serve.masks")
