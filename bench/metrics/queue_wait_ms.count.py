"""Mean milliseconds a request waits from the entry of its submit call to
the drain of its batch, the program's ``serve.queued`` spans in the traced
window."""
from bench.metrics._layer_spans import window_mean_ms


def read(rec):
    return window_mean_ms(rec, "serve.queued")
