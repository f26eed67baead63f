"""Mean milliseconds of the program's ``store.count_delta`` spans (a
flush's count over the store's delta: the device mirror's growth, the launch
and the copy back) in the traced window."""
from bench.metrics._layer_spans import window_mean_ms


def read(rec):
    return window_mean_ms(rec, "store.count_delta")
