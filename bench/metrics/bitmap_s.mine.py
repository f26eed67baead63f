"""Seconds a job spends packing its rows into bitmaps, the program's
``encode.bitmap`` span (``encode_bitmap`` and ``class_weights``)."""
from bench.metrics._layer_spans import per_job_s


def read(rec):
    return per_job_s(rec, "encode.bitmap")
