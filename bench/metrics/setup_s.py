"""Seconds from the start of the process to the first timed call."""


def read(rec):
    return rec.setup_s
