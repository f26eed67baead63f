"""Queries a flush answers: the deltas over the traced window of the
program's ``serve_queries_total`` over its ``serve_flushes_total``."""


def read(rec):
    if not rec.trace:
        return None
    q = rec.counters.get("serve_queries_total", 0.0)
    f = rec.counters.get("serve_flushes_total", 0.0)
    return q / f if f > 0 else None
