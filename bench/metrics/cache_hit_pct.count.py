"""Share of cache lookups that hit, in %: the deltas over the traced window
of the program's ``cache_hits_total`` over hits and ``cache_misses_total``."""


def read(rec):
    if not rec.trace:
        return None
    h = rec.counters.get("cache_hits_total", 0.0)
    m = rec.counters.get("cache_misses_total", 0.0)
    return 100.0 * h / (h + m) if h + m > 0 else None
