"""Seconds of the program's background folds of the delta into the base,
its ``store.bg_compact`` spans that start in the traced window, summed; 0
where the program traces its appends (``store.append``) and no fold started
in the window."""


def read(rec):
    if not rec.trace or not any(n == "store.append" for n, _, _ in rec.spans):
        return None
    return sum(t1 - t0 for n, t0, t1 in rec.spans if n == "store.bg_compact"
               and rec.window_t0 <= t0 <= rec.window_t1)
