"""Mean milliseconds of the program's ``serve.flush`` spans in the traced
window."""


def read(rec):
    d = [t1 - t0 for n, t0, t1 in rec.spans if n == "serve.flush"
         and rec.window_t0 <= t0 <= rec.window_t1]
    return 1e3 * sum(d) / len(d) if d else None
