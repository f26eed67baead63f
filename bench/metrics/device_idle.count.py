"""Share of the traced window, in %, in which the card ran no operation
(kernel, copy or set)."""


def read(rec):
    tl = rec.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)
