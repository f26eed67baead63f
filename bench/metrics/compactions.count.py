"""Folds of the delta into the base that committed in the traced window:
the window's delta of the program's ``store_compactions_total``; 0 where
the program traces its appends (``store.append``) and never folded."""


def read(rec):
    if not rec.trace:
        return None
    if "store_compactions_total" in rec.counters:
        return rec.counters["store_compactions_total"]
    if any(n == "store.append" for n, _, _ in rec.spans):
        return 0.0
    return None
