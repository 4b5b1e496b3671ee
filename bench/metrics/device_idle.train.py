"""The share of the traced steps' span in which no operation ran on the
device (from the profiler's trace)."""


def read(rec, model, mix):
    tr = getattr(rec, "trace", None)
    if tr is None or not getattr(rec, "steps", None) or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
