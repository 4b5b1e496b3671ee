"""Kernels the device ran a training step, counted in the profiler's
trace over the traced steps."""


def read(rec, model, mix):
    tr = getattr(rec, "trace", None)
    n = sum(1 for s in getattr(rec, "steps", []) if s.traced)
    if tr is None or n == 0 or not tr.kernels:
        return None
    return len(tr.kernels) / n
