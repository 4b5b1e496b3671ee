"""Model FLOPs of the window's training steps (bench/lib/work.py: three
times the forward, the head at every position, recomputation not
counted), over their seconds on the host clock, as a share of the dense
bf16 peak (989 TFLOP/s); the steps under the profiler are left out where
others ran."""

from bench.lib import work


def read(rec, model, mix):
    steps = [s for s in getattr(rec, "steps", []) if not s.traced] \
        or getattr(rec, "steps", [])
    secs = sum(s.t1 - s.t0 for s in steps)
    if secs <= 0:
        return None
    flops = len(steps) * work.train_flops(model, int(mix["batch"]),
                                          int(mix["seq_len"]))
    return 100.0 * flops / secs / work.PEAK_FLOPS
