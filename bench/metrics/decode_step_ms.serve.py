"""Mean decode step: every decode step's time as the serve loop records
it (``WaveCost.step_s``), summed, over their count; the waves under the
profiler are left out where others ran."""


def read(rec, model, mix):
    waves = [w for w in getattr(rec, "waves", []) if not w.traced] \
        or getattr(rec, "waves", [])
    steps = [s for w in waves for s in w.step_s]
    return 1e3 * sum(steps) / len(steps) if steps else None
