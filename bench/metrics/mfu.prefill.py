"""Model FLOPs of the prompts' real (unpadded) tokens (bench/lib/work.py:
every layer at each token, the head at its last position), over the summed prefill times the serve
loop records (``WaveCost.prefill_s``), as a share of the dense bf16 peak
(989 TFLOP/s); the waves under the profiler are left out where others
ran."""

from bench.lib import work


def read(rec, model, mix):
    waves = [w for w in getattr(rec, "waves", []) if not w.traced] \
        or getattr(rec, "waves", [])
    secs = sum(w.prefill_s for w in waves)
    if secs <= 0:
        return None
    flops = sum(work.prefill_flops(model, T) for w in waves
                for T in w.prompt_lens)
    return 100.0 * flops / secs / work.PEAK_FLOPS
