"""Mean host time a wave's prefill takes to issue its work (the program's
``serve.prefill.issue`` spans: the cache, the tokens' copy to the card,
the prefill and its argmax until they return), over the waves outside
the profiler: the part of the time to first token before the host waits
for the card."""

from bench.lib import spans


def read(rec, model, mix):
    return spans.mean_host_ms(spans.wave_spans(rec, "serve.prefill.issue"))
