"""Mean host time a decode step takes to issue its work (the program's
``serve.decode.issue`` spans: the step's call and its argmax until they
return), over the waves outside the profiler."""

from bench.lib import spans


def read(rec, model, mix):
    return spans.mean_host_ms(spans.wave_spans(rec, "serve.decode.issue"))
