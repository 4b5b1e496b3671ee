"""Mean host time a decode step then waits for the device (the program's
``serve.decode.wait`` spans: the synchronize), over the waves outside
the profiler."""

from bench.lib import spans


def read(rec, model, mix):
    return spans.mean_host_ms(spans.wave_spans(rec, "serve.decode.wait"))
