"""Share of the decode steps that replayed a CUDA graph: of the program's
``serve.decode.issue`` spans of the waves outside the profiler, those
holding a ``decode.graph.replay`` span, in percent.  None without decode
spans; 0 for a program that never replays one."""

from bench.lib import spans


def read(rec, model, mix):
    issues = spans.wave_spans(rec, "serve.decode.issue")
    if not issues:
        return None
    held = {s.parent for s in spans.wave_spans(rec, "decode.graph.replay")}
    return 100.0 * sum(s.sid in held for s in issues) / len(issues)
