"""The program's kept spans (``repro_torch.obs.kept_spans``) of the
window's waves or steps outside the profiler, for the readers of the
``program_span`` metrics that read them.

The rule is the other readers': the waves or steps outside the profiler,
or all of them where none ran outside it.  A serve span belongs to the
wave whose rids are its key (children carry their wave's key); a train
phase belongs to the ``train.step`` span it nests in, and that step to
the harness's step whose host interval holds the span's start (both
clocks are ``perf_counter``).  A program that keeps no spans, or a span
without the device clock, gives None.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def kept(name: str) -> list:
    """The program's kept spans named ``name`` (none where the program
    keeps none)."""
    try:
        from repro_torch import obs
    except ImportError:
        return []
    spans = getattr(obs, "kept_spans", None)
    return list(spans(name)) if spans is not None else []


def outside_profiler(items) -> list:
    items = list(items or [])
    return [x for x in items if not x.traced] or items


def wave_spans(rec, name: str) -> list:
    """Spans named ``name`` of the window's waves outside the profiler."""
    keys = {tuple(w.rids) for w in outside_profiler(getattr(rec, "waves",
                                                            None))}
    return [s for s in kept(name) if isinstance(s.key, tuple)
            and s.key in keys]


def step_spans(rec, name: str) -> Dict[int, list]:
    """Spans named ``name`` of the window's steps outside the profiler,
    by the ``sid`` of the ``train.step`` span they nest in."""
    steps = outside_profiler(getattr(rec, "steps", None))
    held = {s.sid: [] for s in kept("train.step")
            if any(st.t0 <= s.t0 <= st.t1 for st in steps)}
    for s in kept(name):
        if s.parent in held:
            held[s.parent].append(s)
    return held


def mean_host_ms(spans: List) -> Optional[float]:
    """Mean host milliseconds of ``spans``; None without spans."""
    if not spans:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / len(spans)


def mean_device_ms(by_step: Dict[int, list]) -> Optional[float]:
    """Mean over steps of the device milliseconds of each step's spans
    (summed where a step holds several, one a micro-batch); None without
    spans or where a span has no device clock."""
    per_step = []
    for spans in by_step.values():
        if not spans:
            continue
        ms = [s.device_ms() for s in spans]
        if any(m is None for m in ms):
            return None
        per_step.append(sum(ms))
    return sum(per_step) / len(per_step) if per_step else None
