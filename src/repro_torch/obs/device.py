"""The device side of kept spans (:func:`repro_torch.obs.kept_span`).

Two things a kept span does when torch is there to do them:

* **device clock** -- :func:`record` records a ``torch.cuda.Event`` with
  timing on the current stream of a CUDA device and returns it at once:
  no synchronize, no ``elapsed_time``, no kernel.  :func:`elapsed_ms`
  reads a span's (start, end) pair later, waiting for its end event;
  off a CUDA device there are no events and it gives None;
* **profiler marks** -- while a ``torch.profiler`` records,
  :func:`annotate` opens a ``torch.profiler.record_function`` of the
  span's name, so the span lands on the trace's own clock.

The only module of :mod:`repro_torch.obs` that touches torch, and only
inside these functions: importing it imports no torch, and a process
that never imported torch pays one dictionary lookup a span.
"""

from __future__ import annotations

import sys
from typing import Any, Optional, Tuple


def annotate(name: str):
    """An entered ``record_function(name)`` while a torch profiler records
    in this process (the caller exits it), else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    note = torch.profiler.record_function(name)
    note.__enter__()
    return note


def record(device: Any):
    """A timing event recorded now on ``device``'s current stream, or None
    unless ``device`` is a CUDA device."""
    if getattr(device, "type", None) != "cuda":
        return None
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def elapsed_ms(events: Optional[Tuple[Any, Any]]) -> Optional[float]:
    """Device milliseconds from the start event to the end event, once the
    end event has completed; None without both events."""
    if events is None or events[1] is None:
        return None
    start, end = events
    end.synchronize()
    return float(start.elapsed_time(end))
