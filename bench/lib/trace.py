"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a
steady part of the window, written once as a Chrome trace and read back
here.

The traced span is the harness's ``bench.traced`` annotation.  Busy time
is the union of the device's kernel, copy and set intervals inside it;
an idle gap is named by what the host was doing at its middle: the
harness's innermost ``bench.*`` annotation and the innermost host
operation there.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACED = "bench.traced"


class Tracer:
    """``torch.profiler`` over the host and the card (nothing else
    recorded), opened by :meth:`start` around the span ``bench.traced``
    and closed by :meth:`stop`; :meth:`read` writes the trace once and
    reads it back.  Until :meth:`start`, :meth:`note` costs nothing."""

    def __init__(self):
        self.prof = self.span = None

    @property
    def on(self) -> bool:
        return self.span is not None

    def start(self) -> None:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(
            activities=acts, record_shapes=False, profile_memory=False,
            with_stack=False)
        self.prof.__enter__()
        self.span = torch.profiler.record_function(TRACED)
        self.span.__enter__()

    def stop(self) -> None:
        import torch
        if self.span is None:
            return
        torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.span = None

    def note(self, name: str):
        """A ``bench.*`` annotation while the profiler is on."""
        import torch
        return torch.profiler.record_function(name) if self.on \
            else contextlib.nullcontext()

    def read(self, path: Path) -> Optional["Trace"]:
        if self.prof is None:
            return None
        self.prof.export_chrome_trace(str(path))
        return Trace(path)


def _innermost(starts: List[float], spans: List[Tuple[float, float, str]],
               t: float, reach: int = 400) -> Optional[str]:
    """The name of the latest-starting span that holds ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        s, e, name = spans[j]
        if e >= t:
            return name
    return None


class Trace:
    """Kernels, busy time and idle gaps of one exported trace."""

    def __init__(self, path: Path):
        events = json.loads(Path(path).read_text())["traceEvents"]
        win = [e for e in events if e.get("name") == TRACED
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError(f"trace {path}: no {TRACED!r} span")
        t0 = float(win[0]["ts"])
        t1 = t0 + float(win[0]["dur"])
        self.window_s = (t1 - t0) * 1e-6
        dev, host, notes = [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = float(e["ts"])
            span = (s, s + float(e["dur"]), e.get("name", ""))
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                if span[1] > t0 and s < t1:
                    dev.append((max(s, t0), min(span[1], t1), span[2], cat))
            elif cat == "cpu_op":
                host.append(span)
            elif cat == "user_annotation" and span[2].startswith("bench.") \
                    and span[2] != TRACED:
                notes.append(span)
        dev.sort()
        self.kernels = [(n, (e - s) * 1e-6) for s, e, n, c in dev
                        if c == "kernel"]
        self.device_ops = [(n, (e - s) * 1e-6) for s, e, n, c in dev]
        host.sort()
        notes.sort()
        busy, gaps, cur = 0.0, [], t0
        for s, e, _, _ in dev:
            if s > cur:
                gaps.append((cur, s))
            if e > cur:
                busy += e - max(s, cur)
                cur = e
        if t1 > cur:
            gaps.append((cur, t1))
        self.busy_s = busy * 1e-6
        hs, ns = [h[0] for h in host], [n[0] for n in notes]
        idle: Dict[str, float] = defaultdict(float)
        for s, e in gaps:
            mid = 0.5 * (s + e)
            note = _innermost(ns, notes, mid) or "outside bench spans"
            op = _innermost(hs, host, mid) or "python"
            idle[f"{note}: {op}"] += (e - s) * 1e-6
        self.idle = dict(idle)

    def kernel_seconds(self, names: Iterable[str]) -> float:
        """Device seconds of the kernels whose name holds one of
        ``names``."""
        names = tuple(names)
        return sum(d for n, d in self.kernels if any(k in n for k in names))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops: Dict[str, float] = defaultdict(float)
        for n, d in self.device_ops:
            ops[n[:160]] += d
        rank = lambda d: sorted(([k, v] for k, v in d.items()),
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(ops), "idle_gaps": rank(self.idle)}
