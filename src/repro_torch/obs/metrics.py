"""Process-local metrics registry: counters, gauges, histograms, collectors.

Two ways numbers get here:

* **Explicit instruments** — ``counter("engine.tasks").inc()`` at sites
  executed at most once per task / wave / sweep stage.  Every mutator
  checks the module-global obs switch first, so with ``REPRO_OBS`` unset
  each call is one attribute load and a falsy branch.
* **Collectors** — hot structures (the GroupEval caches, ``_GEO_CACHE``,
  the analyzer's batched/scalar build counters) keep their own cheap
  native counters *unconditionally* (the pre-existing
  ``CachedEvaluator.hits/misses`` pattern) and register a harvest callback
  here; values are read only at snapshot/drain time, so the hot path is
  never touched by the obs layer at all.  Counter-kind collectors report
  cumulative values and are baselined at :func:`repro_torch.obs.enable` time
  (``rebase_collectors``), so a snapshot reflects activity *since enable*;
  gauge-kind collectors (cache size / capacity) report current values.

**Worker aggregation**: a pool worker calls :func:`drain` once per task —
returning its counters + histograms + collector *deltas* and resetting
them — and the payload rides back piggybacked on the task result tuple;
the parent :func:`absorb`\\ s it into its own registry (counters add,
histograms merge, gauges keep the max across processes).  ``snapshot()``
in the parent therefore covers the whole sweep, and
:func:`write_snapshot` lands it as ``metrics.json`` in the run dir.

Copy of ``src/repro/obs/metrics.py``.  Besides the reference's collectors
(the GroupEval caches, ``_GEO_CACHE`` and the prefetch builds) the port's
kernel wrappers register their launch counts (``fused_eval.launches``,
``segment_replay.launches``) when :mod:`repro_torch.kernels.fused_eval`
is imported, so a shard child's snapshot says how often it ran the card.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import trace as _trace


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if _trace._ENABLED:
            self.value += n


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        if _trace._ENABLED:
            self.value = v


class Histogram:
    """Streaming summary (n, total, min, max) — enough for mean/extremes;
    per-event detail lives in the trace stream, not here."""
    __slots__ = ("name", "n", "total", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, x: float) -> None:
        if not _trace._ENABLED:
            return
        self.n += 1
        self.total += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    def merge_raw(self, raw: Dict[str, float]) -> None:
        self.n += int(raw.get("n", 0))
        self.total += float(raw.get("total", 0.0))
        self.min = min(self.min, float(raw.get("min", float("inf"))))
        self.max = max(self.max, float(raw.get("max", float("-inf"))))

    def as_dict(self) -> Dict[str, float]:
        d: Dict[str, float] = {"n": self.n, "total": self.total}
        if self.n:
            d["min"] = self.min
            d["max"] = self.max
            d["mean"] = self.total / self.n
        return d


_COUNTERS: Dict[str, Counter] = {}
_GAUGES: Dict[str, Gauge] = {}
_HISTOGRAMS: Dict[str, Histogram] = {}
# (fn, kind); fn() -> {metric name: value}.  kind "counter" values are
# cumulative-since-process-start; "gauge" values are instantaneous.
_COLLECTORS: List[Tuple[Callable[[], Dict[str, float]], str]] = []
# per-metric baseline for counter-kind collectors: snapshot() reports
# cur - base ("since enable"); drain() additionally advances it so worker
# payloads are deltas-since-last-drain
_COLLECT_BASE: Dict[str, float] = {}


def counter(name: str) -> Counter:
    c = _COUNTERS.get(name)
    if c is None:
        c = _COUNTERS[name] = Counter(name)
    return c


def gauge(name: str) -> Gauge:
    g = _GAUGES.get(name)
    if g is None:
        g = _GAUGES[name] = Gauge(name)
    return g


def histogram(name: str) -> Histogram:
    h = _HISTOGRAMS.get(name)
    if h is None:
        h = _HISTOGRAMS[name] = Histogram(name)
    return h


def register_collector(fn: Callable[[], Dict[str, float]],
                       kind: str = "counter") -> None:
    """Register a harvest callback (module import time; idempotent per
    callable)."""
    if kind not in ("counter", "gauge"):
        raise ValueError(f"collector kind {kind!r}: 'counter' or 'gauge'")
    if any(f is fn for f, _ in _COLLECTORS):
        return
    _COLLECTORS.append((fn, kind))


def rebase_collectors() -> None:
    """Snapshot current collector values as the zero point (called by
    ``obs.enable``), so process-lifetime caches warmed before enable don't
    pollute the run's numbers."""
    _COLLECT_BASE.clear()
    for fn, kind in _COLLECTORS:
        if kind != "counter":
            continue
        for k, v in fn().items():
            _COLLECT_BASE[k] = float(v)


def _collect(advance_base: bool) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(counter deltas vs base, current gauges) over all collectors."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    for fn, kind in _COLLECTORS:
        cur = fn()
        if kind == "gauge":
            gauges.update(cur)
            continue
        for k, v in cur.items():
            v = float(v)
            counters[k] = counters.get(k, 0.0) + v - _COLLECT_BASE.get(k, 0.0)
            if advance_base:
                _COLLECT_BASE[k] = v
    return counters, gauges


def snapshot() -> Dict[str, Any]:
    """Merged view: explicit instruments + collector harvest (cumulative
    since enable / last drain; does not reset anything)."""
    ccol, gcol = _collect(advance_base=False)
    counters: Dict[str, float] = {
        n: c.value for n, c in _COUNTERS.items() if c.value}
    for k, v in ccol.items():
        if v:
            counters[k] = counters.get(k, 0) + v
    gauges: Dict[str, float] = {
        n: g.value for n, g in _GAUGES.items() if g.value is not None}
    gauges.update(gcol)
    hists = {n: h.as_dict() for n, h in _HISTOGRAMS.items() if h.n}
    return {"counters": counters, "gauges": gauges, "histograms": hists}


def drain() -> Dict[str, Any]:
    """Worker-side: return everything accumulated since the last drain and
    reset (the per-task piggyback payload)."""
    ccol, gcol = _collect(advance_base=True)
    counters: Dict[str, float] = {
        n: c.value for n, c in _COUNTERS.items() if c.value}
    for k, v in ccol.items():
        if v:
            counters[k] = counters.get(k, 0) + v
    gauges: Dict[str, float] = {
        n: g.value for n, g in _GAUGES.items() if g.value is not None}
    gauges.update(gcol)
    hists = {n: {"n": h.n, "total": h.total, "min": h.min, "max": h.max}
             for n, h in _HISTOGRAMS.items() if h.n}
    for c in _COUNTERS.values():
        c.value = 0
    for h in _HISTOGRAMS.values():
        h.reset()
    return {"counters": counters, "gauges": gauges, "histograms": hists}


def absorb(payload: Optional[Dict[str, Any]]) -> None:
    """Parent-side: fold one worker's :func:`drain` payload in."""
    if not payload:
        return
    for k, v in payload.get("counters", {}).items():
        c = counter(k)
        c.value += v
    for k, v in payload.get("gauges", {}).items():
        g = gauge(k)
        g.value = v if g.value is None else max(g.value, v)
    for k, raw in payload.get("histograms", {}).items():
        histogram(k).merge_raw(raw)


def write_snapshot(directory: Optional[Path] = None) -> Optional[Path]:
    """Land ``metrics.json`` in the run dir (no-op while disabled)."""
    if not _trace._ENABLED:
        return None
    d = Path(directory) if directory is not None else _trace.run_dir()
    if d is None:
        return None
    d.mkdir(parents=True, exist_ok=True)
    path = d / "metrics.json"
    path.write_text(json.dumps(snapshot(), indent=1, sort_keys=True,
                               default=float) + "\n")
    return path


def reset() -> None:
    """Zero every instrument in place and re-baseline collectors (tests)."""
    for c in _COUNTERS.values():
        c.value = 0
    for g in _GAUGES.values():
        g.value = None
    for h in _HISTOGRAMS.values():
        h.reset()
    rebase_collectors()
