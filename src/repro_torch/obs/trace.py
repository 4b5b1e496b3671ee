"""Low-overhead span tracing + structured logging (the ``REPRO_OBS`` switch).

One process == one append-only JSONL event stream (``trace-<pid>.jsonl``
under the run directory); pool workers each write their own stream and the
report merges them, so no cross-process locking ever happens on the hot
path.  Three event kinds:

* ``{"ev": "proc", ...}`` — stream header: pid, role, wall-clock and
  ``perf_counter`` anchors (pairs of anchors let a reader align the
  monotonic span timestamps of different processes onto one wall axis);
* ``{"ev": "span", "name": ..., "t0": ..., "dur": ..., "attrs": {...}}`` —
  one timed region, emitted on exit of ``with span("phase", k=v):``;
* ``{"ev": "log", "tag": ..., "msg": ...}`` — a structured copy of a
  ``vlog()`` diagnostic line.

**Hard contract** (tested in ``tests/test_torch_obs.py``): nothing in
this module draws randomness or performs float arithmetic that feeds back
into engine results — spans only *read* ``perf_counter`` — so a sweep with
tracing on is bit-identical to tracing off.  The disabled path is a single
module-global bool check returning a shared no-op context manager (no
allocation, no clock read), so ``REPRO_OBS`` unset costs the engine
nothing it could measure.

Besides the event stream, every span feeds a ``phase.<name>`` histogram
in :mod:`repro_torch.obs.metrics` — the report's time-in-phase table
reads those, so per-iteration hot paths can use :func:`timed` (histogram
only, no event line) without flooding the trace file.

Copy of ``src/repro/obs/trace.py``: the same switch, event schema and
functions, plus the port's own *kept spans*.

**Kept spans** (:func:`kept_span`, read back by :func:`kept_spans`) are on
whatever the switch says, for a handful of coarse regions per serve
decode step or train step, never one per layer or kernel.  Each closed
span is a :class:`KeptSpan` (name, ``t0`` / ``t1`` on ``perf_counter``,
its parent's id, a key) in a process-wide ``deque`` of at most
:data:`KEPT_MAX` records, so a long run keeps the newest ones at a fixed
memory ceiling.  Given a CUDA ``device``, a span also records two timing
events on that device's current stream (:mod:`repro_torch.obs.device`);
its device milliseconds are resolved only when read, after the work.
While a ``torch.profiler`` records, a span also opens a
``record_function`` of its name, so the program's regions sit on the
trace's clock.  With the switch on, a kept span also feeds its
``phase.<name>`` histogram and writes a span event, as :func:`span` does.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from time import perf_counter
from typing import Any, Deque, Dict, List, Optional

from . import device as _device

_TRUTHY = ("1", "true", "on", "yes")

_ENABLED: bool = os.environ.get("REPRO_OBS", "").lower() in _TRUTHY
_RUN_DIR: Optional[Path] = None
_FILE = None                      # this process's open trace stream
_VERBOSITY: int = int(os.environ.get("REPRO_VERBOSITY", "1") or "1")


def enabled() -> bool:
    return _ENABLED


def verbosity() -> int:
    return _VERBOSITY


def set_verbosity(level: int) -> None:
    global _VERBOSITY
    _VERBOSITY = int(level)


def _default_run_dir() -> Path:
    env = os.environ.get("REPRO_OBS_DIR")
    if env:
        return Path(env)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    return Path("results") / "obs" / f"run-{stamp}-{os.getpid()}"


def run_dir() -> Optional[Path]:
    """The active run directory (created on first use; None if disabled)."""
    global _RUN_DIR
    if not _ENABLED:
        return None
    if _RUN_DIR is None:
        _RUN_DIR = _default_run_dir()
    _RUN_DIR.mkdir(parents=True, exist_ok=True)
    return _RUN_DIR


def enable(directory: Optional[os.PathLike] = None) -> Path:
    """Programmatically turn tracing on (tests / CLIs; the env switch
    ``REPRO_OBS=1`` is read once at import).  Idempotent; returns the run
    directory."""
    global _ENABLED, _RUN_DIR
    _close_stream()
    _ENABLED = True
    _RUN_DIR = Path(directory) if directory is not None else None
    from . import metrics as _metrics
    _metrics.rebase_collectors()
    return run_dir()


def disable() -> None:
    """Flush + close this process's stream and turn tracing off."""
    global _ENABLED, _RUN_DIR
    _close_stream()
    _ENABLED = False
    _RUN_DIR = None


def _close_stream() -> None:
    global _FILE
    if _FILE is not None:
        try:
            _FILE.flush()
            _FILE.close()
        except (OSError, ValueError):
            pass
        _FILE = None


def _stream():
    global _FILE
    if _FILE is None:
        d = run_dir()
        assert d is not None
        _FILE = (d / f"trace-{os.getpid()}.jsonl").open("a")
        _FILE.write(json.dumps({
            "ev": "proc", "pid": os.getpid(),
            "t_wall": time.time(), "t_perf": perf_counter(),
        }) + "\n")
    return _FILE


def emit(event: Dict[str, Any]) -> None:
    """Append one event to this process's stream (no-op when disabled)."""
    if not _ENABLED:
        return
    _stream().write(json.dumps(event, default=str) + "\n")


def flush() -> None:
    if _FILE is not None:
        _FILE.flush()


atexit.register(_close_stream)


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared do-nothing context manager returned while disabled."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "t0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        self.t0 = perf_counter()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        _span_event(self.name, self.t0, perf_counter() - self.t0,
                    self.attrs, et)
        return False


def _span_event(name: str, t0: float, dur: float,
                attrs: Optional[Dict[str, Any]], et) -> None:
    """A closed span's ``phase.<name>`` observation and its event line."""
    from . import metrics as _metrics
    _metrics.histogram("phase." + name).observe(dur)
    e: Dict[str, Any] = {"ev": "span", "name": name, "pid": os.getpid(),
                         "t0": t0, "dur": dur}
    if attrs:
        e["attrs"] = attrs
    if et is not None:
        e["err"] = getattr(et, "__name__", str(et))
    emit(e)


class _Timed:
    """Histogram-only timer — for regions executed thousands of times per
    task (e.g. one lockstep SA iteration), where a span event per call
    would flood the trace stream."""
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Timed":
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        from . import metrics as _metrics
        _metrics.histogram("phase." + self.name).observe(
            perf_counter() - self.t0)
        return False


def span(name: str, **attrs: Any):
    """``with span("dse", shard="0/3"):`` — timed region + trace event."""
    if not _ENABLED:
        return _NULL_SPAN
    return _Span(name, attrs)


def timed(name: str):
    """Like :func:`span` but feeds only the ``phase.<name>`` histogram."""
    if not _ENABLED:
        return _NULL_SPAN
    return _Timed(name)


# ---------------------------------------------------------------------------
# Kept spans: always on, bounded, read back in-process
# ---------------------------------------------------------------------------

KEPT_MAX = 1 << 15
"""Most kept spans held.  A serve decode step keeps four (five where it
replays a decode graph) and a wave four more (itself, its prefill, the
prefill's issue and wait); a train step four, and three more for each
micro-batch after the first: a 45 s window of serving or training keeps
some thousands at most.  A record is a fixed set of slots whose key is
shared with its parent, so the store stays under a few MiB of host
memory (and two CUDA events a device-timed span)."""

_KEPT: Deque["KeptSpan"] = deque(maxlen=KEPT_MAX)
_SIDS = itertools.count()
_LOCAL = threading.local()          # each thread's stack of open spans


def _open_stack() -> List["KeptSpan"]:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class KeptSpan:
    """One region of the program, kept after it closes.

    ``sid`` numbers spans in the order they opened; ``parent`` is the
    ``sid`` of the span open around this one on the same thread (None at
    the top); ``key`` is the caller's (a serve wave's request ids, a train
    step's index), else the parent's.  ``t0`` / ``t1`` are
    ``perf_counter`` seconds; ``events`` the (start, end) CUDA events of a
    device-timed span, else None."""

    __slots__ = ("name", "sid", "parent", "key", "attrs", "device", "t0",
                 "t1", "events", "_note")

    def __init__(self, name: str, key: Any, device: Any,
                 attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.key = key
        self.attrs = attrs
        self.device = device
        self.t1 = None
        self.events = None

    @property
    def host_s(self) -> float:
        """Seconds between enter and exit on ``perf_counter``."""
        return self.t1 - self.t0

    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's two events on the device, once
        the end event has completed (waits for it); None without events."""
        return _device.elapsed_ms(self.events)

    def __enter__(self) -> "KeptSpan":
        stack = _open_stack()
        self.sid = next(_SIDS)
        if stack:
            top = stack[-1]
            self.parent = top.sid
            if self.key is None:
                self.key = top.key
        else:
            self.parent = None
        stack.append(self)
        self._note = _device.annotate(self.name)
        start = _device.record(self.device)
        if start is not None:
            self.events = (start, None)        # the end comes at exit
        self.t0 = perf_counter()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        self.t1 = perf_counter()
        if self.events is not None:
            self.events = (self.events[0], _device.record(self.device))
        if self._note is not None:
            self._note.__exit__(None, None, None)
            self._note = None
        stack = _open_stack()
        if stack and stack[-1] is self:
            stack.pop()
        _KEPT.append(self)
        if _ENABLED:
            attrs = dict(self.attrs or {})
            if self.key is not None:
                attrs["key"] = self.key
            _span_event(self.name, self.t0, self.t1 - self.t0, attrs, et)
        return False


def kept_span(name: str, key: Any = None, device: Any = None,
              **attrs: Any) -> KeptSpan:
    """``with kept_span("serve.decode"):`` -- a region kept in memory
    whatever the switch says (see the module docstring); ``device`` (a
    ``torch.device``) adds the device clock where it is a CUDA device."""
    return KeptSpan(name, key, device, attrs or None)


def kept_spans(name: Optional[str] = None) -> List[KeptSpan]:
    """The kept spans, oldest first (those named ``name``, if given)."""
    if name is None:
        return list(_KEPT)
    return [s for s in _KEPT if s.name == name]


def last_kept(name: str) -> Optional[KeptSpan]:
    """The newest kept span named ``name``, or None."""
    for s in reversed(_KEPT):
        if s.name == name:
            return s
    return None


def clear_kept() -> None:
    """Forget every kept span."""
    _KEPT.clear()


# ---------------------------------------------------------------------------
# Structured logging (the [tag] diagnostics)
# ---------------------------------------------------------------------------

def vlog(tag: str, msg: str, *, level: int = 1,
         verbosity: Optional[int] = None, **fields: Any) -> None:
    """Structured replacement for the ad-hoc ``print(f"[sweep] ...")``
    diagnostics.

    Prints ``[tag] msg`` — byte-identical to the historical output — when
    the effective verbosity (the ``verbosity`` argument if given, else the
    ``REPRO_VERBOSITY`` env, default 1) is >= ``level``; additionally
    emits a structured ``log`` event when tracing is on, regardless of
    verbosity (a silenced console does not blind the trace).
    """
    if _ENABLED:
        e: Dict[str, Any] = {"ev": "log", "tag": tag, "msg": str(msg),
                             "t": time.time()}
        if fields:
            e["fields"] = fields
        emit(e)
    v = _VERBOSITY if verbosity is None else verbosity
    if v >= level:
        print(f"[{tag}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# Worker propagation (spawned pool workers don't inherit programmatic
# enable(); the pool initializer ships this state across)
# ---------------------------------------------------------------------------

def export_state() -> Optional[Dict[str, Any]]:
    """Picklable snapshot of the obs switch for a spawned worker."""
    if not _ENABLED:
        return None
    return {"run_dir": str(run_dir()), "verbosity": _VERBOSITY}


def import_state(state: Optional[Dict[str, Any]]) -> None:
    """Adopt a parent's :func:`export_state` inside a pool worker."""
    if not state:
        return
    set_verbosity(state.get("verbosity", _VERBOSITY))
    enable(state["run_dir"])
