"""Structured telemetry for the DSE/serve stack (``REPRO_OBS=1``).

Three pillars (see DESIGN.md "Observability"):

* :mod:`repro_torch.obs.trace` — span tracer + structured ``vlog``
  logging, append-only JSONL event stream per process; and the port's
  *kept spans* (:func:`kept_span`): a few coarse regions per serve or
  train step, on whatever the switch says, held in a bounded in-memory
  store (:func:`kept_spans`) on ``perf_counter``, with the device clock
  and the profiler's marks from :mod:`repro_torch.obs.device`;
* :mod:`repro_torch.obs.metrics` — counters/gauges/histograms + collector
  harvest of the engine's native cache counters, worker payloads
  piggybacked on task results;
* :mod:`repro_torch.obs.manifest` / :mod:`repro_torch.obs.report` —
  per-run manifest and the ``launch/obs_report.py`` sweep post-mortem.

Telemetry never draws randomness and never reorders float math: sweeps
are bit-identical with tracing on or off, and the disabled path of
:func:`span` / :func:`timed` is a bool check.

Copy of ``src/repro/obs/__init__.py``, numpy and the standard library
only (no torch: :mod:`repro_torch.obs.device` imports it inside its
functions).  The switch is the reference's (``REPRO_OBS``,
``REPRO_OBS_DIR``, ``REPRO_VERBOSITY``), so the processes of either
package read it, and the event and metrics files have the reference's
schema: either package's ``obs_report`` renders the other's run dir.
"""

from . import manifest, metrics  # noqa: F401
from .trace import (KEPT_MAX, KeptSpan, clear_kept, disable, emit, enable,
                    enabled, export_state, flush, import_state, kept_span,
                    kept_spans, last_kept, run_dir, set_verbosity, span,
                    timed, verbosity, vlog)

__all__ = [
    "KEPT_MAX", "KeptSpan", "clear_kept", "disable", "emit", "enable",
    "enabled", "export_state", "flush", "import_state", "kept_span",
    "kept_spans", "last_kept", "manifest", "metrics", "run_dir",
    "set_verbosity", "span", "timed", "verbosity", "vlog",
]
