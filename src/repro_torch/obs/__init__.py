"""Structured telemetry for the DSE/serve stack (``REPRO_OBS=1``).

Three pillars (see DESIGN.md "Observability"):

* :mod:`repro_torch.obs.trace` — span tracer + structured ``vlog``
  logging, append-only JSONL event stream per process;
* :mod:`repro_torch.obs.metrics` — counters/gauges/histograms + collector
  harvest of the engine's native cache counters, worker payloads
  piggybacked on task results;
* :mod:`repro_torch.obs.manifest` / :mod:`repro_torch.obs.report` —
  per-run manifest and the ``launch/obs_report.py`` sweep post-mortem.

Telemetry never draws randomness and never reorders float math: sweeps
are bit-identical with tracing on or off, and the disabled path is a
bool check.

Copy of ``src/repro/obs/__init__.py``, numpy and the standard library
only (no torch).  The switch is the reference's (``REPRO_OBS``,
``REPRO_OBS_DIR``, ``REPRO_VERBOSITY``), so the processes of either
package read it, and the event and metrics files have the reference's
schema: either package's ``obs_report`` renders the other's run dir.
"""

from . import manifest, metrics  # noqa: F401
from .trace import (disable, emit, enable, enabled, export_state, flush,
                    import_state, run_dir, set_verbosity, span, timed,
                    verbosity, vlog)

__all__ = [
    "disable", "emit", "enable", "enabled", "export_state", "flush",
    "import_state", "manifest", "metrics", "run_dir", "set_verbosity",
    "span", "timed", "verbosity", "vlog",
]
