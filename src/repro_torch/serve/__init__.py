"""Traffic-replay serving subsystem.

The ROADMAP's "millions of users" axis: deterministic synthetic traffic
traces (:mod:`repro_torch.serve.trace`), a discrete-event replay harness
with continuous batch slotting and SLO reporting
(:mod:`repro_torch.serve.harness`), and the analytical queueing predictor
+ traffic-model registry that feeds tail latency back into the DSE as an
objective (:mod:`repro_torch.serve.slo`).

Port of ``src/repro/serve/__init__.py``.  The package is numpy only and
imports no torch (``repro_torch.core`` imports :mod:`.slo`, and the DSE's
spawned workers load the core alone): the executor that runs the model
(``runtime/serve_loop.py``) plugs in through the structural
:class:`repro_torch.serve.harness.WaveExecutor` protocol.
"""

from .harness import (AnalyticalWaveExecutor, RequestTimeline, ServeReport,
                      ServiceModel, WaveCost, WaveExecutor, replay,
                      saturation_sweep, service_model_from_delay)
from .slo import (TrafficModel, register_traffic_model, resolve_traffic,
                  predict_slo)
from .trace import (Trace, TraceRequest, diurnal_trace, make_trace,
                    poisson_trace, respec)

__all__ = [
    "Trace", "TraceRequest", "poisson_trace", "diurnal_trace", "make_trace",
    "respec",
    "WaveExecutor", "WaveCost", "ServiceModel", "AnalyticalWaveExecutor",
    "RequestTimeline", "ServeReport", "replay", "saturation_sweep",
    "service_model_from_delay",
    "TrafficModel", "register_traffic_model", "resolve_traffic",
    "predict_slo",
]
