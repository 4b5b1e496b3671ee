"""Analytical SLO prediction + traffic-model registry for the DSE loop.

Closes the serving loop: ``run_dse(objective="slo", traffic=...)`` scores
each candidate by its predicted tail latency under a registered traffic
model instead of the raw forward-pass delay.  The prediction is fully
analytical — the evaluator's delay maps to a per-token
:class:`~repro_torch.serve.harness.ServiceModel`, which the harness
replays over the traffic model's (deterministic, seeded) arrival process.
Queueing over that process is what makes p99 a *convex* function of the
delay: a candidate whose service rate sits near the trace's offered load
pays super-linear waiting time, so the MC^a * E^b * p99^g objective can
rank candidates differently from MC^a * E^b * D^g even though p99 is
monotone in D for a fixed traffic model.  The replay harness's measured
percentiles (``launch/serve.py --measure``, on the card) validate and
calibrate the prediction the same way ``realize/measure.py`` validates
traffic bytes — they never replace it inside the sweep, which must stay
deterministic.

Port of ``src/repro/serve/slo.py``, numpy only; a traffic model's
fingerprint hashes the reference's text, so SLO-scored sweep headers
match the reference's.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Dict, Tuple, Union

from .harness import replay, service_model_from_delay
from .trace import Trace, make_trace

__all__ = ["TrafficModel", "register_traffic_model", "resolve_traffic",
           "predict_slo", "SLO_SCALAR_KEY"]

# The report key reduce_tasks() folds into the objective.
SLO_SCALAR_KEY = "p99_e2e_s"


@dataclass(frozen=True)
class TrafficModel:
    """A named, replayable load pattern the DSE can optimize against.

    ``trace_spec`` uses the :func:`repro_torch.serve.trace.make_trace`
    grammar;
    ``seq_ref`` is the tokens-per-sequence the evaluator's delay is
    normalized over when deriving the per-token cost (64 matches the
    quick workloads; register a model with the deployment's seq for
    paper-scale runs).  ``mode`` picks the harness scheduling policy
    ("continuous" slotting by default — the wave policy is available for
    A/B against the real serve_loop path).
    """
    name: str
    trace_spec: str
    max_batch: int = 8
    mode: str = "continuous"
    seq_ref: int = 64
    decode_mult: float = 1.0

    def fingerprint(self) -> str:
        """Short stable id stamped into the sweep fingerprint."""
        blob = (f"{self.trace_spec}|b{self.max_batch}|{self.mode}"
                f"|s{self.seq_ref}|d{self.decode_mult:g}")
        h = hashlib.sha1(blob.encode("utf-8")).hexdigest()[:8]
        return f"{self.name}.{h}"


_REGISTRY: Dict[str, TrafficModel] = {}


def register_traffic_model(model: TrafficModel,
                           overwrite: bool = False) -> TrafficModel:
    """Register ``model`` under its name; returns it for chaining."""
    if not overwrite and model.name in _REGISTRY \
            and _REGISTRY[model.name] != model:
        raise ValueError(
            f"traffic model {model.name!r} already registered with a "
            "different definition (pass overwrite=True to replace)")
    _REGISTRY[model.name] = model
    return model


def registered_traffic_models() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_traffic(spec: Union[str, TrafficModel],
                    **overrides) -> TrafficModel:
    """Resolve a TrafficModel, registered name, or raw trace spec.

    A string containing ``":"`` is treated as an ad-hoc
    :func:`make_trace` spec (validated eagerly so typos fail at resolve
    time, with the generator's own listing); anything else must be a
    registered name.  Keyword overrides (``max_batch=…``, ``mode=…``,
    ``seq_ref=…``) are applied on top.
    """
    if isinstance(spec, TrafficModel):
        model = spec
    elif spec in _REGISTRY:
        model = _REGISTRY[spec]
    elif isinstance(spec, str) and ":" in spec:
        make_trace(spec)          # eager validation — raises on bad specs
        model = TrafficModel(name="adhoc", trace_spec=spec)
    else:
        raise KeyError(
            f"unknown traffic model {spec!r}: not a registered name "
            f"{registered_traffic_models()} and not a trace spec "
            "(kind:k=v,... — see repro_torch.serve.trace.make_trace)")
    return replace(model, **overrides) if overrides else model


# -- defaults ---------------------------------------------------------------
# Quick models sized for reduced/CI runs: short traces, mixed prompt and
# decode lengths.  Rates here are placeholders for interactive use; a DSE
# caller who wants the queueing knee to bite should register a model whose
# rate sits near the candidates' service capacity (see tests).
register_traffic_model(TrafficModel(
    name="chat-quick",
    trace_spec="poisson:rate=4,n=48,seed=0,plen=4..32,new=8..32"))
register_traffic_model(TrafficModel(
    name="diurnal-quick",
    trace_spec="diurnal:rate=4,n=48,seed=0,period=60,peak=3,"
               "plen=4..32,new=8..32"))


# -- prediction -------------------------------------------------------------

@lru_cache(maxsize=64)
def _trace_for(trace_spec: str) -> Trace:
    return make_trace(trace_spec)


@lru_cache(maxsize=4096)
def _predict_cached(delay_s: float, traffic: TrafficModel,
                    batch: int) -> Tuple[Tuple[str, float], ...]:
    trace = _trace_for(traffic.trace_spec)
    model = service_model_from_delay(delay_s, batch, traffic.seq_ref,
                                     decode_mult=traffic.decode_mult)
    rep = replay(trace, model, mode=traffic.mode,
                 max_batch=traffic.max_batch)
    s = rep.summary()
    out = {"makespan_s": s["makespan_s"],
           "throughput_rps": s["throughput_rps"],
           "throughput_tok_s": s["throughput_tok_s"],
           "mean_occupancy": s["mean_occupancy"]}
    for pfx, key in (("ttft", "ttft_s"), ("e2e", "e2e_s")):
        for p, v in s[key].items():
            out[f"{p}_{pfx}_s"] = v
    return tuple(sorted(out.items()))


def predict_slo(delay_s: float, traffic: Union[str, TrafficModel],
                batch: int) -> Dict[str, float]:
    """Predicted SLO metrics for a candidate with forward delay ``delay_s``.

    ``batch`` is the DSE batch the delay was evaluated at (together with
    the traffic model's ``seq_ref`` it normalizes the delay to a
    per-token cost).  Returns a dict with ``p50/p95/p99`` TTFT and
    end-to-end latency seconds plus throughput/occupancy; the DSE folds
    ``p99_e2e_s`` (:data:`SLO_SCALAR_KEY`) into its objective.
    Deterministic and cached — safe to call per (candidate x workload)
    task inside a sweep.
    """
    model = resolve_traffic(traffic)
    return dict(_predict_cached(float(delay_s), model, int(batch)))
