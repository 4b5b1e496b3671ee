"""Traffic-replay harness: discrete-event serving simulation + SLO report.

The harness replays a :class:`repro_torch.serve.trace.Trace` against a
served program and reports per-request SLO metrics — p50/p95/p99
time-to-first-token and end-to-end latency, throughput, per-wave
occupancy — plus a saturation-throughput estimate from an arrival-rate
sweep.

Two scheduling modes share one timeline/report format:

* ``mode="wave"`` — the policy ``runtime/serve_loop.py`` actually
  executes: up to ``max_batch`` *ready* requests are packed into a wave,
  the wave runs to completion (prefill once, decode until every slot is
  done), then the next wave forms.  Works with ANY
  :class:`WaveExecutor` — the real-model executor, a realized-program
  executor, or the analytical one.
* ``mode="continuous"`` — continuous batch slotting in the
  MaxText-offline-inference style: the machine serializes prefill and
  decode-step operations; whenever a slot frees and a request is ready,
  a prefill op admits it (prefill-prioritized), otherwise a decode-step
  op advances every active slot by one token.  Requires a
  :class:`ServiceModel` (analytical executors), because a mid-wave
  admission cannot be replayed against the real wave-batched model path.

All time is **virtual**: arrival times come from the trace and service
times from the executor's :class:`WaveCost` (measured wall seconds for
real executors, model-predicted seconds for analytical ones).  With an
analytical executor the whole replay — and therefore the report — is
deterministic for a fixed trace seed.

Port of ``src/repro/serve/harness.py``, numpy only.  The reference's
``obs`` calls (metrics, spans and the ``serve`` timeline events of
``replay``, ``_replay_waves`` and ``_replay_continuous``) go through
``repro_torch.obs`` under the same names; no report field depends on
them.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import (Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, Union, runtime_checkable)

import numpy as np

from .. import obs as _obs
from .trace import Trace, TraceRequest

PCTS = (50.0, 95.0, 99.0)


# ---------------------------------------------------------------------------
# Executor protocol
# ---------------------------------------------------------------------------

@dataclass
class WaveCost:
    """What one wave execution cost, in the executor's time base.

    ``prefill_s`` covers prompt ingestion for every slot; each slot's
    first token is available at ``start + prefill_s`` (greedy decode
    emits it from the prefill logits).  ``step_s[t]`` is the duration of
    the wave's ``t``-th decode step; ``slot_tokens[i]`` is how many
    tokens slot ``i`` actually produced (1 from prefill + one per decode
    step it was active in), so slot ``i`` finishes at
    ``start + prefill_s + sum(step_s[:slot_tokens[i] - 1])``.
    """
    prefill_s: float
    step_s: List[float]
    slot_tokens: List[int]
    tokens: Optional[List[np.ndarray]] = None     # real ids, if executed

    @property
    def total_s(self) -> float:
        return self.prefill_s + float(sum(self.step_s))


@runtime_checkable
class WaveExecutor(Protocol):
    """Transport-agnostic serving backend: execute one wave, report cost.

    Structural protocol — implementors need no import of this module.
    ``runtime.serve_loop.ModelWaveExecutor`` (the model on its device,
    measured wall clock) and :class:`AnalyticalWaveExecutor` (cost model,
    virtual clock) both satisfy it.
    """
    max_batch: int

    def execute(self, wave: Sequence[TraceRequest]) -> WaveCost: ...


# ---------------------------------------------------------------------------
# Analytical service model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ServiceModel:
    """Throughput-normalized token-cost model of a served program.

    Every processed token costs a fixed machine time: prompt tokens
    ``prefill_s_per_token``, generated tokens ``decode_s_per_token`` per
    active slot per step, plus ``overhead_s`` per machine operation
    (prefill or decode step — dispatch, collectives fan-in).  Decode
    steps being latency- rather than throughput-bound is absorbed by
    ``decode_s_per_token``'s calibration factor (DESIGN.md: serving
    harness, queueing-model assumptions).
    """
    prefill_s_per_token: float
    decode_s_per_token: float
    overhead_s: float = 0.0

    def prefill_s(self, prompt_tokens: int) -> float:
        return self.overhead_s + self.prefill_s_per_token * prompt_tokens

    def decode_step_s(self, active_slots: int) -> float:
        return self.overhead_s + self.decode_s_per_token * active_slots

    def request_unloaded_s(self, prompt_len: int, max_new: int) -> float:
        """End-to-end service time of one request on an idle machine."""
        return (self.prefill_s(prompt_len)
                + (max_new - 1) * self.decode_step_s(1))


def service_model_from_delay(delay_s: float, batch: int, seq_ref: int,
                             decode_mult: float = 1.0,
                             overhead_s: float = 0.0) -> ServiceModel:
    """Derive the token-cost model from the evaluator's delay prediction.

    The DSE scores a full forward of ``batch`` sequences x ``seq_ref``
    tokens at ``delay_s`` seconds, so the throughput-normalized per-token
    cost is ``delay_s / (batch * seq_ref)``.  ``decode_mult`` scales the
    decode-token cost relative to prefill (decode steps re-read the KV
    cache and underfill the MACs; calibration fits it from measured
    replays, default 1.0 = pure throughput normalization).
    """
    if delay_s <= 0 or batch < 1 or seq_ref < 1:
        raise ValueError(
            f"service model needs delay_s > 0, batch >= 1, seq_ref >= 1; "
            f"got {delay_s}, {batch}, {seq_ref}")
    c = delay_s / (batch * seq_ref)
    return ServiceModel(prefill_s_per_token=c,
                        decode_s_per_token=c * decode_mult,
                        overhead_s=overhead_s)


class AnalyticalWaveExecutor:
    """Deterministic executor predicting wave costs from a ServiceModel.

    No EOS modeling: every slot runs to its ``max_new`` budget (the trace
    already draws the decode-length distribution, so budgets ARE the
    modeled response lengths).
    """

    def __init__(self, model: ServiceModel, max_batch: int = 8):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.model = model
        self.max_batch = max_batch

    def execute(self, wave: Sequence[TraceRequest]) -> WaveCost:
        budgets = [r.max_new for r in wave]
        n_steps = max(budgets) - 1
        step_s = [self.model.decode_step_s(
                      sum(1 for b in budgets if b - 1 > t))
                  for t in range(n_steps)]
        return WaveCost(
            prefill_s=self.model.prefill_s(sum(r.prompt_len for r in wave)),
            step_s=step_s, slot_tokens=list(budgets))


# ---------------------------------------------------------------------------
# Timelines + report
# ---------------------------------------------------------------------------

@dataclass
class RequestTimeline:
    """Per-request SLO timeline; the invariant ``enqueue <= start <=
    first_token <= finish`` is what the monotonicity test pins."""
    rid: int
    prompt_len: int
    n_tokens: int
    enqueue_t: float
    start_t: float                 # admitted to the machine (wave/prefill)
    first_token_t: float
    finish_t: float

    @property
    def ttft_s(self) -> float:
        return self.first_token_t - self.enqueue_t

    @property
    def latency_s(self) -> float:
        return self.finish_t - self.enqueue_t

    @property
    def queue_s(self) -> float:
        return self.start_t - self.enqueue_t

    def to_json(self) -> Dict[str, float]:
        return {"rid": self.rid, "prompt_len": self.prompt_len,
                "n_tokens": self.n_tokens, "enqueue_t": self.enqueue_t,
                "start_t": self.start_t, "first_token_t": self.first_token_t,
                "finish_t": self.finish_t, "ttft_s": self.ttft_s,
                "latency_s": self.latency_s}


def _pcts(xs: Sequence[float]) -> Dict[str, float]:
    arr = np.asarray(xs, dtype=np.float64)
    return {f"p{p:g}": float(np.percentile(arr, p)) for p in PCTS}


@dataclass
class ServeReport:
    """SLO summary of one replay (+ per-request timelines)."""
    mode: str
    trace_name: str
    trace_spec: str
    trace_seed: int
    max_batch: int
    requests: List[RequestTimeline] = field(default_factory=list)
    n_waves: int = 0
    occupancy: List[float] = field(default_factory=list)   # per wave/step
    timing: str = "virtual"        # "virtual" (model) or "measured" (wall)

    def summary(self) -> Dict[str, object]:
        ttft = [r.ttft_s for r in self.requests]
        e2e = [r.latency_s for r in self.requests]
        makespan = (max(r.finish_t for r in self.requests)
                    - min(r.enqueue_t for r in self.requests)) \
            if self.requests else 0.0
        n_tok = sum(r.n_tokens for r in self.requests)
        return {
            "mode": self.mode,
            "timing": self.timing,
            "trace": {"name": self.trace_name, "spec": self.trace_spec,
                      "seed": self.trace_seed, "n": len(self.requests)},
            "max_batch": self.max_batch,
            "n_waves": self.n_waves,
            "makespan_s": makespan,
            "throughput_rps": len(self.requests) / makespan
                              if makespan > 0 else 0.0,
            "throughput_tok_s": n_tok / makespan if makespan > 0 else 0.0,
            "mean_occupancy": float(np.mean(self.occupancy))
                              if self.occupancy else 0.0,
            "ttft_s": _pcts(ttft) if ttft else {},
            "e2e_s": _pcts(e2e) if e2e else {},
        }

    @property
    def p99_e2e_s(self) -> float:
        return float(np.percentile([r.latency_s for r in self.requests], 99))

    @property
    def p99_ttft_s(self) -> float:
        return float(np.percentile([r.ttft_s for r in self.requests], 99))

    def to_json(self, per_request: bool = True) -> str:
        doc = dict(self.summary())
        if per_request:
            doc["requests"] = [r.to_json() for r in self.requests]
        return json.dumps(doc, sort_keys=True)


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------

def _wave_timelines(wave: Sequence[TraceRequest], cost: WaveCost,
                    start: float) -> Tuple[List[RequestTimeline], float]:
    """Per-slot timelines of one executed wave; returns (timelines, end)."""
    first = start + cost.prefill_s
    cum = np.concatenate([[0.0], np.cumsum(cost.step_s)])
    out = []
    for i, req in enumerate(wave):
        nt = cost.slot_tokens[i]
        out.append(RequestTimeline(
            rid=req.rid, prompt_len=req.prompt_len, n_tokens=nt,
            enqueue_t=req.arrival_s, start_t=start,
            first_token_t=first,
            finish_t=first + float(cum[min(nt - 1, len(cost.step_s))])))
    return out, first + float(cum[-1])


def _replay_waves(trace: Trace, executor: WaveExecutor) -> ServeReport:
    rep = ServeReport(mode="wave", trace_name=trace.name,
                      trace_spec=trace.spec, trace_seed=trace.seed,
                      max_batch=executor.max_batch)
    pending = sorted(trace.requests, key=lambda r: (r.arrival_s, r.rid))
    now = 0.0
    i = 0
    while i < len(pending):
        if pending[i].arrival_s > now:
            now = pending[i].arrival_s        # idle until the next arrival
        wave = []
        while (i < len(pending) and len(wave) < executor.max_batch
               and pending[i].arrival_s <= now):
            wave.append(pending[i])
            i += 1
        cost = executor.execute(wave)
        tls, end = _wave_timelines(wave, cost, now)
        rep.requests.extend(tls)
        rep.n_waves += 1
        rep.occupancy.append(len(wave) / executor.max_batch)
        if _obs.enabled():
            # queue depth = arrived-but-unadmitted backlog at wave launch;
            # simulated time, so the timeline is deterministic per trace
            depth = 0
            j = i
            while j < len(pending) and pending[j].arrival_s <= now:
                depth += 1
                j += 1
            _obs.metrics.counter("serve.requests").inc(len(wave))
            _obs.metrics.histogram("serve.queue_depth").observe(depth)
            _obs.metrics.histogram("serve.occupancy").observe(
                rep.occupancy[-1])
            _obs.emit({"ev": "serve", "mode": "wave", "t_sim": now,
                       "wave": rep.n_waves, "batch": len(wave),
                       "queue_depth": depth,
                       "occupancy": rep.occupancy[-1]})
        now = end
    rep.requests.sort(key=lambda r: r.rid)
    return rep


def _replay_continuous(trace: Trace, model: ServiceModel,
                       max_batch: int) -> ServeReport:
    """Continuous batch slotting over a serialized prefill/decode machine.

    The machine executes one operation at a time: ``prefill(req)`` when a
    slot is free and a request has arrived (admission emits the first
    token at op completion), else ``decode_step`` advancing every active
    slot by one token.  Occupancy is recorded per decode step.
    """
    rep = ServeReport(mode="continuous", trace_name=trace.name,
                      trace_spec=trace.spec, trace_seed=trace.seed,
                      max_batch=max_batch)
    pending = sorted(trace.requests, key=lambda r: (r.arrival_s, r.rid))
    i = 0
    now = 0.0
    # slot -> [req, remaining_tokens, timeline]
    active: List[List] = []
    while i < len(pending) or active:
        can_admit = (len(active) < max_batch and i < len(pending)
                     and pending[i].arrival_s <= now)
        if can_admit:
            req = pending[i]
            i += 1
            dt = model.prefill_s(req.prompt_len)
            tl = RequestTimeline(
                rid=req.rid, prompt_len=req.prompt_len,
                n_tokens=req.max_new, enqueue_t=req.arrival_s,
                start_t=now, first_token_t=now + dt, finish_t=now + dt)
            now += dt
            if req.max_new <= 1:
                rep.requests.append(tl)
            else:
                active.append([req, req.max_new - 1, tl])
        elif active:
            dt = model.decode_step_s(len(active))
            now += dt
            rep.n_waves += 1                   # machine ops, here: steps
            rep.occupancy.append(len(active) / max_batch)
            if _obs.enabled():
                _obs.metrics.histogram("serve.occupancy").observe(
                    rep.occupancy[-1])
                depth = 0
                j = i
                while j < len(pending) and pending[j].arrival_s <= now:
                    depth += 1
                    j += 1
                _obs.metrics.histogram("serve.queue_depth").observe(depth)
                # decode steps are plentiful (one per generated token
                # across the batch); thin the timeline to every 32nd op
                if rep.n_waves % 32 == 1:
                    _obs.emit({"ev": "serve", "mode": "continuous",
                               "t_sim": now, "step": rep.n_waves,
                               "active": len(active), "queue_depth": depth,
                               "occupancy": rep.occupancy[-1]})
            still = []
            for ent in active:
                ent[1] -= 1
                if ent[1] <= 0:
                    ent[2].finish_t = now
                    rep.requests.append(ent[2])
                else:
                    still.append(ent)
            active = still
        else:
            now = pending[i].arrival_s         # idle until the next arrival
    rep.requests.sort(key=lambda r: r.rid)
    return rep


def replay(trace: Trace, executor: Union[WaveExecutor, ServiceModel],
           mode: str = "wave", max_batch: Optional[int] = None
           ) -> ServeReport:
    """Replay ``trace`` against ``executor`` and report SLO metrics.

    ``mode="wave"`` accepts any :class:`WaveExecutor`;
    ``mode="continuous"`` needs a :class:`ServiceModel` (pass one
    directly with ``max_batch``, or an :class:`AnalyticalWaveExecutor`
    whose model+max_batch are used).
    """
    if mode == "wave":
        if isinstance(executor, ServiceModel):
            executor = AnalyticalWaveExecutor(executor,
                                              max_batch=max_batch or 8)
        with _obs.span("serve.replay", mode=mode,
                       n_requests=len(trace.requests)):
            return _replay_waves(trace, executor)
    if mode == "continuous":
        if isinstance(executor, ServiceModel):
            model, mb = executor, max_batch or 8
        elif isinstance(executor, AnalyticalWaveExecutor):
            model, mb = executor.model, executor.max_batch
        else:
            raise ValueError(
                "mode='continuous' simulates mid-wave admissions, which "
                "only a ServiceModel (or AnalyticalWaveExecutor) supports; "
                f"got {type(executor).__name__} — use mode='wave' for real "
                "executors")
        with _obs.span("serve.replay", mode=mode,
                       n_requests=len(trace.requests)):
            rep = _replay_continuous(trace, model, mb)
        _obs.metrics.counter("serve.requests").inc(len(rep.requests))
        return rep
    raise ValueError(f"unknown replay mode {mode!r}: 'wave' or 'continuous'")


# ---------------------------------------------------------------------------
# Saturation sweep
# ---------------------------------------------------------------------------

def saturation_sweep(trace_at: Callable[[float], Trace],
                     executor_at: Callable[[], Union[WaveExecutor,
                                                     ServiceModel]],
                     rates: Sequence[float], mode: str = "wave",
                     max_batch: Optional[int] = None,
                     slo_mult: float = 5.0) -> Dict[str, object]:
    """Find saturation throughput by sweeping the arrival rate.

    Replays ``trace_at(rate)`` for each rate (ascending) and declares the
    system saturated once p99 end-to-end latency exceeds ``slo_mult`` x
    the lowest rate's p99 (the unloaded reference).  Returns the sweep
    table plus the saturation estimate: the highest rate still inside the
    SLO, with its measured request and token throughput.  Deterministic
    for analytical executors (same traces, same model).
    """
    rates = sorted(rates)
    if not rates:
        raise ValueError("saturation_sweep needs at least one rate")
    table: List[Dict[str, float]] = []
    ref_p99: Optional[float] = None
    sat: Optional[Dict[str, float]] = None
    saturated = False
    for rate in rates:
        rep = replay(trace_at(rate), executor_at(), mode=mode,
                     max_batch=max_batch)
        s = rep.summary()
        row = {"rate_rps": rate, "p99_e2e_s": rep.p99_e2e_s,
               "p99_ttft_s": rep.p99_ttft_s,
               "throughput_rps": s["throughput_rps"],
               "throughput_tok_s": s["throughput_tok_s"],
               "mean_occupancy": s["mean_occupancy"]}
        table.append(row)
        if ref_p99 is None:
            ref_p99 = rep.p99_e2e_s
        if rep.p99_e2e_s <= slo_mult * ref_p99:
            sat = row
        else:
            saturated = True
            break
    return {
        "slo_mult": slo_mult,
        "ref_p99_e2e_s": ref_p99,
        "saturated": saturated,
        "sat_rate_rps": sat["rate_rps"] if sat else None,
        "sat_throughput_rps": sat["throughput_rps"] if sat else None,
        "sat_throughput_tok_s": sat["throughput_tok_s"] if sat else None,
        "sweep": table,
    }
