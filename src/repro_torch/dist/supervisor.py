"""Fault-tolerant sweep supervisor: dispatch, liveness, re-shard, merge.

The supervisor owns one sweep end to end:

1. **Screen once, ship the keep set.**  The two-stage screen (cheap
   T-Map pass) runs in the supervisor process with the exact keep rule
   the engine applies, then each shard child receives an *explicit*
   candidate-index list (``run_dse(..., indices=...)``) — stride-sharded
   children would each re-screen the full grid for nothing.  Per-task
   seeds derive from the global candidate index, so any partition of the
   keep set merges bit-identically.
2. **Liveness from checkpoint heartbeats.**  Children append ``_hb``
   lines to their shard checkpoints; the supervisor polls each file's
   progress signature ``(record count, last heartbeat payload)`` and
   tracks *its own monotonic receipt time* of the last change.  The
   heartbeat's wall-clock ``t`` is deliberately not trusted — a skewed
   or frozen remote clock must not look like death (or worse, mask it).
   A shard whose signature hasn't changed within ``hb_timeout`` seconds
   is declared dead.
3. **Re-shard the dead shard's remaining work.**  Remaining = candidates
   whose records the engine's own resume gate would not accept
   (:func:`repro_torch.core.explore.remaining_candidate_indices`).  The
   replacement jobs land on live hosts and write **fresh** checkpoint
   files: a ShellCommandHost kill only reaches the local wrapper, so an
   unkillable remote zombie may keep appending to the old file — which
   is safe precisely because records are seed-gated and deterministic
   (duplicates merge last-wins to identical values; the merge's conflict
   detector would catch anything else).
4. **Merge with a fingerprint assertion.**  Every shard artifact — dead
   shards' partial files included — merges under the sweep fingerprint
   with ``on_conflict="error"``, then the merged file must leave zero
   remaining candidates.

Supervisor state is an append-only, fsync'd JSONL journal (``plan`` /
``launch`` / ``exit`` / ``retry`` / ``dead`` / ``reshard`` /
``shard_done`` / ``merged`` events): a killed supervisor resumes
mid-sweep with :meth:`Supervisor.resume` by replaying the journal,
recomputing what remains from the shard checkpoints on disk, and
dispatching only that.

Copy of ``src/repro/dist/supervisor.py``.  ``SweepSpec.sa`` takes the
port's SA backends, ``"numpy"`` and ``"fused"`` (the reference's
``"jax"`` is refused with the port's unknown-backend error).  Two
additions:

* a spec that scores on ``"fused"`` gets its ``fused_eval`` library
  built once, before dispatch, on a machine with a card, so that no child
  spends its heartbeat window in ``nvcc``; without a card the children
  run and fail loudly (no numpy fallback), and the sweep ends in
  :class:`SupervisorError`;
* with tracing on, each child traces into its own run dir,
  ``<supervisor run dir>/<job label>`` (the reference's children share
  one, and the last to finish overwrites the others' ``metrics.json``),
  and the supervisor lands its own ``supervisor.*`` metrics snapshot
  after the merge.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .. import obs as _obs
from ..core.dse import DSEConfig, grid_candidates, run_dse
from ..core.explore import (ExplorationEngine, merge_checkpoints,
                            remaining_candidate_indices, sweep_fingerprint)
from ..core.sa import SAConfig, check_backend
from ..core.workload import Graph
from ..core.workloads import make_workload
from ..obs.report import parse_heartbeats
from .faults import FaultSpec, env_for, plan_faults
from .hosts import Handle, Host, LocalProcessHost


class SupervisorError(RuntimeError):
    """The sweep cannot make progress (hosts exhausted, merge refused,
    or the merged checkpoint is incomplete)."""


# ---------------------------------------------------------------------------
# SweepSpec — the JSON-serializable sweep description shipped to children
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SweepSpec:
    """Everything needed to rebuild the sweep in any process.

    The spec is deliberately plain JSON data — workload *spec strings*
    (``repro_torch.core.workloads.make_workload`` grammar), the Table-I
    grid's
    ``grid_candidates`` kwargs, and ``DSEConfig``/``SAConfig`` kwarg
    overrides — so the supervisor journal, the shard children and a
    resuming supervisor all reconstruct the identical sweep (same
    fingerprint, same seeds) from one artifact.
    """
    workloads: Dict[str, str]             # name -> make_workload spec
    grid: Dict[str, Any]                  # grid_candidates kwargs
    sa: Dict[str, Any] = field(default_factory=dict)     # SAConfig kwargs
    cfg: Dict[str, Any] = field(default_factory=dict)    # DSEConfig kwargs
    n_shards: int = 2
    screen_keep: float = 1.0
    use_sa: bool = True

    def __post_init__(self):
        if not self.workloads:
            raise ValueError("spec needs at least one workload")
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if isinstance(self.screen_keep, str):
            raise ValueError(
                "adaptive screening (screen_keep='auto') consumes SA "
                "results as they arrive and cannot be dispatched as an "
                "up-front keep set; supervised sweeps need a fixed "
                "fraction")
        if "sa" in self.cfg or "traffic" in self.cfg:
            raise ValueError("put SAConfig kwargs in spec.sa; traffic "
                             "models are not JSON-serializable")
        check_backend(self.sa.get("backend", SAConfig.backend))

    # -- builders ----------------------------------------------------------
    def build_workloads(self) -> Dict[str, Graph]:
        return {name: make_workload(s) for name, s in self.workloads.items()}

    def build_candidates(self) -> List[Any]:
        return grid_candidates(**self.grid)

    def build_cfg(self) -> DSEConfig:
        return DSEConfig(sa=SAConfig(**self.sa), **self.cfg)

    def fingerprint(self) -> str:
        return sweep_fingerprint(self.build_workloads(), self.build_cfg(),
                                 use_sa=self.use_sa)

    # -- (de)serialization -------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SweepSpec":
        return cls(**d)

    @classmethod
    def from_json(cls, text: str) -> "SweepSpec":
        return cls.from_dict(json.loads(text))


def quick_spec(seed: int = 3, n_shards: int = 2,
               screen_keep: float = 1.0) -> SweepSpec:
    """The CI-sized sweep (6 candidates x 1 workload, 40-iteration SA) —
    small enough that the whole chaos matrix runs in seconds."""
    return SweepSpec(
        workloads={"tf": "tf-quick"},
        grid=dict(tops=72.0, mac_options=[512, 1024], cut_options=[1, 2],
                  dram_per_tops=[2.0], noc_options=[16, 32],
                  d2d_ratio=[0.5], glb_options=[1024]),
        sa=dict(iters=40, seed=seed),
        cfg=dict(batch=8),
        n_shards=n_shards, screen_keep=screen_keep)


# ---------------------------------------------------------------------------
# ShardJob — one dispatched child
# ---------------------------------------------------------------------------

@dataclass
class ShardJob:
    """One launched shard child, as the supervisor tracks it."""
    shard_id: int
    attempt: int
    indices: List[int]
    checkpoint: Path
    host: Host
    fault: Optional[FaultSpec] = None
    dup: bool = False                       # duplicate-dispatch twin
    handle: Optional[Handle] = None
    launched_t: float = 0.0                 # monotonic, supervisor-local
    progress: Tuple[int, Optional[str]] = (0, None)
    progress_t: float = 0.0                 # monotonic receipt of last change
    state: str = "pending"      # pending|running|done|failed

    @property
    def label(self) -> str:
        tag = "d" if self.dup else "a"
        return f"s{self.shard_id}{tag}{self.attempt}"


# ---------------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------------

def _append_event(path: Path, event: Dict[str, Any]) -> None:
    """Durable append: one JSON line, flushed and fsync'd — the journal
    must survive the supervisor dying right after a state transition."""
    with path.open("a") as f:
        f.write(json.dumps(event, sort_keys=True) + "\n")
        f.flush()
        try:
            os.fsync(f.fileno())
        except OSError:
            pass


def read_state(state_path: Union[str, Path]) -> Dict[str, Any]:
    """Replay a supervisor journal into a summary dict (tolerant of a
    torn final line — the supervisor may have died mid-append)."""
    events: List[Dict[str, Any]] = []
    p = Path(state_path)
    if p.exists():
        lines = p.read_text().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    continue
                raise ValueError(f"corrupt journal line {i + 1} in {p}")
    plan = next((e for e in events if e["ev"] == "plan"), None)
    ckpts: List[str] = []
    for e in events:
        if e["ev"] == "launch" and e["checkpoint"] not in ckpts:
            ckpts.append(e["checkpoint"])
    merged = next((e for e in reversed(events) if e["ev"] == "merged"), None)
    return {"plan": plan, "checkpoints": ckpts, "merged": merged,
            "events": events}


class Supervisor:
    """Run one supervised sweep; see the module docstring for the
    protocol.  ``hosts`` defaults to a single :class:`LocalProcessHost`.

    ``fault_kind``/``fault_seed`` arm the deterministic chaos harness
    (:mod:`repro_torch.dist.faults`): the seeded plan picks a victim
    first-generation shard and the supervisor ships the fault to that
    child's *first* attempt only, so recovery must succeed.
    """

    def __init__(self, spec: SweepSpec, out_dir: Union[str, Path],
                 hosts: Optional[Sequence[Host]] = None,
                 state_path: Union[str, Path, None] = None,
                 hb_timeout: float = 60.0, poll_s: float = 0.5,
                 max_attempts: int = 3, hb_every: float = 0.0,
                 fault_kind: Optional[str] = None, fault_seed: int = 0,
                 fault_k: Optional[int] = None):
        self.spec = spec
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.hosts: List[Host] = list(hosts) if hosts else [LocalProcessHost()]
        self.state_path = Path(state_path) if state_path is not None \
            else self.out_dir / "supervisor_state.jsonl"
        self.hb_timeout = float(hb_timeout)
        self.poll_s = float(poll_s)
        self.max_attempts = int(max_attempts)
        self.hb_every = float(hb_every)
        self.faults: Dict[int, FaultSpec] = {}
        self.fault_kind = fault_kind
        if fault_kind is not None:
            self.faults = plan_faults(fault_seed, spec.n_shards, fault_kind,
                                      k=fault_k)
        self._dead_hosts: set = set()
        self._next_shard = spec.n_shards
        self._jobs: List[ShardJob] = []
        self._spec_path = self.out_dir / "spec.json"
        self.merged_path = self.out_dir / "merged.jsonl"
        # materialized once; identical in every process by construction
        self._candidates = spec.build_candidates()
        self._workloads = spec.build_workloads()
        self._cfg = spec.build_cfg()
        self.fingerprint = sweep_fingerprint(self._workloads, self._cfg,
                                             use_sa=spec.use_sa)

    # -- keep set (screen once) -------------------------------------------
    def _keep_set(self) -> List[int]:
        """The exact keep set an unsharded ``engine.run`` would screen to
        (same stable order, same epsilon-guarded ceil) — computed here
        once instead of once per shard."""
        n = len(self._candidates)
        if not (self.spec.use_sa and self.spec.screen_keep < 1.0 and n > 1):
            return list(range(n))
        with ExplorationEngine(self._workloads, self._cfg) as eng:
            indexed = list(enumerate(self._candidates))
            with _obs.span("supervisor.screen", n_candidates=n):
                pts = eng._reduce(indexed, eng._screen_tasks(indexed))
        order = sorted(range(n), key=lambda i: pts[i].objective)
        keep = max(1, min(n, math.ceil(self.spec.screen_keep * n - 1e-9)))
        return sorted(order[:keep])

    @staticmethod
    def _partition(keep: Sequence[int], n_shards: int) -> List[List[int]]:
        shards: List[List[int]] = [[] for _ in range(n_shards)]
        for i, ci in enumerate(keep):
            shards[i % n_shards].append(ci)
        return [s for s in shards if s]

    # -- events ------------------------------------------------------------
    def _event(self, ev: str, **fields: Any) -> None:
        _append_event(self.state_path, {"ev": ev, "t": time.time(),
                                        **fields})
        _obs.vlog("supervisor", f"{ev}: " + json.dumps(fields, default=str),
                  level=2)

    # -- dispatch ----------------------------------------------------------
    def _live_hosts(self) -> List[Host]:
        return [h for h in self.hosts if h.name not in self._dead_hosts]

    def _launch(self, job: ShardJob) -> None:
        env = {"REPRO_HB_EVERY": str(self.hb_every)}
        env.update(env_for(job.fault, job.attempt))
        run_dir = _obs.run_dir()
        if run_dir is not None:
            env.update({"REPRO_OBS": "1",
                        "REPRO_OBS_DIR": str(run_dir / job.label),
                        "REPRO_VERBOSITY": str(_obs.verbosity())})
        argv = ["-m", "repro_torch.dist.shard_child",
                "--spec", str(self._spec_path),
                "--indices", ",".join(map(str, job.indices)),
                "--checkpoint", str(job.checkpoint),
                "--shard-label", job.label]
        log = self.out_dir / f"{job.label}.log"
        job.handle = job.host.launch(argv, env, log_path=log)
        now = time.monotonic()
        job.launched_t = job.progress_t = now
        job.progress = parse_heartbeats_signature(job.checkpoint)
        job.state = "running"
        _obs.metrics.counter("supervisor.launches").inc()
        self._event("launch", shard=job.shard_id, attempt=job.attempt,
                    dup=job.dup, host=job.host.name,
                    checkpoint=str(job.checkpoint),
                    indices=job.indices,
                    fault=(job.fault.encode() if job.fault else None))
        self._jobs.append(job)

    def _new_job(self, shard_id: int, attempt: int, indices: List[int],
                 host: Host, fault: Optional[FaultSpec] = None,
                 dup: bool = False) -> ShardJob:
        tag = "d" if dup else "a"
        ckpt = self.out_dir / f"shard{shard_id}_{tag}{attempt}.jsonl"
        return ShardJob(shard_id=shard_id, attempt=attempt,
                        indices=list(indices), checkpoint=ckpt, host=host,
                        fault=fault, dup=dup)

    # -- failure handling --------------------------------------------------
    def _remaining(self, job: ShardJob) -> List[int]:
        return remaining_candidate_indices(
            self._candidates, self._workloads, self._cfg, job.checkpoint,
            use_sa=self.spec.use_sa, indices=job.indices)

    def _retry_or_reshard(self, job: ShardJob, remaining: List[int],
                          reason: str) -> None:
        if not remaining:
            # the crash landed after the last record (e.g. a corrupt-tail
            # fault appended its torn line post-completion): the work is
            # all on disk, nothing to redo
            job.state = "done"
            self._event("shard_done", shard=job.shard_id,
                        attempt=job.attempt, dup=job.dup, note=reason)
            return
        job.state = "failed"
        alive = job.host.name not in self._dead_hosts
        if alive and job.attempt + 1 < self.max_attempts:
            _obs.metrics.counter("supervisor.retries").inc()
            self._event("retry", shard=job.shard_id,
                        attempt=job.attempt + 1, remaining=remaining,
                        reason=reason)
            nxt = self._new_job(job.shard_id, job.attempt + 1, remaining,
                                job.host, fault=job.fault, dup=job.dup)
            self._launch(nxt)
            return
        if alive:
            self._mark_dead(job.host, f"shard {job.shard_id}: {reason}; "
                            "retries exhausted")
        self._reshard(remaining, origin=job.shard_id)

    def _mark_dead(self, host: Host, reason: str) -> None:
        if host.name in self._dead_hosts:
            return
        self._dead_hosts.add(host.name)
        _obs.metrics.counter("supervisor.deaths").inc()
        self._event("dead", host=host.name, reason=reason)
        # reap every other running job on the dead host: its work is
        # re-sharded the same way (poll loop sees state=="failed" no more)
        for other in self._jobs:
            if other.state == "running" and other.host is host:
                if other.handle is not None:
                    other.handle.kill()
                other.state = "failed"
                rem = self._remaining(other)
                if rem:
                    self._reshard(rem, origin=other.shard_id)

    def _reshard(self, indices: List[int], origin: int) -> None:
        if not indices:
            return
        live = self._live_hosts()
        if not live:
            raise SupervisorError(
                f"no live hosts left to re-shard {len(indices)} "
                f"candidate(s) from shard {origin}")
        parts = self._partition(indices, len(live))
        _obs.metrics.counter("supervisor.reshards").inc()
        self._event("reshard", origin=origin, remaining=indices,
                    n_new=len(parts))
        for part, host in zip(parts, live):
            job = self._new_job(self._next_shard, 0, part, host)
            self._next_shard += 1
            self._launch(job)

    # -- poll loop ---------------------------------------------------------
    def _poll_once(self) -> bool:
        """One pass over running jobs; True while any job still runs."""
        busy = False
        for job in list(self._jobs):
            if job.state != "running":
                continue
            rc = job.handle.poll() if job.handle is not None else 1
            if rc is not None:
                self._event("exit", shard=job.shard_id, attempt=job.attempt,
                            dup=job.dup, rc=rc)
                remaining = self._remaining(job)
                if rc == 0 and not remaining:
                    job.state = "done"
                    self._event("shard_done", shard=job.shard_id,
                                attempt=job.attempt, dup=job.dup)
                    continue
                self._retry_or_reshard(
                    job, remaining,
                    reason=(f"exit rc={rc}" if rc != 0
                            else "exit 0 with incomplete checkpoint"))
                busy = True
                continue
            busy = True
            sig = parse_heartbeats_signature(job.checkpoint)
            now = time.monotonic()
            if sig != job.progress:
                job.progress, job.progress_t = sig, now
            elif now - max(job.progress_t, job.launched_t) > self.hb_timeout:
                if job.handle is not None:
                    job.handle.kill()
                job.state = "failed"
                self._event("hb_timeout", shard=job.shard_id,
                            attempt=job.attempt,
                            silent_s=round(now - job.progress_t, 3))
                self._mark_dead(job.host,
                                f"shard {job.shard_id}: no heartbeat "
                                f"progress for {self.hb_timeout:g}s")
                rem = self._remaining(job)
                if rem:
                    self._reshard(rem, origin=job.shard_id)
        return busy

    # -- public entry points ----------------------------------------------
    def _prebuild(self) -> None:
        """Build the ``fused_eval`` library before any child needs it,
        where the spec scores on the card and there is one."""
        if self._cfg.sa.backend != "fused":
            return
        import torch
        if not torch.cuda.is_available():
            _obs.vlog("supervisor", "no CUDA device here: the fused shard "
                      "children will fail", level=2)
            return
        from ..kernels import _build
        with _obs.span("supervisor.build", source="fused_eval"):
            _build.build(["fused_eval"])

    def run(self) -> Path:
        """Screen, dispatch, supervise, merge; returns the merged path."""
        self._spec_path.write_text(self.spec.to_json() + "\n")
        self._prebuild()
        keep = self._keep_set()
        parts = self._partition(keep, self.spec.n_shards)
        self._event("plan", fingerprint=self.fingerprint,
                    n_candidates=len(self._candidates), keep=keep,
                    shards=[list(p) for p in parts],
                    spec=self.spec.to_dict(),
                    fault_kind=self.fault_kind,
                    faults={str(k): v.encode()
                            for k, v in self.faults.items()})
        hosts = self._live_hosts()
        for sid, part in enumerate(parts):
            fault = self.faults.get(sid)
            dup = fault is not None and fault.kind == "dup"
            job = self._new_job(sid, 0, part, hosts[sid % len(hosts)],
                                fault=None if dup else fault)
            self._launch(job)
            if dup:
                # duplicate dispatch: the same indices race into a second
                # checkpoint on another host; last-wins merge + the
                # conflict detector prove both computed identical records
                twin_host = hosts[(sid + 1) % len(hosts)]
                self._launch(self._new_job(sid, 0, part, twin_host,
                                           dup=True))
        return self._supervise_and_merge(keep)

    def resume(self) -> Path:
        """Resume a killed supervisor from its journal: re-dispatch only
        the candidates no on-disk checkpoint completes, then merge every
        artifact (old attempts included)."""
        state = read_state(self.state_path)
        if state["plan"] is None:
            return self.run()
        if state["plan"]["fingerprint"] != self.fingerprint:
            raise SupervisorError(
                "journal belongs to a different sweep: fingerprint "
                f"{state['plan']['fingerprint']!r} != {self.fingerprint!r}")
        if not self._spec_path.exists():
            self._spec_path.write_text(self.spec.to_json() + "\n")
        self._prebuild()
        keep = list(state["plan"]["keep"])
        done: set = set()
        old_ckpts: List[Path] = []
        for c in state["checkpoints"]:
            p = Path(c)
            old_ckpts.append(p)
            if p.exists():
                rem = set(remaining_candidate_indices(
                    self._candidates, self._workloads, self._cfg, p,
                    use_sa=self.spec.use_sa, indices=keep))
                done |= set(keep) - rem
        remaining = [ci for ci in keep if ci not in done]
        self._next_shard = max(
            [self.spec.n_shards] + [e["shard"] + 1 for e in state["events"]
                                    if e["ev"] == "launch"])
        self._event("resume", remaining=remaining,
                    prior_checkpoints=[str(p) for p in old_ckpts])
        self._prior_ckpts = old_ckpts
        if remaining:
            live = self._live_hosts()
            for part, host in zip(self._partition(remaining, len(live)),
                                  live):
                job = self._new_job(self._next_shard, 0, part, host)
                self._next_shard += 1
                self._launch(job)
        return self._supervise_and_merge(keep)

    def _supervise_and_merge(self, keep: List[int]) -> Path:
        while self._poll_once():
            time.sleep(self.poll_s)
        # merge EVERY artifact ever written (prior runs, dead shards'
        # partials, duplicate twins): records are seed-gated so overlap
        # is harmless, and partial files may hold work nothing else has
        ckpts = list(getattr(self, "_prior_ckpts", []))
        for job in self._jobs:
            if job.checkpoint not in ckpts:
                ckpts.append(job.checkpoint)
        ckpts = [p for p in ckpts if Path(p).exists()]
        if not ckpts:
            raise SupervisorError("nothing to merge: no shard checkpoint "
                                  "was ever written")
        report = merge_checkpoints(ckpts, out=self.merged_path,
                                   expect_fingerprint=self.fingerprint,
                                   verbose=False, on_conflict="error")
        left = remaining_candidate_indices(
            self._candidates, self._workloads, self._cfg, self.merged_path,
            use_sa=self.spec.use_sa, indices=keep)
        if left:
            raise SupervisorError(
                f"merged checkpoint incomplete: {len(left)} candidate(s) "
                f"missing ({left[:8]}{'...' if len(left) > 8 else ''})")
        self._event("merged", out=str(self.merged_path),
                    n_records=report.n_records,
                    shards=[str(p) for p in ckpts],
                    skipped=[[str(p), why] for p, why in report.skipped])
        _obs.metrics.write_snapshot()
        _obs.flush()
        return self.merged_path

    # -- results -----------------------------------------------------------
    def results(self) -> List[Any]:
        """The sweep's DSEPoints, reconstructed from the merged
        checkpoint through the engine's own resume path — bit-identical
        to a failure-free unsharded run by the seed-gate contract."""
        return supervised_results(self.spec, self.merged_path)


def supervised_results(spec: SweepSpec,
                       merged: Union[str, Path]) -> List[Any]:
    """Load a supervised sweep's results by resuming the engine from the
    merged checkpoint (every task is recorded, so nothing recomputes)."""
    return run_dse(spec.build_candidates(), spec.build_workloads(),
                   spec.build_cfg(), use_sa=spec.use_sa,
                   screen_keep=spec.screen_keep, checkpoint=merged)


def parse_heartbeats_signature(path: Union[str, Path]
                               ) -> Tuple[int, Optional[str]]:
    """A shard checkpoint's progress signature: (record count, last
    heartbeat JSON).  Any change — new record, new heartbeat — counts as
    liveness; the supervisor timestamps changes on ITS monotonic clock."""
    n, hb = parse_heartbeats(path)
    return n, (json.dumps(hb, sort_keys=True) if hb else None)
