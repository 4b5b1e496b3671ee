"""Unified parallel exploration engine (DSE + SA orchestration layer).

The outer search loops — Table-I architecture enumeration and the per-
candidate SA mapping runs — dominate Gemini's co-exploration wall time, not
the cost model.  This module owns everything *around* a candidate
evaluation:

* **(candidate x workload) task fan-out** — the engine's unit of work is
  one ``(candidate, workload)`` pair, not one candidate.
  :class:`ExplorationEngine` fans tasks out over a ``ProcessPoolExecutor``
  (workload graphs and the ``DSEConfig`` are pickled once per worker via
  the pool initializer); the executor's queue gives natural work stealing,
  so a candidate whose SA finishes early frees its worker for another
  candidate's remaining workloads.  Per-task SA seeds derive
  deterministically from ``(cfg.sa.seed, candidate index, workload
  index)``, so any worker count, any completion order and any sharding
  produce bit-identical ``DSEPoint`` lists.  Per-candidate geometric means
  are reduced in the parent (:func:`repro_torch.core.dse.reduce_tasks`).
* **Sharded sweeps** — ``run(..., shard=(i, n))`` evaluates only the
  candidates with ``index % n == i`` (after the screening stage, which is
  deterministic and therefore replicated per shard), each shard writing an
  independent checkpoint; :func:`merge_checkpoints` reconstructs the full
  sweep from the shard artifacts (fingerprint-checked, last-wins on
  duplicate keys, corrupt shards set aside).  This is what lets a sweep
  span CI matrix jobs or multiple hosts.
* **Two-stage screening** — a cheap T-Map pass (``tangram_map``, no SA)
  scores every candidate; only the top ``screen_keep`` fraction proceeds
  to full SA.  ``screen_keep=1.0`` (default) reproduces the exhaustive
  behavior exactly; the pruned count is logged.
* **Replica-exchange SA** — :func:`replica_exchange_sa` runs
  ``cfg.n_chains`` chains on a geometric temperature ladder with periodic
  Metropolis swaps of adjacent chains' states, all sharing one
  content-addressed evaluator cache.  ``sa_optimize`` dispatches here for
  ``n_chains > 1`` (and bumps the degenerate ``n_chains=2`` to 3).
* **Sweep artifacts** — :class:`ResumableSweep` (append-only JSON-lines
  checkpoint, schema v2: one record per task, with transparent migration
  of schema-v1 per-candidate records), an opt-in LMS mapping
  (de)serializer (:func:`mapping_to_jsonable`) so ``keep_mappings``
  sweeps survive resume/merge, and :func:`pareto_frontier` over
  (MC, E, D).

Copy of ``src/repro/core/explore.py``.  A checkpoint either package writes
is byte-for-byte what the other writes for the same sweep, and each
resumes and merges the other's.  The reference's spans, counters,
manifests and worker telemetry go through the port's
:mod:`repro_torch.obs` under the reference's names, and the engine's
diagnostics are its ``vlog`` lines with the reference's tags and text
(``[explore]``, ``[screen]``, ``[sweep]``, ``[merge]``).
``objective="slo"`` scores through ``repro_torch.serve.slo`` and stamps
the reference's ``obj=slo(<traffic fingerprint>):`` header segment.
"""

from __future__ import annotations

import hashlib
import json
import math
import os as _os
import time as _time
from collections import OrderedDict
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from dataclasses import dataclass, field
from pathlib import Path
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from .. import obs as _obs
from .encoding import LMS, MS
from .evaluator import (CachedEvaluator, Evaluator, analysis_signature,
                        evaluator_for)
from .graph_partition import partition_graph
from .hw import TECH_12NM, ArchConfig
from .sa import (Mapping, SAChain, SAConfig, SAResult,
                 check_backend, group_draw_cdf, step_chains_lockstep)
from .tangram import tangram_map
from .workload import Graph, LayerGroup

# resolved lazily through the module so tests can monkeypatch
# dse.evaluate_task and observe the engine's serial path
from . import dse as _dse


# ---------------------------------------------------------------------------
# Deterministic per-candidate / per-task seeds
# ---------------------------------------------------------------------------

def derive_seed(base_seed: int, index: int) -> int:
    """Deterministic per-candidate SA seed from ``(base seed, index)``.

    Routed through ``np.random.SeedSequence`` so neighbouring indices give
    statistically independent streams (``base_seed + index`` would make
    candidate ``i``'s chain 1 collide with candidate ``i+1``'s chain 0).
    Independent of worker count / scheduling by construction.
    """
    ss = np.random.SeedSequence([abs(int(base_seed)), int(index)])
    return int(ss.generate_state(1, np.uint32)[0])


def derive_task_seed(base_seed: int, cand_idx: int, wl_idx: int) -> int:
    """Per-(candidate, workload) task seed — the engine's unit of work.

    Workload index 0 reduces to :func:`derive_seed`, so single-workload
    sweeps (and workload 0 of multi-workload sweeps) keep the exact seeds
    of the per-candidate schema — which is what makes schema-v1 checkpoint
    records reusable after migration.  Later workloads append their index
    to the ``SeedSequence`` entropy key, giving every task an independent
    stream regardless of worker count, sharding or completion order.
    """
    if wl_idx == 0:
        return derive_seed(base_seed, cand_idx)
    ss = np.random.SeedSequence(
        [abs(int(base_seed)), int(cand_idx), int(wl_idx)])
    return int(ss.generate_state(1, np.uint32)[0])


def parse_shard_spec(spec: str) -> Tuple[int, int]:
    """Parse an ``"i/n"`` shard argument into a validated ``(i, n)``."""
    try:
        i_s, n_s = spec.split("/")
        i, n = int(i_s), int(n_s)
    except ValueError:
        raise ValueError(f"shard spec {spec!r} is not of the form i/n")
    if n < 1 or not 0 <= i < n:
        raise ValueError(f"shard spec {spec!r} needs 0 <= i < n")
    return i, n


# ---------------------------------------------------------------------------
# Replica-exchange SA (parallel tempering)
# ---------------------------------------------------------------------------

def replica_exchange_sa(g: Graph, arch: ArchConfig,
                        groups: Sequence[LayerGroup], total_batch: int,
                        cfg: SAConfig, init: Optional[Mapping] = None,
                        evaluator: Optional[Evaluator] = None) -> SAResult:
    """Parallel tempering over ``cfg.n_chains`` chains (paper Sec. V-B1 SA,
    upgraded from independent restarts).

    Chain 0 is an **unswapped reference chain**: same seed and cooling
    schedule as the single-chain engine and excluded from state exchanges,
    so its trajectory — and therefore its best — is bit-identical to
    ``n_chains=1``.  The returned global best can consequently never be
    worse than the single-chain result on the same seed (elitism), which
    turns the satellite invariant into a structural guarantee rather than
    a per-seed accident.

    Chains ``1..N-1`` form the tempering ladder: chain ``k`` anneals at
    ``t_ladder**(k-1)`` times the base temperature, and every
    ``swap_every`` iterations adjacent ladder chains attempt a Metropolis
    state swap ``P = min(1, exp((1/T_a - 1/T_b) * (cost_a - cost_b)))``,
    so good configurations found by hot (exploratory) chains percolate
    down while locally-refined cold states heat up to escape minima.  All
    chains share one content-addressed evaluator cache, so a state
    re-visited by any chain is never re-analyzed.  Chain ``k`` is seeded
    ``cfg.seed + k``; the best mapping over all chains is re-evaluated
    exactly.

    With ``cfg.lockstep`` (the default) the chains advance through
    :func:`repro_torch.core.sa.step_chains_lockstep`: each iteration draws
    every chain's proposal, batch-evaluates them in one pass on
    ``cfg.backend``, then runs the acceptances in chain order.  Per-chain
    RNG streams are consumed in the serial order and evaluation consumes
    none, so on the exact engine the trajectories are those of the serial
    loop wherever the batched scores equal the scalar ones (the batched
    numpy path, like the reference's, can be an ulp off the scalar path on
    Python 3.12).

    Note ``n_chains=2`` has a one-chain ladder and therefore no swaps —
    it degenerates to two independent seeds plus elitism (the pre-refactor
    restart behavior).  Tempering proper needs ``n_chains >= 3``;
    ``sa_optimize`` warns and substitutes 3 when handed 2.
    """
    check_backend(cfg.backend)
    ev = evaluator or CachedEvaluator(arch, g)
    cum_w = group_draw_cdf(groups, arch.n_cores)
    chains = [SAChain(g, arch, groups, total_batch, cfg, init, ev,
                      seed=cfg.seed + k, cum_w=cum_w,
                      t_scale=1.0 if k == 0 else cfg.t_ladder ** (k - 1))
              for k in range(cfg.n_chains)]
    ladder = chains[1:]
    swap_rng = np.random.default_rng(
        np.random.SeedSequence([abs(int(cfg.seed)), 0x52455853]))  # "REXS"
    swap_every = max(1, cfg.swap_every)
    history: List[float] = []
    n_pairs = max(0, len(ladder) - 1)
    swap_attempts = [0] * n_pairs
    swap_accepts = [0] * n_pairs
    for it in range(cfg.iters):
        if cfg.lockstep:
            step_chains_lockstep(chains, backend=cfg.backend)
        else:
            for chain in chains:
                chain.step()
        if (it + 1) % swap_every == 0:
            for k in range(n_pairs):
                cold, hot = ladder[k], ladder[k + 1]
                t_cold = max(cold.T, 1e-30)
                t_hot = max(hot.T, 1e-30)
                delta = (1.0 / t_cold - 1.0 / t_hot) * (cold.cost - hot.cost)
                swap_attempts[k] += 1
                if delta >= 0 or swap_rng.random() < math.exp(max(delta, -700.0)):
                    swap_accepts[k] += 1
                    cold.exchange_state(hot)
        if cfg.log_every and it % cfg.log_every == 0:
            history.append(chains[0].cost)      # reference-chain trace
    # pick the winner by *exact* re-evaluated cost (incremental best_cost
    # carries float accumulation error); ties prefer the reference chain,
    # keeping the never-worse-than-single-chain guarantee airtight
    finals = [c.finalize([]) for c in chains]
    res = min(finals, key=lambda r: r.cost)
    res.history = history
    res.accepted = sum(c.accepted for c in chains)
    res.proposed = sum(c.proposed for c in chains)
    res.swap_attempts = swap_attempts
    res.swap_accepts = swap_accepts
    if _obs.enabled():
        # once per SA run, strictly after the result is fixed: the obs
        # layer observes counters the chains already kept, it never adds
        # RNG draws or float ops to the trajectory (bit-identity contract)
        m = _obs.metrics
        m.counter("sa.runs").inc()
        m.counter("sa.proposed").inc(res.proposed)
        m.counter("sa.accepted").inc(res.accepted)
        m.counter("sa.swap_attempts").inc(sum(swap_attempts))
        m.counter("sa.swap_accepts").inc(sum(swap_accepts))
        for c in chains:
            if c.proposed:
                m.histogram("sa.acceptance_rate").observe(
                    c.accepted / c.proposed)
        for a, s in zip(swap_attempts, swap_accepts):
            if a:
                m.histogram("sa.swap_rate").observe(s / a)
    return res


# ---------------------------------------------------------------------------
# ArchConfig <-> JSON (checkpoint records)
# ---------------------------------------------------------------------------

_TECHS = {TECH_12NM.name: TECH_12NM}

_ARCH_FIELDS = ("x_cores", "y_cores", "xcut", "ycut", "noc_bw", "d2d_bw",
                "dram_bw", "glb_kb", "macs_per_core", "freq_ghz", "n_dram")


def register_tech(tech) -> None:
    """Make a non-default :class:`Tech` (a calibrated one, say) resolvable
    from checkpoint records, which name their tech only; an unknown name
    is refused rather than silently given the wrong constants."""
    _TECHS[tech.name] = tech


def arch_to_dict(arch: ArchConfig) -> Dict[str, Any]:
    d = {f: getattr(arch, f) for f in _ARCH_FIELDS}
    d["tech"] = arch.tech.name
    return d


def arch_from_dict(d: Dict[str, Any]) -> ArchConfig:
    kw = {f: d[f] for f in _ARCH_FIELDS}
    tech_name = d.get("tech", "")
    tech = _TECHS.get(tech_name)
    if tech is None:
        raise ValueError(
            f"unknown tech {tech_name!r} in checkpoint record; the port "
            f"knows {sorted(_TECHS)} (register_tech() adds one)")
    return ArchConfig(**kw, tech=tech)


def graph_fingerprint(g: Graph) -> str:
    """Stable content digest of a workload DAG (layers, edges, inputs).

    ``Layer`` is a frozen dataclass, so its ``repr`` enumerates every
    field; two graphs with equal structure hash equally regardless of
    insertion order.  Expected-traffic scales and edge multiplicities are
    ``repr=False`` (they would otherwise churn every dense fingerprint),
    so they hash explicitly here — but only when non-default, keeping
    dense graphs' digests byte-identical to pre-scale checkpoints.  The
    digest is the reference's, so a port-built graph matches a checkpoint
    header the JAX package wrote.
    """
    h = hashlib.sha1()
    for name in sorted(g.layers):
        lyr = g.layers[name]
        h.update(repr((name, lyr)).encode())
        if lyr.traffic_scale != 1.0 or lyr.weight_traffic_scale != 1.0:
            h.update(repr((name, "scale", lyr.traffic_scale,
                           lyr.weight_traffic_scale)).encode())
    h.update(repr(sorted(g.edges)).encode())
    if g.edge_mults:
        h.update(repr(("mults", sorted(g.edge_mults.items()))).encode())
    h.update(repr(sorted(g.input_layers)).encode())
    return h.hexdigest()[:12]


def candidate_key(arch: ArchConfig) -> str:
    """Stable content identity of a candidate (checkpoint skip key)."""
    d = arch_to_dict(arch)
    return "/".join(f"{f}={d[f]:g}" if isinstance(d[f], float) else
                    f"{f}={d[f]}" for f in (*_ARCH_FIELDS, "tech"))


def task_checkpoint_key(arch: ArchConfig, workload: str) -> str:
    """Checkpoint key of one (candidate, workload) task (schema v2)."""
    return f"{candidate_key(arch)}|wl={workload}"


# ---------------------------------------------------------------------------
# LMS mapping <-> JSON (opt-in; checkpointed when cfg.keep_mappings)
# ---------------------------------------------------------------------------

def mapping_to_jsonable(mapping: Mapping) -> List[Dict[str, Any]]:
    """Serialize a full LP-SPM mapping (list of (LayerGroup, LMS)) to plain
    JSON types.  Inverse of :func:`mapping_from_jsonable`; round-trips
    exactly (all fields are ints/strings)."""
    out: List[Dict[str, Any]] = []
    for grp, lms in mapping:
        out.append({
            "group": {"names": list(grp.names),
                      "batch_unit": int(grp.batch_unit)},
            "lms": {name: {"part": list(ms.part), "cg": list(ms.cg),
                           "fd": list(ms.fd)}
                    for name, ms in lms.ms.items()}})
    return out


def mapping_from_jsonable(data: Sequence[Dict[str, Any]]) -> Mapping:
    """Rebuild a mapping from :func:`mapping_to_jsonable` output.

    ``MS.__post_init__`` re-validates the structural invariants (Part
    product == |CG|, no duplicate cores), so a hand-edited or damaged
    record raises instead of producing a silently-wrong mapping.
    """
    mapping: Mapping = []
    for entry in data:
        grp = LayerGroup(names=tuple(entry["group"]["names"]),
                         batch_unit=int(entry["group"]["batch_unit"]))
        ms = {name: MS(part=tuple(int(v) for v in m["part"]),
                       cg=tuple(int(v) for v in m["cg"]),
                       fd=tuple(int(v) for v in m["fd"]))
              for name, m in entry["lms"].items()}
        mapping.append((grp, LMS(ms=ms)))
    return mapping


def task_to_dict(tr: "_dse.TaskResult", arch: ArchConfig, workload: str,
                 seed: int, keep_mapping: bool) -> Dict[str, Any]:
    """Schema-v2 checkpoint record of one completed task."""
    d: Dict[str, Any] = {"seed": seed, "workload": workload,
                         "arch": arch_to_dict(arch),
                         "energy_j": tr.energy_j, "delay_s": tr.delay_s}
    if keep_mapping and tr.mapping is not None:
        d["mapping"] = mapping_to_jsonable(tr.mapping)
    return d


def task_from_dict(d: Dict[str, Any]) -> "_dse.TaskResult":
    mapping = (mapping_from_jsonable(d["mapping"])
               if "mapping" in d else None)
    return _dse.TaskResult(energy_j=float(d["energy_j"]),
                           delay_s=float(d["delay_s"]), mapping=mapping)


def migrate_v1_record(key: str, rec: Dict[str, Any]
                      ) -> List[Tuple[str, Dict[str, Any]]]:
    """Split a schema-v1 per-candidate record into schema-v2 task records.

    v1 stored one record per candidate (keyed ``candidate_key``) with a
    ``per_workload`` map and a single shared SA seed.  Each workload's
    (E, D) becomes its own task record carrying that seed; on resume the
    engine reuses a record only when its seed matches the v2 task seed —
    true for workload 0 by construction (see :func:`derive_task_seed`),
    so single-workload v1 sweeps resume in full, while extra workloads of
    multi-workload sweeps recompute under their now-independent seeds.
    Mappings were never serialized in v1, so migrated records are
    metrics-only.
    """
    out: List[Tuple[str, Dict[str, Any]]] = []
    per = rec.get("per_workload") or {}
    for name in sorted(per):
        ed = per[name]
        # v1 ran every workload under the one candidate seed, so that seed
        # is the true provenance of each split record; the resume-time seed
        # gate then reuses a record exactly when v2 derives the same seed
        out.append((f"{key}|wl={name}",
                    {"seed": rec.get("seed"),
                     "workload": name, "arch": rec.get("arch"),
                     "energy_j": ed[0], "delay_s": ed[1]}))
    return out


# ---------------------------------------------------------------------------
# Resumable sweeps (JSON-lines checkpoint)
# ---------------------------------------------------------------------------

# checkpoint durability switch: records fsync on append and every atomic
# rewrite fsyncs before rename (crash between write and rename can
# otherwise lose the repair).  On by default; REPRO_CKPT_FSYNC=0 opts
# hot single-host sweeps out of the per-record fsync cost.
def _fsync_enabled() -> bool:
    return _os.environ.get("REPRO_CKPT_FSYNC", "1").lower() not in (
        "0", "false", "off", "no")


def _fsync_file(f) -> None:
    if not _fsync_enabled():
        return
    try:
        _os.fsync(f.fileno())
    except OSError:
        pass


def _replace_durable(dst: Path, text: str) -> None:
    """Atomic replace that survives a crash at any point: write to a
    sibling temp file, fsync it, rename over ``dst``, fsync the
    directory (the rename itself must be on disk before we report the
    repair/merge done)."""
    tmp = dst.with_name(dst.name + ".tmp")
    with tmp.open("w") as f:
        f.write(text)
        f.flush()
        _fsync_file(f)
    tmp.replace(dst)
    if _fsync_enabled():
        try:
            dfd = _os.open(str(dst.parent), _os.O_RDONLY)
            try:
                _os.fsync(dfd)
            finally:
                _os.close(dfd)
        except OSError:
            pass


def _hb_collision(lines: List[str], i: int) -> bool:
    """Is corrupt line ``i`` attributable to a concurrent heartbeat
    writer?

    Task records have exactly one sanctioned class of concurrent
    appender: heartbeat lines (a supervisor-era shard child heartbeats
    the same file its task loop appends to, and a duplicate dispatch may
    briefly share a file).  A torn line that carries an ``"_hb"`` marker
    itself, or sits adjacent to a line that parses as a pure heartbeat,
    is that collision: the damaged record halves are dropped (the
    per-task seed gate recomputes them on resume) instead of poisoning
    the whole checkpoint.
    """
    if '"_hb"' in lines[i]:
        return True
    for j in (i - 1, i + 1):
        if 0 <= j < len(lines) and lines[j].strip():
            try:
                rec = json.loads(lines[j])
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "_hb" in rec:
                return True
    return False


class ResumableSweep:
    """Append-only JSON-lines checkpoint for long sweeps.

    One ``{"_key": ..., **record}`` object per line; an optional first line
    ``{"_config": fingerprint}`` guards against resuming under a changed
    configuration (mismatch discards the stale file).  A truncated trailing
    line (process killed mid-write) is tolerated and dropped.  Duplicate
    keys are last-wins, so a forced re-run simply appends an overriding
    record.  ``legacy`` maps superseded fingerprints to record-migration
    functions ``(key, rec) -> [(new_key, new_rec), ...]``: a file written
    under an old schema is converted in memory and rewritten atomically
    under the current fingerprint instead of being discarded.  Used by
    ``run_dse(..., checkpoint=...)`` and by the realization CLI
    (``launch/realize.py``).
    """

    def __init__(self, path: Union[str, Path],
                 config_fingerprint: Optional[str] = None,
                 resume: bool = True,
                 legacy: Optional[Dict[str, Callable[
                     [str, Dict[str, Any]],
                     Iterable[Tuple[str, Dict[str, Any]]]]]] = None):
        self.path = Path(path)
        self.fingerprint = config_fingerprint
        self._legacy = legacy or {}
        self._records: Dict[str, Dict[str, Any]] = {}
        fresh = True
        if self.path.exists():
            if resume:
                fresh = not self._load(readonly=False)
            if fresh:
                self._set_aside()
        if fresh:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            header = (json.dumps({"_config": self.fingerprint}) + "\n"
                      if self.fingerprint is not None else "")
            self.path.write_text(header)

    def _set_aside(self) -> None:
        """Move a rejected file (corrupt line / changed config /
        ``resume=False``) to a fresh ``.bakN`` name — recorded data is
        never destroyed, and existing backups are never clobbered."""
        n = 0
        while True:
            suffix = ".bak" if n == 0 else f".bak{n}"
            bak = self.path.with_name(self.path.name + suffix)
            if not bak.exists():
                break
            n += 1
        self.path.replace(bak)
        _obs.vlog("sweep", f"previous file kept at {bak}")

    @classmethod
    def read(cls, path: Union[str, Path]) -> "ResumableSweep":
        """Read-only parse: never creates, repairs or resets the file.

        For consumers that only read recorded sweeps (``realize/plan.py``);
        a corrupt or config-mismatched file yields whatever records parse
        instead of triggering the constructor's set-aside logic.
        """
        inst = cls.__new__(cls)
        inst.path = Path(path)
        inst.fingerprint = None
        inst._legacy = {}
        inst._records = {}
        if inst.path.exists():
            inst._load(readonly=True)
        return inst

    def _load(self, readonly: bool) -> bool:
        """Parse the existing file; False if it must be discarded."""
        text = self.path.read_text()
        lines = text.splitlines()
        valid: List[str] = []
        saw_header = False
        migrate = None
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    continue                  # truncated final line: drop it
                if _hb_collision(lines, i):
                    # torn by a concurrent heartbeat writer: drop just the
                    # damaged line(s); the repair rewrite below heals the
                    # file and the seed gate recomputes the lost record
                    _obs.vlog("sweep", f"{self.path}: line {i + 1} torn by "
                              "a concurrent heartbeat writer; dropped")
                    continue
                _obs.vlog("sweep", f"{self.path}: corrupt line {i + 1}; "
                          "discarding checkpoint")
                if readonly:
                    continue                  # salvage what parses
                self._records.clear()        # discard means ALL records
                return False
            if "_config" in rec:
                if self.fingerprint is not None \
                        and rec["_config"] != self.fingerprint:
                    if rec["_config"] in self._legacy:
                        # superseded schema: convert records, rewrite below
                        migrate = self._legacy[rec["_config"]]
                        saw_header = True
                        continue
                    _obs.vlog("sweep", f"{self.path}: config changed; "
                              "discarding checkpoint")
                    return False
                saw_header = True
                valid.append(line)
                continue
            valid.append(line)
            key = rec.pop("_key", None)
            if key is not None:
                self._records[key] = rec
        if not readonly and self.fingerprint is not None and not saw_header \
                and self._records:
            # a fingerprinted sweep whose header is gone (e.g. killed while
            # writing it) can no longer prove the records match this config
            _obs.vlog("sweep", f"{self.path}: missing config header; "
                      "discarding checkpoint")
            self._records.clear()
            return False
        if migrate is not None and not readonly:
            old = self._records
            self._records = {}
            for key, rec in old.items():
                for k2, r2 in migrate(key, rec):
                    self._records[k2] = r2
            _obs.vlog("sweep", f"{self.path}: migrated {len(old)} legacy "
                      f"records -> {len(self._records)} under the current "
                      "schema")
            self._rewrite()
            return True
        # a killed-mid-write trailing fragment (or missing final newline)
        # would merge with the next append — repair the file first;
        # atomically (temp + fsync + replace), so a crash at any point
        # mid-repair cannot lose the already-recorded lines
        repaired = "".join(v + "\n" for v in valid)
        if not readonly and repaired != text:
            _replace_durable(self.path, repaired)
        return True

    def _rewrite(self) -> None:
        """Atomically replace the file with the in-memory records."""
        header = (json.dumps({"_config": self.fingerprint}) + "\n"
                  if self.fingerprint is not None else "")
        body = "".join(json.dumps({"_key": k, **r}, default=float) + "\n"
                       for k, r in self._records.items())
        _replace_durable(self.path, header + body)

    def __contains__(self, key: str) -> bool:
        return key in self._records

    def __len__(self) -> int:
        return len(self._records)

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        return self._records.get(key)

    def add(self, key: str, record: Dict[str, Any]) -> None:
        self._records[key] = record
        with self.path.open("a") as f:
            f.write(json.dumps({"_key": key, **record}, default=float) + "\n")
            f.flush()
            # records are the durable artifact: fsync before returning, so
            # a host losing power right after a task completes never loses
            # work the supervisor believes is checkpointed
            _fsync_file(f)

    def heartbeat(self, payload: Dict[str, Any]) -> None:
        """Append a ``{"_hb": ...}`` liveness line (shard id, tasks
        done/total, wall time — see ``ExplorationEngine``).

        Heartbeats are *not* records: they carry no ``_key``, so
        :meth:`_load`, :meth:`read` and :func:`merge_checkpoints` all skip
        them (and any rewrite/merge drops them), while a multi-host supervisor
        polling the file tail can tell a slow shard from a dead one.
        Heartbeats flush but do not fsync — losing one to a crash only
        ages the liveness view, never data.
        """
        with self.path.open("a") as f:
            f.write(json.dumps({"_hb": payload}, default=float) + "\n")
            f.flush()

    def as_dict(self) -> Dict[str, Dict[str, Any]]:
        return dict(self._records)


# ---------------------------------------------------------------------------
# Shard merging
# ---------------------------------------------------------------------------

@dataclass
class MergeReport:
    """Outcome of :func:`merge_checkpoints`."""
    fingerprint: Optional[str]
    records: Dict[str, Dict[str, Any]]
    merged: List[Path]                    # shards that contributed
    skipped: List[Tuple[Path, str]]       # (path, reason) set aside
    out: Optional[Path] = None
    # task keys where two shards recorded *different* results — the
    # symptom of a fingerprint or seed-gate bug (duplicate dispatch of a
    # deterministic task must reproduce the identical record); last-wins
    # still applies, but silently so no longer
    conflicts: List[str] = field(default_factory=list)

    @property
    def n_records(self) -> int:
        return len(self.records)


def _parse_checkpoint_shard(path: Path
                            ) -> Tuple[Optional[str], Dict[str, Dict]]:
    """Strict parse of one shard file: (fingerprint, ordered records).

    A truncated *final* line (shard killed mid-write) is tolerated and
    dropped, exactly as on resume; any other parse failure marks the whole
    shard corrupt — a mid-file hole means unknown records were lost, and a
    partial merge would silently present itself as complete.
    """
    text = path.read_text()
    lines = text.splitlines()
    fingerprint: Optional[str] = None
    records: Dict[str, Dict] = {}
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                continue                      # killed mid-write: drop it
            if _hb_collision(lines, i):
                continue        # torn by a concurrent heartbeat writer
            raise ValueError(f"corrupt line {i + 1}")
        if "_config" in rec:
            if fingerprint is not None and rec["_config"] != fingerprint:
                raise ValueError("conflicting _config headers")
            fingerprint = rec["_config"]
            continue
        key = rec.pop("_key", None)
        if key is not None:
            records[key] = rec                # in-file duplicates: last wins
    return fingerprint, records


def _records_conflict(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    """Do two same-key records *disagree*?

    A metrics-only record and its ``keep_mappings`` upgrade (identical
    metrics, one extra ``mapping`` field) are the one sanctioned way
    records legitimately differ, so mappings compare only when both
    records carry one; every other field difference is a conflict.
    """
    ka, kb = set(a) - {"mapping"}, set(b) - {"mapping"}
    if ka != kb or any(a[k] != b[k] for k in ka):
        return True
    return ("mapping" in a and "mapping" in b
            and a["mapping"] != b["mapping"])


def merge_checkpoints(shards: Sequence[Union[str, Path]],
                      out: Union[str, Path, None] = None,
                      expect_fingerprint: Optional[str] = None,
                      verbose: bool = True,
                      on_conflict: str = "report") -> MergeReport:
    """Merge per-shard :class:`ResumableSweep` checkpoints into one.

    * every usable shard must carry the **same** config fingerprint (and
      match ``expect_fingerprint`` when given) — a mismatch refuses the
      whole merge rather than mixing incompatible sweeps;
    * duplicate keys are **last-wins** in ``shards`` order (within a
      shard, in line order), mirroring the sweep's own append semantics —
      overlapping shard ranges are therefore safe; but two shards
      recording *different* results for the same task key is the symptom
      of a fingerprint or seed-gate bug (the supervisor's duplicate
      dispatch can trigger it), so such keys are collected in
      ``MergeReport.conflicts`` and reported (``on_conflict="report"``,
      the default) or refused (``on_conflict="error"`` — what the
      supervisor passes: a conflicted merge can never be bit-identical
      to the clean run);
    * a corrupt or unreadable shard is **set aside** (skipped, reported in
      ``MergeReport.skipped``) instead of poisoning the others; source
      files are never modified.

    With ``out`` set, the merged checkpoint is written atomically (with a
    ``_merged_from`` provenance line) and is directly resumable:
    ``run_dse(candidates, ..., checkpoint=out)`` reconstructs the full
    sweep, recomputing only tasks no shard covered.
    """
    if on_conflict not in ("report", "error"):
        raise ValueError(
            f"on_conflict must be 'report' or 'error', got {on_conflict!r}")
    parsed: List[Tuple[Path, Optional[str], Dict[str, Dict]]] = []
    skipped: List[Tuple[Path, str]] = []
    for p in (Path(s) for s in shards):
        try:
            fp, recs = _parse_checkpoint_shard(p)
        except (ValueError, OSError) as e:
            if verbose:
                _obs.vlog("merge", f"{p}: {e}; shard set aside")
            skipped.append((p, str(e)))
            continue
        parsed.append((p, fp, recs))
    if not parsed:
        raise ValueError(
            f"merge_checkpoints: no usable shards among {list(shards)}")
    fps = {fp for _, fp, _ in parsed}
    if expect_fingerprint is not None and fps != {expect_fingerprint}:
        raise ValueError(
            f"merge_checkpoints: shard fingerprints {sorted(map(repr, fps))} "
            f"!= expected {expect_fingerprint!r}")
    if len(fps) > 1:
        raise ValueError(
            "merge_checkpoints: refusing to merge shards with mismatched "
            f"fingerprints: {sorted(map(repr, fps))}")
    fingerprint = next(iter(fps))
    records: Dict[str, Dict] = {}
    conflicts: List[str] = []
    for _p, _fp, recs in parsed:
        for k, r in recs.items():             # later shards win duplicates
            prev = records.get(k)
            if prev is not None and _records_conflict(prev, r):
                conflicts.append(k)
            records[k] = r
    conflicts = sorted(set(conflicts))
    if conflicts:
        sample = ", ".join(conflicts[:3])
        msg = (f"{len(conflicts)} task key(s) have conflicting records "
               f"across shards (e.g. {sample}) — a fingerprint or "
               f"seed-gate bug; duplicate dispatch of a deterministic "
               f"task must reproduce identical records")
        if on_conflict == "error":
            raise ValueError(f"merge_checkpoints: {msg}")
        _obs.vlog("merge", f"WARNING: {msg}", n_conflicts=len(conflicts))
        _obs.metrics.counter("merge.conflicts").inc(len(conflicts))
    report = MergeReport(fingerprint=fingerprint, records=records,
                         merged=[p for p, _, _ in parsed], skipped=skipped,
                         conflicts=conflicts)
    if out is not None:
        out = Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        header = (json.dumps({"_config": fingerprint}) + "\n"
                  if fingerprint is not None else "")
        prov = json.dumps(
            {"_merged_from": [p.name for p in report.merged]}) + "\n"
        body = "".join(json.dumps({"_key": k, **r}, default=float) + "\n"
                       for k, r in records.items())
        _replace_durable(out, header + prov + body)
        report.out = out
    if verbose:
        note = f" ({len(skipped)} shard(s) set aside)" if skipped else ""
        _obs.vlog(
            "merge",
            f"{len(records)} records from {len(report.merged)} "
            f"shard(s){' -> ' + str(out) if out is not None else ''}{note}",
            n_records=len(records), n_shards=len(report.merged),
            n_skipped=len(skipped))
    return report


# ---------------------------------------------------------------------------
# Supervisor-facing sweep introspection (multi-host re-sharding)
# ---------------------------------------------------------------------------

def sweep_fingerprint(workloads: Dict[str, Graph], cfg: "_dse.DSEConfig",
                      use_sa: bool = True) -> str:
    """The checkpoint fingerprint a sweep of ``(workloads, cfg)`` stamps.

    Public wrapper over the engine's internal fingerprint so the
    multi-host supervisor can assert every shard
    artifact — and the final merge — against the one expected header
    without running anything.
    """
    with ExplorationEngine(workloads, cfg) as eng:
        return eng._fingerprint(use_sa)


def remaining_candidate_indices(candidates: Sequence[ArchConfig],
                                workloads: Dict[str, Graph],
                                cfg: "_dse.DSEConfig",
                                checkpoint: Union[str, Path],
                                use_sa: bool = True,
                                indices: Optional[Iterable[int]] = None,
                                ) -> List[int]:
    """Candidate indices whose (candidate x workload) tasks are NOT all
    resumable from ``checkpoint`` — the re-shard unit of the multi-host
    supervisor.

    Mirrors the engine's resume gate exactly: a task counts as done only
    when its record exists under the sweep's fingerprint, carries the
    seed this sweep would derive (``use_sa`` sweeps), and has a mapping
    when ``cfg.keep_mappings`` asks for one.  The checkpoint is parsed
    tolerantly (a dead shard's torn tail or heartbeat-collision damage
    just leaves those tasks "remaining"), and a missing / foreign-
    fingerprint file leaves *everything* remaining — re-sharding is
    always safe because reassigned tasks recompute bit-identically.
    """
    wl_names = sorted(workloads)
    fingerprint = sweep_fingerprint(workloads, cfg, use_sa)
    want = sorted(set(int(i) for i in indices)) if indices is not None \
        else list(range(len(candidates)))
    for i in want:
        if not 0 <= i < len(candidates):
            raise ValueError(f"candidate index {i} outside the grid "
                             f"(0..{len(candidates) - 1})")
    path = Path(checkpoint)
    records: Dict[str, Dict[str, Any]] = {}
    if path.exists():
        try:
            fp, records = _parse_checkpoint_shard(path)
        except (ValueError, OSError):
            # strict parse refused the file (mid-file hole): salvage what
            # the tolerant reader can — lost records simply stay remaining
            fp = None
            sweep = ResumableSweep.read(path)
            records = sweep.as_dict()
            head = path.read_text().splitlines()[:1]
            if head:
                try:
                    fp = json.loads(head[0]).get("_config")
                except (json.JSONDecodeError, AttributeError):
                    fp = None
        if fp != fingerprint:
            records = {}                      # foreign sweep: nothing reusable
    out: List[int] = []
    keep = cfg.keep_mappings
    for ci in want:
        arch = candidates[ci]
        for wi, name in enumerate(wl_names):
            rec = records.get(task_checkpoint_key(arch, name))
            if rec is None \
                    or (use_sa and rec.get("seed")
                        != derive_task_seed(cfg.sa.seed, ci, wi)) \
                    or (keep and "mapping" not in rec):
                out.append(ci)
                break
    return out


# ---------------------------------------------------------------------------
# Pareto frontier over (MC, E, D)
# ---------------------------------------------------------------------------

def _pareto_mask_quadratic(vals: List[Tuple]) -> List[bool]:
    """Reference O(n^2) all-pairs dominance check (kept for arbitrary key
    counts and as the property-test oracle for the sweep below)."""
    out = []
    for i, vi in enumerate(vals):
        out.append(not any(
            all(a <= b for a, b in zip(vj, vi)) and vj != vi
            for j, vj in enumerate(vals) if j != i))
    return out


def _pareto_mask_sweep(vals: List[Tuple]) -> List[bool]:
    """Sort-based sweep for 2-3 keys: O(n log n) instead of all-pairs.

    Points are processed in lexicographic order (any dominator of ``v``
    is lex-<= ``v``; lex-equal vectors never dominate each other, so
    groups of identical vectors are decided together).  A staircase of
    non-dominated ``(y, z)`` pairs — ``y`` strictly ascending, ``z``
    strictly descending — answers "does any earlier point have y' <= y
    and z' <= z" with one bisect; 2-key inputs use a constant third
    coordinate.  Exactly equivalent to the all-pairs rule, including tie
    handling (identical vectors are all kept).
    """
    from bisect import bisect_left, bisect_right
    order = sorted(range(len(vals)), key=lambda i: vals[i])
    keep = [False] * len(vals)
    ys: List = []
    zs: List = []
    i = 0
    while i < len(order):
        j = i
        v = vals[order[i]]
        while j < len(order) and vals[order[j]] == v:
            j += 1
        y, z = (v[1], v[2]) if len(v) == 3 else (v[1], 0)
        pos = bisect_right(ys, y) - 1
        if not (pos >= 0 and zs[pos] <= z):      # not dominated
            for t in range(i, j):
                keep[order[t]] = True
            # insert (y, z); drop staircase entries the new pair dominates
            # (y'' >= y with z'' >= z form a prefix of the tail, since z
            # is descending)
            ip = bisect_left(ys, y)
            q = ip
            while q < len(ys) and zs[q] >= z:
                q += 1
            ys[ip:q] = [y]
            zs[ip:q] = [z]
        i = j
    return keep


def pareto_frontier(points: Sequence["_dse.DSEPoint"],
                    keys: Tuple[str, ...] = ("mc", "energy_j", "delay_s"),
                    ) -> List["_dse.DSEPoint"]:
    """Non-dominated subset under element-wise minimization of ``keys``.

    A point is dominated if some other point is <= on every key and < on at
    least one.  Ties (identical key vectors) are all kept.  Returned sorted
    by scalar objective, best first.  The default 2-3 key case runs a sort
    + staircase sweep (O(n log n)); other key counts fall back to the
    all-pairs scan.
    """
    vals = [tuple(getattr(p, k) for k in keys) for p in points]
    if vals and len(vals[0]) in (2, 3):
        mask = _pareto_mask_sweep(vals)
    else:
        mask = _pareto_mask_quadratic(vals)
    out = [p for p, m in zip(points, mask) if m]
    out.sort(key=lambda p: p.objective)
    return out


# ---------------------------------------------------------------------------
# Worker-process plumbing
# ---------------------------------------------------------------------------

# populated once per worker by the pool initializer; workloads + cfg are
# pickled exactly once per worker instead of once per task
_WORKER_STATE: Dict[str, Any] = {}


def _worker_init(workloads: Dict[str, Graph], cfg: "_dse.DSEConfig",
                 obs_state: Optional[Dict[str, Any]] = None) -> None:
    _WORKER_STATE["workloads"] = workloads
    _WORKER_STATE["cfg"] = cfg
    # spawned workers don't inherit a programmatic obs.enable(); the
    # parent ships its switch + run dir through the initializer so worker
    # trace streams land in the same run directory
    _obs.import_state(obs_state)


def _worker_eval(task: Tuple[int, int, ArchConfig, str, int, bool]
                 ) -> Tuple[int, int, "_dse.TaskResult",
                            Optional[Dict[str, Any]]]:
    ci, wi, arch, wl_name, seed, use_sa = task
    obs_on = _obs.enabled()
    t_start = _time.time() if obs_on else 0.0
    cfg = _WORKER_STATE["cfg"]
    tr = _dse.evaluate_task(arch, _WORKER_STATE["workloads"][wl_name], cfg,
                            use_sa=use_sa, seed=seed)
    if not cfg.keep_mappings:
        tr.mapping = None       # don't pickle mappings nobody asked for
    payload: Optional[Dict[str, Any]] = None
    if obs_on:
        # piggyback this worker's metrics delta on the result: counters +
        # collector harvest since the previous task, plus wall-clock task
        # bounds the parent turns into queue-wait/wall-time telemetry
        _obs.flush()
        payload = {"pid": _os.getpid(), "t_start": t_start,
                   "t_end": _time.time(), "metrics": _obs.metrics.drain()}
    return ci, wi, tr, payload


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

# a task is (cand_idx, wl_idx, arch, workload name, derived seed)
_Task = Tuple[int, int, ArchConfig, str, int]


class ExplorationEngine:
    """Screened, parallel, sharded, resumable (candidate x workload) sweeps.

    One engine instance owns (at most) one worker pool; ``screen()`` and
    ``run()`` share it, so the per-worker import + unpickle cost is paid
    once per sweep.  Use as a context manager (or call :meth:`close`).

    Workloads are indexed in **sorted-name order** for seed derivation and
    reduction, so results never depend on dict insertion order (shards
    built by different callers stay merge-compatible).

    ``mp_context`` defaults to ``"spawn"``: the parent process may hold
    torch and CUDA state (fork-unsafe), and spawned workers import only the
    numpy cost-model stack (``repro_torch.core`` imports no torch).
    """

    def __init__(self, workloads: Dict[str, Graph], cfg: "_dse.DSEConfig",
                 n_workers: int = 1, checkpoint: Union[str, Path, None] = None,
                 progress: bool = False, mp_context: str = "spawn",
                 batched_screen: bool = True,
                 verbosity: Optional[int] = None,
                 hb_every: Optional[float] = None):
        self.workloads = dict(workloads)
        self._wl_names = sorted(self.workloads)
        self.cfg = cfg
        ww = getattr(cfg, "workload_weights", None)
        if ww is not None:
            unknown = sorted(set(ww) - set(self.workloads))
            if unknown:
                raise ValueError(
                    f"workload_weights name(s) {unknown} not in this "
                    f"sweep's workloads {self._wl_names} — a typo here "
                    f"would silently weigh the portfolio uniformly")
        obj = getattr(cfg, "objective", "geomean")
        if obj not in ("geomean", "slo"):
            raise ValueError(
                f"unknown DSE objective {obj!r}: 'geomean' or 'slo'")
        if obj == "slo":
            # resolve eagerly: a typo'd traffic name must fail before the
            # sweep burns hours of SA, not in the final reduction
            from ..serve.slo import resolve_traffic
            if cfg.traffic is None:
                raise ValueError(
                    "objective='slo' needs cfg.traffic (a TrafficModel, "
                    "registered name, or trace spec — see "
                    "repro_torch.serve.slo)")
            resolve_traffic(cfg.traffic)
        self.n_workers = max(1, int(n_workers))
        self.checkpoint = checkpoint
        self.progress = progress
        self.mp_context = mp_context
        # diagnostics verbosity: the kwarg overrides REPRO_VERBOSITY
        # (default 1 — historical output); 0 silences the [stage] lines
        self.verbosity = verbosity
        # batched T-Map screening (bit-identical to the per-candidate
        # loop); False keeps the per-task path for A/B tests + benchmarks
        self.batched_screen = batched_screen
        self._pool: Optional[ProcessPoolExecutor] = None
        # shard-heartbeat period in seconds (liveness lines in the
        # checkpoint; see ResumableSweep.heartbeat).  None reads
        # REPRO_HB_EVERY (default 15s); 0 emits one per completed task.
        if hb_every is None:
            try:
                hb_every = float(_os.environ.get("REPRO_HB_EVERY", "15"))
            except ValueError:
                hb_every = 15.0
        self.hb_every = hb_every
        self._shard_label = "0/1"
        # screening scores of the last run() that screened (sorted best
        # first); lets callers report the screen stage without re-running it
        self.last_screen: Optional[List["_dse.DSEPoint"]] = None

    # -- lifecycle -----------------------------------------------------
    def __enter__(self) -> "ExplorationEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._pool is not None:
            # queued-but-unstarted work is pointless once we're exiting
            # (normally the queue is already drained; after a worker error
            # it isn't, and waiting for it would stall the traceback)
            self._pool.shutdown(cancel_futures=True)
            self._pool = None

    def _get_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            import multiprocessing as mp
            self._pool = ProcessPoolExecutor(
                max_workers=self.n_workers,
                mp_context=mp.get_context(self.mp_context),
                initializer=_worker_init,
                initargs=(self.workloads, self.cfg, _obs.export_state()))
        return self._pool

    def _log(self, tag: str, msg: str, **fields: Any) -> None:
        _obs.vlog(tag, msg, verbosity=self.verbosity, **fields)

    # -- fingerprint for checkpoint compatibility ----------------------
    def _fingerprint(self, use_sa: bool, schema: int = 2,
                     re_knobs: Optional[Tuple[int, float]] = None) -> str:
        c = self.cfg
        # workloads hash by *content*, not name: editing a graph while
        # keeping its dict key must invalidate the checkpoint.
        # keep_mappings is deliberately NOT part of the fingerprint: a
        # metrics-only sweep resumed with keep_mappings=True recomputes
        # just the tasks whose records lack a mapping.
        wl = ",".join(f"{n}:{graph_fingerprint(self.workloads[n])}"
                      for n in self._wl_names)
        swap, ladder = re_knobs or (c.sa.swap_every, c.sa.t_ladder)
        # portfolio weights join the fingerprint ONLY when set: weightless
        # sweeps keep their historical header and stay resumable, while a
        # re-weighted portfolio never silently reuses old records.  Note
        # the segment sits BEFORE :wl= (realize's header parser partitions
        # on ':wl=' and must keep seeing the workload list last).
        w = ""
        if getattr(c, "workload_weights", None) is not None:
            ww = c.workload_weights
            w = "w=" + ",".join(f"{n}:{float(ww.get(n, 1.0)):g}"
                                for n in self._wl_names) + ":"
        # non-default objective modes stamp their own segment (also before
        # :wl=): an SLO-scored sweep under one traffic model never shares
        # artifacts with the raw-delay sweep or a re-trafficked one, while
        # the default mode keeps the historical header byte-identical
        obj = ""
        if getattr(c, "objective", "geomean") != "geomean":
            from ..serve.slo import resolve_traffic
            tfp = (resolve_traffic(c.traffic).fingerprint()
                   if c.traffic is not None else "none")
            obj = f"obj={c.objective}({tfp}):"
        return (f"dse:v{schema}:a{c.alpha:g}:b{c.beta:g}:g{c.gamma:g}:"
                f"B{c.batch}:"
                f"sa({c.sa.iters},{c.sa.t0:g},{c.sa.t_end:g},{c.sa.seed},"
                f"{c.sa.beta:g},{c.sa.gamma:g},{c.sa.n_chains},"
                f"{swap},{ladder:g}):sa={int(use_sa)}:"
                f"{obj}{w}wl={wl}")

    def _open_sweep(self, checkpoint: Union[str, Path],
                    use_sa: bool) -> ResumableSweep:
        """Open a checkpoint under the current fingerprint, accepting
        superseded-but-equivalent ones via the legacy migration map."""
        keep_rec = lambda k, r: [(k, r)]           # identity migration
        legacy = {self._fingerprint(use_sa, schema=1): migrate_v1_record}
        if self.cfg.sa.n_chains == 1:
            # single-chain sweeps never consult the replica-exchange
            # knobs, yet the fingerprint embeds them — checkpoints
            # written under the pre-retune defaults (50, 3.0) are
            # value-identical and must survive the default change
            legacy[self._fingerprint(use_sa, re_knobs=(50, 3.0))] = keep_rec
            legacy[self._fingerprint(use_sa, schema=1,
                                     re_knobs=(50, 3.0))] = migrate_v1_record
        return ResumableSweep(checkpoint, self._fingerprint(use_sa),
                              legacy=legacy)

    # -- task construction / reduction ---------------------------------
    def _tasks(self, indexed: Sequence[Tuple[int, ArchConfig]]
               ) -> List[_Task]:
        return [(ci, wi, arch, name,
                 derive_task_seed(self.cfg.sa.seed, ci, wi))
                for ci, arch in indexed
                for wi, name in enumerate(self._wl_names)]

    def _reduce(self, indexed: Sequence[Tuple[int, ArchConfig]],
                results: Dict[Tuple[int, int], "_dse.TaskResult"]
                ) -> List["_dse.DSEPoint"]:
        pts = []
        for ci, arch in indexed:
            per = {name: results[(ci, wi)]
                   for wi, name in enumerate(self._wl_names)}
            pts.append(_dse.reduce_tasks(arch, self.cfg, per))
        return pts

    # -- evaluation fan-out --------------------------------------------
    def _map_tasks(self, tasks: List[_Task], use_sa: bool,
                   checkpoint: Union[str, Path, "ResumableSweep", None],
                   stage: str,
                   ) -> Dict[Tuple[int, int], "_dse.TaskResult"]:
        """Evaluate tasks (any order); the returned dict is keyed
        ``(cand_idx, wl_idx)``, so callers reduce deterministically
        regardless of completion order.  ``checkpoint`` may be an
        already-open :class:`ResumableSweep` (the adaptive path calls
        this once per kept candidate and must not re-parse the file
        each time)."""
        results: Dict[Tuple[int, int], "_dse.TaskResult"] = {}
        keep = self.cfg.keep_mappings
        sweep: Optional[ResumableSweep] = None
        if isinstance(checkpoint, ResumableSweep):
            sweep = checkpoint
        elif checkpoint is not None:
            sweep = self._open_sweep(checkpoint, use_sa)
        if sweep is not None:
            n_nomap = 0
            for ci, wi, arch, wl, seed in tasks:
                rec = sweep.get(task_checkpoint_key(arch, wl))
                if rec is None:
                    continue
                # a record is only valid for the seed this sweep would
                # use: editing the candidate grid shifts indices (and
                # therefore derived seeds), and those tasks must recompute
                # or resume would silently mix seeds (SA-less records are
                # seed-independent)
                if use_sa and rec.get("seed") != seed:
                    continue
                if keep and "mapping" not in rec:
                    n_nomap += 1        # metrics-only record, mapping asked
                    continue
                try:
                    results[(ci, wi)] = task_from_dict(rec)
                except (KeyError, ValueError, TypeError) as e:
                    self._log(stage, f"checkpoint record for "
                              f"{arch.label()} x {wl} unusable ({e}); "
                              "recomputing")
            if n_nomap:
                self._log(stage, f"{n_nomap} checkpointed tasks lack "
                          "serialized mappings (metrics-only records, "
                          "keep_mappings sweep); recomputing them")
            if results and self.progress:
                self._log(stage, f"resumed {len(results)}/{len(tasks)} "
                          f"tasks from {sweep.path}")
            _obs.metrics.counter("engine.tasks_resumed").inc(len(results))
        pending = [t for t in tasks if (t[0], t[1]) not in results]
        done_n = len(results)
        t_stage0 = _time.time()
        hb_last = t_stage0

        def _record(ci: int, wi: int, arch: ArchConfig, wl: str, seed: int,
                    tr: "_dse.TaskResult") -> None:
            nonlocal done_n, hb_last
            results[(ci, wi)] = tr
            done_n += 1
            if sweep is not None:
                sweep.add(task_checkpoint_key(arch, wl),
                          task_to_dict(tr, arch, wl, seed, keep))
                now = _time.time()
                if now - hb_last >= self.hb_every:
                    hb_last = now
                    sweep.heartbeat({
                        "shard": self._shard_label, "stage": stage,
                        "done": done_n, "total": len(tasks),
                        "wall_s": now - t_stage0, "t": now})
            if self.progress:
                print(f"[{stage} {done_n}/{len(tasks)}] {arch.label()} "
                      f"x {wl} E={tr.energy_j:.3e}J D={tr.delay_s:.3e}s",
                      flush=True)

        obs_on = _obs.enabled()
        if self.n_workers <= 1 or len(pending) <= 1:
            for ci, wi, arch, wl, seed in pending:
                with _obs.span("task", arch=arch.label(), wl=wl,
                               queue_s=0.0):
                    tr = _dse.evaluate_task(arch, self.workloads[wl],
                                            self.cfg, use_sa=use_sa,
                                            seed=seed)
                if not keep:
                    # mirror the worker path: results live for the whole
                    # sweep, so unrequested mappings must not accumulate
                    tr.mapping = None
                _obs.metrics.counter("engine.tasks").inc()
                _record(ci, wi, arch, wl, seed, tr)
        else:
            pool = self._get_pool()
            submit_t = _time.time() if obs_on else 0.0
            futs = {pool.submit(_worker_eval, (*t, use_sa)): t
                    for t in pending}
            not_done = set(futs)
            try:
                while not_done:
                    done, not_done = wait(not_done,
                                          return_when=FIRST_COMPLETED)
                    for fut in done:
                        ci, wi, tr, payload = fut.result()
                        t = futs[fut]
                        if obs_on and payload is not None:
                            self._absorb_task_payload(t, payload, stage,
                                                      submit_t)
                        _record(ci, wi, t[2], t[3], t[4], tr)
            except BaseException:
                # surface the failure now, not after the queue drains
                for fut in not_done:
                    fut.cancel()
                raise
            finally:
                if obs_on:
                    _obs.metrics.histogram("engine.pool_batch_s").observe(
                        _time.time() - submit_t)
        return results

    def _absorb_task_payload(self, task: _Task, payload: Dict[str, Any],
                             stage: str, submit_t: float) -> None:
        """Fold one worker's piggybacked telemetry into the parent: merge
        its metrics delta, emit a ``task`` span on the worker's behalf
        (wall-clock bounds measured in the worker; queue-wait derived from
        the submit stamp), and feed the queue-wait/wall-time histograms."""
        _obs.metrics.absorb(payload.get("metrics"))
        _obs.metrics.counter("engine.tasks").inc()
        t_start = float(payload.get("t_start", 0.0))
        t_end = float(payload.get("t_end", t_start))
        queue_s = max(0.0, t_start - submit_t)
        dur = max(0.0, t_end - t_start)
        _obs.metrics.histogram("engine.task_wall_s").observe(dur)
        _obs.metrics.histogram("engine.queue_wait_s").observe(queue_s)
        _obs.metrics.histogram("phase.task").observe(dur)
        _obs.emit({"ev": "span", "name": "task",
                   "pid": payload.get("pid"), "t0": t_start, "dur": dur,
                   "attrs": {"arch": task[2].label(), "wl": task[3],
                             "stage": stage, "queue_s": queue_s}})

    # -- batched T-Map screening ---------------------------------------
    def _screen_tasks(self, indexed: Sequence[Tuple[int, ArchConfig]]
                      ) -> Dict[Tuple[int, int], "_dse.TaskResult"]:
        """T-Map-score every candidate in one batched pass per
        bandwidth-sibling signature group.

        The traffic/compute analysis of a T-Map mapping depends on every
        ArchConfig field EXCEPT the three bandwidths
        (:func:`repro_torch.core.evaluator.analysis_signature`), and Table-I
        grids enumerate bandwidths densely — so candidates sharing a
        signature share ``partition_graph``, ``tangram_map`` and every
        ``GroupAnalysis`` bit-for-bit.  This path computes each signature's
        analysis once and re-derives only the per-candidate delay terms,
        vectorized over the signature's bandwidth columns
        (:meth:`repro_torch.core.evaluator.Evaluator.eval_mapping_archs`);
        energies never read a bandwidth and are shared outright.  Results
        are bit-identical to the per-candidate ``evaluate_task`` loop
        (A/B-tested; ``batched_screen=False`` keeps that loop for the
        benchmark's reference leg).
        """
        if not self.batched_screen:
            return self._map_tasks(self._tasks(indexed), use_sa=False,
                                   checkpoint=None, stage="screen")
        keep = self.cfg.keep_mappings
        results: Dict[Tuple[int, int], "_dse.TaskResult"] = {}
        # the signature reads only the arch, so one grouping serves every
        # workload
        by_sig: "OrderedDict[Tuple, List[Tuple[int, ArchConfig]]]" \
            = OrderedDict()
        for ci, arch in indexed:
            by_sig.setdefault(analysis_signature(arch), []).append((ci, arch))
        n_sigs = len(by_sig)
        for wi, name in enumerate(self._wl_names):
            g = self.workloads[name]
            for members in by_sig.values():
                rep = members[0][1]
                groups = partition_graph(g, rep, self.cfg.batch)
                mapping = tangram_map(groups, g, rep)
                ev = evaluator_for(rep, g)
                E, D = ev.eval_mapping_archs(mapping, self.cfg.batch,
                                             [a for _, a in members])
                for (ci, arch), e_c, d_c in zip(members, E, D):
                    results[(ci, wi)] = _dse.TaskResult(
                        energy_j=float(e_c), delay_s=float(d_c),
                        mapping=mapping if keep else None)
        if self.progress:
            self._log("screen", f"batched: {len(indexed)} candidates x "
                      f"{len(self._wl_names)} workloads in {n_sigs} "
                      "signature group(s)")
        return results

    # -- public API ----------------------------------------------------
    def map_archs(self, archs: Sequence[ArchConfig], use_sa: bool = True,
                  ) -> List["_dse.DSEPoint"]:
        """Evaluate ``archs`` (parallel, deterministic), *preserving input
        order* — for callers that reduce positionally (``joint_reuse_dse``)
        rather than rank by objective."""
        indexed = list(enumerate(archs))
        with _obs.span("map", n_archs=len(indexed)):
            results = self._map_tasks(self._tasks(indexed), use_sa=use_sa,
                                      checkpoint=self.checkpoint,
                                      stage="map")
            out = self._reduce(indexed, results)
        self._finalize_obs()
        return out

    def screen(self, candidates: Sequence[ArchConfig]
               ) -> List["_dse.DSEPoint"]:
        """T-Map-only scoring pass (no SA), sorted best-objective first."""
        indexed = list(enumerate(candidates))
        with _obs.span("screen", n_candidates=len(indexed)):
            results = self._screen_tasks(indexed)
        return sorted(self._reduce(indexed, results),
                      key=lambda p: p.objective)

    def _finalize_obs(self) -> None:
        """Land the metrics snapshot + flush trace buffers (no-op while
        disabled); called at the end of every public sweep entry point so
        a killed-later process still leaves a parseable run dir."""
        if _obs.enabled():
            _obs.metrics.write_snapshot()
            _obs.flush()

    def run(self, candidates: Sequence[ArchConfig], use_sa: bool = True,
            screen_keep: Union[float, str] = 1.0,
            shard: Tuple[int, int] = (0, 1),
            indices: Optional[Sequence[int]] = None,
            shard_label: Optional[str] = None,
            ) -> List["_dse.DSEPoint"]:
        """Full sweep: optional screening stage, then (parallel) evaluation
        of this shard's (candidate x workload) tasks.

        Per-task seeds derive from the candidate's index in ``candidates``
        and the workload's sorted-name index, so results are independent of
        ``n_workers``, completion order, screening of *other* candidates,
        sharding and resume.

        ``screen_keep`` selects the screening mode: a fraction in (0, 1)
        keeps the best fixed fraction of T-Map scores (the explicit
        override); ``"auto"`` applies the **adaptive gap rule** — refine
        candidates in screened order and stop as soon as the next
        candidate's T-Map objective gap vs the best screened score exceeds
        the largest SA improvement observed so far in this sweep (a
        heuristic: see :meth:`_run_adaptive`); ``1.0`` (default) is
        exhaustive.

        ``shard=(i, n)`` evaluates only the candidates with
        ``index % n == i``.  The screening stage (deterministic, no SA)
        runs over the FULL grid in every shard so all shards agree on the
        global keep set — merging the n shard checkpoints and resuming is
        then bit-identical to the unsharded sweep.  Adaptive mode is
        incompatible with sharding: the gap rule consumes SA results as
        they arrive, which independent shards cannot agree on.

        ``indices`` is the supervisor-style alternative to stride
        sharding: evaluate exactly the listed global candidate indices
        and run NO screening stage — the caller (a multi-host
        supervisor) has already screened once and ships each shard an
        explicit slice of the keep set.  Seeds still derive from the
        *global* index, so any partition of the keep set across shards
        merges bit-identically.  ``shard_label`` names this shard in
        heartbeats/manifests when the ``i/n`` stride form doesn't apply.
        """
        candidates = list(candidates)
        si, sn = shard
        if sn < 1 or not 0 <= si < sn:
            raise ValueError(f"bad shard {si}/{sn}: need 0 <= i < n")
        if indices is not None:
            if sn > 1:
                raise ValueError("indices= is an explicit task list; "
                                 "combining it with stride sharding "
                                 f"({si}/{sn}) is ambiguous")
            if screen_keep != 1.0:
                raise ValueError(
                    "indices= means screening already happened upstream; "
                    "pass screen_keep=1.0 (the supervisor ships the keep "
                    "set explicitly)")
            idx = sorted(set(int(i) for i in indices))
            for i in idx:
                if not 0 <= i < len(candidates):
                    raise ValueError(f"candidate index {i} outside the "
                                     f"grid (0..{len(candidates) - 1})")
        self._shard_label = shard_label or f"{si}/{sn}"
        if _obs.enabled():
            _obs.manifest.write_manifest({
                "stage": "run", "fingerprint": self._fingerprint(use_sa),
                "seed": self.cfg.sa.seed, "grid": len(candidates),
                "n_workloads": len(self._wl_names),
                "shard": self._shard_label, "n_workers": self.n_workers,
                "screen_keep": screen_keep,
                "checkpoint": (str(self.checkpoint)
                               if self.checkpoint is not None else None)})
        indexed = list(enumerate(candidates))
        self.last_screen = None
        if use_sa and screen_keep == "auto" and len(candidates) > 1:
            if sn > 1:
                raise ValueError(
                    "adaptive screening (screen_keep='auto') decides the "
                    "keep set from SA results as they arrive, which "
                    "independent shards cannot agree on; pass a fixed "
                    "screen_keep fraction for sharded sweeps")
            return self._run_adaptive(indexed)
        if screen_keep == "auto":
            screen_keep = 1.0          # nothing to screen (or no SA stage)
        if isinstance(screen_keep, str):
            raise ValueError(
                f"screen_keep must be a fraction or 'auto', "
                f"got {screen_keep!r}")
        if use_sa and screen_keep < 1.0 and len(candidates) > 1:
            with _obs.span("screen", n_candidates=len(indexed)):
                screen_results = self._screen_tasks(indexed)
                screen_pts = self._reduce(indexed, screen_results)
            order = sorted(range(len(indexed)),
                           key=lambda i: screen_pts[i].objective)
            # epsilon guard: fraction-derived keeps like 6/n can float up
            # (6/187*187 == 6.000000000000001) and must not round to 7
            keep = max(1, min(len(indexed),
                              math.ceil(screen_keep * len(indexed) - 1e-9)))
            kept = sorted(order[:keep])
            self._log("explore", f"screening kept {keep}/{len(indexed)} "
                      f"candidates (pruned {len(indexed) - keep})")
            _obs.metrics.counter("screen.kept").inc(keep)
            _obs.metrics.counter("screen.pruned").inc(len(indexed) - keep)
            self.last_screen = [screen_pts[i] for i in order]
            indexed = [indexed[i] for i in kept]
        if indices is not None:
            want = set(idx)
            indexed = [(ci, arch) for ci, arch in indexed if ci in want]
            self._log("explore",
                      f"shard {self._shard_label}: {len(indexed)} assigned "
                      f"candidates ({len(indexed) * len(self._wl_names)} "
                      "tasks)")
        if sn > 1:
            mine = [(ci, arch) for ci, arch in indexed if ci % sn == si]
            self._log("explore",
                      f"shard {si}/{sn}: {len(mine)}/{len(indexed)} "
                      f"candidates ({len(mine) * len(self._wl_names)} tasks)")
            indexed = mine
        with _obs.span("dse", shard=self._shard_label,
                       n_candidates=len(indexed)):
            results = self._map_tasks(self._tasks(indexed), use_sa=use_sa,
                                      checkpoint=self.checkpoint,
                                      stage="dse")
            out = sorted(self._reduce(indexed, results),
                         key=lambda p: p.objective)
        self._finalize_obs()
        return out

    def _run_adaptive(self, indexed: List[Tuple[int, ArchConfig]]
                      ) -> List["_dse.DSEPoint"]:
        """Gap-rule screening (``screen_keep="auto"``).

        After the T-Map screen, candidates are refined best-screened-first.
        Let ``gain_max`` be the largest log-objective improvement SA has
        delivered over its own candidate's T-Map score so far; a candidate
        whose T-Map gap to the *best* screened score exceeds ``gain_max``
        is pruned, and so is everything behind it (screened order is
        monotone in the gap).  This is a *heuristic* stopping rule, not a
        bound: it assumes no pruned candidate's achievable SA gain exceeds
        the largest gain observed on the refined ones — a candidate whose
        T-Map mapping is unusually far from its optimum can still be
        missed (the fixed-fraction override exists for exactly that
        doubt).  Huge grids prune hard; tight grids degrade to
        exhaustive.  Fully deterministic (screened order + per-task
        seeds), so resume replays identically.
        """
        screen_results = self._screen_tasks(indexed)
        screen_pts = self._reduce(indexed, screen_results)
        order = sorted(range(len(indexed)),
                       key=lambda i: screen_pts[i].objective)
        self.last_screen = [screen_pts[i] for i in order]
        # one sweep for the whole refine loop: re-opening per candidate
        # would re-parse the growing checkpoint O(kept^2) times
        sweep: Union[ResumableSweep, None] = None
        if self.checkpoint is not None:
            sweep = self._open_sweep(self.checkpoint, use_sa=True)
        best_log = math.log(screen_pts[order[0]].objective)
        gain_max = 0.0
        kept: List[Tuple[int, ArchConfig]] = []
        results: Dict[Tuple[int, int], "_dse.TaskResult"] = {}
        for rank, oi in enumerate(order):
            gap = math.log(screen_pts[oi].objective) - best_log
            if rank > 0 and gap > gain_max:
                break
            ci, arch = indexed[oi]
            res = self._map_tasks(self._tasks([(ci, arch)]), use_sa=True,
                                  checkpoint=sweep, stage="dse")
            results.update(res)
            kept.append((ci, arch))
            pt = self._reduce([(ci, arch)], res)[0]
            gain_max = max(gain_max, math.log(screen_pts[oi].objective)
                           - math.log(pt.objective))
        self._log("explore",
                  f"adaptive screening kept {len(kept)}/{len(indexed)}"
                  f" candidates (largest SA gain {gain_max:.3g} in "
                  f"log-objective; pruned {len(indexed) - len(kept)})")
        _obs.metrics.counter("screen.kept").inc(len(kept))
        _obs.metrics.counter("screen.pruned").inc(len(indexed) - len(kept))
        out = sorted(self._reduce(sorted(kept), results),
                     key=lambda p: p.objective)
        self._finalize_obs()
        return out
