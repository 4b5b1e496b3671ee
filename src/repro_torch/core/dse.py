"""Architecture x Mapping co-exploration (paper Sec. V-A, Table I).

Enumerate architecture candidates exhaustively; run the mapping engine
(DP graph partition + SA LP-SPM) once per (candidate, workload) **task**
— the unit of work the exploration engine fans out and checkpoints —
then reduce geometric-mean E and D across workloads and score
``MC^alpha * E^beta * D^gamma`` (:func:`reduce_tasks`).  Supports joint
DSE across several compute-power targets built from one chiplet (paper
Sec. VII-B) and sharded sweeps merged via
``explore.merge_checkpoints``.

Copy of ``src/repro/core/dse.py``.  ``objective="slo"`` scores a sweep by
the serving stack's SLO model (``repro_torch.serve.slo``, numpy only).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .evaluator import evaluator_for
from .graph_partition import partition_graph
from .hw import ArchConfig
from .mc import evaluate_mc
from .sa import Mapping, SAConfig, sa_optimize
from .tangram import tangram_map
from .workload import Graph

# module object (not names): explore imports this module back, so names may
# not exist yet at import time — attributes resolve at call time instead
from . import explore as _explore


@dataclass
class DSEPoint:
    arch: ArchConfig
    mc: float
    energy_j: float          # geometric mean across workloads
    delay_s: float           # geometric mean across workloads
    objective: float
    per_workload: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    mappings: Dict[str, Mapping] = field(default_factory=dict)
    # predicted serving metrics (objective="slo" sweeps only): p50/95/99
    # TTFT + e2e seconds, throughput, occupancy — see repro_torch.serve.slo
    slo: Optional[Dict[str, float]] = None

    @property
    def edp(self) -> float:
        return self.energy_j * self.delay_s


@dataclass
class DSEConfig:
    alpha: float = 1.0        # MC exponent
    beta: float = 1.0         # E exponent
    gamma: float = 1.0        # D exponent
    batch: int = 64
    sa: SAConfig = field(default_factory=lambda: SAConfig(iters=1500))
    keep_mappings: bool = False
    # portfolio co-exploration: traffic-share weight per workload name
    # (weighted geometric mean in reduce_tasks).  None — and ONLY None —
    # takes the historical unweighted path; explicit all-1.0 weights are
    # bit-identical to it but stamp a ``:w=`` segment into the sweep
    # fingerprint.  Missing names default to weight 1.0.
    workload_weights: Optional[Dict[str, float]] = None
    # scoring mode: "geomean" (historical MC^a * E^b * D^g; the default
    # keeps every existing sweep bit-identical) or "slo", which replaces
    # the raw delay term with the predicted p99 end-to-end latency of the
    # candidate serving ``traffic`` (a repro_torch.serve.slo.TrafficModel,
    # a registered model name, or a raw trace spec).  Queueing over the
    # traffic's arrival process makes p99 convex in D, so E/D trade-offs
    # rank differently than under the raw-delay objective.  Tasks (E, D)
    # are computed identically in both modes — only the reduction differs
    # — but the engine stamps an ``obj=`` fingerprint segment so
    # differently-scored sweep artifacts are never conflated.
    objective: str = "geomean"
    traffic: Optional[object] = None


@dataclass
class TaskResult:
    """Result of one (candidate, workload) task — the engine's unit of
    work and the payload of one schema-v2 checkpoint record."""
    energy_j: float
    delay_s: float
    mapping: Optional[Mapping] = None


def grid_candidates(tops: float,
                    mac_options: Sequence[int] = (512, 1024, 2048, 4096),
                    cut_options: Sequence[int] = (1, 2, 3, 6),
                    dram_per_tops: Sequence[float] = (0.5, 1.0, 2.0),
                    noc_options: Sequence[float] = (8, 16, 32, 64),
                    d2d_ratio: Sequence[float] = (0.25, 0.5, 1.0),
                    glb_options: Sequence[int] = (256, 512, 1024, 2048, 4096),
                    ) -> List[ArchConfig]:
    """The paper's Table-I grid for a given total TOPS (int8, 2 ops/MAC)."""
    out: List[ArchConfig] = []
    for macs in mac_options:
        n_cores = int(round(tops * 1e3 / (2 * macs)))
        if n_cores < 1:
            continue
        # near-square arrangement
        x = int(math.isqrt(n_cores))
        while n_cores % x:
            x -= 1
        y, xc = n_cores // x, x
        x_cores, y_cores = max(xc, y), min(xc, y)
        if x_cores * y_cores != n_cores:
            continue
        for xcut, ycut in itertools.product(cut_options, cut_options):
            if x_cores % xcut or y_cores % ycut:
                continue
            for dpt, noc, dr, glb in itertools.product(
                    dram_per_tops, noc_options, d2d_ratio, glb_options):
                out.append(ArchConfig(
                    x_cores=x_cores, y_cores=y_cores, xcut=xcut, ycut=ycut,
                    noc_bw=float(noc), d2d_bw=float(noc * dr),
                    dram_bw=float(dpt * tops), glb_kb=glb,
                    macs_per_core=macs))
    return out


def evaluate_task(arch: ArchConfig, g: Graph, cfg: DSEConfig,
                  use_sa: bool = True,
                  seed: Optional[int] = None) -> TaskResult:
    """Score one (architecture, workload) pair — the engine's unit of work.

    ``seed`` overrides ``cfg.sa.seed`` for this task's SA chains; the
    engine passes a per-task seed derived from ``(cfg.sa.seed, candidate
    index, workload index)`` so serial, parallel and sharded sweeps are
    bit-identical.
    """
    sa_cfg = cfg.sa if seed is None else replace(cfg.sa, seed=seed)
    groups = partition_graph(g, arch, cfg.batch)
    # per-process LRU registry: re-scoring this (arch, graph) soon after
    # (small screen-then-refine sweeps, same-arch loops) reuses the
    # analyzer + GroupEval cache; within this call, SA chains and the
    # final exact re-evaluation share ev by argument passing
    ev = evaluator_for(arch, g)
    if use_sa:
        res = sa_optimize(g, arch, groups, cfg.batch, sa_cfg, evaluator=ev)
        return TaskResult(energy_j=res.energy_j, delay_s=res.delay_s,
                          mapping=res.mapping)
    mapping = tangram_map(groups, g, arch)
    r = ev.evaluate(mapping, cfg.batch)
    return TaskResult(energy_j=r.energy_j, delay_s=r.delay_s, mapping=mapping)


def reduce_tasks(arch: ArchConfig, cfg: DSEConfig,
                 task_results: Dict[str, TaskResult]) -> DSEPoint:
    """Geometric-mean reduction of per-workload task results into one
    scored :class:`DSEPoint` (paper's ``MC^a * E^b * D^g`` objective).

    With ``cfg.workload_weights`` set this is the *weighted* geomean
    ``exp(sum_i w_i log E_i / sum_i w_i)`` — the portfolio co-exploration
    objective where ``w_i`` is workload ``i``'s traffic share.  Weights
    must be positive; names absent from the dict weigh 1.0.

    ``task_results`` must iterate in a deterministic workload order (the
    engine uses sorted names) — the log-domain accumulation is float
    arithmetic, so the order is part of the bit-identity contract.
    ``workload_weights=None`` reproduces the historical float-op sequence
    exactly; uniform explicit 1.0 weights are bit-identical to it because
    ``1.0 * x == x`` and a sum of ones equals the exact float count.
    """
    mc = evaluate_mc(arch).total
    w = cfg.workload_weights
    logE = logD = 0.0
    wsum = 0.0
    per: Dict[str, Tuple[float, float]] = {}
    maps: Dict[str, Mapping] = {}
    for name, tr in task_results.items():
        per[name] = (tr.energy_j, tr.delay_s)
        if cfg.keep_mappings and tr.mapping is not None:
            maps[name] = tr.mapping
        le = math.log(tr.energy_j)
        ld = math.log(tr.delay_s)
        if w is not None:
            wi = float(w.get(name, 1.0))
            if wi <= 0 or not math.isfinite(wi):
                raise ValueError(
                    f"workload_weights[{name!r}] = {wi} must be a positive "
                    f"finite traffic share")
            wsum += wi
            if wi != 1.0:
                le *= wi
                ld *= wi
        logE += le
        logD += ld
    n = (wsum if wsum > 0 else 1.0) if w is not None \
        else max(1, len(task_results))
    E = math.exp(logE / n)
    D = math.exp(logD / n)
    slo: Optional[Dict[str, float]] = None
    if cfg.objective == "slo":
        # tail-latency scoring: the geomean delay becomes a per-token
        # service model replayed over the traffic model's arrival process
        # (deterministic, cached); p99 e2e replaces D in the objective
        from ..serve.slo import SLO_SCALAR_KEY, predict_slo
        if cfg.traffic is None:
            raise ValueError(
                "objective='slo' needs cfg.traffic (a TrafficModel, a "
                "registered name, or a trace spec — see "
                "repro_torch.serve.slo)")
        slo = predict_slo(D, cfg.traffic, cfg.batch)
        obj = (mc ** cfg.alpha) * (E ** cfg.beta) \
            * (slo[SLO_SCALAR_KEY] ** cfg.gamma)
    elif cfg.objective == "geomean":
        obj = (mc ** cfg.alpha) * (E ** cfg.beta) * (D ** cfg.gamma)
    else:
        raise ValueError(
            f"unknown DSE objective {cfg.objective!r}: 'geomean' or 'slo'")
    return DSEPoint(arch=arch, mc=mc, energy_j=E, delay_s=D, objective=obj,
                    per_workload=per, mappings=maps, slo=slo)


def evaluate_candidate(arch: ArchConfig, workloads: Dict[str, Graph],
                       cfg: DSEConfig, use_sa: bool = True,
                       seed: Optional[int] = None,
                       cand_idx: Optional[int] = None) -> DSEPoint:
    """Score one architecture over all workloads (sorted-name order).

    Standalone convenience over :func:`evaluate_task` +
    :func:`reduce_tasks` (the engine fans the tasks out itself):

    * ``seed`` — one SA seed shared by every workload (the pre-task-model
      behavior, kept for fig6/fig8-style single-candidate probes);
    * ``cand_idx`` — derive a per-(candidate, workload) seed from
      ``(cfg.sa.seed, cand_idx, workload index)``; matches bit-for-bit
      what ``run_dse`` computes for the candidate at that index.
    """
    if seed is not None and cand_idx is not None:
        raise ValueError("pass either seed= or cand_idx=, not both")
    results: Dict[str, TaskResult] = {}
    for wi, name in enumerate(sorted(workloads)):
        task_seed = seed
        if cand_idx is not None:
            task_seed = _explore.derive_task_seed(cfg.sa.seed, cand_idx, wi)
        results[name] = evaluate_task(arch, workloads[name], cfg,
                                      use_sa=use_sa, seed=task_seed)
    return reduce_tasks(arch, cfg, results)


def run_dse(candidates: Sequence[ArchConfig], workloads: Dict[str, Graph],
            cfg: DSEConfig, use_sa: bool = True, progress: bool = False,
            n_workers: int = 1, screen_keep: Union[float, str] = 1.0,
            checkpoint: Union[str, Path, None] = None,
            shard: Tuple[int, int] = (0, 1),
            mp_context: str = "spawn",
            objective: Optional[str] = None,
            traffic: Optional[object] = None,
            indices: Optional[Sequence[int]] = None,
            shard_label: Optional[str] = None) -> List[DSEPoint]:
    """Sweep ``candidates``; thin wrapper over the exploration engine.

    * ``n_workers > 1`` fans (candidate x workload) tasks out over worker
      processes; results are bit-identical to the serial path (per-task
      seeds derive from the candidate/workload indices, not scheduling).
    * ``screen_keep < 1.0`` first scores every candidate with the cheap
      T-Map pass and runs full SA only on the best fraction;
      ``screen_keep="auto"`` prunes adaptively instead — refinement stops
      once the T-Map gap to the best exceeds the largest SA improvement
      observed so far (unsharded sweeps only).
    * ``checkpoint`` names a JSON-lines file: completed tasks are skipped
      on re-run (resume after a crash / interrupted sweep).
    * ``shard=(i, n)`` evaluates only candidates with ``index % n == i``;
      give each shard its own checkpoint and reconstruct the full sweep
      with ``explore.merge_checkpoints`` — the merged result is
      bit-identical to an unsharded run.
    * ``objective="slo"`` with ``traffic=...`` scores candidates by
      predicted p99 end-to-end latency under the traffic model instead of
      the raw geomean delay (convenience overrides for
      ``cfg.objective``/``cfg.traffic``); left at ``None`` the sweep —
      and its checkpoint fingerprint — is untouched.
    * ``indices=[...]`` evaluates exactly the listed global candidate
      indices with no screening stage — the multi-host supervisor's
      screen-once dispatch form (``shard_label`` names the shard in
      heartbeats).  Mutually exclusive with stride ``shard``.
    """
    if objective is not None:
        cfg = replace(cfg, objective=objective)
    if traffic is not None:
        cfg = replace(cfg, traffic=traffic)
    with _explore.ExplorationEngine(workloads, cfg, n_workers=n_workers,
                                    checkpoint=checkpoint, progress=progress,
                                    mp_context=mp_context) as eng:
        return eng.run(candidates, use_sa=use_sa, screen_keep=screen_keep,
                       shard=shard, indices=indices, shard_label=shard_label)


def scaled_arch(base: ArchConfig, s: int) -> ArchConfig:
    """Tile ``s`` copies of a base chiplet in an as-square-as-possible grid."""
    sx = int(math.isqrt(s))
    while s % sx:
        sx -= 1
    sy = s // sx
    return base.replace(
        x_cores=base.x_cores * sx, y_cores=base.y_cores * sy,
        xcut=base.xcut * sx, ycut=base.ycut * sy,
        dram_bw=base.dram_bw * s)


def joint_reuse_dse(chiplet_grid: Sequence[ArchConfig],
                    scale_factors: Sequence[int],
                    workloads: Dict[str, Graph],
                    cfg: DSEConfig,
                    n_workers: int = 1,
                    objective: Optional[str] = None,
                    traffic: Optional[object] = None
                    ) -> List[Tuple[ArchConfig, float]]:
    """Paper Sec. VII-B: pick ONE chiplet; build each scale by tiling it.

    ``chiplet_grid`` holds base (single-chiplet) configs; ``scale_factors``
    multiplies the chiplet count (e.g. (1, 4) for 128/512 TOPs).  Returns
    (base_arch, product-of-objectives) sorted ascending.  The flattened
    (base x scale) grid is evaluated through the engine, so ``n_workers``
    parallelizes it with the same determinism guarantee as ``run_dse``.

    With ``cfg.workload_weights`` set this is *portfolio co-exploration*:
    each scale's objective is the weighted geomean over the workload
    portfolio (traffic shares), so the selected chiplet is the one whose
    tilings best serve the expected deployment mix — e.g. a 0.75/0.25
    dense/MoE portfolio — rather than an unweighted workload zoo.  The
    weights are stamped into the sweep fingerprint (schema-v2 checkpoint
    header ``:w=`` segment), so differently-weighted portfolios never
    share checkpoint records.

    ``objective="slo"`` with ``traffic=...`` scores each scale by
    predicted tail latency under the traffic model (see :func:`run_dse`);
    the product over scales then selects the chiplet whose tilings best
    keep the deployment's p99 in budget rather than its raw delay.
    """
    if objective is not None:
        cfg = replace(cfg, objective=objective)
    if traffic is not None:
        cfg = replace(cfg, traffic=traffic)
    scales = list(scale_factors)
    flat = [scaled_arch(base, s) for base in chiplet_grid for s in scales]
    with _explore.ExplorationEngine(workloads, cfg,
                                    n_workers=n_workers) as eng:
        pts = eng.map_archs(flat, use_sa=True)
    out: List[Tuple[ArchConfig, float]] = []
    for bi, base in enumerate(chiplet_grid):
        prod = 1.0
        for si in range(len(scales)):
            prod *= pts[bi * len(scales) + si].objective
        out.append((base, prod))
    out.sort(key=lambda t: t[1])
    return out
