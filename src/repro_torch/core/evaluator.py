"""Delay + energy evaluation of a mapped DNN (paper Sec. V-B2, SET-style).

Reduced copy of the scalar path of ``src/repro/core/evaluator.py``:
``analysis_signature`` (``:43``), ``GroupEval``, ``EvalResult`` (with
``cost``, ``:93``), ``_pipeline_depth``, ``Evaluator`` with ``eval_group``
(``:221``), the bandwidth-vectorized ``eval_mapping_archs`` (``:481``),
``traffic_summary`` (``:540``) and ``evaluate`` (``:563``),
``CachedEvaluator`` with its separate fused cache and ``cache_info``
(``:577-684``) and ``evaluator_for`` (``:687``); and the batched engine:
``eval_requests_batch`` (``:285``), ``eval_group_batch`` (``:445``) and
``eval_groups_batched`` (``:456``).  The arithmetic is the reference's,
float64 and in the same order, so every ``GroupEval`` equals the
reference's scalar one and every batched row the reference's batched row.
``CACHE_STATS`` counts the GroupEval caches' hits, misses and evictions
under the reference's names, harvested by a ``repro_torch.obs`` collector
(``:56-67``).

The reference's opt-in ``backend="jax"`` (``_build_fused_fn``, ``:97-179``,
and ``_eval_requests_fused``, ``:376``) is the port's ``backend="fused"``:
the batch's float32 contribution streams go through the ``fused_eval`` CUDA
kernel (:mod:`repro_torch.kernels.fused_eval`), which replays them and
computes every row's delay, energy and bottleneck in one launch.  It runs
on the evaluator's ``fused_device``, the card unless the caller asks for
the CPU (where the kernel's plain version runs); without a card the first
fused call raises.  ``"jax"`` is refused like any unknown backend.

A mapped DNN is a sequence of (LayerGroup, LMS).  Per group we take the
``GroupAnalysis`` traffic and compute

  delay  = stage_time * (n_passes + pipeline_depth - 1)
  stage_time = max( compute time on the busiest core,
                    busiest NoC link, busiest D2D link, busiest DRAM port )

(fine-grained pipelining over batch-unit passes, with fill/drain captured by
the depth term — the Tangram/SET model).  Energy sums MACs, GLB traffic
(from the intra-core exploration), NoC hop bytes, D2D crossing bytes and
DRAM bytes, each times its unit energy.  GLB overcommit is penalized softly
(spill traffic + delay multiplier).  ``CachedEvaluator`` adds a
content-addressed ``GroupEval`` cache keyed on (group, LMS key, batch).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import metrics as _obs_metrics
from .analyzer import (T_CORE_IN, T_CORE_MACS, T_CORE_TIME, T_DRAM,
                       T_DRAM_AM, T_EDGE, T_EDGE_AM, T_GLB, T_GLB_RW,
                       Analyzer, GroupAnalysis, router_grid)
from .encoding import LMS
from .hw import ArchConfig
from .workload import Graph, LayerGroup

# Process-wide cache economics, summed over every CachedEvaluator this
# process ever built (the per-instance hits/misses reset with each
# candidate's evaluator; sweep-level rates need the union).  Plain-dict
# increments on the hit path cost nanoseconds against a cache lookup and
# keep the counters alive when instances are GC'd; the obs layer harvests
# them through a collector, so REPRO_OBS never touches this path.
CACHE_STATS: Dict[str, int] = {
    "group_eval.hits": 0, "group_eval.misses": 0, "group_eval.evictions": 0,
    "group_eval_fused.hits": 0, "group_eval_fused.misses": 0,
    "group_eval_fused.evictions": 0,
}
_obs_metrics.register_collector(lambda: dict(CACHE_STATS))


def analysis_signature(arch: ArchConfig) -> Tuple:
    """The ArchConfig fields the traffic/compute ANALYSIS depends on.

    Everything except the three bandwidths (``noc_bw``, ``d2d_bw``,
    ``dram_bw``), which enter only the delay math of ``eval_group``.
    Candidates sharing a signature share ``partition_graph``,
    ``tangram_map`` and every ``GroupAnalysis`` bit-for-bit — the
    batched T-Map screening path exploits exactly this.
    """
    return (arch.x_cores, arch.y_cores, arch.xcut, arch.ycut, arch.glb_kb,
            arch.macs_per_core, arch.freq_ghz, arch.n_dram, arch.tech)


@dataclass
class GroupEval:
    delay_s: float
    energy_j: float
    stage_time_s: float
    n_passes: int
    depth: int
    bottleneck: str
    glb_overflow_bytes: float
    energy_breakdown: Dict[str, float] = field(default_factory=dict)


@dataclass
class EvalResult:
    delay_s: float
    energy_j: float
    groups: List[GroupEval]
    analyses: List[GroupAnalysis]

    @property
    def edp(self) -> float:
        return self.delay_s * self.energy_j

    def cost(self, beta: float = 1.0, gamma: float = 1.0) -> float:
        return (self.energy_j ** beta) * (self.delay_s ** gamma)


def _pipeline_depth(g: Graph, group: LayerGroup) -> int:
    """Longest dependency chain within the group (fill/drain passes)."""
    names = set(group.names)
    depth: Dict[str, int] = {}
    for n in g.topo_order():
        if n not in names:
            continue
        preds = [p for p in g.preds(n) if p in names]
        depth[n] = 1 + max((depth[p] for p in preds), default=0)
    return max(depth.values(), default=1)


class Evaluator:
    """Per-(arch, graph) evaluator; reuses the Analyzer and its caches.

    ``fused_device`` is where ``backend="fused"`` runs: ``"cuda"`` (the
    default: the ``fused_eval`` kernel on the card) or ``"cpu"`` (its plain
    version).  The exact numpy engine never reads it."""

    def __init__(self, arch: ArchConfig, g: Graph,
                 fused_device: str = "cuda"):
        self.arch = arch
        self.g = g
        self.fused_device = fused_device
        self.analyzer = Analyzer(arch, g, fused_device=fused_device)
        self.grid = router_grid(arch)
        self._is_d2d = self.grid.edge_is_d2d
        self._not_d2d = ~self._is_d2d
        self._has_d2d = bool(self._is_d2d.any())
        # integer column indices: fancy-indexing (B, ne) rows is cheaper
        # than boolean masks and selects the same elements in the same
        # (ascending-position) order
        self._noc_idx = np.flatnonzero(self._not_d2d)
        self._d2d_idx = np.flatnonzero(self._is_d2d)
        self._depth_cache: Dict[Tuple[str, ...], int] = {}
        self._fused_plan = None          # built on first backend="fused" use

    # ------------------------------------------------------------------
    def _group_depth(self, group: LayerGroup) -> int:
        d = self._depth_cache.get(group.names)
        if d is None:
            d = self._depth_cache[group.names] = _pipeline_depth(self.g, group)
        return d

    # ------------------------------------------------------------------
    def eval_group(self, group: LayerGroup, lms: LMS,
                   total_batch: int) -> Tuple[GroupEval, GroupAnalysis]:
        arch, g, tech = self.arch, self.g, self.arch.tech
        an = self.analyzer.analyze(group, lms, total_batch)
        bu = group.batch_unit
        n_passes = max(1, -(-total_batch // bu))
        depth = self._group_depth(group)

        # -- per-core compute time + GLB traffic (intra-core engine) -------
        # resolved inside the analyzer's cached contribution streams via
        # the batch dataflow API (explore_intra_core_many)
        core_time = an.core_time_s
        glb_rd = float(an.glb_rw_bytes[0])
        glb_wr = float(an.glb_rw_bytes[1])

        # -- resource times per pass ---------------------------------------
        edge_tot = an.edge_bytes + an.edge_bytes_amortized
        is_d2d, not_d2d = self._is_d2d, self._not_d2d
        t_noc = float((edge_tot[not_d2d] / (arch.noc_bw * 1e9)).max(initial=0.0))
        t_d2d = float((edge_tot[is_d2d] / (arch.d2d_bw * 1e9)).max(initial=0.0)) \
            if self._has_d2d else 0.0
        dram_port_bw = arch.dram_bw / arch.n_dram * 1e9
        t_dram = float(((an.dram_bytes + an.dram_bytes_amortized)
                        / dram_port_bw).max(initial=0.0))
        t_comp = float(core_time.max(initial=0.0))
        stage = max(t_comp, t_noc, t_d2d, t_dram, 1e-12)
        # first-maximum pick, same tie-break as np.argmax over the four times
        bi, bv = 0, t_comp
        for i, v in enumerate((t_noc, t_d2d, t_dram), start=1):
            if v > bv:
                bi, bv = i, v
        bottleneck = ("compute", "noc", "d2d", "dram")[bi]

        # -- GLB overcommit: soft penalty -----------------------------------
        over = np.maximum(an.core_glb_need - arch.core_glb_bytes, 0.0)
        overflow = float(over.sum())
        spill_dram = overflow * 2.0          # write + re-read per pass
        stage *= 1.0 + overflow / (arch.core_glb_bytes * arch.n_cores)
        t_dram_spill = spill_dram / (arch.dram_bw * 1e9)
        stage += t_dram_spill

        delay = stage * (n_passes + depth - 1)

        # -- energy over the whole batch -------------------------------------
        noc_bytes = float(edge_tot[not_d2d].sum()) * n_passes
        d2d_bytes = float(edge_tot[is_d2d].sum()) * n_passes
        dram_b = float(an.dram_bytes.sum()) * n_passes \
            + an.weight_dram_bytes_total + spill_dram * n_passes
        macs_total = float(an.core_macs.sum()) * n_passes
        e = {
            "mac": macs_total * tech.e_mac,
            "glb": (glb_rd + glb_wr + float(an.core_in_bytes.sum())) * n_passes
                   * tech.e_glb_byte,
            "noc": (noc_bytes + d2d_bytes) * tech.e_noc_hop_byte,
            "d2d": d2d_bytes * tech.e_d2d_byte,
            "dram": dram_b * tech.e_dram_byte,
        }
        ge = GroupEval(delay_s=delay, energy_j=sum(e.values()),
                       stage_time_s=stage, n_passes=n_passes, depth=depth,
                       bottleneck=bottleneck, glb_overflow_bytes=overflow,
                       energy_breakdown=e)
        return ge, an


    def eval_requests_batch(self, requests: Sequence[Tuple[LayerGroup, LMS]],
                            total_batch: int, backend: str = "numpy"
                            ) -> List[Tuple[GroupEval, GroupAnalysis]]:
        """Evaluate a mixed batch of (group, lms) requests in ONE pass.

        With the default ``backend="numpy"``, row ``b`` equals the
        reference's batched row to the bit, and ``eval_group(*requests[b],
        total_batch)`` within an ulp: the batched analyzer replays every
        request's contribution stream in the scalar order (disjoint buffer
        rows, one ``np.bincount``, so the analyses are the scalar ones to
        the bit), and the delay/energy math below mirrors the scalar path
        operation for operation along a leading batch axis, except the
        energy total: the scalar path's ``sum(e.values())`` is compensated
        on Python 3.12, the explicit left-to-right adds here are not.

        ``backend="fused"`` (the reference's ``"jax"``) instead runs the
        opt-in FUSED pass: batched construction feeds one ``fused_eval``
        launch that replays the streams and computes the delay/energy math
        (float32, ~1e-4 parity envelope, analyses are ``None`` in the
        returned tuples).  Winners must be re-scored by the exact engine.
        """
        if backend == "fused":
            return self._eval_requests_fused(requests, total_batch)
        if backend != "numpy":
            raise ValueError(f"unknown eval batch backend {backend!r}")
        arch, tech = self.arch, self.arch.tech
        ab = self.analyzer.analyze_requests(requests, total_batch)
        n_passes = np.array([max(1, -(-total_batch // grp.batch_unit))
                             for grp, _ in requests], dtype=np.int64)
        depth = np.array([self._group_depth(grp) for grp, _ in requests],
                         dtype=np.int64)

        core_time = ab.target(T_CORE_TIME)                   # (B, nc)
        glb_rw = ab.target(T_GLB_RW)                         # (B, 2)
        edge_tot = ab.target(T_EDGE) + ab.target(T_EDGE_AM)  # (B, ne)
        edge_noc = edge_tot[:, self._noc_idx]
        edge_d2d = edge_tot[:, self._d2d_idx]
        t_noc = (edge_noc / (arch.noc_bw * 1e9)).max(axis=1, initial=0.0)
        if self._has_d2d:
            t_d2d = (edge_d2d / (arch.d2d_bw * 1e9)).max(axis=1, initial=0.0)
        else:
            t_d2d = np.zeros(len(t_noc))
        dram_port_bw = arch.dram_bw / arch.n_dram * 1e9
        dram_tot = ab.target(T_DRAM) + ab.target(T_DRAM_AM)
        t_dram = (dram_tot / dram_port_bw).max(axis=1, initial=0.0)
        t_comp = core_time.max(axis=1, initial=0.0)
        times = np.stack([t_comp, t_noc, t_d2d, t_dram])     # (4, B)
        stage = np.maximum(times.max(axis=0), 1e-12)
        # np.argmax picks the FIRST of tied maxima — same tie-break as the
        # scalar path's strict-greater update loop
        b_idx = np.argmax(times, axis=0)

        over = np.maximum(ab.target(T_GLB) - arch.core_glb_bytes, 0.0)
        overflow = over.sum(axis=1)
        spill_dram = overflow * 2.0
        stage = stage * (1.0 + overflow / (arch.core_glb_bytes * arch.n_cores))
        stage = stage + spill_dram / (arch.dram_bw * 1e9)
        delay = stage * (n_passes + depth - 1)

        noc_bytes = edge_noc.sum(axis=1) * n_passes
        d2d_bytes = edge_d2d.sum(axis=1) * n_passes
        dram_b = ab.target(T_DRAM).sum(axis=1) * n_passes \
            + ab.weight_totals + spill_dram * n_passes
        macs_total = ab.target(T_CORE_MACS).sum(axis=1) * n_passes
        e_mac = macs_total * tech.e_mac
        e_glb = (glb_rw[:, 0] + glb_rw[:, 1]
                 + ab.target(T_CORE_IN).sum(axis=1)) * n_passes \
            * tech.e_glb_byte
        e_noc = (noc_bytes + d2d_bytes) * tech.e_noc_hop_byte
        e_d2d = d2d_bytes * tech.e_d2d_byte
        e_dram = dram_b * tech.e_dram_byte
        # same association order as the scalar path's sum(e.values())
        energy = ((((e_mac + e_glb) + e_noc) + e_d2d) + e_dram)

        names = ("compute", "noc", "d2d", "dram")
        out: List[Tuple[GroupEval, GroupAnalysis]] = []
        for b, an in enumerate(ab.analyses):
            ge = GroupEval(
                delay_s=float(delay[b]), energy_j=float(energy[b]),
                stage_time_s=float(stage[b]), n_passes=int(n_passes[b]),
                depth=int(depth[b]),
                bottleneck=names[int(b_idx[b])],
                glb_overflow_bytes=float(overflow[b]),
                energy_breakdown={
                    "mac": float(e_mac[b]), "glb": float(e_glb[b]),
                    "noc": float(e_noc[b]), "d2d": float(e_d2d[b]),
                    "dram": float(e_dram[b])})
            out.append((ge, an))
        return out

    def _fused_inputs(self, requests: Sequence[Tuple[LayerGroup, LMS]],
                      total_batch: int):
        """The fused pass's inputs for a batch, written into the staging
        buffer of :meth:`fused_plan`: a
        :class:`~repro_torch.kernels.fused_eval.FusedInputs` of numpy
        views ``(off int32, idx int32, vals f32, npass int32, depth int32,
        weight totals f32)``.

        Construction is the same batched engine the exact path uses
        (``_prefetch_contribs`` + cached ``row_stream`` downcasts).  Each
        row's stream keeps its row-local cell indices; the B + 1 offsets
        say where each row's entries start.  Nothing is padded: the
        reference pads to power-of-two lengths so that ``jit`` retraces
        stay rare, and a CUDA launch has no trace to keep."""
        an = self.analyzer
        an._prefetch_contribs(requests, total_batch)
        streams = [an.row_stream(grp, lms, total_batch)
                   for grp, lms in requests]
        x = self.fused_plan().stage(len(requests),
                                    sum(i.size for i, _, _ in streams))
        x.off[0] = end = 0
        for b, ((grp, _), (i, v, wt)) in enumerate(zip(requests, streams)):
            start, end = end, end + i.size
            x.idx[start:end] = i
            x.vals[start:end] = v
            x.off[b + 1] = end
            x.wts[b] = wt
            x.npass[b] = max(1, -(-total_batch // grp.batch_unit))
            x.depth[b] = self._group_depth(grp)
        return x

    def fused_plan(self):
        """This evaluator's :class:`~repro_torch.kernels.fused_eval.
        FusedEvalPlan` on ``fused_device``, uploaded on first use (raises
        for the card when there is none)."""
        if self._fused_plan is None:
            from ..kernels.fused_eval import FusedEvalPlan
            an = self.analyzer
            self._fused_plan = FusedEvalPlan.build(
                an._layout, an._buf_len, self._is_d2d, self.arch,
                self.fused_device)
        return self._fused_plan

    def _eval_requests_fused(self, requests: Sequence[Tuple[LayerGroup, LMS]],
                             total_batch: int
                             ) -> List[Tuple[GroupEval, GroupAnalysis]]:
        """The fused construct->replay->eval pass (``backend="fused"``):
        :meth:`_fused_inputs` fills the plan's staging buffer, then
        :func:`~repro_torch.kernels.fused_eval.evaluate_rows` runs the
        replay and the entire delay/energy pipeline as ONE ``fused_eval``
        launch on ``fused_device`` (on the card: one copy there, the
        launch, one copy back).

        Returns ``(GroupEval, None)`` tuples: the fused path never
        materializes per-row :class:`GroupAnalysis` views.  Results carry
        a ~1e-4 relative envelope vs the exact engine (float32 math,
        summed in another order) — winners must be re-scored exactly.
        """
        if not requests:
            return []
        from ..kernels.fused_eval import evaluate_rows
        x = self._fused_inputs(requests, total_batch)
        npass, dep = x.npass.tolist(), x.depth.tolist()
        out = evaluate_rows(self.fused_plan(), x)
        names = ("compute", "noc", "d2d", "dram")
        ekeys = ("mac", "glb", "noc", "d2d", "dram")
        delay, energy, stage, over, bn, parts = (
            a.tolist() for a in (out.delay, out.energy, out.stage,
                                 out.overflow, out.bottleneck,
                                 out.energy_parts.T))
        res: List[Tuple[GroupEval, GroupAnalysis]] = []
        for b in range(len(requests)):
            ge = GroupEval(
                delay_s=delay[b], energy_j=energy[b], stage_time_s=stage[b],
                n_passes=npass[b], depth=dep[b], bottleneck=names[bn[b]],
                glb_overflow_bytes=over[b],
                energy_breakdown=dict(zip(ekeys, parts[b])))
            res.append((ge, None))
        return res

    def eval_group_batch(self, group: LayerGroup, lms_list: Sequence[LMS],
                         total_batch: int, backend: str = "numpy"
                         ) -> List[Tuple[GroupEval, GroupAnalysis]]:
        """Evaluate B mappings of ONE group in a single vectorized pass
        (:meth:`eval_requests_batch` with a constant group)."""
        return self.eval_requests_batch([(group, lms) for lms in lms_list],
                                        total_batch, backend=backend)

    # ------------------------------------------------------------------
    def eval_groups_batched(self, requests: Sequence[Tuple[LayerGroup, LMS]],
                            total_batch: int, backend: str = "numpy"
                            ) -> List[Tuple[GroupEval, GroupAnalysis]]:
        """Evaluate a mixed batch of (group, lms) requests.

        Requests are deduplicated and run through ONE
        :meth:`eval_requests_batch` pass (layer groups may mix — the
        accumulator layout is per-arch).  Results are returned in request
        order; ``backend="fused"`` routes through the fused parity-grade
        pass instead of the exact one.
        """
        keyed = [(grp.names, grp.batch_unit, lms.cache_key())
                 for grp, lms in requests]
        distinct: "OrderedDict[Tuple, Tuple[LayerGroup, LMS]]" = OrderedDict()
        for req, key in zip(requests, keyed):
            if key not in distinct:
                distinct[key] = req
        results = dict(zip(distinct,
                           self.eval_requests_batch(list(distinct.values()),
                                                    total_batch,
                                                    backend=backend)))
        return [results[key] for key in keyed]

    # ------------------------------------------------------------------
    def eval_mapping_archs(self, mapping: Sequence[Tuple[LayerGroup, LMS]],
                           total_batch: int, archs: Sequence[ArchConfig]
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """(energy (C,), delay (C,)) of ONE mapping under C archs that share
        this evaluator's :func:`analysis_signature` (i.e. differ only in the
        noc/d2d/dram bandwidths).

        The analysis — and therefore the energy — is computed once; only
        the per-candidate delay terms are re-derived, vectorized over the
        bandwidth columns.  Each column is bit-identical to evaluating the
        mapping under that arch with its own scalar evaluator: traffic
        maxima are reduced BEFORE the bandwidth division, which is exact
        because the numerators are non-negative byte counts and float
        division by a positive constant is monotone non-decreasing, so
        ``max_i fl(a_i / c) == fl(max_i a_i / c)`` bit-for-bit.

        The per-group terms are summed as :meth:`evaluate` sums them, with
        the built-in ``sum`` over Python floats in group order.  The
        reference adds them into a numpy array instead, which on Python
        3.12, whose ``sum`` of floats is compensated, differs from its own
        scalar path in the last bit.
        """
        sig = analysis_signature(self.arch)
        for arch in archs:
            if analysis_signature(arch) != sig:
                raise ValueError(
                    f"arch {arch.label()} does not share the analysis "
                    f"signature of {self.arch.label()}; only bandwidth "
                    "fields may differ")
        C = len(archs)
        noc_div = np.array([a.noc_bw * 1e9 for a in archs])
        d2d_div = np.array([a.d2d_bw * 1e9 for a in archs])
        dram_port_div = np.array([a.dram_bw / a.n_dram * 1e9 for a in archs])
        dram_div = np.array([a.dram_bw * 1e9 for a in archs])
        glb_pen_div = self.arch.core_glb_bytes * self.arch.n_cores
        energies: List[float] = []
        delays: List[np.ndarray] = []
        for group, lms in mapping:
            ge, an = self.eval_group(group, lms, total_batch)
            edge_tot = an.edge_bytes + an.edge_bytes_amortized
            t_noc = float(edge_tot[self._not_d2d].max(initial=0.0)) / noc_div
            if self._has_d2d:
                t_d2d = float(edge_tot[self._is_d2d].max(initial=0.0)) \
                    / d2d_div
            else:
                t_d2d = np.zeros(C)
            m_dram = float((an.dram_bytes
                            + an.dram_bytes_amortized).max(initial=0.0))
            t_dram = m_dram / dram_port_div
            t_comp = float(an.core_time_s.max(initial=0.0))
            stage = np.maximum(
                np.maximum(np.maximum(np.maximum(t_comp, t_noc), t_d2d),
                           t_dram), 1e-12)
            overflow = ge.glb_overflow_bytes
            spill_dram = overflow * 2.0
            stage = stage * (1.0 + overflow / glb_pen_div)
            stage = stage + spill_dram / dram_div
            delays.append(stage * (ge.n_passes + ge.depth - 1))
            energies.append(ge.energy_j)    # energy never reads a bandwidth
        E = np.full(C, float(sum(energies)))
        D = np.array([sum(float(d[c]) for d in delays) for c in range(C)])
        return E, D

    # ------------------------------------------------------------------
    def traffic_summary(self, group: LayerGroup, lms: LMS,
                        total_batch: int) -> Dict[str, float]:
        """Per-pass traffic totals of one group, split by physical axis.

        The realization subsystem diffs these against the measured traffic
        of the compiled stage program (``repro.realize.measure``); the keys
        mirror the measured axes: MACs doubled to FLOPs, NoC vs D2D link
        bytes (amortized weight loads included), DRAM bytes per pass.
        """
        ge, an = self.eval_group(group, lms, total_batch)
        edge_tot = an.edge_bytes + an.edge_bytes_amortized
        return {
            "flops": 2.0 * float(an.core_macs.sum()),
            "noc_bytes": float(edge_tot[self._not_d2d].sum()),
            "d2d_bytes": float(edge_tot[self._is_d2d].sum()),
            "dram_bytes": float((an.dram_bytes
                                 + an.dram_bytes_amortized).sum()),
            "delay_s": ge.delay_s,
            "energy_j": ge.energy_j,
            "glb_overflow_bytes": ge.glb_overflow_bytes,
        }

    # ------------------------------------------------------------------
    def evaluate(self, mapping: Sequence[Tuple[LayerGroup, LMS]],
                 total_batch: int) -> EvalResult:
        groups: List[GroupEval] = []
        analyses: List[GroupAnalysis] = []
        for group, lms in mapping:
            ge, an = self.eval_group(group, lms, total_batch)
            groups.append(ge)
            analyses.append(an)
        return EvalResult(
            delay_s=sum(ge.delay_s for ge in groups),
            energy_j=sum(ge.energy_j for ge in groups),
            groups=groups, analyses=analyses)



class CachedEvaluator(Evaluator):
    """Content-addressed ``GroupEval`` cache on top of :class:`Evaluator`.

    Key: ``(group id, LMS cache key, total_batch)`` where the group id is the
    (names, batch_unit) pair.  An LMS is frozen, so a cached entry can never
    go stale for a fixed (arch, graph).  Callers must treat the returned
    (GroupEval, GroupAnalysis) as immutable: the tuple is shared between
    cache hits.  If the arch or graph changes, build a new evaluator.
    Fused (``backend="fused"``) results live in a separate cache, so a
    parity-grade value never satisfies an exact lookup.
    """

    def __init__(self, arch: ArchConfig, g: Graph, maxsize: int = 20_000,
                 fused_device: str = "cuda"):
        super().__init__(arch, g, fused_device=fused_device)
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._cache: "OrderedDict[Tuple, Tuple[GroupEval, GroupAnalysis]]" \
            = OrderedDict()
        self._fused_cache: "OrderedDict[Tuple, Tuple[GroupEval, None]]" \
            = OrderedDict()

    def eval_group(self, group: LayerGroup, lms: LMS,
                   total_batch: int) -> Tuple[GroupEval, GroupAnalysis]:
        key = (group.names, group.batch_unit, lms.cache_key(), total_batch)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            CACHE_STATS["group_eval.hits"] += 1
            return hit
        self.misses += 1
        CACHE_STATS["group_eval.misses"] += 1
        out = super().eval_group(group, lms, total_batch)
        self._cache[key] = out
        if len(self._cache) > self.maxsize:
            self._cache.popitem(last=False)
            CACHE_STATS["group_eval.evictions"] += 1
        return out

    def eval_groups_batched(self, requests: Sequence[Tuple[LayerGroup, LMS]],
                            total_batch: int, backend: str = "numpy"
                            ) -> List[Tuple[GroupEval, GroupAnalysis]]:
        """Cache-aware batch: hits resolve from the content cache, misses
        run through the vectorized batch path and are inserted under the
        keys :meth:`eval_group` uses (values within an ulp of its own, as
        in the reference, so a later scalar call returns the batched
        value).  Fused
        (``backend="fused"``) results resolve against a separate cache —
        parity-grade values never leak into exact-path lookups."""
        cache = self._fused_cache if backend == "fused" else self._cache
        stats = "group_eval_fused" if backend == "fused" else "group_eval"
        keys = [(grp.names, grp.batch_unit, lms.cache_key(), total_batch)
                for grp, lms in requests]
        out: List[Optional[Tuple[GroupEval, GroupAnalysis]]] \
            = [None] * len(requests)
        fresh: Dict[Tuple, Tuple[GroupEval, GroupAnalysis]] = {}
        miss_reqs: List[Tuple[LayerGroup, LMS]] = []
        miss_keys: List[Tuple] = []
        n_hits = 0
        for i, key in enumerate(keys):
            hit = cache.get(key)
            if hit is not None:
                cache.move_to_end(key)
                n_hits += 1
                out[i] = hit
            elif key not in fresh:
                fresh[key] = None          # claimed; filled below
                miss_reqs.append(requests[i])
                miss_keys.append(key)
            else:
                n_hits += 1                # duplicate of an in-batch miss
        self.hits += n_hits
        CACHE_STATS[stats + ".hits"] += n_hits
        if miss_reqs:
            self.misses += len(miss_reqs)
            CACHE_STATS[stats + ".misses"] += len(miss_reqs)
            for key, res in zip(miss_keys,
                                self.eval_requests_batch(miss_reqs,
                                                         total_batch,
                                                         backend=backend)):
                fresh[key] = res
                cache[key] = res
                if len(cache) > self.maxsize:
                    cache.popitem(last=False)
                    CACHE_STATS[stats + ".evictions"] += 1
        for i, key in enumerate(keys):
            if out[i] is None:
                out[i] = fresh[key]
        return out

    def cache_info(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._cache)}


# ---------------------------------------------------------------------------
# Per-process evaluator registry
# ---------------------------------------------------------------------------

# (ArchConfig, id(graph), fused device) -> CachedEvaluator.  Each entry holds its Graph
# strongly (Evaluator.g), so a live entry's id() can never be recycled; the
# key is only ever compared while the entry is alive.
_REGISTRY: "OrderedDict[Tuple[ArchConfig, int, str], CachedEvaluator]" \
    = OrderedDict()
_REGISTRY_MAX = 8


def evaluator_for(arch: ArchConfig, g: Graph, maxsize: int = 20_000,
                  fused_device: str = "cuda") -> CachedEvaluator:
    """Process-local LRU registry of :class:`CachedEvaluator` instances:
    the same ``(arch, graph)`` re-scored within the last ``_REGISTRY_MAX``
    distinct architectures reuses its evaluator and caches.  Reuse is pure
    memoization: values are identical whether or not an entry was found.
    ``fused_device`` is the device of the fused pass (see
    :class:`Evaluator`); it is part of the key."""
    key = (arch, id(g), fused_device)
    ev = _REGISTRY.get(key)
    if ev is None:
        ev = CachedEvaluator(arch, g, maxsize=maxsize,
                             fused_device=fused_device)
        _REGISTRY[key] = ev
        if len(_REGISTRY) > _REGISTRY_MAX:
            _REGISTRY.popitem(last=False)
    else:
        _REGISTRY.move_to_end(key)
    return ev
