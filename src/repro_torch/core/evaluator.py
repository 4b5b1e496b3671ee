"""Delay + energy evaluation of a mapped DNN (paper Sec. V-B2, SET-style).

Reduced copy of the scalar path of ``src/repro/core/evaluator.py``:
``analysis_signature`` (``:43``), ``GroupEval``, ``EvalResult`` (with
``cost``, ``:93``), ``_pipeline_depth``, ``Evaluator`` with ``eval_group``
(``:221``), the bandwidth-vectorized ``eval_mapping_archs`` (``:481``),
``traffic_summary`` (``:540``) and ``evaluate`` (``:563``),
``CachedEvaluator.eval_group`` and ``evaluator_for`` (``:687``).  The
arithmetic is the reference's, float64 and in the same order, so every
``GroupEval`` equals the reference's scalar one.  The batched and fused
(jitted) paths belong to the fused-evaluator item of the port's roadmap;
the port's copy records no metrics.

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
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .analyzer import Analyzer, GroupAnalysis, router_grid
from .encoding import LMS
from .hw import ArchConfig
from .workload import Graph, LayerGroup


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
    """Per-(arch, graph) evaluator; reuses the Analyzer and its caches."""

    def __init__(self, arch: ArchConfig, g: Graph):
        self.arch = arch
        self.g = g
        self.analyzer = Analyzer(arch, g)
        self.grid = router_grid(arch)
        self._is_d2d = self.grid.edge_is_d2d
        self._not_d2d = ~self._is_d2d
        self._has_d2d = bool(self._is_d2d.any())
        self._depth_cache: Dict[Tuple[str, ...], int] = {}

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
    """

    def __init__(self, arch: ArchConfig, g: Graph, maxsize: int = 20_000):
        super().__init__(arch, g)
        self.maxsize = maxsize
        self._cache: "OrderedDict[Tuple, Tuple[GroupEval, GroupAnalysis]]" \
            = OrderedDict()

    def eval_group(self, group: LayerGroup, lms: LMS,
                   total_batch: int) -> Tuple[GroupEval, GroupAnalysis]:
        key = (group.names, group.batch_unit, lms.cache_key(), total_batch)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            return hit
        out = super().eval_group(group, lms, total_batch)
        self._cache[key] = out
        if len(self._cache) > self.maxsize:
            self._cache.popitem(last=False)
        return out


# ---------------------------------------------------------------------------
# Per-process evaluator registry
# ---------------------------------------------------------------------------

# (ArchConfig, id(graph)) -> CachedEvaluator.  Each entry holds its Graph
# strongly (Evaluator.g), so a live entry's id() can never be recycled; the
# key is only ever compared while the entry is alive.
_REGISTRY: "OrderedDict[Tuple[ArchConfig, int], CachedEvaluator]" \
    = OrderedDict()
_REGISTRY_MAX = 8


def evaluator_for(arch: ArchConfig, g: Graph,
                  maxsize: int = 20_000) -> CachedEvaluator:
    """Process-local LRU registry of :class:`CachedEvaluator` instances:
    the same ``(arch, graph)`` re-scored within the last ``_REGISTRY_MAX``
    distinct architectures reuses its evaluator and caches.  Reuse is pure
    memoization: values are identical whether or not an entry was found."""
    key = (arch, id(g))
    ev = _REGISTRY.get(key)
    if ev is None:
        ev = CachedEvaluator(arch, g, maxsize=maxsize)
        _REGISTRY[key] = ev
        if len(_REGISTRY) > _REGISTRY_MAX:
            _REGISTRY.popitem(last=False)
    else:
        _REGISTRY.move_to_end(key)
    return ev
