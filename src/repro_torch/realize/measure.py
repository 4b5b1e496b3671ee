"""Measured side of the realization report (realization stage 3).

Port of the measured half of ``src/repro/realize/measure.py``;
``StageReport`` and ``RealizationReport`` keep the reference's field names
and record layout.  The reference reads FLOPs and HBM bytes from compiled
HLO; the port has no HLO, so it counts them per kernel launch from the
launch's shapes (:func:`launch_cost`):

* ``flops``: 2·M·N·K for a GEMM; 4·B·H·D·P for flash attention, its two
  products over the P (query, key) pairs the mask keeps
  (:func:`attention_pairs`).  The same count bounds the kernel in
  ``chip_smoke.py``.  The CUDA kernel skips kv tiles wholly past the causal
  diagonal, so it computes these pairs plus the masked part of each
  diagonal tile; the Pallas kernel computes every pair;
  2·BC·(T·N + T·H·P + Q·H·N·P) for the SSD chunk kernel, with
  T = Q(Q+1)/2 the (i, j <= i) pairs its causal decay keeps: the scores
  C·Bᵀ and the product with x over those pairs, and the chunk state over
  every row;
* ``hbm_bytes``: each operand read once plus the result written once;
* ``dci_bytes`` and ``wall_s``: from the executor
  (:meth:`..realize.program.RealizedProgram.execute`);
* ``ici_bytes``: 0.  A stage's logical grid lives on one card, which runs
  no collectives, so no intra-stage traffic is measured.

The predicted per-stage fields (``pred_*``) stay 0 until the cost model is
ported (ROADMAP queue 1, slice 3), and the measured/predicted ratios
(``ratios``, ``ratio_summary``) come with it; the candidate-level
``pred_energy_j`` and ``pred_delay_s`` come from the checkpoint record.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from .plan import RealizeCandidate
from .program import RealizedProgram

F32_BYTES = 4


def attention_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs attention scores: all of them, or with the
    top-left causal mask (k_pos <= q_pos, both from 0) those it keeps."""
    if not causal:
        return Sq * Sk
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + max(Sq - Sk, 0) * Sk


def launch_cost(kernel: str, shape: Dict[str, int]) -> Tuple[float, float]:
    """(FLOPs, bytes moved) of one f32 kernel launch of ``shape``."""
    if kernel == "tiled_matmul":
        M, K, N = shape["M"], shape["K"], shape["N"]
        return 2.0 * M * N * K, float(F32_BYTES * (M * K + K * N + M * N))
    if kernel == "flash_attention_mha":
        B, H, Sq, Sk, D = (shape[k] for k in ("B", "H", "Sq", "Sk", "D"))
        pairs = attention_pairs(Sq, Sk, bool(shape["causal"]))
        return (4.0 * B * H * D * pairs,
                float(F32_BYTES * B * H * D * (2 * Sq + 2 * Sk)))
    if kernel == "ssd_chunk_dual":
        BC, Q, H, P, N = (shape[k] for k in ("BC", "Q", "H", "P", "N"))
        T = attention_pairs(Q, Q, True)
        return (2.0 * BC * (T * N + T * H * P + Q * H * N * P),
                float(F32_BYTES * BC * (2 * Q * H * P + Q * H + 2 * Q * N
                                        + H * N * P)))
    raise KeyError(f"no cost model for kernel {kernel!r}")


@dataclass
class StageReport:
    """Measured and predicted traffic of one realized pipeline stage."""
    index: int
    layers: Tuple[str, ...]
    n_devices: int
    routes: Dict[str, str]
    # measured (one pass)
    flops: float = 0.0
    hbm_bytes: float = 0.0
    ici_bytes: float = 0.0             # one card: no collectives
    dci_bytes: float = 0.0             # inter-stage activation transfer
    coll_by_kind: Dict[str, float] = field(default_factory=dict)
    temp_bytes: float = 0.0
    arg_bytes: float = 0.0
    compile_s: float = 0.0             # eager: nothing is compiled
    wall_s: float = 0.0
    # predicted (analytical, one pass): not ported yet, stays 0
    pred_flops: float = 0.0
    pred_dram_bytes: float = 0.0
    pred_noc_bytes: float = 0.0
    pred_d2d_bytes: float = 0.0
    pred_delay_s: float = 0.0
    pred_energy_j: float = 0.0
    pred_glb_overflow: float = 0.0

    def to_record(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in (
            "index", "n_devices", "flops", "hbm_bytes", "ici_bytes",
            "dci_bytes", "temp_bytes", "arg_bytes", "compile_s", "wall_s",
            "pred_flops", "pred_dram_bytes", "pred_noc_bytes",
            "pred_d2d_bytes", "pred_delay_s", "pred_energy_j")}
        d["layers"] = list(self.layers)
        d["routes"] = dict(self.routes)
        d["coll_by_kind"] = dict(self.coll_by_kind)
        return d


@dataclass
class RealizationReport:
    """Full measured-vs-predicted record of one realized candidate."""
    key: str
    workload: str
    arch_label: str
    tech: str
    batch_unit: int
    stages: List[StageReport]
    pred_energy_j: float = 0.0         # checkpoint's analytical prediction
    pred_delay_s: float = 0.0

    def totals(self) -> Dict[str, float]:
        t: Dict[str, float] = {}
        for f in ("flops", "hbm_bytes", "ici_bytes", "dci_bytes",
                  "pred_flops", "pred_dram_bytes", "pred_noc_bytes",
                  "pred_d2d_bytes", "wall_s", "compile_s"):
            t[f] = sum(getattr(s, f) for s in self.stages)
        return t

    def to_record(self) -> Dict[str, Any]:
        return {"workload": self.workload, "arch": self.arch_label,
                "tech": self.tech, "batch_unit": self.batch_unit,
                "pred_energy_j": self.pred_energy_j,
                "pred_delay_s": self.pred_delay_s,
                "totals": self.totals(),
                "stages": [s.to_record() for s in self.stages]}


def measure_candidate(cand: RealizeCandidate, prog: RealizedProgram,
                      execute: bool = True, seed: int = 0
                      ) -> RealizationReport:
    """Count one candidate's kernel work per stage and, with ``execute``,
    run it once for wall time and DCI bytes."""
    reports: List[StageReport] = []
    for sp in prog.stages:
        costs = [launch_cost(k, s) for k, s in sp.launches]
        reports.append(StageReport(
            index=sp.index, layers=sp.stage.layers, n_devices=sp.n_devices,
            routes=dict(sp.routes),
            flops=sum(c[0] for c in costs),
            hbm_bytes=sum(c[1] for c in costs)))
    if execute:
        run = prog.execute(seed=seed)
        for sr, wall, dci in zip(reports, run["wall_s"], run["dci_bytes"]):
            sr.wall_s = wall
            sr.dci_bytes = float(dci)
    return RealizationReport(
        key=cand.key, workload=cand.workload, arch_label=cand.arch.label(),
        tech=cand.arch.tech.name, batch_unit=prog.batch_unit,
        stages=reports, pred_energy_j=cand.energy_j,
        pred_delay_s=cand.delay_s)
