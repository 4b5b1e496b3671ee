"""Measured-vs-predicted report (realization stage 3).

Port of ``src/repro/realize/measure.py``; ``StageReport`` and
``RealizationReport`` keep the reference's field names and record layout.

**Predicted side** (``:166-228`` of the reference): one
:func:`repro_torch.core.evaluator.evaluator_for` per candidate, and per
stage ``traffic_summary(group, lms, group.batch_unit)`` of the stage's
(group, LMS) — one pipeline pass, weight loads unamortized, the exact
call the reference makes — into the seven ``pred_*`` fields.  It is host
numpy, float64, and equals the reference's to the bit; it runs before the
stages execute, outside their timed CUDA events, and
``RealizationReport.predict_s`` records its host seconds.  A scaled
(expected-traffic) graph, a routed MoE, executes its dense-equivalent
cubes, so its measured side is multiplied per stage by the per-axis factor
``pred_scaled / pred_dense`` of a
:func:`repro_torch.core.workload.dense_twin` evaluation of the same LMS, as
in the reference (``expected_scale``); a dense graph is its own twin and
takes no factor.

**Measured side.**  The reference reads FLOPs and HBM bytes from compiled
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
* ``ici_bytes``: 0.

**Where the measured side counts differently from the reference's HLO
walk**, and what calibration makes of it:

* ``ici_bytes`` stays 0: a stage's logical grid lives on one card, which
  runs no collectives.  The reshards of the logical grid are not counted
  as ICI; that would be a model of traffic, not a measurement.  So no
  stage has a ``noc_bytes`` ratio, and the fitted ``f_noc`` stays 1.0 by
  ``fit_overlay``'s rule for an axis with no evidence.
* ``hbm_bytes`` counts each kernel operand once, not the compiled
  program's HBM bytes with its eager glue, so the fitted ``f_dram`` is on
  the port's own scale.  An overlay the port fits names ``repro_torch:``
  and the device in its ``source``.
* ``flops`` counts only the pairs the masks keep; no factor is fitted from
  FLOPs, so the difference shows only in ``ratio_summary``.
* ``dci_bytes`` equals the reference's, so ``f_d2d``, the factor the paper
  calibrates, compares between the two packages.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np

from ..core.evaluator import evaluator_for
from ..core.workload import dense_twin
from .plan import RealizeCandidate
from .program import RealizedProgram

F32_BYTES = 4


def attention_pairs(Sq: int, Sk: int, causal: bool,
                    q_offset: int = 0) -> int:
    """(query, key) pairs attention scores: all of them, or with the
    causal mask (k_pos <= q_offset + q_pos, both from 0) those it keeps."""
    if not causal:
        return Sq * Sk
    # query i keeps min(Sk, q_offset + i + 1) keys
    full = max(0, min(Sq, Sk - q_offset))       # rows below the last key
    n0 = q_offset + 1
    return full * n0 + full * (full - 1) // 2 + (Sq - full) * Sk


def launch_cost(kernel: str, shape: Dict[str, int]) -> Tuple[float, float]:
    """(FLOPs, bytes moved) of one f32 kernel launch of ``shape``."""
    if kernel == "tiled_matmul":
        M, K, N = shape["M"], shape["K"], shape["N"]
        return 2.0 * M * N * K, float(F32_BYTES * (M * K + K * N + M * N))
    if kernel == "flash_attention_mha":
        B, H, Sq, Sk, D = (shape[k] for k in ("B", "H", "Sq", "Sk", "D"))
        pairs = attention_pairs(Sq, Sk, bool(shape["causal"]),
                                shape.get("q_offset", 0))
        return (4.0 * B * H * D * pairs,
                float(F32_BYTES * B * H * D * (2 * Sq + 2 * Sk)))
    if kernel == "ssd_chunk_dual":
        BC, Q, H, P, N = (shape[k] for k in ("BC", "Q", "H", "P", "N"))
        T = attention_pairs(Q, Q, True)
        return (2.0 * BC * (T * N + T * H * P + Q * H * N * P),
                float(F32_BYTES * BC * (2 * Q * H * P + Q * H + 2 * Q * N
                                        + H * N * P)))
    if kernel == "ssd_state_pass":
        B, nc, Q, H, P, N, G = (shape[k] for k in
                                ("B", "nc", "Q", "H", "P", "N", "G"))
        init = shape.get("init", 0)
        # y_inter = C . h (Q x N x P a head and chunk), the exp scale and
        # the add, the state update; y_intra in, y out, S, cum, C, the
        # final state (and the initial one) once each
        return (2.0 * B * nc * H * (Q * N * P + Q * P + N * P),
                float(F32_BYTES * (2 * B * nc * Q * H * P + B * nc * H * N * P
                                   + B * nc * Q * H + B * nc * Q * G * N
                                   + (1 + init) * B * H * N * P)))
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
    # predicted (analytical, one pass)
    pred_flops: float = 0.0
    pred_dram_bytes: float = 0.0
    pred_noc_bytes: float = 0.0
    pred_d2d_bytes: float = 0.0
    pred_delay_s: float = 0.0
    pred_energy_j: float = 0.0
    pred_glb_overflow: float = 0.0
    # expected-traffic factors applied to the measured side (scaled graphs
    # only; empty for dense graphs — see module docstring)
    expected_scale: Dict[str, float] = field(default_factory=dict)

    def ratios(self) -> Dict[str, float]:
        """measured / predicted per axis; only well-defined pairs appear."""
        out: Dict[str, float] = {}
        for key, meas, pred in (
                ("flops", self.flops, self.pred_flops),
                ("dram_bytes", self.hbm_bytes, self.pred_dram_bytes),
                ("noc_bytes", self.ici_bytes, self.pred_noc_bytes),
                ("d2d_bytes", self.dci_bytes, self.pred_d2d_bytes)):
            if pred > 0 and meas > 0:
                out[key] = meas / pred
        return out

    def to_record(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in (
            "index", "n_devices", "flops", "hbm_bytes", "ici_bytes",
            "dci_bytes", "temp_bytes", "arg_bytes", "compile_s", "wall_s",
            "pred_flops", "pred_dram_bytes", "pred_noc_bytes",
            "pred_d2d_bytes", "pred_delay_s", "pred_energy_j")}
        d["layers"] = list(self.layers)
        d["routes"] = dict(self.routes)
        d["coll_by_kind"] = dict(self.coll_by_kind)
        d["ratios"] = self.ratios()
        if self.expected_scale:        # dense records keep their shape
            d["expected_scale"] = dict(self.expected_scale)
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
    predict_s: float = 0.0             # host seconds of the predicted side

    def totals(self) -> Dict[str, float]:
        t: Dict[str, float] = {}
        for f in ("flops", "hbm_bytes", "ici_bytes", "dci_bytes",
                  "pred_flops", "pred_dram_bytes", "pred_noc_bytes",
                  "pred_d2d_bytes", "wall_s", "compile_s"):
            t[f] = sum(getattr(s, f) for s in self.stages)
        return t

    def ratio_summary(self) -> Dict[str, float]:
        """Geometric-mean measured/predicted ratio per traffic axis."""
        acc: Dict[str, List[float]] = {}
        for s in self.stages:
            for k, v in s.ratios().items():
                acc.setdefault(k, []).append(v)
        return {k: float(np.exp(np.mean(np.log(v))))
                for k, v in acc.items()}

    def to_record(self) -> Dict[str, Any]:
        return {"workload": self.workload, "arch": self.arch_label,
                "tech": self.tech, "batch_unit": self.batch_unit,
                "pred_energy_j": self.pred_energy_j,
                "pred_delay_s": self.pred_delay_s,
                "predict_s": self.predict_s,
                "totals": self.totals(),
                "ratio_summary": self.ratio_summary(),
                "stages": [s.to_record() for s in self.stages]}


def measure_candidate(cand: RealizeCandidate, prog: RealizedProgram,
                      execute: bool = True, seed: int = 0
                      ) -> RealizationReport:
    """Predict and count one candidate's work per stage and, with
    ``execute``, run it once for wall time and DCI bytes.

    The predicted side re-runs the analytical evaluator on the candidate's
    own (arch, graph, LMS), the code path the DSE scored it with, so the
    diff isolates model-vs-measurement error, not drift."""
    t0 = time.perf_counter()
    ev = evaluator_for(cand.arch, cand.graph)
    twin = dense_twin(cand.graph)
    ev_dense = ev if twin is cand.graph else evaluator_for(cand.arch, twin)
    # total_batch = batch_unit: ONE pipeline pass, with weight loads
    # unamortized — what the realized stage executes
    preds = [ev.traffic_summary(grp, lms, grp.batch_unit)
             for grp, lms in cand.mapping]
    denses = None if ev_dense is ev else [
        ev_dense.traffic_summary(grp, lms, grp.batch_unit)
        for grp, lms in cand.mapping]
    predict_s = time.perf_counter() - t0
    reports: List[StageReport] = []
    for i, (sp, pred) in enumerate(zip(prog.stages, preds)):
        costs = [launch_cost(k, s) for k, s in sp.launches]
        meas = {"flops": sum(c[0] for c in costs),
                "hbm_bytes": sum(c[1] for c in costs), "ici_bytes": 0.0}
        esc: Dict[str, float] = {}
        if denses is not None:
            dense = denses[i]
            esc = {k: (pred[k] / dense[k]) if dense[k] > 0 else 1.0
                   for k in ("flops", "dram_bytes", "noc_bytes",
                             "d2d_bytes")}
            meas["flops"] *= esc["flops"]
            meas["hbm_bytes"] *= esc["dram_bytes"]
            meas["ici_bytes"] *= esc["noc_bytes"]
        reports.append(StageReport(
            index=sp.index, layers=sp.stage.layers, n_devices=sp.n_devices,
            routes=dict(sp.routes),
            flops=meas["flops"], hbm_bytes=meas["hbm_bytes"],
            ici_bytes=meas["ici_bytes"],
            pred_flops=pred["flops"],
            pred_dram_bytes=pred["dram_bytes"],
            pred_noc_bytes=pred["noc_bytes"],
            pred_d2d_bytes=pred["d2d_bytes"],
            pred_delay_s=pred["delay_s"],
            pred_energy_j=pred["energy_j"],
            pred_glb_overflow=pred["glb_overflow_bytes"],
            expected_scale=esc))
    if execute:
        run = prog.execute(seed=seed)
        for sr, wall, dci in zip(reports, run["wall_s"], run["dci_bytes"]):
            sr.wall_s = wall
            sr.dci_bytes = float(dci) * sr.expected_scale.get("d2d_bytes",
                                                              1.0)
    return RealizationReport(
        key=cand.key, workload=cand.workload, arch_label=cand.arch.label(),
        tech=cand.arch.tech.name, batch_unit=prog.batch_unit,
        stages=reports, pred_energy_j=cand.energy_j,
        pred_delay_s=cand.delay_s, predict_s=predict_s)
