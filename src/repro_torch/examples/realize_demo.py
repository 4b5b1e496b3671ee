"""Close the co-exploration loop on one card: keep_mappings DSE checkpoint
-> stage plans -> stage programs on the device -> measured-vs-predicted
report -> Tech overlay -> measured-calibrated second DSE pass.

Port of ``examples/realize_demo.py``, with the same steps and ``[demo]``
lines.  It runs on the card unless the caller asks for the CPU:

  PYTHONPATH=src python -m repro_torch.examples.realize_demo
  PYTHONPATH=src python -m repro_torch.examples.realize_demo --device cpu

The defaults are the reference demo's: a one-layer transformer (d_model
64, d_ff 128, seq 32) and two 4-core candidates, one monolithic and one of
two chiplets.  :func:`close_loop` is the loop itself; ``chip_smoke.py``
calls it at the paper's width.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Sequence, Union

import torch

from ..core.dse import DSEConfig, DSEPoint, run_dse
from ..core.explore import ResumableSweep, candidate_key
from ..core.hw import ArchConfig
from ..core.sa import SAConfig
from ..core.workload import Graph
from ..core.workloads import transformer
from ..kernels.flash_attention import flash_attention_mha
from ..kernels.mamba_ssd import ssd_chunk_dual
from ..kernels.ssd_state import (ssd_state_out, ssd_state_scan,
                                 ssd_state_walk)
from ..kernels.tiled_matmul import tiled_matmul
from ..realize.calibrate import (TechOverlay, calibrated_candidates,
                                 fit_overlay)
from ..realize.measure import RealizationReport, measure_candidate
from ..realize.plan import (RealizeCandidate, load_realize_candidates,
                            plans_for)
from ..realize.program import RealizedProgram, build_program, resolve_device

CKPT = "results/realize_demo-torch.ckpt.jsonl"
OUT = "results/realize_demo-torch.jsonl"

# each kernel's wrapper counts the launches it makes on the card
_WRAPPERS = {"tiled_matmul": tiled_matmul,
             "flash_attention_mha": flash_attention_mha,
             "ssd_chunk_dual": ssd_chunk_dual,
             "ssd_state_walk": ssd_state_walk,
             "ssd_state_scan": ssd_state_scan,
             "ssd_state_out": ssd_state_out}


def demo_graph() -> Graph:
    return transformer(n_layers=1, d_model=64, d_ff=128, seq=32,
                       name="tf-demo")


def demo_candidates() -> List[ArchConfig]:
    return [
        ArchConfig(x_cores=2, y_cores=2, xcut=1, ycut=1, noc_bw=32,
                   d2d_bw=16, dram_bw=64, glb_kb=512, macs_per_core=1024),
        ArchConfig(x_cores=2, y_cores=2, xcut=2, ycut=1, noc_bw=32,
                   d2d_bw=16, dram_bw=64, glb_kb=512, macs_per_core=1024),
    ]


def demo_config() -> DSEConfig:
    return DSEConfig(batch=4, sa=SAConfig(iters=120, seed=0),
                     keep_mappings=True)


@dataclass
class Realized:
    """One candidate realized on the device and measured."""
    candidate: RealizeCandidate
    program: RealizedProgram
    report: RealizationReport
    launches: Dict[str, int]          # counted on the card; 0 on the CPU
    seconds: float                    # build + predict + run, host clock


@dataclass
class LoopResult:
    baseline: List[DSEPoint]
    realized: List[Realized]
    overlay: TechOverlay
    identity: List[DSEPoint]
    calibrated: List[DSEPoint]
    # host seconds of the three DSE passes
    dse_s: Dict[str, float] = field(default_factory=dict)
    # candidate_key of the input arch -> (baseline, calibrated) objective
    rows: Dict[str, tuple] = field(default_factory=dict)
    ranking_changed: bool = False


def _timed_dse(cands, workloads, cfg, **kw):
    t0 = time.perf_counter()
    pts = run_dse(cands, workloads, cfg, **kw)
    return pts, time.perf_counter() - t0


def close_loop(workloads: Dict[str, Graph], cands: Sequence[ArchConfig],
               cfg: DSEConfig, device: Union[str, torch.device] = "cuda",
               top: int = 2, ckpt: Union[str, Path] = CKPT,
               out: Union[str, Path] = OUT) -> LoopResult:
    """Run the paper's loop once; raise if the identity overlay's second
    pass is not bit-identical to the baseline."""
    device = resolve_device(device)
    ckpt, out = Path(ckpt), Path(out)
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    for p in (ckpt, out):
        p.unlink(missing_ok=True)          # the demo measures from scratch

    # -- 1. a keep_mappings DSE with a checkpoint ---------------------------
    baseline, dse_s = _timed_dse(cands, workloads, cfg, checkpoint=ckpt)
    print(f"[demo] DSE over {len(cands)} candidates ({dse_s:.1f}s); "
          f"best {baseline[0].arch.label()}")

    # -- 2. realize: checkpoint -> plans -> stage programs on the device ----
    rcands = load_realize_candidates(ckpt, workloads, top=top)
    sweep = ResumableSweep(out, f"realize-torch-demo:v1:device={device.type}")
    realized: List[Realized] = []
    for cand, plan in plans_for(rcands):
        t0 = time.perf_counter()
        before = {k: fn.launches for k, fn in _WRAPPERS.items()}
        prog = build_program(cand.graph, plan, device=device)
        rep = measure_candidate(cand, prog, execute=True)
        launches = {k: fn.launches - before[k] for k, fn in _WRAPPERS.items()}
        seconds = time.perf_counter() - t0
        realized.append(Realized(cand, prog, rep, launches, seconds))
        sweep.add(cand.key, rep.to_record())
        tot = rep.totals()
        print(f"[demo] realized {cand.arch.label()}: "
              f"{len(plan.stages)} stages on "
              f"{plan.n_devices_needed} devices "
              f"({seconds:.1f}s, wall {tot['wall_s']*1e3:.0f}ms); "
              f"measured/predicted geomean: "
              + "  ".join(f"{k}={v:.3g}"
                          for k, v in sorted(rep.ratio_summary().items())))

    # -- 3. calibrate + second pass -----------------------------------------
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    overlay = fit_overlay([r.report for r in realized],
                          source=f"repro_torch:realize_demo|device={name}")
    print(f"[demo] Tech overlay: f_d2d={overlay.f_d2d:.3g} "
          f"f_noc={overlay.f_noc:.3g} f_dram={overlay.f_dram:.3g} "
          f"(evidence: {overlay.n_stages} stages)")

    same, same_s = _timed_dse(calibrated_candidates(cands, TechOverlay()),
                              workloads, cfg)
    if [p.objective for p in same] != [p.objective for p in baseline]:
        raise AssertionError("identity overlay changed the DSE: "
                             f"{[p.objective for p in same]} != "
                             f"{[p.objective for p in baseline]}")
    print("[demo] identity overlay: second pass bit-identical to baseline "
          "(calibration off => no behavior change)")

    cal_cands = calibrated_candidates(cands, overlay)
    cal, cal_s = _timed_dse(cal_cands, workloads, cfg)
    # both lists are sorted by their own objective: pair rows by the input
    # arch's candidate_key (a label does not show how a grid is cut, and a
    # calibrated arch's key names its calibrated tech)
    key_of = {candidate_key(c): candidate_key(a)
              for a, c in zip(cands, cal_cands)}
    cal_by_key = {key_of[candidate_key(p.arch)]: p.objective for p in cal}
    rows = {candidate_key(b.arch): (b.objective,
                                    cal_by_key[candidate_key(b.arch)])
            for b in baseline}
    print(f"{'arch':42s} {'baseline obj':>14s} {'calibrated obj':>15s}")
    for b in baseline:
        base_obj, cal_obj = rows[candidate_key(b.arch)]
        print(f"{b.arch.label():42s} {base_obj:14.4e} {cal_obj:15.4e}")
    flip = ([candidate_key(p.arch) for p in baseline]
            != [key_of[candidate_key(p.arch)] for p in cal])
    print(f"[demo] measured-calibrated costs "
          f"{'re-ranked the candidates' if flip else 'kept the ranking'}; "
          f"report -> {out}")
    return LoopResult(baseline=baseline, realized=realized, overlay=overlay,
                      identity=same, calibrated=cal,
                      dse_s={"baseline": dse_s, "identity": same_s,
                             "calibrated": cal_s},
                      rows=rows, ranking_changed=flip)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="close the co-exploration loop on the reference demo's "
                    "graph and candidates")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; the hand-written kernels) or "
                    "'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    close_loop({"TF": demo_graph()}, demo_candidates(), demo_config(),
               device=args.device)


if __name__ == "__main__":
    main()
