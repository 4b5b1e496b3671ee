#!/usr/bin/env python3
"""The realization's on-chip traffic in mesh mode: each plan stage on its
ranks, the collective bytes the port's rule (the owner computes,
``repro_torch/realize/program.py``) moves, beside the NoC bytes the cost
model predicts, on the two plans PERF.md sets beside the reference's XLA
partitioning:

* ``tangram``: ``transformer:n_layers=1,d_model=64,d_ff=128,seq=32``
  mapped by T-Map as one group of batch unit 2 on a 4 x 3-core arch (the
  CPU parity test's), 12 ranks: one stage on 2 ranks, Part (1, 1, 2, 1);
* ``tf-paper``: the committed ``tf-paper`` simba fixture at Table I width,
  36 ranks: 37 stages on 18-36 ranks each.

Run from the root of a checkout:

    python3 benchmarks/port_mesh_traffic.py [--case tangram,tf-paper]
        [--device cuda|cpu]

Each case starts its ranks (``launch.mesh.start_local_ranks``, gloo, on
``--device``: by default the card, every rank sharing it, which raises
without one; ``--device cpu`` runs the ranks on the host instead) and
realizes the plan once through ``measure_candidate``, the kernels built
first on the card.  One
JSON line a case: per stage ``n_devices``, the collective bytes summed over
the stage's ranks (``ici_bytes``, by kind), ``pred_noc_bytes``, measured and
predicted FLOPs; the totals, the stages that bill ICI and
``ratio_summary``.  Wall times are not printed: with many ranks sharing a
host they time the sharing.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CASES = {"tangram": 12, "tf-paper": 36}
TANGRAM_SPEC = "transformer:n_layers=1,d_model=64,d_ff=128,seq=32,name=tf-par"


def _candidate(case: str):
    """The case's realization candidate (arch, graph, mapping)."""
    from repro_torch.core.hw import ArchConfig
    from repro_torch.core.tangram import tangram_map
    from repro_torch.core.workload import LayerGroup
    from repro_torch.core.workloads import make_workload
    from repro_torch.realize.plan import (RealizeCandidate,
                                          load_realize_candidates)
    if case == "tf-paper":
        fixture = ROOT / "tests" / "data" / "realize" \
            / "tf-paper.simba.ckpt.jsonl"
        cand, = load_realize_candidates(
            fixture, {"TF": make_workload("tf-paper")}, top=1,
            verbose=False)
        return cand
    arch = ArchConfig(x_cores=4, y_cores=3, xcut=2, ycut=1, noc_bw=32,
                      d2d_bw=16, dram_bw=64, glb_kb=1024, macs_per_core=1024)
    g = make_workload(TANGRAM_SPEC)
    mapping = tangram_map([LayerGroup(names=tuple(g.topo_order()),
                                      batch_unit=2)], g, arch)
    return RealizeCandidate(key="tangram", workload="TF", arch=arch,
                            mapping=mapping, graph=g, energy_j=0.0,
                            delay_s=0.0)


def rank_main(case: str, device: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.realize.measure import measure_candidate
    from repro_torch.realize.plan import plans_for
    from repro_torch.realize.program import build_program
    torch.set_num_threads(1)
    (cand, plan), = plans_for([_candidate(case)], dist.get_world_size())
    prog = build_program(cand.graph, plan, device=device,
                         mesh=range(dist.get_world_size()))
    rep = measure_candidate(cand, prog, execute=True)
    if dist.get_rank():
        return
    stages = [s.to_record() for s in rep.stages]
    kinds = {}
    for s in stages:
        for k, v in s["coll_by_kind"].items():
            kinds[k] = kinds.get(k, 0.0) + v
    totals = rep.totals()
    Path(out).write_text(json.dumps({
        "case": case, "ranks": dist.get_world_size(), "device": device,
        "arch": rep.arch_label, "batch_unit": rep.batch_unit,
        "stages": len(stages),
        "n_devices": [min(s["n_devices"] for s in stages),
                      max(s["n_devices"] for s in stages)],
        "stages_with_ici": sum(s["ici_bytes"] > 0 for s in stages),
        "ici_bytes": totals["ici_bytes"], "coll_by_kind": kinds,
        "pred_noc_bytes": totals["pred_noc_bytes"],
        "flops": totals["flops"], "pred_flops": totals["pred_flops"],
        "dci_bytes": totals["dci_bytes"],
        "pred_d2d_bytes": totals["pred_d2d_bytes"],
        "ratio_summary": rep.ratio_summary(),
        "per_stage": [[s["index"], s["n_devices"], s["ici_bytes"],
                       s["pred_noc_bytes"], s["coll_by_kind"]]
                      for s in stages],
        "per_stage_columns": ["stage", "n_devices", "ici_bytes",
                              "pred_noc_bytes", "coll_by_kind"]}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default=",".join(CASES),
                    help="comma-separated: " + ", ".join(CASES))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; the ranks share the card) or "
                    "'cpu'")
    args = ap.parse_args()
    from repro_torch.launch.mesh import start_local_ranks
    from repro_torch.realize.program import resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda":       # once, not in every rank
        from repro_torch.kernels import _build
        _build.build()
    for case in args.case.split(","):
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "case.json"
            start_local_ranks(CASES[case], rank_main,
                              (case, device.type, str(out)),
                              device_type=device.type)
            print(out.read_text(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
