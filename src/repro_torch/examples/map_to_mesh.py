"""Gemini-mapped pipelined execution: the paper's technique driving a real
forward pass on the card.

Port of ``examples/map_to_mesh.py``.  The LM architecture's layer DAG is
exported to the Gemini IR, the SA engine explores stage placement against
an abstract accelerator mirroring a device mesh (devices as cores, pods as
chiplets, the device links as NoC and D2D), and the resulting ``MeshPlan``
executes a pipelined forward pass with measured per-stage times, checked
against the monolithic forward.  Same model (``smollm-135m`` reduced to 8
layers), seq 64, batch 4, 2 x 2 abstract mesh, 600 SA iterations and 2
microbatches as the reference, on the card unless asked for the CPU:

  PYTHONPATH=src python -m repro_torch.examples.map_to_mesh
  PYTHONPATH=src python -m repro_torch.examples.map_to_mesh --device cpu

(``--layers``, ``--seq`` and ``--sa-iters`` shrink it further.)
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import torch

from ..configs import get_config
from ..core.bridge import mesh_as_arch, plan_for_graph
from ..core.workloads.lm_graph import lm_graph
from ..models import lm
from ..runtime.pipeline import PipelineExec

BATCH = 4                    # the reference's batch, in 2 microbatches


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--sa-iters", type=int, default=600)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; run with "
                           "--device cpu for the CPU")

    cfg = get_config("smollm-135m").reduced().replace(n_layers=args.layers)
    seq, batch = args.seq, BATCH
    g = lm_graph(cfg, seq=seq)
    print(f"[map] exported {cfg.name} -> {len(g.layers)} Gemini layers")

    # abstract accelerator mirroring a 2x2 device mesh (1 'pod')
    arch = mesh_as_arch(x_chips=2, y_chips=2, pods_x=1)
    t0 = time.time()
    plan = plan_for_graph(g, arch, total_batch=batch, sa_iters=args.sa_iters)
    sa_s = time.time() - t0
    print(f"[map] Gemini SA produced {len(plan.stages)} stages in "
          f"{sa_s:.1f}s "
          f"(modelled delay {plan.cost_delay_s * 1e3:.2f} ms, "
          f"energy {plan.cost_energy_j * 1e3:.2f} mJ)")
    for i, st in enumerate(plan.stages):
        print(f"  stage {i}: {len(st.layers):2d} layers on devices "
              f"{st.devices[:8]}{'...' if len(st.devices) > 8 else ''}")

    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    toks = torch.randint(0, cfg.vocab, (batch, seq),
                         generator=torch.Generator(dev).manual_seed(1),
                         device=dev)
    pipe = PipelineExec(cfg=cfg, params=params, plan=plan, devices=[dev])
    logits = pipe.forward(toks, n_micro=2)
    print(f"[map] pipelined logits {tuple(logits.shape)}; per-stage "
          f"seconds: {[round(t, 3) for t in pipe.stage_times]}")

    with torch.no_grad():
        expected, _, _ = lm.forward(cfg, params, {"tokens": toks},
                                    mode="train")
    err = float((logits - expected).abs().max())
    print(f"[map] max |pipelined - monolithic| = {err:.2e}  "
          f"({'OK' if err < 0.05 else 'MISMATCH'})")
    return {"plan": plan, "sa_s": sa_s, "stage_times": pipe.stage_times,
            "err": err, "logits_shape": tuple(logits.shape)}


if __name__ == "__main__":
    main()
