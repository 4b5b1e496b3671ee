"""Mini architecture DSE (paper Table I flavor, trimmed for small machines):
co-explore chiplet cut / NoC bandwidth / GLB size for a 72-TOPS budget on
the Transformer workload, through the exploration engine — T-Map screening,
parallel workers, a resumable checkpoint and the (MC, E, D) Pareto frontier.

Port of ``examples/dse_demo.py`` on the port's numpy engine, which prints
the reference's numbers and writes its checkpoint byte for byte:

  PYTHONPATH=src python -m repro_torch.examples.dse_demo

Kill it mid-sweep and re-run: completed candidates are skipped
(results/dse_demo.ckpt.jsonl).
"""

import os

from ..core.dse import DSEConfig, grid_candidates, run_dse
from ..core.explore import pareto_frontier
from ..core.sa import SAConfig
from ..core.workloads import transformer


def main() -> None:
    cands = grid_candidates(
        72.0, mac_options=(1024,), cut_options=(1, 2, 6),
        dram_per_tops=(2.0,), noc_options=(16, 32), d2d_ratio=(0.5,),
        glb_options=(1024, 2048))
    n_workers = max(1, min(4, os.cpu_count() or 1))
    print(f"[dse] exploring {len(cands)} candidates with {n_workers} "
          f"workers (trimmed grid; full grid in benchmarks/table1_dse.py)")
    cfg = DSEConfig(batch=64, sa=SAConfig(iters=800, seed=0))
    os.makedirs("results", exist_ok=True)
    # screening: every candidate gets the cheap T-Map score, the best 2/3
    # get the full SA refinement; screen_keep=1.0 would skip the screen
    pts = run_dse(cands, {"TF": transformer()}, cfg, use_sa=True,
                  progress=True, n_workers=n_workers, screen_keep=0.67,
                  checkpoint="results/dse_demo.ckpt.jsonl")
    print(f"\n{'rank':4s} {'architecture':46s} {'MC$':>7s} "
          f"{'E(mJ)':>8s} {'D(ms)':>8s} {'MC*E*D':>10s}")
    for i, p in enumerate(pts):
        print(f"{i + 1:4d} {p.arch.label():46s} {p.mc:7.1f} "
              f"{p.energy_j * 1e3:8.2f} {p.delay_s * 1e3:8.3f} "
              f"{p.objective:10.3e}")
    frontier = pareto_frontier(pts)
    print(f"\n[dse] (MC, E, D) Pareto frontier "
          f"({len(frontier)}/{len(pts)} refined points are non-dominated):")
    for p in frontier:
        print(f"  {p.arch.label():46s} MC=${p.mc:.1f} "
              f"E={p.energy_j * 1e3:.2f}mJ D={p.delay_s * 1e3:.3f}ms")
    best = pts[0]
    print(f"\n[dse] best: {best.arch.label()}  "
          f"(paper's 72-TOPS optimum was (2, 36, 144GB/s, 32GB/s, 16GB/s, "
          f"2MB, 1024))")


if __name__ == "__main__":
    main()
