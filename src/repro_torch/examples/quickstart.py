"""Quickstart: the whole Gemini flow in one minute on CPU.

1. Build the paper's Transformer workload DAG.
2. Evaluate the Tangram stripe baseline (T-Map) on the Simba architecture.
3. Run the SA mapping engine (G-Map) and show the gains + D2D reduction.
4. Price both architectures with the Monetary-Cost evaluator.

Port of ``examples/quickstart.py`` on the port's numpy engine, which
prints the reference's numbers:

  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from ..core.analyzer import d2d_hop_stats
from ..core.evaluator import Evaluator
from ..core.graph_partition import partition_graph
from ..core.hw import gemini_arch_72t, simba_arch
from ..core.mc import evaluate_mc
from ..core.sa import SAConfig, sa_optimize
from ..core.tangram import tangram_map
from ..core.workloads import transformer


def main() -> None:
    g = transformer(n_layers=3, d_model=512, d_ff=2048, seq=512)
    batch = 64

    for arch, name in ((simba_arch(), "S-Arch (Simba)"),
                       (gemini_arch_72t(), "G-Arch (paper DSE)")):
        print(f"\n=== {name}: {arch.label()} | {arch.tops:.0f} TOPS ===")
        mc = evaluate_mc(arch)
        print(f"monetary cost: ${mc.total:.1f}  (silicon ${mc.silicon:.1f}, "
              f"dram ${mc.dram:.1f}, packaging ${mc.packaging:.1f}; "
              f"D2D area share {mc.d2d_area_fraction:.0%})")

        groups = partition_graph(g, arch, batch)
        print(f"graph partition: {len(groups)} layer groups, "
              f"batch units {[gr.batch_unit for gr in groups]}")

        ev = Evaluator(arch, g)
        tmap = tangram_map(groups, g, arch)
        base = ev.evaluate(tmap, batch)
        print(f"T-Map baseline: delay {base.delay_s * 1e3:.2f} ms, "
              f"energy {base.energy_j * 1e3:.1f} mJ")

        res = sa_optimize(g, arch, groups, batch,
                          SAConfig(iters=2000, seed=0), init=tmap,
                          evaluator=ev)
        print(f"G-Map (SA):     delay {res.delay_s * 1e3:.2f} ms "
              f"({base.delay_s / res.delay_s:.2f}x), "
              f"energy {res.energy_j * 1e3:.1f} mJ "
              f"({base.energy_j / res.energy_j:.2f}x)")

        st = d2d_hop_stats(arch, ev.evaluate(tmap, batch).analyses)
        sg = d2d_hop_stats(arch, ev.evaluate(res.mapping, batch).analyses)
        print(f"D2D hop-bytes: {st['d2d_hop_bytes']:.2e} -> "
              f"{sg['d2d_hop_bytes']:.2e} "
              f"({100 * (1 - sg['d2d_hop_bytes'] / max(st['d2d_hop_bytes'], 1e-12)):+.0f}%)")


if __name__ == "__main__":
    main()
