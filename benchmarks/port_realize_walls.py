#!/usr/bin/env python3
"""Pass walls of the realization paths, for comparing two versions of the
port's kernels on the card.

Run from the root of a checkout, on a machine with an NVIDIA card and the
CUDA toolkit:

    python3 benchmarks/port_realize_walls.py [--src DIR] [--label NAME]
                                             [--passes N]

``--src`` names the ``src`` directory whose ``repro_torch`` runs (default:
this checkout's), so that two versions of the port, each unpacked with
``git archive``, are timed by the same code: run it once a tree, parent,
change, change, parent, in one run on the card.  For each path of
``chip_smoke.PATHS`` (``tf-paper``, ``mamba2-370m``, ``granite-moe-3b-
a800m`` at 2 of 32 layers, ``mla-paper``) it builds the fixture's program
on the card (``build_program``, f32, through the kernels), runs one
warm-up pass and then ``--passes`` passes of ``RealizedProgram.execute``
(each stage timed with CUDA events), and prints one JSON line a path: each
pass's wall (the sum of its stage walls, ms), their median, the kernel
launches of one pass and, where the tree's wrappers count them, the f32
launches that took the TF32 wgmma kernels.  With ``--profile``, one more
pass a path under ``torch.profiler``: its wall, the device time of its
kernels summed, the idle share (1 - device / wall) and the kernels that
take the most device time.  Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def profile_pass(prog, trace: Path) -> dict:
    """One pass of ``prog`` under torch.profiler, its chrome trace written
    to ``trace``: the pass's wall (the sum of the stage walls, ms), the
    device time of its kernels and copies (ms), the idle share and the
    eight kernels that take the most device time."""
    import collections

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = sum(prog.execute(seed=0)["wall_s"]) * 1e3
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    device = sum(e["dur"] for e in events) / 1e3
    by = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        by[e.get("name", "")[:60]][0] += 1
        by[e.get("name", "")[:60]][1] += e["dur"] / 1e3
    return {"wall_ms": wall, "device_ms": device,
            "idle_share": 1 - device / wall,
            "top": sorted(([k, *v] for k, v in by.items()),
                          key=lambda r: -r[2])[:8]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch runs")
    ap.add_argument("--label", default="", help="printed on every line")
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--profile", action="store_true",
                    help="one more pass a path under torch.profiler")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    from repro_torch.core.workloads import make_workload
    from repro_torch.realize.plan import load_realize_candidates, plans_for
    from repro_torch.realize.program import build_program
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = chip_smoke.kernel_wrappers()
    for name, fixture, binding, *_ in chip_smoke.PATHS:
        wl, spec = binding.split("=", 1)
        g = make_workload(spec)
        (_, plan), = plans_for(load_realize_candidates(
            chip_smoke.FIXTURES / fixture, {wl: g}, verbose=False))
        prog = build_program(g, plan, "cuda")
        prog.execute(seed=0)
        walls = []
        for _ in range(args.passes):
            for fn in wrappers.values():
                fn.launches = 0
                if hasattr(fn, "wgmma_f32_launches"):
                    fn.wgmma_f32_launches = 0
            walls.append(sum(prog.execute(seed=0)["wall_s"]) * 1e3)
        line = {
            "label": args.label, "path": name, "walls_ms": walls,
            "median_ms": statistics.median(walls),
            "launches": {k: fn.launches for k, fn in wrappers.items()},
            "wgmma_f32_launches": {
                k: fn.wgmma_f32_launches for k, fn in wrappers.items()
                if hasattr(fn, "wgmma_f32_launches")}}
        if args.profile:
            line["profile"] = profile_pass(
                prog, ROOT / "results" / f"port_realize_walls.{args.label}."
                f"{name}.trace.json")
        print(json.dumps(line), flush=True)
        del prog
        torch.cuda.empty_cache()
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
