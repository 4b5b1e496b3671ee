#!/usr/bin/env python3
"""Whether ``fused_eval`` gives the same bits launch after launch, and its
time a launch on rows of each width.

Run from the root of a checkout, on a machine with an NVIDIA card and the
CUDA toolkit:

    python3 benchmarks/port_fused_eval_repro.py [--src DIR] [--label NAME]
        [--reps N] [--batches 4,64,600] [--rows sweep,512,1024] [--load]

``--src`` names the ``src`` directory whose ``repro_torch`` is run
(default: this checkout's), so that two versions of the kernel, each
unpacked with ``git archive``, are held to the same inputs by the same
code: run it once a tree, parent, change, change, parent, in one session
on the card.  Rows: ``sweep`` is ``chip_smoke.sweep_arch()`` (the
supervised fused sweep's widest candidate, 952 cells), a number N the
most-cored candidate of ``grid_candidates(N)`` (500 cores at 512: 6,638
cells; 1,000 at 1024: 13,138), each with ``tf-paper`` at the sweep's
batch of 8.  For each row and batch size B it draws B requests with
``chip_smoke.cost_requests`` (seed B) and keeps their inputs under
``results/port_fused_eval_repro/`` for the next tree's run, launches
``fused_eval`` ``--reps`` times on the same device tensors and counts
the distinct results (the outputs' and bottlenecks' bytes), and times
one launch as ``chip_smoke.py`` times kernels (device time, the least of
three timings of 20 launches), beside the plain version's time, the
bound (``chip_smoke.py``'s for ``fused_eval``: the real entries read
once and the outputs written once at the HBM rate, or the adds at the
f32 rate) and the largest error relative to the plain version.
``--load`` keeps a second process multiplying on the card meanwhile.
Prints one JSON line a row and batch size, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

CACHE = ROOT / "results" / "port_fused_eval_repro"
HOG = ("import time, torch\n"
       "a = torch.randn(8192, 8192, device='cuda')\n"
       "t = time.time()\n"
       "while time.time() - t < 300:\n"
       "    a = (a @ a).clamp_(-1, 1)\n")


def batch_inputs(rows: str, B: int):
    """The evaluator (fused on the card) of ``rows``' arch with
    ``tf-paper``, and the inputs of B requests at the sweep's batch."""
    import numpy as np

    from repro_torch.core.dse import grid_candidates
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.core.workloads import make_workload
    from repro_torch.kernels.fused_eval import FusedInputs
    arch = chip_smoke.sweep_arch() if rows == "sweep" else max(
        grid_candidates(float(rows)), key=lambda a: a.n_cores)
    g = make_workload("tf-paper")
    batch = chip_smoke.SWEEP_FUSED_SPEC["cfg"]["batch"]
    ev = Evaluator(arch, g, fused_device="cuda")
    path = CACHE / f"{rows}-{B}.npz"
    if path.exists():
        with np.load(path) as z:
            return ev, FusedInputs(*(z[k] for k in FusedInputs._fields))
    reqs = chip_smoke.cost_requests(arch, g, B, seed=B, total_batch=batch)
    x = FusedInputs(*(a.copy() for a in ev._fused_inputs(reqs, batch)))
    CACHE.mkdir(parents=True, exist_ok=True)
    np.savez(path, **x._asdict())
    return ev, x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is run")
    ap.add_argument("--label", default="", help="printed on every line")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--batches", default="4,64,132,600")
    ap.add_argument("--rows", default="sweep")
    ap.add_argument("--load", action="store_true",
                    help="a second process multiplies on the card")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    from repro_torch.kernels import fused_eval as fe
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    hog = None
    if args.load:
        hog = subprocess.Popen([sys.executable, "-c", HOG])
        time.sleep(8)                       # its context and first products
    try:
        for rows in args.rows.split(","):
            for B in (int(b) for b in args.batches.split(",")):
                ev, x = batch_inputs(rows, B)
                plan = ev.fused_plan()
                t = [torch.from_numpy(a).to("cuda") for a in x]
                seen = {}
                for _ in range(args.reps):
                    out, bn = fe.fused_eval(plan, *t)
                    key = (out.cpu().numpy().tobytes()
                           + bn.cpu().numpy().tobytes())
                    seen[key] = seen.get(key, 0) + 1
                kw = dict(spans=plan.spans, d2d_mask=plan.d2d_mask,
                          consts=plan.consts, has_d2d=plan.has_d2d,
                          buf_len=plan.buf_len)
                want, _ = ref.fused_eval_ref(*t, **kw)
                ms = min(chip_smoke.time_ms(lambda: fe.fused_eval(plan, *t))
                         for _ in range(3))
                plain_ms = chip_smoke.time_ms(
                    lambda: ref.fused_eval_ref(*t, **kw), reps=5)
                bound = chip_smoke._bound(
                    x.idx.size + 2 * B * plan.buf_len,
                    chip_smoke.PEAK_F32_FLOPS,
                    sum(a.nbytes for a in x) + out.numel() * 4 + B * 4)
                print(json.dumps({
                    "label": args.label, "rows": rows, "B": B,
                    "buf_len": plan.buf_len, "stream": int(x.idx.size),
                    "reps": args.reps, "load": args.load,
                    "distinct": len(seen),
                    "largest_share": max(seen.values()) / args.reps,
                    "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound["bound_ms"],
                    "bound_by": bound["bound_by"],
                    "max_rel_err_vs_plain": ((out - want).abs() / want.abs()
                                             .clamp_min(1e-30)).max().item()
                    }), flush=True)
                del t, out, want
                torch.cuda.empty_cache()
    finally:
        if hog is not None:
            hog.kill()
            hog.wait()
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
