#!/usr/bin/env python3
"""Host time of one whole batch evaluation of the port's cost model, the
exact numpy engine against the fused pass on the card.

Run from the root of a checkout, on a machine with an NVIDIA card and the
CUDA toolkit:

    python3 benchmarks/port_eval_batch.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two versions of the port, each
unpacked with ``git archive``, are timed by the same code: run it once a
tree, parent, change, change, parent, in one session on the card.  At the
shapes of ``chip_smoke.py``'s ``fused_eval`` lines (three layouts, batches
of 4 and 64) it times ``Evaluator.eval_requests_batch(reqs, batch,
backend=be)`` at the layout's total batch, a call every version of the
port has: per backend one warm-up call, then the mean host milliseconds
of 20 calls, in the order numpy, fused, fused, numpy.  Prints one JSON line a shape, then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

ORDER = ("numpy", "fused", "fused", "numpy")
REPS = 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="", help="printed on every line")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    from repro_torch.core.evaluator import Evaluator
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    for layout, arch, g, batch in chip_smoke.cost_layouts():
        for B in chip_smoke.FUSED_B:
            reqs = chip_smoke.cost_requests(arch, g, B, seed=B,
                                            total_batch=batch)
            ev = Evaluator(arch, g, fused_device=dev)
            runs = [chip_smoke.host_ms(
                lambda: ev.eval_requests_batch(
                    reqs, batch, backend=be),
                reps=REPS) for be in ORDER]
            mean = {be: sum(ms for b, ms in zip(ORDER, runs) if b == be) / 2
                    for be in ("numpy", "fused")}
            print(json.dumps({
                "label": args.label, "src": args.src, "layout": layout,
                "B": B, "order": ORDER, "reps": REPS, "runs_ms": runs,
                "eval_batch_ms": mean,
                "fused_over_numpy": mean["fused"] / mean["numpy"]}),
                flush=True)
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
