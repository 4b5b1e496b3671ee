"""Readings that set a cell's limits: the program's numbers on many
seeds, and the control's (the reference in FP8 in the program's place,
``bench/reference/lowp.py``) and, for a training cell, the half-batch
fault's, in one process.

    python3 bench/control.py --workload <name> --seconds <s> --seeds <n> ...

runs, for each seed, the cell's set-up and a short window at the cell's
own load, the check, and the control on the same inputs, and prints one
JSON line a seed (also written to ``--out``).  A training cell also reads
the reference run under bf16 autocast (its products and einsums in bf16,
as the program computes) against the f32 reference, leaf by leaf: what
bf16 rounding alone does to each gap.  The benchmark's own runs never
run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "bench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench.drivers import serve_closed, train_packed  # noqa: E402
from bench.lib import harness  # noqa: E402
from bench.reference.lowp import fp8_matmul  # noqa: E402
from bench.reference.weights import make_weights  # noqa: E402


def serve_readings(rec, model, mix, seed, device) -> dict:
    """The program's widest gap and the control's, over the same sample
    of requests, positions and served tokens."""
    W = make_weights(model, seed, device)
    g, c = [], []
    for row, first, toks in serve_closed.check_rows(
            rec, serve_closed.sample(rec, mix, seed), mix):
        g.append(serve_closed.logit_gaps(W, model, row, first, toks, device))
        c.append(serve_closed.logit_gaps(W, model, row, first, toks, device,
                                         choose=fp8_matmul))
    g, c = np.concatenate(g), np.concatenate(c)
    stats = lambda x: {"max": float(x.max()), "p99": float(
        np.percentile(x, 99)), "mean": float(x.mean()),
        "nonzero": float((x > 0).mean())}
    return {"logit_gap": float(g.max()), "control": {"logit_gap":
                                                     float(c.max())},
            "tokens": int(len(g)), "program_gaps": stats(g),
            "control_gaps": stats(c)}


def bf16_reference_readings(full, model, mix, seed, device) -> dict:
    """The reference under bf16 autocast against the f32 one."""
    with torch.autocast(device.type, dtype=torch.bfloat16):
        low = train_packed.reference_steps(model, mix, seed, device)
    return {**train_packed.compare(low, full, mix),
            "worst_leaves": {k: train_packed.worst_leaves(low[k], full[k])
                             for k in ("grads", "change")}}


def train_readings(rec, model, mix, seed, device) -> dict:
    full = train_packed.reference_steps(model, mix, seed, device)
    prog = train_packed.compare({"losses": rec.check_losses,
                                 "grads": rec.grad_norms,
                                 "change": rec.change_norms}, full, mix)
    ctrl = train_packed.reference_steps(model, mix, seed, device,
                                        mm=fp8_matmul)
    half = train_packed.reference_steps(
        model, mix, seed, device, rows=slice(0, int(mix["batch"]) // 2))
    got = {"losses": rec.check_losses, "grads": rec.grad_norms,
           "change": rec.change_norms}
    worst = {k: train_packed.worst_leaves(got[k], full[k])
             for k in ("grads", "change")}
    return {**prog, "control": train_packed.compare(ctrl, full, mix),
            "half_batch": train_packed.compare(half, full, mix),
            "bf16_reference": bf16_reference_readings(full, model, mix,
                                                      seed, device),
            "losses": {"program": rec.check_losses,
                       "reference": full["losses"],
                       "control": ctrl["losses"]},
            "worst_leaves": worst}


def readings(spec: dict, seed: int, seconds: float, device) -> dict:
    drv = harness.driver_module(spec["mix"]["kind"])
    t0 = time.perf_counter()
    state = drv.setup(spec["model"], spec["mix"], seed, device)
    rec = drv.window(state, seconds, None)
    drv.release(state)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if spec["mix"]["kind"] == "serve_closed":
        out = serve_readings(rec, spec["model"], spec["mix"], seed, device)
    else:
        out = train_readings(rec, spec["model"], spec["mix"], seed, device)
    out.update(seed=seed, attempted=rec.attempted, failed=rec.failed,
               seconds=time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    spec = harness.cell_spec(harness.load_json(ROOT / "BENCHMARK.json"),
                             a.workload)
    harness.cache_env()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    out = Path(a.out) if a.out else None
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
    for seed in a.seeds:
        line = json.dumps({"workload": a.workload,
                           **readings(spec, seed, a.seconds, device)})
        print(line, flush=True)
        if out:
            with out.open("a") as f:
                f.write(line + "\n")
    found = harness.forbidden_modules()
    print(f"forbidden modules: {found}", flush=True)
    return 0 if not found else 4


if __name__ == "__main__":
    sys.exit(main())
