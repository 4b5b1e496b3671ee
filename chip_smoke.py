#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

Run from the root of a checkout, with no environment set:

    python3 chip_smoke.py

It puts ``src`` on ``sys.path`` itself and imports nothing of JAX.  Each
phase prints one JSON line:

1. ``env``: the card's name and power limit from ``nvidia-smi``, torch and
   CUDA versions.
2. ``build``: the CUDA kernels compiled from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once), with seconds and ptxas lines.
3. ``kernel``: one line per kernel and shape.  Each kernel is held against
   its plain PyTorch version on the same inputs on the card, with TF32 off,
   at the tolerances of ``tests/test_kernels.py`` (GEMM atol 1e-3 /
   rtol 1e-4, flash 2e-5).  The realization path's shapes also get the
   kernel's time, the plain version's, one PyTorch library call's
   (``torch.matmul``, ``scaled_dot_product_attention``) and the least time
   the card could take (``bound_ms``).
4. ``path``: the committed ``tf-paper`` keep_mappings checkpoint realized
   at full width through ``repro_torch.launch.realize`` (one warm-up pass,
   then the counted pass): stages, kernel launches of the pass, wall, FLOPs
   and DCI bytes per stage, and the largest difference of every stage cube
   between the kernel route and the plain route given identical stage
   inputs.
5. ``kernels``: every kernel with its launches on the path and its numbers
   summed over one pass of the path.

Then the card's name and power limit, and a last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero without that line; without a card, or outside a checkout,
it exits non-zero before printing anything.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
FIXTURE = ROOT / "tests" / "data" / "realize" / "tf-paper.simba.ckpt.jsonl"
REPORT = ROOT / "results" / "chip_smoke.realize.jsonl"

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth.  Both kernels compute in plain f32.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12

MM_TOL = {"atol": 1e-3, "rtol": 1e-4}
FLASH_TOL = {"atol": 2e-5, "rtol": 2e-5}
# per-stage cube agreement, relative to the cube's max (tests/test_realize.py)
STAGE_REL_TOL = 2e-4

MM_PATH = [(2048, 512, 512), (2048, 512, 2048), (2048, 2048, 512)]
MM_EDGE = [(100, 300, 50), (257, 129, 65), (1000, 77, 3), (64, 64, 64)]
FLASH_PATH = [(4, 4, 512, 512, 128, True)]
FLASH_EDGE = [(2, 4, 96, 96, 64, True), (1, 2, 128, 256, 32, False),
              (1, 2, 100, 300, 64, True), (1, 2, 256, 128, 32, True),
              (2, 3, 70, 45, 100, False), (1, 2, 130, 130, 256, True)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call on the card, after warm-up."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def check_kernels(dev) -> dict:
    """Kernel vs plain version at the path's and at ragged shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_mha
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.realize.measure import launch_cost

    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)
    timed = {}
    for path, (M, K, N) in [(True, s) for s in MM_PATH] \
            + [(False, s) for s in MM_EDGE]:
        a, b = randn(M, K), randn(K, N)
        got, want = tiled_matmul(a, b), ref.matmul_ref(a, b)
        torch.cuda.synchronize()
        line = {"phase": "kernel", "kernel": "tiled_matmul",
                "shape": {"M": M, "K": K, "N": N}, "main_path": path,
                **MM_TOL, "max_abs_err": (got - want).abs().max().item()}
        if path:
            flops, nbytes = launch_cost("tiled_matmul",
                                        {"M": M, "K": K, "N": N})
            line["bound_ms"], line["bound_by"] = bound(flops, nbytes)
            line["ms"] = time_ms(lambda: tiled_matmul(a, b))
            line["plain_ms"] = time_ms(lambda: ref.matmul_ref(a, b))
            line["library_ms"] = time_ms(lambda: torch.matmul(a, b))
            timed[("tiled_matmul", (M, K, N))] = line
        emit(line)
        if not torch.allclose(got, want, **MM_TOL):
            raise AssertionError(f"tiled_matmul disagrees at {(M, K, N)}")
    for path, (B, H, Sq, Sk, D, causal) in \
            [(True, s) for s in FLASH_PATH] + [(False, s) for s in FLASH_EDGE]:
        q, k, v = randn(B, H, Sq, D), randn(B, H, Sk, D), randn(B, H, Sk, D)
        got = flash_attention_mha(q, k, v, causal=causal)
        want = ref.attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        line = {"phase": "kernel", "kernel": "flash_attention_mha",
                "shape": {"B": B, "H": H, "Sq": Sq, "Sk": Sk, "D": D},
                "causal": causal, "main_path": path, **FLASH_TOL,
                "max_abs_err": (got - want).abs().max().item()}
        if path:
            shape = {**line["shape"], "causal": int(causal)}
            line["bound_ms"], line["bound_by"] = bound(
                *launch_cost("flash_attention_mha", shape))
            line["ms"] = time_ms(
                lambda: flash_attention_mha(q, k, v, causal=causal))
            line["plain_ms"] = time_ms(
                lambda: ref.attention_ref(q, k, v, causal=causal))
            line["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal))
            timed[("flash_attention_mha", tuple(shape.values()))] = line
        emit(line)
        if not torch.allclose(got, want, **FLASH_TOL):
            raise AssertionError(
                f"flash_attention_mha disagrees at {(B, H, Sq, Sk, D)}")
    return timed


def stage_cube_errors(g, plan, dev) -> dict:
    """Largest difference, relative to the cube's max, of every stage cube
    between the kernel route and the plain route, each stage given the
    same inputs (the kernel route's upstream cubes and the same drawn
    sources and weights); and the kernel route's program."""
    import torch

    from repro_torch.realize.program import (build_program,
                                             draw_stage_arrays,
                                             stage_args_from_numpy)
    kern = build_program(g, plan, device=dev, use_kernels=True)
    plain = build_program(g, plan, device=dev, use_kernels=False)
    args = stage_args_from_numpy(draw_stage_arrays(kern, 0), kern.device)
    outputs = {}
    worst, worst_cube, n_cubes = 0.0, None, 0
    for sk, sp, own in zip(kern.stages, plain.stages, args):
        ext = [outputs[n] for n in sk.ext_inputs]
        got, want = sk.fn(*ext, *own), sp.fn(*ext, *own)
        for name, a, b in zip(sk.out_layers, got, want):
            if tuple(a.shape) != tuple(b.shape) \
                    or not torch.isfinite(a).all():
                raise AssertionError(f"stage cube {name}: shape or finite")
            err = ((a - b).abs().max() / b.abs().max().clamp_min(1e-9)).item()
            n_cubes += 1
            if err > worst:
                worst, worst_cube = err, name
            outputs[name] = a
    torch.cuda.synchronize()
    return {"stage_cubes_checked": n_cubes, "stage_max_rel_err": worst,
            "stage_worst_cube": worst_cube,
            "stage_rel_tol": STAGE_REL_TOL}, kern


def fixture_plan():
    """The tf-paper graph and the plan of the committed checkpoint."""
    from repro_torch.core.workloads import make_workload
    from repro_torch.realize.plan import load_realize_candidates, plans_for
    g = make_workload("tf-paper")
    (_, plan), = plans_for(load_realize_candidates(FIXTURE, {"TF": g},
                                                   verbose=False))
    return g, plan


def run_path(g, plan, dev) -> dict:
    """Realize the fixture through the CLI entry point; count launches of
    the measured pass.  Returns the launches and the kernel route's
    program."""
    from repro_torch.kernels.flash_attention import flash_attention_mha
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.launch.realize import main as realize_main

    argv = ["--ckpt", str(FIXTURE), "--workload", "TF=tf-paper", "--top",
            "1", "--device", "cuda", "--out", str(REPORT), "--force"]
    with contextlib.redirect_stdout(sys.stderr):   # the CLI's own table
        realize_main(argv)                          # warm-up pass
        tiled_matmul.launches = 0
        flash_attention_mha.launches = 0
        t0 = time.perf_counter()
        realize_main(argv)                          # the counted pass
        seconds = time.perf_counter() - t0
    launches = {"tiled_matmul": tiled_matmul.launches,
                "flash_attention_mha": flash_attention_mha.launches}
    rec = [json.loads(line) for line in REPORT.read_text().splitlines()
           if '"_key"' in line][-1]
    stages = rec["stages"]
    if len(stages) != 37 or launches != {"tiled_matmul": 36,
                                         "flash_attention_mha": 6}:
        raise AssertionError(f"path ran {len(stages)} stages with "
                             f"launches {launches}")
    cubes, prog = stage_cube_errors(g, plan, dev)
    emit({"phase": "path", "workload": "tf-paper", "arch": rec["arch"],
          "batch_unit": rec["batch_unit"], "stages": len(stages),
          "seconds": seconds, "launches": launches,
          "wall_ms": rec["totals"]["wall_s"] * 1e3,
          "flops": rec["totals"]["flops"],
          "dci_bytes": rec["totals"]["dci_bytes"],
          "per_stage": [[s["index"], s["wall_s"] * 1e3, s["flops"],
                         s["dci_bytes"]] for s in stages],
          "per_stage_columns": ["stage", "wall_ms", "flops", "dci_bytes"],
          **cubes})
    if cubes["stage_max_rel_err"] > STAGE_REL_TOL:
        raise AssertionError(f"stage cube {cubes['stage_worst_cube']} "
                             f"differs by {cubes['stage_max_rel_err']}")
    return launches, prog


KERNEL_FILES = {
    "tiled_matmul": ("src/repro_torch/kernels/csrc/tiled_matmul.cu",
                     "src/repro/kernels/tiled_matmul.py:51"),
    "flash_attention_mha": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:90"),
}


def per_pass_summary(timed: dict, launches: dict, prog) -> list:
    """Each kernel's numbers summed over one pass of the path: the timed
    line of every launch's shape, once per launch."""
    lines = {}
    for sp in prog.stages:
        for kernel, shape in sp.launches:
            lines.setdefault(kernel, []).append(
                timed[(kernel, tuple(shape.values()))])
    out = []
    for name, (source, replaces) in KERNEL_FILES.items():
        ls = lines[name]
        total = lambda k: sum(ln[k] for ln in ls)
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(ln["max_abs_err"] for ln in ls),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(ls, key=lambda ln: ln["bound_ms"])["bound_by"],
            "library_ms": total("library_ms"),
            "per": "one pass of the path: sums over its launches"})
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir() or not FIXTURE.exists():
        print("chip_smoke.py: run it from the root of a checkout of the "
              "repository (src/repro_torch and the checkpoint fixture are "
              "missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0)})

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source": info})

    g, plan = fixture_plan()
    timed = check_kernels(dev)
    launches, prog = run_path(g, plan, dev)
    emit({"kernels": per_pass_summary(timed, launches, prog)})
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
