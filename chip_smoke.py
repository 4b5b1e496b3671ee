#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

Run from the root of a checkout, with no environment set:

    python3 chip_smoke.py

It puts ``src`` on ``sys.path`` itself and imports nothing of JAX.  Each
phase prints one JSON line:

1. ``env``: the card's name and power limit from ``nvidia-smi``, torch and
   CUDA versions.
2. ``build``: the CUDA kernels compiled from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once), with seconds and ptxas lines
   (registers, spills).  Then ``sass``: the tensor-core ``HMMA``
   instructions in each built library's SASS, by kernel function, where
   the toolkit has ``cuobjdump``.
3. ``kernel``: one line per kernel and shape.  Each kernel is held against
   its plain PyTorch version on the same inputs on the card, with TF32 off,
   at the tolerances of ``tests/test_kernels.py`` (GEMM atol 1e-3 /
   rtol 1e-4, flash 2e-5, SSD chunk 1e-4; the chunked SSD ``ssd_forward``
   at 2e-4).  Each kernel line names the kernel configuration the launch
   took (``route``: tile, head-dim template or P tile, copy width); the
   edge shapes drive each of them.  The realization paths' shapes also get
   the kernel's time, the plain version's, one PyTorch library call's
   (``torch.matmul``, ``scaled_dot_product_attention``; none computes the
   SSD chunk form, so its ``library_ms`` is null), each as device time
   (``time_ms``), the kernel's time also as the host issues it
   (``host_issued_ms``: above ``ms`` where the wrapper's host time per
   call exceeds the kernel's), and the least time the card could take:
   ``bound_ms`` at the f32 FMA peak (kept so that rows compare across
   versions), ``bound_3xtf32_ms`` at a third of the TF32 tensor-core
   peak, the rate of the arithmetic the three kernels now use
   (``arith``).  Then one ``dtype: bf16`` line per kernel at every path
   shape and at ragged sizes (odd K and N, D = 40 and 33, P = 130): bf16
   operands, held against the plain version on the upcast inputs at the
   reference's bf16 tolerances (GEMM atol 0.5 / rtol 5e-2, flash 2e-2;
   SSD, whose outputs are f32, 1e-4), each launch counted and the output
   type checked; at the path shapes also the kernel's, the plain
   version's and the bf16 library call's time and the bound at bf16
   rates (989 TFLOP/s dense, 2 bytes an element).
4. ``path``, once per realization path: a committed keep_mappings
   checkpoint realized at full width through ``repro_torch.launch.realize
   --calibrate`` (one warm-up pass, then the counted pass, with every
   launch count set to 0 just before it): stages, kernel launches of the
   pass, wall, FLOPs and DCI bytes per stage, the predicted totals
   (``pred_flops``, ``pred_dram_bytes``, ``pred_noc_bytes``,
   ``pred_d2d_bytes``, held to the pinned CPU values), the
   measured/predicted geomeans (``ratio_summary``), the fitted overlay,
   the host seconds of the predicted side (``predict_s``; the warm-up
   pass's apart), and the largest difference of every stage cube between
   the kernel route and the plain route given identical stage inputs.  A
   stage that launches a kernel with no predicted FLOPs, a ratio that is
   not finite, or an identity overlay that does not return its input
   Tech fails the run.  The paths are ``tf-paper`` (37 stages; GEMM and
   flash) and ``mamba2-370m`` (96 stages; GEMM and the SSD chunk kernel).
   Then ``profile`` (not gated): the timed ``ops.ssd_forward`` call at the
   ``mamba2-370m`` SSD layer's shape once more, under ``torch.profiler``:
   the device time of its kernels, the device's idle share over its
   host-issued wall, and kernel launches and device time split between
   the chunk kernel, the inter-chunk recurrence loop and the rest of the
   eager glue.
5. ``kernels``: every kernel with its launches on the paths and its numbers
   summed over one pass of each path, and each path's share apart (both
   bounds, ``arith``); under ``bf16`` the same launches' sums with bf16
   operands.

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
FIXTURES = ROOT / "tests" / "data" / "realize"
REPORTS = ROOT / "results"

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, dense TF32 and bf16 on the tensor cores, and HBM3 bandwidth.  All
# three kernels multiply in 3xTF32 (three TF32 products per f32 product,
# f32 accuracy); with bf16 operands, which are exact in TF32, a product of
# two of them is one TF32 product and a product with an operand computed
# in f32 two.
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
ARITH = {"tiled_matmul": "3xTF32 mma.sync",
         "flash_attention_mha": "3xTF32 mma.sync",
         "ssd_chunk_dual": "3xTF32 mma.sync"}
ARITH_BF16 = {
    "tiled_matmul": "bf16 operands, f32 math: 1 TF32 mma.sync a product",
    "flash_attention_mha": "bf16 operands, f32 math: 1 TF32 mma.sync for "
                           "QK^T, 2 for PV (P split)",
    "ssd_chunk_dual": "bf16 inputs, f32 math and outputs: 1 TF32 mma.sync "
                      "for CB^T, 2 for Wx and (dB)^T x"}

MM_TOL = {"atol": 1e-3, "rtol": 1e-4}
FLASH_TOL = {"atol": 2e-5, "rtol": 2e-5}
SSD_TOL = {"atol": 1e-4, "rtol": 1e-4}
SSD_FORWARD_TOL = {"atol": 2e-4, "rtol": 2e-4}
# bf16 operands against the plain version on the upcast inputs, at the
# reference's bf16 tolerances (tests/test_kernels.py: GEMM atol 0.5 /
# rtol 5e-2, flash 2e-2); the reference has no bf16 SSD test, and the SSD
# kernel returns f32 with bf16 inputs exact in f32, so it keeps 1e-4
MM_BF16_TOL = {"atol": 0.5, "rtol": 5e-2}
FLASH_BF16_TOL = {"atol": 2e-2, "rtol": 2e-2}
SSD_BF16_TOL = SSD_TOL
# cycles of the sleep kernel ahead of a device timing: 5 ms at 2 GHz, more
# than the host takes to queue 20 calls of any function timed that way
SLEEP_CYCLES = 10_000_000
# per-stage cube agreement, relative to the cube's max (tests/test_realize.py)
STAGE_REL_TOL = 2e-4

MM_PATH = [(2048, 512, 512), (2048, 512, 2048), (2048, 2048, 512),
           (4096, 1024, 4384), (4096, 2048, 1024)]
# (M, K, N, A one float into its storage): ragged shapes; both tile
# configurations with 16-byte copies (the path's shapes) and with 4-byte
# copies (K or N % 4 != 0, or A not 16-byte aligned)
MM_EDGE = [(100, 300, 50, False), (257, 129, 65, False),
           (1000, 77, 3, False), (64, 64, 64, False),
           (2048, 130, 2050, False), (512, 256, 512, True),
           (2048, 512, 2048, True)]
FLASH_PATH = [(4, 4, 512, 512, 128, True)]
# (B, H, Sq, Sk, D, causal, q one float into its storage): every head-dim
# template (32, 64, 128, 256), Sq != Sk causal both ways, 4-byte copies
# (D % 4 != 0, q not 16-byte aligned)
FLASH_EDGE = [(2, 4, 96, 96, 64, True, False),
              (1, 2, 128, 256, 32, False, False),
              (1, 2, 100, 300, 64, True, False),
              (1, 2, 256, 128, 32, True, False),
              (2, 3, 70, 45, 100, False, False),
              (1, 2, 130, 130, 256, True, False),
              (1, 2, 96, 200, 256, True, False),
              (2, 2, 192, 100, 128, True, False),
              (1, 3, 80, 90, 33, True, False),
              (1, 2, 64, 96, 64, True, True)]
# (BC, Q, H, P, N, x one float into its storage): the mamba2-370m path's
# shape; tests/test_kernels.py's three; ragged chunk lengths; P of 32 and
# 64; two P tiles with N off 4; then, each at an odd number of (chunk,
# head) blocks: 4-byte copies (x not 16-byte aligned), Q of 70 and 100,
# N % 8 != 0 and P = 130
SSD_PATH = [(32, 128, 16, 128, 64, False)]
SSD_EDGE = [(2, 16, 2, 8, 4, False), (4, 64, 4, 32, 16, False),
            (1, 128, 8, 64, 32, False), (2, 96, 4, 64, 64, False),
            (3, 70, 2, 32, 16, False), (2, 70, 3, 130, 50, False),
            (3, 70, 3, 64, 16, True), (1, 100, 5, 64, 64, False),
            (3, 100, 1, 32, 12, False), (1, 128, 3, 130, 20, False),
            (1, 70, 7, 60, 50, True)]
# bf16 at ragged sizes, each taking the one-element (ld2) copies: odd K,
# odd N; D = 40 (16-byte copies, a head dim off the template) and D = 33;
# P = 130 and N % 8 != 0
MM_BF16_EDGE = [(257, 129, 65), (2048, 131, 2048), (1000, 64, 77)]
FLASH_BF16_EDGE = [(2, 2, 100, 70, 40, True), (1, 2, 70, 70, 33, True)]
SSD_BF16_EDGE = [(1, 128, 3, 130, 24), (2, 16, 2, 8, 4)]
# ssd_forward, kernel vs plain: (B, L, H, P, N, chunk); a padded last
# chunk, and the mamba2-370m path's SSD layer (timed: the chunk kernel plus
# the eager discretization, recurrence and inter-chunk output around it)
SSD_FORWARD = [(2, 70, 4, 64, 32, 32), (1, 4096, 16, 128, 64, 128)]

# the realization paths: (name, fixture, workload binding, stages,
# launches of one pass, counted FLOPs of one pass, predicted totals of one
# pass).  The predicted totals are the port's CPU values, which
# tests/test_torch_cost_model.py holds equal to the reference's.
PATHS = [
    ("tf-paper", "tf-paper.simba.ckpt.jsonl", "TF=tf-paper", 37,
     {"tiled_matmul": 36, "flash_attention_mha": 6, "ssd_chunk_dual": 0},
     83_764_445_184,
     {"pred_flops": 90_244_644_864.0, "pred_noc_bytes": 109_003_176.0,
      "pred_d2d_bytes": 2_166_178_741.0, "pred_dram_bytes": 325_844_992.0}),
    ("mamba2-370m", "mamba2-370m.simba.ckpt.jsonl", "MAMBA=lm:mamba2-370m",
     96, {"tiled_matmul": 96, "flash_attention_mha": 0, "ssd_chunk_dual": 48},
     2_694_970_343_424,
     {"pred_flops": 3_002_987_446_272.0, "pred_noc_bytes": 3_068_313_600.0,
      "pred_d2d_bytes": 77_788_781_360.0,
      "pred_dram_bytes": 11_575_820_288.0}),
]
# the predicted totals are host float64 sums; a numpy that groups its
# pairwise sums differently may move the last bits
PRED_REL_TOL = 1e-9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, device: bool = True) -> float:
    """Mean milliseconds per call on the card, after warm-up.  With
    ``device`` the stream first runs a sleep kernel (``SLEEP_CYCLES``, a
    few ms) while the host queues every call, so the events bracket the
    calls' device work and not the host's pace of launching them; without
    it the calls run as the host issues them."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if device:
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bounds(flops: float, nbytes: float) -> dict:
    """The least ms the card could take at the f32 FMA peak and what bounds
    it there, and the least ms at the 3xTF32 rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_3xtf32_ms": max(flops / PEAK_3XTF32_FLOPS, t_bytes) * 1e3}


def bf16_bounds(kernel: str, shape: dict) -> dict:
    """The least ms the card could take for a bf16 launch: its FLOPs at the
    dense bf16 tensor-core peak against its bytes at the HBM rate, inputs
    at 2 bytes an element (GEMM and flash outputs too; the SSD kernel's
    outputs are f32, 4 bytes)."""
    from repro_torch.realize.measure import launch_cost
    flops, f32_bytes = launch_cost(kernel, shape)
    if kernel == "ssd_chunk_dual":
        BC, Q, H, P, N = (shape[k] for k in ("BC", "Q", "H", "P", "N"))
        out = BC * (Q * H * P + H * N * P)
        nbytes = 2 * (f32_bytes / 4 - out) + 4 * out
    else:
        nbytes = f32_bytes / 2
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def on_card(randn, shape, offset: bool):
    """randn of ``shape``, contiguous; with ``offset`` a view one float into
    its storage (data pointer 4- but not 16-byte aligned)."""
    n = 1
    for d in shape:
        n *= d
    return randn(n + int(offset))[int(offset):].view(*shape)


def check_kernels(dev):
    """Kernel vs plain version at the path's and at ragged shapes.  Returns
    the timed lines by (kernel, shape), and the inputs, chunk and timed
    line of ``ops.ssd_forward`` at the ``mamba2-370m`` layer's shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, mamba_ssd, ops, ref
    from repro_torch.kernels import tiled_matmul as mm
    from repro_torch.kernels.flash_attention import flash_attention_mha
    from repro_torch.kernels.mamba_ssd import ssd_chunk_dual
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.realize.measure import launch_cost

    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)
    timed = {}
    for path, (M, K, N, offset) in [(True, (*s, False)) for s in MM_PATH] \
            + [(False, s) for s in MM_EDGE]:
        a, b = on_card(randn, (M, K), offset), randn(K, N)
        got, want = tiled_matmul(a, b), ref.matmul_ref(a, b)
        torch.cuda.synchronize()
        line = {"phase": "kernel", "kernel": "tiled_matmul",
                "shape": {"M": M, "K": K, "N": N}, "a_offset": int(offset),
                "route": mm.kernel_route(a, b), "arith": ARITH["tiled_matmul"],
                "main_path": path, **MM_TOL,
                "max_abs_err": (got - want).abs().max().item()}
        if path:
            line.update(bounds(*launch_cost("tiled_matmul",
                                            {"M": M, "K": K, "N": N})))
            line["ms"] = time_ms(lambda: tiled_matmul(a, b))
            line["host_issued_ms"] = time_ms(lambda: tiled_matmul(a, b),
                                             device=False)
            line["plain_ms"] = time_ms(lambda: ref.matmul_ref(a, b))
            line["library_ms"] = time_ms(lambda: torch.matmul(a, b))
            timed[("tiled_matmul", (M, K, N))] = line
        emit(line)
        if not torch.allclose(got, want, **MM_TOL):
            raise AssertionError(f"tiled_matmul disagrees at {(M, K, N)}")
    for path, (B, H, Sq, Sk, D, causal, offset) in \
            [(True, (*s, False)) for s in FLASH_PATH] \
            + [(False, s) for s in FLASH_EDGE]:
        q = on_card(randn, (B, H, Sq, D), offset)
        k, v = randn(B, H, Sk, D), randn(B, H, Sk, D)
        got = flash_attention_mha(q, k, v, causal=causal)
        want = ref.attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        line = {"phase": "kernel", "kernel": "flash_attention_mha",
                "shape": {"B": B, "H": H, "Sq": Sq, "Sk": Sk, "D": D},
                "causal": causal, "q_offset": int(offset),
                "route": flash_attention.kernel_route(q, k, v),
                "arith": ARITH["flash_attention_mha"], "main_path": path,
                **FLASH_TOL, "max_abs_err": (got - want).abs().max().item()}
        if path:
            shape = {**line["shape"], "causal": int(causal)}
            line.update(bounds(*launch_cost("flash_attention_mha", shape)))
            line["ms"] = time_ms(
                lambda: flash_attention_mha(q, k, v, causal=causal))
            line["host_issued_ms"] = time_ms(
                lambda: flash_attention_mha(q, k, v, causal=causal),
                device=False)
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
    for path, (BC, Q, H, P, N, offset) in \
            [(True, s) for s in SSD_PATH] + [(False, s) for s in SSD_EDGE]:
        x = on_card(randn, (BC, Q, H, P), offset)
        cum = torch.cumsum(-randn(BC, Q, H).abs() * 0.1, dim=1)
        Bm, Cm = randn(BC, Q, N), randn(BC, Q, N)
        got = ssd_chunk_dual(x, cum, Bm, Cm)
        want = ref.ssd_chunk_ref(x, cum, Bm, Cm)
        torch.cuda.synchronize()
        shape = {"BC": BC, "Q": Q, "H": H, "P": P, "N": N}
        line = {"phase": "kernel", "kernel": "ssd_chunk_dual",
                "shape": shape, "x_offset": int(offset),
                "route": mamba_ssd.kernel_route(x, Bm, Cm),
                "arith": ARITH["ssd_chunk_dual"],
                "main_path": path, **SSD_TOL,
                "max_abs_err": max((g - w).abs().max().item()
                                   for g, w in zip(got, want))}
        if path:
            line.update(bounds(*launch_cost("ssd_chunk_dual", shape)))
            line["ms"] = time_ms(lambda: ssd_chunk_dual(x, cum, Bm, Cm))
            line["host_issued_ms"] = time_ms(
                lambda: ssd_chunk_dual(x, cum, Bm, Cm), device=False)
            line["plain_ms"] = time_ms(
                lambda: ref.ssd_chunk_ref(x, cum, Bm, Cm))
            line["library_ms"] = None
            line["library"] = "none: no single PyTorch call computes it"
            timed[("ssd_chunk_dual", tuple(shape.values()))] = line
        emit(line)
        if not all(torch.allclose(g, w, **SSD_TOL)
                   for g, w in zip(got, want)):
            raise AssertionError(
                f"ssd_chunk_dual disagrees at {(BC, Q, H, P, N)}")
    for path, (B, L, H, P, N, chunk) in zip((False, True), SSD_FORWARD):
        args = (randn(B, L, H, P), randn(B, L, H).abs() * 0.1,
                -randn(H).abs(), randn(B, L, 1, N), randn(B, L, 1, N))
        got, _ = ops.ssd_forward(*args, chunk=chunk)
        want, _ = ops.ssd_forward(*args, chunk=chunk,
                                  chunk_dual=ref.ssd_chunk_ref)
        torch.cuda.synchronize()
        line = {"phase": "kernel", "kernel": "ssd_chunk_dual",
                "via": "ops.ssd_forward", "shape": dict(zip(
                    ("B", "L", "H", "P", "N", "chunk"),
                    (B, L, H, P, N, chunk))),
                "main_path": path, **SSD_FORWARD_TOL,
                "max_abs_err": (got - want).abs().max().item()}
        if path:
            # as the host issues it: the recurrence is host-bound
            line["ms"] = time_ms(lambda: ops.ssd_forward(*args, chunk=chunk),
                                 device=False)
            line["plain_ms"] = time_ms(lambda: ops.ssd_forward(
                *args, chunk=chunk, chunk_dual=ref.ssd_chunk_ref),
                device=False)
        emit(line)
        if not torch.allclose(got, want, **SSD_FORWARD_TOL):
            raise AssertionError(
                f"ssd_forward disagrees at {(B, L, H, P, N, chunk)}")
        if path:
            layer = (args, chunk, line)
    return timed, layer


def check_bf16(dev) -> dict:
    """Each kernel with bf16 operands at every shape of the paths and at
    ragged sizes, against its plain version on the upcast inputs.  Each
    call must launch the kernel (its count moves by one) and return the
    reference's output type (bf16 for GEMM and flash, f32 for SSD).  The
    path shapes also get the kernel's time, the plain version's and the
    bf16 library call's (``torch.matmul``, ``scaled_dot_product_attention``
    on bf16; none for SSD), and the bound at bf16 rates.  Returns the timed
    lines by (kernel, shape)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, mamba_ssd, ref
    from repro_torch.kernels import tiled_matmul as mm
    from repro_torch.kernels.flash_attention import flash_attention_mha
    from repro_torch.kernels.mamba_ssd import ssd_chunk_dual
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *s: torch.randn(*s, device=dev,
                                   generator=gen).bfloat16()
    timed = {}

    def run(fn, kernel, *args, **kw):
        n0 = fn.launches
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        if fn.launches != n0 + 1:
            raise AssertionError(f"{kernel} bf16: the launch was not "
                                 f"counted ({n0} -> {fn.launches})")
        return out

    def finish(line, kernel, key, path, err, ok, timings):
        line["max_abs_err"] = err
        if path:
            line.update(bf16_bounds(kernel, line["shape"]))
            line.update({k: time_ms(f) if f else None
                         for k, f in timings.items()})
            timed[(kernel, key)] = line
        emit(line)
        if not ok:
            raise AssertionError(f"{kernel} bf16 disagrees at {key}")

    for path, (M, K, N) in [(True, s) for s in MM_PATH] \
            + [(False, s) for s in MM_BF16_EDGE]:
        a, b = randn(M, K), randn(K, N)
        got = run(tiled_matmul, "tiled_matmul", a, b)
        want = ref.matmul_ref(a.float(), b.float())
        line = {"phase": "kernel", "kernel": "tiled_matmul", "dtype": "bf16",
                "shape": {"M": M, "K": K, "N": N},
                "route": mm.kernel_route(a, b),
                "arith": ARITH_BF16["tiled_matmul"], "main_path": path,
                "out_dtype": str(got.dtype), **MM_BF16_TOL}
        finish(line, "tiled_matmul", (M, K, N), path,
               (got.float() - want).abs().max().item(),
               got.dtype == torch.bfloat16
               and torch.allclose(got.float(), want, **MM_BF16_TOL),
               {"ms": lambda: tiled_matmul(a, b),
                "plain_ms": lambda: ref.matmul_ref(a, b),
                "library_ms": lambda: torch.matmul(a, b)})
    for path, (B, H, Sq, Sk, D, causal) in \
            [(True, s) for s in FLASH_PATH] \
            + [(False, s) for s in FLASH_BF16_EDGE]:
        q, k, v = randn(B, H, Sq, D), randn(B, H, Sk, D), randn(B, H, Sk, D)
        got = run(flash_attention_mha, "flash_attention_mha", q, k, v,
                  causal=causal)
        want = ref.attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal)
        shape = {"B": B, "H": H, "Sq": Sq, "Sk": Sk, "D": D,
                 "causal": int(causal)}
        line = {"phase": "kernel", "kernel": "flash_attention_mha",
                "dtype": "bf16", "shape": shape,
                "route": flash_attention.kernel_route(q, k, v),
                "arith": ARITH_BF16["flash_attention_mha"],
                "main_path": path, "out_dtype": str(got.dtype),
                **FLASH_BF16_TOL}
        finish(line, "flash_attention_mha", tuple(shape.values()), path,
               (got.float() - want).abs().max().item(),
               got.dtype == torch.bfloat16
               and torch.allclose(got.float(), want, **FLASH_BF16_TOL),
               {"ms": lambda: flash_attention_mha(q, k, v, causal=causal),
                "plain_ms": lambda: ref.attention_ref(q, k, v,
                                                      causal=causal),
                "library_ms": lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)})
    for path, (BC, Q, H, P, N) in \
            [(True, s[:5]) for s in SSD_PATH] \
            + [(False, s) for s in SSD_BF16_EDGE]:
        x = randn(BC, Q, H, P)
        cum = torch.cumsum(-randn(BC, Q, H).float().abs() * 0.1,
                           dim=1).bfloat16()
        Bm, Cm = randn(BC, Q, N), randn(BC, Q, N)
        got = run(ssd_chunk_dual, "ssd_chunk_dual", x, cum, Bm, Cm)
        want = ref.ssd_chunk_ref(x.float(), cum.float(), Bm.float(),
                                 Cm.float())
        shape = {"BC": BC, "Q": Q, "H": H, "P": P, "N": N}
        line = {"phase": "kernel", "kernel": "ssd_chunk_dual",
                "dtype": "bf16", "shape": shape,
                "route": mamba_ssd.kernel_route(x, Bm, Cm),
                "arith": ARITH_BF16["ssd_chunk_dual"], "main_path": path,
                "out_dtype": str(got[0].dtype), **SSD_BF16_TOL}
        if path:
            line["library"] = "none: no single PyTorch call computes it"
        finish(line, "ssd_chunk_dual", tuple(shape.values()), path,
               max((g - w).abs().max().item() for g, w in zip(got, want)),
               all(g.dtype == torch.float32
                   and torch.allclose(g, w, **SSD_BF16_TOL)
                   for g, w in zip(got, want)),
               {"ms": lambda: ssd_chunk_dual(x, cum, Bm, Cm),
                "plain_ms": lambda: ref.ssd_chunk_ref(x, cum, Bm, Cm),
                "library_ms": None})
    return timed


def profile_ssd_forward(args, chunk: int, timed_line: dict) -> dict:
    """One ``ops.ssd_forward`` call under ``torch.profiler``: the device
    time of all its kernels and copies; the device's idle share over the
    call's wall as the host issues it without the profiler (``ms`` of the
    timed line); the profiled wall (ended by a synchronize), which the
    profiler stretches; and the kernel launches and their device time in
    three groups, by the host time of each launch: the chunk kernel; the
    recurrence, launched after it up to the end of the ``torch.stack`` of
    the states (``ops.py``: the zero state, the loop over chunks, the
    stack), with the share of the profiled wall that its launches span;
    and the rest of the glue (discretization, cumsum, casts, the
    inter-chunk output).  Kernels are matched to their launches by the
    trace's correlation ids.  The chrome trace goes to ``results/``.  It
    runs after the paths: launches that follow a profiler session in the
    same process were slower (the ``mamba2-370m`` pass took 205-249 ms
    after it against 124-147 ms without; NVIDIA H100 80GB HBM3, 700 W)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    ops.ssd_forward(*args, chunk=chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ops.ssd_forward(*args, chunk=chunk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    REPORTS.mkdir(parents=True, exist_ok=True)
    trace = REPORTS / "chip_smoke.ssd_forward.trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    corr = lambda e: (e.get("args") or {}).get("correlation")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events
              if e.get("cat") in ("gpu_memcpy", "gpu_memset")]
    launch_ts = {corr(e): e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and corr(e) is not None}
    chunk_k = [e for e in kernels if "ssd_chunk" in e.get("name", "")]
    line = {"phase": "profile", "via": "ops.ssd_forward",
            "shape": timed_line["shape"], "gated": False,
            "trace": str(trace.relative_to(ROOT)),
            "host_issued_ms": timed_line["ms"], "profiled_wall_ms": wall_ms,
            "device_ms": sum(e["dur"] for e in kernels + copies) / 1e3}
    line["idle_share"] = 1.0 - line["device_ms"] / line["host_issued_ms"]
    if len(chunk_k) != 1 or corr(chunk_k[0]) not in launch_ts:
        line["split"] = None
        line["note"] = (f"{len(kernels)} device kernels in the trace, "
                        f"{len(chunk_k)} of them the chunk kernel; no split")
        return line
    start = launch_ts[corr(chunk_k[0])]
    stacks = [e["ts"] + e["dur"] for e in events
              if e.get("cat") == "cpu_op" and e.get("name") == "aten::stack"
              and e["ts"] > start]
    end = min(stacks) if stacks else float("inf")
    groups = {"chunk_kernel": [], "recurrence": [], "glue": []}
    for e in kernels:
        ts = launch_ts.get(corr(e))
        key = ("chunk_kernel" if e is chunk_k[0] else
               "recurrence" if ts is not None and start < ts <= end else
               "glue")
        groups[key].append(e)
    line["split"] = {k: {"launches": len(v),
                         "device_ms": sum(e["dur"] for e in v) / 1e3}
                     for k, v in groups.items()}
    line["split"]["recurrence"]["profiled_wall_share"] = \
        None if not stacks else (end - start) / 1e3 / wall_ms
    names = {}
    for e in groups["glue"]:
        short = e["name"][:60]
        names[short] = names.get(short, 0) + 1
    line["glue_kernels"] = dict(sorted(names.items(),
                                       key=lambda kv: -kv[1])[:8])
    return line


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


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, by kernel name (each counts its launches)."""
    from repro_torch.kernels.flash_attention import flash_attention_mha
    from repro_torch.kernels.mamba_ssd import ssd_chunk_dual
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    return {"tiled_matmul": tiled_matmul,
            "flash_attention_mha": flash_attention_mha,
            "ssd_chunk_dual": ssd_chunk_dual}


def run_path(path, dev):
    """Realize one path's fixture through the CLI entry point with
    ``--calibrate``; count the launches of the measured pass.  Check the
    predicted side (totals against the pinned ones, every stage that
    launches a kernel predicted, every ratio finite) and the overlay, and
    that an identity overlay returns its input Tech.  Returns the launches
    and the kernel route's program."""
    import math

    from repro_torch.core.workloads import make_workload
    from repro_torch.launch.realize import main as realize_main
    from repro_torch.realize.calibrate import TechOverlay, load_overlay
    from repro_torch.realize.plan import load_realize_candidates, plans_for

    (name, fixture, binding, n_stages, want_launches, want_flops,
     want_pred) = path
    fixture = FIXTURES / fixture
    report = REPORTS / f"chip_smoke.{name}.jsonl"
    overlay_path = REPORTS / f"chip_smoke.{name}.overlay.json"
    argv = ["--ckpt", str(fixture), "--workload", binding, "--top", "1",
            "--device", "cuda", "--out", str(report), "--force",
            "--calibrate", "--overlay-out", str(overlay_path)]
    last_record = lambda: [json.loads(line) for line
                           in report.read_text().splitlines()
                           if '"_key"' in line][-1]
    wrappers = kernel_wrappers()
    with contextlib.redirect_stdout(sys.stderr):   # the CLI's own table
        realize_main(argv)                          # warm-up pass
        predict_s_first = last_record()["predict_s"]
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        realize_main(argv)                          # the counted pass
        seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    rec = last_record()
    stages = rec["stages"]
    if len(stages) != n_stages or launches != want_launches:
        raise AssertionError(f"path {name} ran {len(stages)} stages with "
                             f"launches {launches}")
    if rec["totals"]["flops"] != want_flops:
        raise AssertionError(f"path {name} counted "
                             f"{rec['totals']['flops']} FLOPs, not "
                             f"{want_flops}")
    pred = {k: rec["totals"][k] for k in want_pred}
    for k, v in want_pred.items():
        if not math.isclose(pred[k], v, rel_tol=PRED_REL_TOL):
            raise AssertionError(f"path {name} predicted {k} = {pred[k]}, "
                                 f"not {v}")
    unpredicted = [s["index"] for s in stages
                   if s["flops"] > 0 and s["pred_flops"] <= 0]
    ratios = [v for s in stages for v in s["ratios"].values()] \
        + list(rec["ratio_summary"].values())
    if unpredicted or not all(math.isfinite(v) and v > 0 for v in ratios):
        raise AssertionError(f"path {name}: stages {unpredicted} launch a "
                             f"kernel with pred_flops 0, or a ratio is not "
                             f"finite: {rec['ratio_summary']}")
    overlay = load_overlay(overlay_path)
    wl_name, spec = binding.split("=", 1)
    g = make_workload(spec)
    (cand, plan), = plans_for(load_realize_candidates(fixture, {wl_name: g},
                                                      verbose=False))
    identity = TechOverlay()
    if identity.apply(cand.arch.tech) is not cand.arch.tech \
            or identity.apply_arch(cand.arch) is not cand.arch \
            or overlay.n_stages != n_stages:
        raise AssertionError(f"path {name}: the identity overlay changed "
                             f"the Tech, or the overlay saw "
                             f"{overlay.n_stages} stages")
    cubes, prog = stage_cube_errors(g, plan, dev)
    emit({"phase": "path", "workload": name, "arch": rec["arch"],
          "batch_unit": rec["batch_unit"], "stages": len(stages),
          "seconds": seconds, "launches": launches,
          "wall_ms": rec["totals"]["wall_s"] * 1e3,
          "flops": rec["totals"]["flops"],
          "dci_bytes": rec["totals"]["dci_bytes"],
          "hbm_bytes": rec["totals"]["hbm_bytes"], **pred,
          "ratio_summary": rec["ratio_summary"],
          "overlay": overlay.to_dict(),
          "identity_overlay_returns_input_tech": True,
          "predict_s": rec["predict_s"],
          "predict_s_first_pass": predict_s_first,
          "per_stage": [[s["index"], s["wall_s"] * 1e3, s["flops"],
                         s["dci_bytes"], s["pred_flops"],
                         s["pred_d2d_bytes"]] for s in stages],
          "per_stage_columns": ["stage", "wall_ms", "flops", "dci_bytes",
                                "pred_flops", "pred_d2d_bytes"],
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
    "ssd_chunk_dual": ("src/repro_torch/kernels/csrc/mamba_ssd.cu",
                       "src/repro/kernels/mamba_ssd.py:48"),
}


def per_pass_summary(timed: dict, timed_bf16: dict, runs: dict) -> list:
    """Each kernel's numbers summed over one pass of each path (the timed
    line of every launch's shape, once per launch), and each path's share
    apart; under ``bf16`` the same sums for bf16 operands at the same
    shapes (the paths themselves run f32).  ``runs`` maps a path to its
    (launches, kernel route program)."""
    out = []
    for name, (source, replaces) in KERNEL_FILES.items():
        per_path, lines, lines16 = {}, [], []
        for path, (launches, prog) in runs.items():
            keys = [(kernel, tuple(shape.values()))
                    for sp in prog.stages for kernel, shape in sp.launches
                    if kernel == name]
            ls = [timed[k] for k in keys]
            lib = [ln["library_ms"] for ln in ls]
            per_path[path] = {
                "launches": launches[name],
                "ms": sum(ln["ms"] for ln in ls),
                "plain_ms": sum(ln["plain_ms"] for ln in ls),
                "bound_ms": sum(ln["bound_ms"] for ln in ls),
                "bound_3xtf32_ms": sum(ln["bound_3xtf32_ms"] for ln in ls),
                "library_ms": None if None in lib else sum(lib)}
            lines += ls
            lines16 += [timed_bf16[k] for k in keys]
        total = lambda k: sum(p[k] for p in per_path.values())
        lib = [ln["library_ms"] for ln in lines]
        line = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": total("launches"),
            "max_abs_err": max(ln["max_abs_err"] for ln in lines),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(lines, key=lambda ln: ln["bound_ms"])["bound_by"],
            "bound_3xtf32_ms": total("bound_3xtf32_ms"), "arith": ARITH[name],
            "library_ms": None if None in lib else sum(lib),
            "per": "one pass of each path, summed; per_path splits it",
            "per_path": per_path}
        if None in lib:
            line["library"] = "none: no single PyTorch call computes it"
        lib16 = [ln["library_ms"] for ln in lines16]
        line["bf16"] = {
            "route": "cuda", "dtype": "bf16",
            "routes": sorted({ln["route"] for ln in lines16}),
            "arith": ARITH_BF16[name],
            "max_abs_err": max(ln["max_abs_err"] for ln in lines16),
            "ms": sum(ln["ms"] for ln in lines16),
            "plain_ms": sum(ln["plain_ms"] for ln in lines16),
            "bound_ms": sum(ln["bound_ms"] for ln in lines16),
            "bound_by": max(lines16,
                            key=lambda ln: ln["bound_ms"])["bound_by"],
            "library_ms": None if None in lib16 else sum(lib16),
            "per": "the launches of one pass of each path, at their shapes, "
                   "with bf16 operands (not run on the paths)"}
        out.append(line)
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir() \
            or not all((FIXTURES / p[1]).exists() for p in PATHS):
        print("chip_smoke.py: run it from the root of a checkout of the "
              "repository (src/repro_torch and the checkpoint fixtures are "
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
    hmma = {name: _build.hmma_counts(name) for name in _build.SOURCES}
    if None in hmma.values():
        emit({"phase": "sass", "HMMA": None,
              "note": "the toolkit has no cuobjdump"})
    else:
        emit({"phase": "sass", "HMMA": hmma})
        for name in _build.SOURCES:
            if not hmma[name] or 0 in hmma[name].values():
                raise AssertionError(f"{name}: a kernel without tensor-core "
                                     f"instructions: {hmma[name]}")

    timed, layer = check_kernels(dev)
    timed_bf16 = check_bf16(dev)
    runs = {path[0]: run_path(path, dev) for path in PATHS}
    emit(profile_ssd_forward(*layer))
    emit({"kernels": per_pass_summary(timed, timed_bf16, runs)})
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
