#!/usr/bin/env python3
"""Time source variants of the port's GEMM and flash kernels on the card.

Run from the root of a checkout, on a machine with an NVIDIA card and the
CUDA toolkit:

    python3 benchmarks/port_kernel_variants.py

Each variant is ``src/repro_torch/kernels/csrc`` with one substitution in
the shared header ``tf32x3.cuh``, built with the port's nvcc flags into
``results/kernel_variants/`` and called through the same C entry points,
at the realization paths' shapes, timed as ``chip_smoke.py`` times kernels
(device time):

* ``as built``: the sources as they are;
* ``cvt split``: the TF32 split through two ``cvt.rna.tf32.f32``
  conversions (hi, then lo of the rest), the PTX instruction made for it,
  in place of the integer rounding the header uses;
* ``1 product``: hi.hi only, one TF32 product in place of three.  Its
  results are off by about 1e-3 (printed): it shows what the two extra
  products cost, not a usable kernel.

Prints one JSON line per kernel and shape, then the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "results" / "kernel_variants"
SPLIT = """  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));"""
CVT_SPLIT = """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo)
      : "f"(x - __uint_as_float(hi)));"""
THREE = """  mma(d, alo, bhi);
  mma(d, ahi, blo);
  mma(d, ahi, bhi);"""
VARIANTS = {"as built": None, "cvt split": (SPLIT, CVT_SPLIT),
            "1 product": (THREE, "  mma(d, ahi, bhi);")}
SOURCES = ("tiled_matmul", "flash_attention")


def build_variants() -> dict:
    """{(variant, source): library}, every build started at once."""
    header = (_build.CSRC / "tf32x3.cuh").read_text()
    procs = {}
    for i, (variant, sub) in enumerate(VARIANTS.items()):
        vdir = OUT / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        if sub is not None and sub[0] not in header:
            raise RuntimeError(f"{variant}: the header has changed")
        (vdir / "tf32x3.cuh").write_text(
            header if sub is None else header.replace(*sub))
        for name in SOURCES:
            src = vdir / f"{name}.cu"
            src.write_text((_build.CSRC / f"{name}.cu").read_text())
            lib = vdir / f"{name}.so"
            procs[(variant, name)] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                 str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key} failed to build:\n{log}")
        lib = ctypes.CDLL(str(path))
        for symbol, argtypes in _build.SIGNATURES[key[1]].items():
            fn = getattr(lib, symbol)
            fn.restype, fn.argtypes = ctypes.c_int, argtypes
        libs[key] = lib
    return libs


def main() -> int:
    import torch

    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("port_kernel_variants.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)
    for M, K, N in chip_smoke.MM_PATH:
        a, b = randn(M, K), randn(K, N)
        c, want = torch.empty(M, N, device=dev), ref.matmul_ref(a, b)
        line = {"kernel": "tiled_matmul", "shape": [M, K, N]}
        for variant in VARIANTS:
            fn = libs[(variant, "tiled_matmul")].tiled_matmul_f32
            launch = lambda: fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                M, N, K, 0, stream)
            if launch() != 0:
                raise RuntimeError(f"{variant}: launch failed")
            torch.cuda.synchronize()
            line[variant] = {"ms": chip_smoke.time_ms(launch),
                             "max_abs_err": (c - want).abs().max().item()}
        print(json.dumps(line), flush=True)
    for B, H, Sq, Sk, D, causal in chip_smoke.FLASH_PATH:
        q, k, v = randn(B, H, Sq, D), randn(B, H, Sk, D), randn(B, H, Sk, D)
        o = torch.empty_like(q)
        want = ref.attention_ref(q, k, v, causal=causal)
        line = {"kernel": "flash_attention_mha",
                "shape": [B, H, Sq, Sk, D, causal]}
        for variant in VARIANTS:
            fn = libs[(variant, "flash_attention")].flash_attention_f32
            launch = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), B, H, Sq, Sk, D, int(causal), 0,
                                stream)
            if launch() != 0:
                raise RuntimeError(f"{variant}: launch failed")
            torch.cuda.synchronize()
            line[variant] = {"ms": chip_smoke.time_ms(launch),
                             "max_abs_err": (o - want).abs().max().item()}
        print(json.dumps(line), flush=True)
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
