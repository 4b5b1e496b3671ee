#!/usr/bin/env python3
"""Time configurations of the port's bf16 tensor-core kernels on the card.

Run from the root of a checkout, on a machine with an NVIDIA card and the
CUDA toolkit:

    python3 benchmarks/port_bf16_variants.py

Each variant is a source of ``src/repro_torch/kernels/csrc`` with a
substitution, built with the port's nvcc flags into
``results/bf16_variants/`` and called through its C entry points, timed
as ``chip_smoke.py`` times kernels (device time), and held against the
plain version at the reference's bf16 tolerances.

* Flash (``flash_attention_bf16``), at the main paths' bf16 shapes (head
  dim 64: the cells' prefill, the train eval, the pipeline, zamba2's and
  whisper-small's serve waves, whisper's encoder and cross-attention) and
  the granite realization shape at head dim 128: ``as built`` (4 warps of
  16 query rows, 64-key tiles, three blocks an SM up to D = 64), ``4
  blocks an SM`` (a register cap of 128 in place of 168), ``8 warps``
  (128 query rows a block, two blocks an SM), ``kv32`` and ``kv128`` (32-
  and 128-key tiles at D <= 64).  Registers and spills of each at head dim 64 print first.
* The GEMM (``gemm_wgmma_bf16``), at ``chip_smoke.MM_PATH``: each of the
  four wgmma tiles forced (``128x256``, ``128x128``, ``128x64``,
  ``64x64``), beside the tile ``wgmma_tile`` picks (``rule``); a last
  line sums each over the shapes, with the per-shape best and bf16
  ``torch.matmul``.

Prints one JSON line per shape, the sums, then the card's name and power
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

OUT = ROOT / "results" / "bf16_variants"
BF16_CFG = """  static constexpr int WARPS = 4;
  static constexpr int BQ = 16 * WARPS;
  static constexpr int BKV = DMAX > 128 ? 32 : 64;
  static constexpr bool QREG = DMAX <= 128;
  static constexpr int MIN_BLOCKS = DMAX <= 64 ? 3 : 1;"""
FLASH_VARIANTS = {
    "as built": BF16_CFG,
    "4 blocks an SM": BF16_CFG.replace("DMAX <= 64 ? 3 : 1;",
                                       "DMAX <= 64 ? 4 : 1;"),
    "8 warps": BF16_CFG.replace("WARPS = 4;", "WARPS = DMAX <= 64 ? 8 : 4;")
    .replace("DMAX <= 64 ? 3 : 1;", "DMAX <= 64 ? 2 : 1;"),
    "kv32": BF16_CFG.replace("BKV = DMAX > 128 ? 32 : 64;",
                             "BKV = DMAX > 128 || DMAX <= 64 ? 32 : 64;"),
    "kv128": BF16_CFG.replace("BKV = DMAX > 128 ? 32 : 64;",
                              "BKV = DMAX > 128 ? 32 : DMAX <= 64 ? 128 : 64;")
    .replace("DMAX <= 64 ? 3 : 1;", "DMAX <= 64 ? 2 : 1;"),
}
# the route names' check of the built configuration, left out of variants
ROUTE_CHECK = """    static_assert(Bf16Cfg<64>::BQ == 64 && Bf16Cfg<64>::BKV == 64 &&
                      Bf16Cfg<256>::BQ == 64 && Bf16Cfg<256>::BKV == 32,
                  "the route names name the configurations");
"""
# (B, H, Sq, Sk, D, causal): where each runs
FLASH_SHAPES = {
    "cells:smollm-135m": (4, 9, 4096, 4096, 64, True),
    "train:smollm-135m": (4, 9, 1024, 1024, 64, True),
    "pipeline:smollm-135m": (2, 9, 1024, 1024, 64, True),
    "serve (zamba2-1.2b)": (4, 32, 916, 916, 64, True),
    "serve:whisper-small": (4, 12, 916, 916, 64, False),
    "whisper encoder": (4, 12, 1500, 1500, 64, False),
    "whisper cross": (4, 12, 448, 1500, 64, False),
    "granite (realization, bf16)": (1, 12, 4096, 4096, 128, True),
}
GEMM_TILES = {"128x256": "WgWide", "128x128": "WgBig", "128x64": "WgMid",
              "64x64": "WgSmall"}
# a C entry point that launches one tile, whatever wgmma_tile would pick
GEMM_ENTRY = """
extern "C" int gemm_tile_bf16(int tile, const void* a, const void* b,
                              void* c, int M, int N, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
%s
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
"""


def substitute(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"variant anchor not found: {old[:60]!r}")
    return text.replace(old, new)


def build() -> dict:
    """Write and build every variant, one nvcc each, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    flash = (_build.CSRC / "flash_attention.cu").read_text()
    unchecked = substitute(flash, ROUTE_CHECK, "")
    sources = {f"flash {name}": substitute(
        flash if name == "as built" else unchecked, BF16_CFG, cfg)
               for name, cfg in FLASH_VARIANTS.items()}
    cases = "\n".join(f"    case {i}: return launch_wgmma<{w}>(a, b, c, M, N, "
                      f"K, st);" for i, w in enumerate(GEMM_TILES.values()))
    gemm = (_build.CSRC / "tiled_matmul.cu").read_text()
    sources["gemm tiles"] = substitute(gemm, '}  // namespace\n',
                                       '}  // namespace\n'
                                       + GEMM_ENTRY % cases)
    procs = {}
    for name, text in sources.items():
        stem = name.replace(" ", "_")
        (OUT / f"{stem}.cu").write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{stem}.so"),
             str(OUT / f"{stem}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), stem)
    libs = {}
    for name, (proc, stem) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"{stem}.so"))
        # registers and spills of the bf16 kernels at head dim 64
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and (
                    "flash_fwd_bf16ILi64E" in ln or "gemm_wgmma_bf16" in ln):
                print(json.dumps({"variant": name, "function": ln.split(
                    "'")[1], "ptxas": [x.strip() for x in lines[i + 1:i + 4]
                                       if "spill" in x or "registers" in x]}))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        if name.startswith("flash"):
            lib.flash_attention_bf16.argtypes = [P] * 4 + [I] * 8 + [P]
        else:
            lib.gemm_tile_bf16.argtypes = [I] + [P] * 3 + [I] * 3 + [P]
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import tiled_matmul as mm
    from repro_torch.kernels.flash_attention import flash_attention_mha

    if not torch.cuda.is_available():
        print("port_bf16_variants.py: no CUDA device", file=sys.stderr)
        return 2
    libs = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen).bfloat16()
    stream = torch.cuda.current_stream(dev).cuda_stream
    time_ms = chip_smoke.time_ms

    for where, (B, H, Sq, Sk, D, causal) in FLASH_SHAPES.items():
        q, k, v = randn(B, H, Sq, D), randn(B, H, Sk, D), randn(B, H, Sk, D)
        want = ref.attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal)
        line = {"kernel": "flash_attention_mha", "main_path": where,
                "shape": [B, H, Sq, Sk, D, int(causal)]}
        for name, lib in libs.items():
            if not name.startswith("flash"):
                continue
            o = torch.empty_like(q)
            call = lambda: lib.flash_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H,
                Sq, Sk, D, int(causal), 0, 0, stream)
            if call() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            if not torch.allclose(o.float(), want, atol=2e-2, rtol=2e-2):
                raise AssertionError(f"{name} disagrees at {line['shape']}")
            line[name[len("flash "):]] = time_ms(call)
        line["package"] = time_ms(
            lambda: flash_attention_mha(q, k, v, causal=causal))
        line["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
        print(json.dumps(line), flush=True)

    lib = libs["gemm tiles"]
    sums = {**{t: 0.0 for t in GEMM_TILES}, "rule": 0.0, "best": 0.0,
            "library_ms": 0.0}
    for M, K, N in chip_smoke.MM_PATH:
        a, b = randn(M, K), randn(K, N)
        want = ref.matmul_ref(a.float(), b.float())
        line = {"kernel": "tiled_matmul", "shape": [M, K, N],
                "rule_route": mm.kernel_route(a, b)}
        for i, tile in enumerate(GEMM_TILES):
            c = torch.empty((M, N), device=dev, dtype=torch.bfloat16)
            call = lambda: lib.gemm_tile_bf16(i, a.data_ptr(), b.data_ptr(),
                                              c.data_ptr(), M, N, K, stream)
            if call() != 0:
                raise RuntimeError(f"{tile}: launch failed")
            torch.cuda.synchronize()
            if not torch.allclose(c.float(), want, atol=0.5, rtol=5e-2):
                raise AssertionError(f"{tile} disagrees at {(M, K, N)}")
            line[tile] = time_ms(call)
            sums[tile] += line[tile]
        line["rule"] = line[line["rule_route"].split()[0]]
        line["library_ms"] = time_ms(lambda: torch.matmul(a, b))
        for key in ("rule", "library_ms"):
            sums[key] += line[key]
        sums["best"] += min(line[t] for t in GEMM_TILES)
        print(json.dumps(line), flush=True)
    print(json.dumps({"kernel": "tiled_matmul", "sum_over": "MM_PATH",
                      **sums}))
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
