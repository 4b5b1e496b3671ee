#!/usr/bin/env python3
"""Time source variants of the port's CUDA kernels on the card.

Run from the root of a checkout, on a machine with an NVIDIA card and the
CUDA toolkit:

    python3 benchmarks/port_kernel_variants.py

Each variant is ``src/repro_torch/kernels/csrc`` with substitutions in
the shared header ``tf32x3.cuh`` or in one kernel's source, built with the
port's nvcc flags into ``results/kernel_variants/`` and called through the
same C entry points (the f32 ones), at the realization paths' shapes,
timed as ``chip_smoke.py`` times kernels (device time).  For the three
kernels:

* ``as built``: the sources as they are;
* ``cvt split``: the TF32 split through two ``cvt.rna.tf32.f32``
  conversions (hi, then lo of the rest), the PTX instruction made for it,
  in place of the integer rounding the header uses;
* ``1 product``: hi.hi only, one TF32 product in place of three.  Its
  results are off by about 1e-3 (printed): it shows what the two extra
  products cost, not a usable kernel.

For the SSD chunk kernel only:

* ``expf mask``: the decay mask through ``expf`` in place of ``__expf``;
* ``x split once``: the x tile split into its TF32 parts once, in shared
  memory (both parts kept there, read in place of a split per use; the W
  exchange single-buffered, with a second barrier a round, to make room).

For the SSD state pass (``ssd_state.cu``), its walk and its outputs
kernel at ``chip_smoke.STATE_PATH``'s three shapes:

* ``as built``;
* ``plain stores``: y written with plain 16-byte stores in place of
  streaming ones (``st.global.cs``);
* ``no L2 prefetch``: the walk without its prefetch of the next chunk's
  y_intra and S tiles;
* ``no product``: C . h taken out (zeros): its results are wrong
  (printed); it shows what the product costs next to the memory traffic.

Then the state pass's two routes, walk and split, through the port's
wrappers at 8 chunks of 128, P = 64 and a range of block counts at N =
64 and 128, beside the route ``ssd_state.state_route`` picks.

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
SOURCES = ("tiled_matmul", "flash_attention", "mamba_ssd")
EXPF = [(f"s[n][{e}] * __expf(", f"s[n][{e}] * expf(") for e in range(4)]
# the x-split-once variant applies to the f32 instance (a bf16 x tile is
# exact in TF32 and has no lo part to keep); the bf16 instance still
# compiles from the same source
SPLIT_X = [
    ("constexpr int EXF = STRIPS * 2 * 2 * 256;",
     "constexpr int EXF = STRIPS * 2 * 256;"),
    ("         sizeof(float) * (2 * size_t(QP) + EXF);",
     "         sizeof(float) * (size_t(QP) * Ld<T>::X + 2 * size_t(QP)"
     " + EXF);"),
    ("  float* cs = reinterpret_cast<float*>(Xs + QP * LDX);",
     "  float* Xl = reinterpret_cast<float*>(Xs + QP * LDX);\n"
     "  float* cs = Xl + QP * LDX;"),
    ("  __syncthreads();                      // x and the decays are in\n",
     "  __syncthreads();\n"
     "  if constexpr (!EX) {\n"
     "    for (int idx = threadIdx.x; idx < QP * PT; idx += THREADS) {\n"
     "      T* xp = Xs + (idx / PT) * LDX + idx % PT;\n"
     "      uint32_t hi, lo;\n"
     "      split(*xp, hi, lo);\n"
     "      *xp = __uint_as_float(hi);\n"
     "      Xl[xp - Xs] = __uint_as_float(lo);\n"
     "    }\n"
     "  }\n"
     "  __syncthreads();\n"),
    ("      float* buf = ex + strip * 1024 + (r & 1) * 512;",
     "      float* buf = ex + strip * 512;"),
    ("        const float4 u0 = src[0], u1 = src[1];",
     "        const float4 u0 = src[0], u1 = src[1];\n"
     "        if (hh == 1 || k + 1 > strip)\n"
     "          asm volatile(\"bar.sync %0, 64;\" :: \"r\"(1 + strip)"
     " : \"memory\");"),
    ("            split_t(xr[0], bhi[0], blo[0]);\n"
     "            split_t(xr[LDX], bhi[1], blo[1]);",
     "            if constexpr (EX) {\n"
     "              split_t(xr[0], bhi[0], blo[0]);\n"
     "              split_t(xr[LDX], bhi[1], blo[1]);\n"
     "            } else {\n"
     "              bhi[0] = __float_as_uint(xr[0]);\n"
     "              bhi[1] = __float_as_uint(xr[LDX]);\n"
     "              blo[0] = __float_as_uint(Xl[xr - Xs]);\n"
     "              blo[1] = __float_as_uint(Xl[xr - Xs + LDX]);\n"
     "            }"),
    ("        split_t(xr[0], bhi[0], blo[0]);\n"
     "        split_t(xr[LDX], bhi[1], blo[1]);",
     "        if constexpr (EX) {\n"
     "          split_t(xr[0], bhi[0], blo[0]);\n"
     "          split_t(xr[LDX], bhi[1], blo[1]);\n"
     "        } else {\n"
     "          bhi[0] = __float_as_uint(xr[0]);\n"
     "          bhi[1] = __float_as_uint(xr[LDX]);\n"
     "          blo[0] = __float_as_uint(Xl[xr - Xs]);\n"
     "          blo[1] = __float_as_uint(Xl[xr - Xs + LDX]);\n"
     "        }"),
]
SSD_VARIANTS = {"expf mask": EXPF, "x split once": SPLIT_X}
NO_PRODUCT = """    for (auto& a : acc)
      for (auto& b : a)
        for (float& e : b) e = 0.f;"""
STATE_VARIANTS = {
    "as built": [],
    "plain stores": [("        __stcs(reinterpret_cast<float4*>(dst), o);",
                      "        *reinterpret_cast<float4*>(dst) = o;")],
    "no L2 prefetch": [("    if (VEC && vec_y && c + 1 < nc) {",
                        "    if (false) {")],
    "no product": [("""    if (round8(N) == NMAX) {
      product<NMAX, true>(acc, Cs, hi, lo, T, Q, N);
    } else {
      product<NMAX, false>(acc, Cs, hi, lo, T, Q, N);
    }""", NO_PRODUCT)],
}
# (B, H, N) of the route sweep, at 8 chunks of 128 and P = 64: blocks of
# the walk from 64 to 256 at N = 128 (one walk an SM) and N = 64 (two)
STATE_SWEEP = [(2, 32, 128), (3, 32, 128), (2, 56, 128), (4, 30, 128),
               (4, 32, 128), (5, 32, 128), (4, 64, 128), (2, 32, 64),
               (3, 32, 64), (4, 32, 64), (5, 32, 64), (4, 64, 64)]


def substitute(text: str, subs, what: str) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{what}: the source has changed")
        text = text.replace(old, new)
    return text


def start_build(vdir: Path, name: str, header: str, source: str):
    vdir.mkdir(parents=True, exist_ok=True)
    (vdir / "tf32x3.cuh").write_text(header)
    src = vdir / f"{name}.cu"
    src.write_text(source)
    lib = vdir / f"{name}.so"
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                             str(lib), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def build_variants() -> dict:
    """{(variant, source): library}, every build started at once."""
    header = (_build.CSRC / "tf32x3.cuh").read_text()
    source = {n: (_build.CSRC / f"{n}.cu").read_text() for n in SOURCES}
    procs = {}
    for i, (variant, sub) in enumerate(VARIANTS.items()):
        h = header if sub is None else substitute(header, [sub], variant)
        for name in SOURCES:
            procs[(variant, name)] = start_build(OUT / f"v{i}", name, h,
                                                 source[name])
    for i, (variant, subs) in enumerate(SSD_VARIANTS.items()):
        procs[(variant, "mamba_ssd")] = start_build(
            OUT / f"s{i}", "mamba_ssd", header,
            substitute(source["mamba_ssd"], subs, variant))
    state = (_build.CSRC / "ssd_state.cu").read_text()
    for i, (variant, subs) in enumerate(STATE_VARIANTS.items()):
        procs[(variant, "ssd_state")] = start_build(
            OUT / f"t{i}", "ssd_state", header,
            substitute(state, subs, variant))
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


def least_ms(fn) -> float:
    """The least of three device timings of 100 calls each (a first
    timing in a process can read high)."""
    return min(chip_smoke.time_ms(fn, reps=100) for _ in range(3))


def time_state(libs: dict, randn, stream: int) -> None:
    """The state pass's variants at chip_smoke.STATE_PATH, then the route
    sweep (STATE_SWEEP) through the port's wrappers, each time the least
    of three."""
    import torch

    from repro_torch.kernels import ref, ssd_state
    sms = ssd_state.sm_count(torch.device("cuda", 0))
    for shape in chip_smoke.STATE_PATH:
        B, nc, Q, H, P, N, G, _ = shape
        y, S, cum, C, _ = chip_smoke.state_inputs(randn, *shape)
        want = ref.ssd_state_ref(y, S, cum, C)
        hb, _ = ref.ssd_state_scan_ref(S, cum)
        want_out = ref.ssd_state_out_ref(y, hb, cum, C)
        yo, ho = torch.empty_like(y), torch.empty_like(want[1])
        heads = ssd_state.out_heads(B * nc, H, G, P, sms)
        line = {"kernel": "ssd_state", "shape": list(shape[:7]),
                "out_heads": heads}
        for variant in STATE_VARIANTS:
            lib = libs[(variant, "ssd_state")]
            walk = lambda: lib.ssd_state_walk_f32(
                y.data_ptr(), S.data_ptr(), cum.data_ptr(), C.data_ptr(),
                None, yo.data_ptr(), ho.data_ptr(), B, nc, Q, H, P, N, G, 0,
                stream)
            out = lambda: lib.ssd_state_out_f32(
                y.data_ptr(), hb.data_ptr(), cum.data_ptr(), C.data_ptr(),
                yo.data_ptr(), B, nc, Q, H, P, N, G, heads, 0, stream)
            if walk() != 0:
                raise RuntimeError(f"{variant}: walk launch failed")
            torch.cuda.synchronize()
            walk_err = max((yo - want[0]).abs().max().item(),
                           (ho - want[1]).abs().max().item())
            walk_ms = least_ms(walk)
            if out() != 0:
                raise RuntimeError(f"{variant}: outputs launch failed")
            torch.cuda.synchronize()
            line[variant] = {
                "walk_ms": walk_ms, "walk_max_abs_err": walk_err,
                "out_ms": least_ms(out),
                "out_max_abs_err": (yo - want_out).abs().max().item()}
        print(json.dumps(line), flush=True)
    for B, H, N in STATE_SWEEP:
        args = chip_smoke.state_inputs(randn, B, 8, 128, H, 64, N, 1, False)
        y, S, cum, C, h0 = args

        def split():
            hb, h = ssd_state.ssd_state_scan(S, cum, h0)
            return ssd_state.ssd_state_out(y, hb, cum, C), h

        print(json.dumps({
            "kernel": "ssd_state_pass", "routes": "walk vs split",
            "shape": [B, 8, 128, H, 64, N, 1], "walk_blocks": B * H,
            "walk_slots": ssd_state.walk_slots(N, sms),
            "rule": ssd_state.state_route(B, H, 64, N, sms),
            "walk_ms": least_ms(lambda: ssd_state.ssd_state_walk(*args)),
            "split_ms": least_ms(split)}), flush=True)


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
            # q_offset 0 and device 0, as the entry point takes them
            launch = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), B, H, Sq, Sk, D, int(causal),
                                0, 0, stream)
            if launch() != 0:
                raise RuntimeError(f"{variant}: launch failed")
            torch.cuda.synchronize()
            line[variant] = {"ms": chip_smoke.time_ms(launch),
                             "max_abs_err": (o - want).abs().max().item()}
        print(json.dumps(line), flush=True)
    for BC, Q, H, P, N, _ in chip_smoke.SSD_PATH:
        x = randn(BC, Q, H, P)
        cum = torch.cumsum(-randn(BC, Q, H).abs() * 0.1, dim=1)
        Bm, Cm = randn(BC, Q, N), randn(BC, Q, N)
        y, s = torch.empty_like(x), torch.empty(BC, H, N, P, device=dev)
        want = ref.ssd_chunk_ref(x, cum, Bm, Cm)
        line = {"kernel": "ssd_chunk_dual", "shape": [BC, Q, H, P, N]}
        for variant in [*VARIANTS, *SSD_VARIANTS]:
            fn = libs[(variant, "mamba_ssd")].ssd_chunk_dual_f32
            launch = lambda: fn(x.data_ptr(), cum.data_ptr(), Bm.data_ptr(),
                                Cm.data_ptr(), y.data_ptr(), s.data_ptr(),
                                BC, Q, H, P, N, 0, stream)
            if launch() != 0:
                raise RuntimeError(f"{variant}: launch failed")
            torch.cuda.synchronize()
            line[variant] = {"ms": chip_smoke.time_ms(launch),
                             "max_abs_err": max(
                                 (g - w).abs().max().item()
                                 for g, w in zip((y, s), want))}
        print(json.dumps(line), flush=True)
    time_state(libs, randn, stream)
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
