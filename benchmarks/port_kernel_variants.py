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

* ``expf mask``: the decay tables (the diagonal tiles' masked decays and
  the row and column factors) through ``expf`` in place of ``__expf``.

Its other levers (heads a block, the bf16 scores of the mixed instance)
are ``benchmarks/port_ssd_variants.py``'s.

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

For the evaluator's fused pass (``fused_eval.cu``), at the six shapes of
``chip_smoke.py``'s ``fused_eval`` lines (three layouts, batches of 4 and
64), against the plain version:

* ``as built``;
* ``T threads, U a lane``: the block size and the stream entries each
  lane has in flight (one pair is the source as built);
* ``no warp aggregation``: each entry added to its cell by its own
  shared-memory atomicAdd, without first summing a warp's entries for
  the same cell (``__match_any_sync``);
* ``no stream`` and ``no row math``: the stream's adds, or everything
  after them, taken out.  Their results are wrong (printed): they show
  what each part of the kernel costs next to the launch and its loads.

Then the row length (``buf_len`` cells) of the archs the repo builds,
beside the most cells a ``fused_eval`` row may have on the card.

For the analyzer's replay (``segment_replay`` in ``fused_eval.cu``), at
``chip_smoke.py``'s ``segment_replay`` lines (three layouts, ``REPLAY_B``
rows), against ``np.bincount`` bit for bit:

* ``N cells a block``: the cells one block owns, 32 to 512, forced, beside
  ``rule`` (the most that still give every SM a block,
  ``replay_cells_per_block``).  A last line sums each cut's times over the
  lines and names the least.

Prints one JSON line per kernel and shape, then the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import re
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
EXPF = [("dg[e] = j <= i ? __expf(", "dg[e] = j <= i ? expf("),
        ("bt[16 * J + lane] = __expf(", "bt[16 * J + lane] = expf("),
        ("at[J * QMAX + i] = __expf(", "at[J * QMAX + i] = expf(")]
SSD_VARIANTS = {"expf mask": EXPF}
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
FUSED_SHAPE = re.compile(r"constexpr int kThreads = \d+;.*\n"
                         r"constexpr int kUnroll = \d+;")
FUSED_AGGREGATE = """  unsigned peers = __match_any_sync(0xffffffffu, c);
  const int first = __ffs(peers) - 1;
  int rel = __popc(peers & ((1u << lane) - 1u));   // peers below this lane
  peers &= ~((2u << lane) - 1u);                   // peers above it
  while (__any_sync(0xffffffffu, peers != 0u)) {
    const int next = __ffs(peers);                 // 0: none left
    const float t = __shfl_sync(0xffffffffu, v, (next - 1) & 31);
    if (next) v += t;
    peers &= ~__ballot_sync(0xffffffffu, rel & 1);
    rel >>= 1;
  }
  if (c >= 0 && lane == first) cells[c] += v;"""
FUSED_STREAM = "    for (long long base = lo + 32 * warp;"
FUSED_MATH = "  float acc[N_ACC];\n"


def fused_variants(source: str) -> dict:
    """{variant: substitutions} of fused_eval.cu."""
    built, = FUSED_SHAPE.findall(source)
    out = {"as built": []}
    for t, u in ((256, 8), (512, 2), (512, 4), (1024, 2), (1024, 4)):
        out[f"{t} threads, {u} a lane"] = [
            (built, f"constexpr int kThreads = {t};\n"
                    f"constexpr int kUnroll = {u};")]
    out["no warp aggregation"] = [
        (FUSED_AGGREGATE, "  if (c >= 0) atomicAdd(cells + c, v);")]
    out["no stream"] = [(FUSED_STREAM, "    for (long long base = hi;")]
    out["no row math"] = [(FUSED_MATH, "  if (buf_len > 0) return;\n"
                                       + FUSED_MATH)]
    return out


REPLAY_RULE = "  int cells = kReplayCells;\n"
REPLAY_CUTS = (32, 64, 128, 256, 512)


def replay_variants(source: str) -> dict:
    """{variant: substitutions} of fused_eval.cu: segment_replay's cut,
    each forced, beside the rule as built."""
    return {"rule": [], **{f"{n} cells a block": [
        (REPLAY_RULE, f"  return {n};\n  int cells = kReplayCells;\n")]
        for n in REPLAY_CUTS}}


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
    for other in _build.CSRC.glob("*.cuh"):
        (vdir / other.name).write_text(other.read_text())
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
    fused = (_build.CSRC / "fused_eval.cu").read_text()
    for i, (variant, subs) in enumerate(fused_variants(fused).items()):
        procs[(variant, "fused_eval")] = start_build(
            OUT / f"f{i}", "fused_eval", header,
            substitute(fused, subs, variant))
    for i, (variant, subs) in enumerate(replay_variants(fused).items()):
        procs[(variant, "fused_eval")] = start_build(
            OUT / f"r{i}", "fused_eval", header,
            substitute(fused, subs, variant))
    libs = {}
    for key, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key} failed to build:\n{log}")
        lib = ctypes.CDLL(str(path))
        for symbol, argtypes in {**_build.SIGNATURES[key[1]],
                                 **_build.QUERIES.get(key[1], {})}.items():
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


def time_fused(libs: dict, stream: int) -> None:
    """fused_eval's variants at chip_smoke.py's fused_eval shapes, each
    time the least of three, with the largest error relative to the plain
    version."""
    import torch

    from repro_torch.core.evaluator import Evaluator
    from repro_torch.kernels import fused_eval, ref
    dev = torch.device("cuda", 0)
    source = (_build.CSRC / "fused_eval.cu").read_text()
    variants = fused_variants(source)
    # a variant's block sums a row into as many copies as it has warps
    warps = {v: int(re.search(r"constexpr int kThreads = (\d+);",
                              substitute(source, subs, v)).group(1)) // 32
             for v, subs in variants.items()}
    for layout, arch, g, batch in chip_smoke.cost_layouts():
        for B in chip_smoke.FUSED_B:
            reqs = chip_smoke.cost_requests(arch, g, B, seed=B,
                                            total_batch=batch)
            ev = Evaluator(arch, g, fused_device=dev)
            plan = ev.fused_plan()
            x = ev._fused_inputs(reqs, batch)
            args = [torch.from_numpy(a.copy()).to(dev) for a in x]
            off, idx, vals, npass, depth, wts = args
            want, _ = ref.fused_eval_ref(
                *args, spans=plan.spans, d2d_mask=plan.d2d_mask,
                consts=plan.consts, has_d2d=plan.has_d2d,
                buf_len=plan.buf_len)
            out = torch.empty_like(want)
            bn = torch.empty(B, dtype=torch.int32, device=dev)
            if fused_eval.splits(dev, plan.buf_len) != 1:
                raise RuntimeError("the variants time one launch a row")
            line = {"kernel": "fused_eval", "layout": layout, "B": B,
                    "stream": idx.numel(), "buf_len": plan.buf_len}
            for variant in variants:
                fn = libs[(variant, "fused_eval")].fused_eval_f32
                copies = min(warps[variant],
                             fused_eval.max_cells(dev) // plan.buf_len)
                launch = lambda: fn(
                    off.data_ptr(), idx.data_ptr(), vals.data_ptr(),
                    idx.numel(), B, plan.buf_len, npass.data_ptr(),
                    depth.data_ptr(), wts.data_ptr(), plan.spans.data_ptr(),
                    plan.d2d_mask.data_ptr(), plan.consts.data_ptr(),
                    int(plan.has_d2d), copies, 1, None, out.data_ptr(),
                    bn.data_ptr(), 0, stream)
                if launch() != 0:
                    raise RuntimeError(f"{variant}: launch failed")
                torch.cuda.synchronize()
                line[variant] = {
                    "ms": least_ms(launch),
                    "max_rel_err": ((out - want).abs()
                                    / want.abs().clamp_min(1e-30))
                    .max().item()}
            print(json.dumps(line), flush=True)


def time_replay(libs: dict, stream: int) -> None:
    """segment_replay's cuts at chip_smoke.py's segment_replay lines, each
    time the least of three, and whether each gives np.bincount's bits;
    then each cut's times summed over the lines."""
    import numpy as np
    import torch

    from repro_torch.core.evaluator import Evaluator
    dev = torch.device("cuda", 0)
    variants = replay_variants((_build.CSRC / "fused_eval.cu").read_text())
    total = dict.fromkeys(variants, 0.0)
    for layout, arch, g, batch in chip_smoke.cost_layouts():
        for B in chip_smoke.REPLAY_B:
            reqs = chip_smoke.cost_requests(arch, g, B, seed=B,
                                            total_batch=batch)
            ev = Evaluator(arch, g, fused_device="cpu")
            idx, vals, _ = ev.analyzer._request_streams(reqs, batch)
            n = B * ev.analyzer._buf_len
            ti, tv = torch.from_numpy(idx).to(dev), torch.from_numpy(
                vals).to(dev)
            want = np.bincount(idx, weights=vals, minlength=n)
            out = torch.empty(n, dtype=torch.float64, device=dev)
            line = {"kernel": "segment_replay", "layout": layout, "B": B,
                    "stream": int(idx.size), "cells": n}
            for variant in variants:
                lib = libs[(variant, "fused_eval")]
                ranges = torch.empty(2 * -(-n // 32),
                                     dtype=torch.int32, device=dev)
                launch = lambda init=0: lib.segment_replay_f64(
                    ti.data_ptr(), tv.data_ptr(), ti.numel(), out.data_ptr(),
                    n, ranges.data_ptr(), init, 0, stream)
                if launch(1) != 0:
                    raise RuntimeError(f"{variant}: launch failed")
                torch.cuda.synchronize()
                ms = least_ms(launch)
                total[variant] += ms
                line[variant] = {"ms": ms, "bit_equal_bincount": bool(
                    np.array_equal(out.cpu().numpy(), want))}
            print(json.dumps(line), flush=True)
    print(json.dumps({"kernel": "segment_replay", "summed_ms": total,
                      "least": min(total, key=total.get)}), flush=True)


def fused_rows_fit() -> None:
    """``buf_len`` of S-Arch, the 72-TOPS Gemini arch and the most-cored
    ``grid_candidates`` at 72 to 1024 TOPS (the analyzer's layout, which
    depends on the arch alone), against ``fused_eval.max_cells``."""
    import torch

    from repro_torch.core.analyzer import Analyzer
    from repro_torch.core.dse import grid_candidates
    from repro_torch.core.hw import gemini_arch_72t, simba_arch
    from repro_torch.core.workloads import make_workload
    from repro_torch.kernels.fused_eval import max_cells
    g = make_workload("tf-paper")
    archs = {"simba_arch": simba_arch(), "gemini_arch_72t": gemini_arch_72t()}
    for tops in (72, 128, 512, 1024):
        archs[f"grid_candidates({tops}), most cores"] = max(
            grid_candidates(tops), key=lambda a: a.n_cores)
    rows = {name: {"cores": a.n_cores,
                   "buf_len": Analyzer(a, g, fused_device="cpu")._buf_len}
            for name, a in archs.items()}
    limit = max_cells(torch.device("cuda", 0))
    print(json.dumps({"kernel": "fused_eval", "rows": rows,
                      "max_cells": limit,
                      "all_fit": all(r["buf_len"] <= limit
                                     for r in rows.values())}), flush=True)


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
    time_fused(libs, stream)
    fused_rows_fit()
    time_replay(libs, stream)
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
