#!/usr/bin/env python3
"""Time the SSD chunk kernel's levers on the card, and the kernel of other
trees beside this one's.

Run from the root of a checkout, on a machine with an NVIDIA card and the
CUDA toolkit:

    python3 benchmarks/port_ssd_variants.py [--tree NAME=SRC ...]

Each variant is ``src/repro_torch/kernels/csrc/mamba_ssd.cu`` with
substitutions, built with the port's nvcc flags into
``results/ssd_variants/`` and called through its C entry points (f32,
mixed, bf16), at the main paths' shapes (``chip_smoke.SSD_SERVE``:
zamba2-1.2b's serve wave; ``chip_smoke.SSD_WIDE[0]``: mamba2-370m's;
``chip_smoke.SSD_PATH``: the realization's), timed as ``chip_smoke.py``
times kernels (device time, the least of three) and held against the
plain version (1e-4) where its result is meant to be right:

* ``as built``;
* ``N heads a block``: the grid-fill rule replaced by N (1, 2, 4, 8,
  16); 1 computes C Bᵀ once for every head, as the design before this
  one did;
* ``no S``, ``no y``, ``no tables``: the state's product, the output's
  product, or the per-unit decay tables taken out.  Their results are
  wrong (printed): they show what each part costs;
* ``P64 units``: bf16 x at P = 128 in two units of 64 columns, in place
  of one of 128;
* ``expf tables``: the decay tables through ``expf`` in place of
  ``__expf``.

Then, with ``--tree NAME=SRC`` (a ``src`` directory, e.g. a parent
commit unpacked with ``git archive``), each tree's ``ssd_chunk_dual``
wrapper at every launch shape of the serving, eval and realization paths
(``PATH_LAUNCHES``), in the types it takes (a tree without the mixed
launch function raises on mixed inputs and is timed on f32 and bf16), the
trees in turn and then in reverse order (parent, new, new, parent), and
one pass of each path summed from them in the type the path launches.
Prints one JSON line per shape and per path, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "results" / "ssd_variants"
RULE = "  const int HB = heads_per_block(BC, H, P, PT, sms);"
VARIANTS = {
    "as built": [],
    **{f"{n} heads a block": [(RULE, f"  const int HB = {n};")]
       for n in (1, 2, 4, 8, 16)},
    "no S": [("      if (hasSA) s_tile(sa, mA);\n"
              "      if (hasSB) s_tile(sb, mB);\n", "")],
    "no y": [("      if (hasA && J <= sA) y_tile(ya, sA);\n"
              "      if (hasB && J <= sB) y_tile(yb, sB);\n", "")],
    "no tables": [("  float* de = bt + QMAX;                // [QMAX]\n",
                   "  float* de = bt + QMAX;                // [QMAX]\n"
                   "  if (Q > 0) return;\n")],
    "P64 units": [("  return x_bytes == 2 && N <= NMAX_S && P > 64 ? 128 "
                   ": 64;", "  return 64;")],
    "expf tables": [("dg[e] = j <= i ? __expf(", "dg[e] = j <= i ? expf("),
                    ("bt[16 * J + lane] = __expf(",
                     "bt[16 * J + lane] = expf("),
                    ("at[J * QMAX + i] = __expf(",
                     "at[J * QMAX + i] = expf(")],
}
# variants whose results are not the function's
WRONG = ("no S", "no y", "no tables")
DTYPES = ("f32", "mixed", "bf16")
# the chunk kernel's launches in one pass of each path that runs it, by
# (BC, Q, H, P, N): chip_smoke.py's per_path (zamba2's two waves of 38
# layers, mamba2-370m's of 48, the trace's five waves, the train eval's
# and the cells' prefill, the realization's 48 SSD layers; its bf16 line
# times the same launches with bf16 operands)
PATH_LAUNCHES = {
    "serve": {(32, 128, 64, 64, 64): 38, (24, 128, 64, 64, 64): 38},
    "serve:mamba2-370m": {(32, 128, 32, 64, 128): 48,
                          (24, 128, 32, 64, 128): 48},
    "serve_trace": {(21, 128, 32, 64, 128): 48, (32, 128, 32, 64, 128): 144,
                    (8, 128, 32, 64, 128): 48},
    "train:mamba2-370m": {(32, 128, 32, 64, 128): 48},
    "cells:mamba2-370m": {(128, 128, 32, 64, 128): 48},
    "mamba2-370m": {(32, 128, 16, 128, 64): 48},
    "mamba2-370m bf16": {(32, 128, 16, 128, 64): 48},
}
# the type each path launches (serving, the train eval and the cells
# compute in bf16: x and cum f32, B and C bf16); "mixed" where not named
PATH_DTYPE = {"mamba2-370m": "f32", "mamba2-370m bf16": "bf16"}


def shapes() -> list:
    return [s[:5] for s in chip_smoke.SSD_SERVE + chip_smoke.SSD_WIDE[:1]
            + chip_smoke.SSD_PATH]


def substitute(text: str, subs, what: str) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{what}: the source has changed")
        text = text.replace(old, new)
    return text


def build() -> dict:
    """{variant: library}, every build started at once."""
    source = (_build.CSRC / "mamba_ssd.cu").read_text()
    procs = {}
    for i, (variant, subs) in enumerate(VARIANTS.items()):
        vdir = OUT / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC.glob("*.cuh"):
            (vdir / header.name).write_text(header.read_text())
        (vdir / "mamba_ssd.cu").write_text(substitute(source, subs, variant))
        lib = vdir / "mamba_ssd.so"
        procs[variant] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(vdir / "mamba_ssd.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for variant, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{variant}: nvcc failed\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(json.dumps({"variant": variant, "ptxas": regs}), flush=True)
        cdll = ctypes.CDLL(str(lib))
        for name, argtypes in _build.SIGNATURES["mamba_ssd"].items():
            fn = getattr(cdll, name)
            fn.restype, fn.argtypes = ctypes.c_int, argtypes
        libs[variant] = cdll
    return libs


def least_ms(fn) -> float:
    return min(chip_smoke.time_ms(fn, reps=50) for _ in range(3))


def time_variants(libs: dict, dev) -> None:
    import torch

    from repro_torch.kernels import ref
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)
    for BC, Q, H, P, N in shapes():
        for dtype in DTYPES:
            x, cum, Bm, Cm = chip_smoke.ssd_inputs(randn, BC, Q, H, P, N,
                                                   dtype)
            y = torch.empty(BC, Q, H, P, device=dev)
            s = torch.empty(BC, H, N, P, device=dev)
            want = ref.ssd_chunk_ref(x.float(), cum.float(), Bm.float(),
                                     Cm.float())
            line = {"kernel": "ssd_chunk_dual", "dtype": dtype,
                    "shape": [BC, Q, H, P, N]}
            for variant, lib in libs.items():
                fn = getattr(lib, f"ssd_chunk_dual_{dtype}")
                launch = lambda: fn(x.data_ptr(), cum.data_ptr(),
                                    Bm.data_ptr(), Cm.data_ptr(),
                                    y.data_ptr(), s.data_ptr(), BC, Q, H, P,
                                    N, dev.index or 0, stream)
                if launch() != 0:
                    raise RuntimeError(f"{variant}: launch failed")
                torch.cuda.synchronize()
                err = max((g - w).abs().max().item()
                          for g, w in zip((y, s), want))
                ok = all(torch.allclose(g, w, atol=1e-4, rtol=1e-4)
                         for g, w in zip((y, s), want))
                if variant not in WRONG and not ok:
                    raise AssertionError(f"{variant} {dtype} disagrees at "
                                         f"{[BC, Q, H, P, N]}: {err}")
                line[variant] = {"ms": least_ms(launch), "max_abs_err": err}
            print(json.dumps(line), flush=True)


def tree_wrapper(src: Path):
    """``ssd_chunk_dual`` of the ``repro_torch`` under ``src``, built."""
    for mod in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[mod]
    sys.path.insert(0, str(src))
    try:
        build_mod = importlib.import_module("repro_torch.kernels._build")
        build_mod.build(["mamba_ssd"])
        return importlib.import_module(
            "repro_torch.kernels.mamba_ssd").ssd_chunk_dual
    finally:
        sys.path.remove(str(src))


def time_trees(trees: dict, dev) -> None:
    """Each tree's wrapper at every launch shape of ``PATH_LAUNCHES`` in
    each type it takes, the trees in turn and then in reverse order; then
    one pass of each path summed, in the type the path launches there
    (``PATH_DTYPE``; a tree that refuses mixed inputs, whose
    ``ops.ssd_chunks`` upcasts B and C, launches f32 on those paths)."""
    import torch
    wrappers = {name: tree_wrapper(src) for name, src in trees.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)
    order = list(wrappers) + list(reversed(wrappers))
    shapes = sorted({sh for per in PATH_LAUNCHES.values() for sh in per})
    ms = {}
    for shape in shapes:
        for dtype in DTYPES:
            args = chip_smoke.ssd_inputs(randn, *shape, dtype)
            line = {"kernel": "ssd_chunk_dual", "dtype": dtype,
                    "shape": list(shape), "order": order}
            for name in order:
                fn = wrappers[name]
                try:
                    fn(*args)
                except TypeError as e:       # a tree without the type
                    line[name] = {"refused": str(e)[:80]}
                    continue
                line.setdefault(name, {"ms": []})["ms"].append(
                    least_ms(lambda: fn(*args)))
            for name in wrappers:
                if "ms" in line[name]:
                    ms[(name, dtype, shape)] = (sum(line[name]["ms"])
                                                / len(line[name]["ms"]))
            print(json.dumps(line), flush=True)
            del args
    for path, per in PATH_LAUNCHES.items():
        line = {"kernel": "ssd_chunk_dual", "path": path,
                "launches": sum(per.values())}
        for name in wrappers:
            dtype = PATH_DTYPE.get(path, "mixed")
            if any((name, dtype, sh) not in ms for sh in per):
                dtype = "f32"
            line[name] = {"dtype": dtype, "ms": sum(
                n * ms[(name, dtype, sh)] for sh, n in per.items())}
        print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=SRC: time the ssd_chunk_dual of the "
                         "repro_torch under SRC beside this tree's")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    time_variants(build(), dev)
    if args.tree:
        trees = dict(t.split("=", 1) for t in args.tree)
        trees = {name: Path(src).resolve() for name, src in trees.items()}
        trees.setdefault("new", ROOT / "src")
        time_trees(trees, dev)
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
