"""Build and bind the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``
into ``_build/`` beside this file (listed in ``.gitignore``), then loaded
with ``ctypes``.  A library's file name carries a digest of its source, of
every shared header ``csrc/*.cuh`` and of the flags, so an edited source or
header is rebuilt and a stale library never loads.
:func:`build` compiles several sources at once, one ``nvcc`` process each;
:func:`load` declares each C entry point's signature once, from
:data:`SIGNATURES`.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# the sources whose every kernel multiplies on the tensor cores (SASS
# HMMA, or HGMMA for the wgmma kernels), each with an f32 and a bf16 launch
# function, apart from NO_PRODUCT_KERNELS; fused_eval does no product, and
# in ssd_state (f32 only) the walk and the split's outputs do but the scan
# does not
TENSOR_CORE_SOURCES = ("tiled_matmul", "flash_attention", "mamba_ssd")
SOURCES = TENSOR_CORE_SOURCES + ("fused_eval", "ssd_state")
# the kernel functions (a part of the mangled name), by source, that take f32
# operands into 3xTF32 products on TF32 wgmma: each must hold HGMMA with TF32
# operands and no bf16 product
TF32_WGMMA_KERNELS = {"flash_attention": "flash_fwd_wgmma_tf32x3",
                      "tiled_matmul": "gemm_wgmma_tf32x3"}
# the functions of a tensor-core source that do no product (the GEMM's
# split transpose of B ahead of its TF32 wgmma kernel): printed, not gated
NO_PRODUCT_KERNELS = {"tiled_matmul": ("split_transpose_tf32",)}
# the kernel functions (a part of the mangled name) that take bf16 operands
# straight into bf16 tensor-core products, by source, with the SASS
# instruction kind each must use; they may hold no TF32 product
BF16_TC_KERNELS = {"flash_attention": ("flash_fwd_bf16", "HMMA.BF16"),
                   "tiled_matmul": ("gemm_wgmma_bf16", "HGMMA.BF16")}
# the kernel functions, by source, that take one product on the bf16 tensor
# cores (C B^T from bf16 B and C) and others in TF32 (W x and (d .* B)^T x,
# whose f32 operands keep their split): each must hold the bf16 instruction
# kind named, and TF32 products are allowed beside it
MIXED_TC_KERNELS = {"mamba_ssd": (("ssd_chunk_mixed", "ssd_chunk_bf16"),
                                  "HMMA.BF16")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_MM = [_P] * 3 + [_I] * 4 + [_P]
_MM_SCRATCH = [_P] * 4 + [_I] * 4 + [_P]
_FLASH = [_P] * 4 + [_I] * 8 + [_P]
_FLASH_STATS = [_P] * 6 + [_I] * 8 + [_P]
_SSD = [_P] * 6 + [_I] * 6 + [_P]
# argument types of each source's launch functions, one per element type
# (f32, bf16) for the three tensor-core sources (flash also with its
# statistics; the f32 GEMM with its scratch), and the GEMM's and flash's
# mma.sync kernel forced for f32 (``_sync_f32``); every one returns the
# launch's cudaError_t as an int
SIGNATURES = {
    "tiled_matmul": {"tiled_matmul_f32": _MM_SCRATCH,
                     "tiled_matmul_bf16": _MM, "tiled_matmul_sync_f32": _MM},
    "flash_attention": {"flash_attention_f32": _FLASH,
                        "flash_attention_sync_f32": _FLASH,
                        "flash_attention_bf16": _FLASH,
                        "flash_attention_stats_f32": _FLASH_STATS,
                        "flash_attention_stats_bf16": _FLASH_STATS},
    "mamba_ssd": {"ssd_chunk_dual_f32": _SSD, "ssd_chunk_dual_bf16": _SSD,
                  "ssd_chunk_dual_mixed": _SSD},
    "fused_eval": {"fused_eval_f32": [_P] * 3 + [_L, _I, _I] + [_P] * 6
                   + [_I] * 3 + [_P] * 3 + [_I, _P],
                   "segment_replay_f64": [_P, _P, _L, _P, _L, _P, _I, _I,
                                          _P]},
    "ssd_state": {"ssd_state_walk_f32": [_P] * 7 + [_I] * 8 + [_P],
                  "ssd_state_scan_f32": [_P] * 5 + [_I] * 7 + [_P],
                  "ssd_state_out_f32": [_P] * 5 + [_I] * 9 + [_P]},
}
# argument types of the functions that name the configuration a launch
# takes (then the operands' bytes an element and, for the GEMM and flash,
# whether the ``_sync_f32`` entry point launches); each returns a C string
ROUTES = {
    "tiled_matmul": {"tiled_matmul_route": [_I] * 3 + [_P] * 2 + [_I] * 3},
    "flash_attention": {"flash_attention_route": [_I] + [_P] * 3 + [_I] * 2},
    "mamba_ssd": {"ssd_chunk_dual_route": [_I] * 2 + [_P] * 3 + [_I] * 2},
    "ssd_state": {"ssd_state_pass_route": [_I] * 2 + [_P] * 2},
}
# argument types of the functions that report a count (an int)
QUERIES = {
    "fused_eval": {"fused_eval_max_cells": [_I],
                   "replay_cells_per_block": [_L, _I]},
    "mamba_ssd": {"ssd_chunk_dual_heads": [_I] * 6},
}
# the suffix of a launch function's name, by operand dtype name
DTYPE_SUFFIX = {"float32": "f32", "bfloat16": "bf16"}
# the SSD chunk kernel's launch functions, by the dtype names of (x and
# cum, B and C): all f32, all bf16, or x and cum f32 with B and C bf16
SSD_DTYPE_SUFFIX = {("float32", "float32"): "f32",
                    ("bfloat16", "bfloat16"): "bf16",
                    ("float32", "bfloat16"): "mixed"}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a digest of the source,
    every ``csrc/*.cuh`` it may include, and the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Dict]:
    """Compile every named source whose library is missing, all at once.

    Returns ``{name: {"seconds": s, "ptxas": [lines], "warnings": [lines],
    "cached": bool}}`` (the compiler's register and spill lines, and its
    warnings, such as ptxas serializing ``wgmma``);
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    info: Dict[str, Dict] = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            info[name] = {"seconds": 0.0, "ptxas": [], "warnings": [],
                          "cached": True}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed: List[str] = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        tmp.replace(out)
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        warnings = [ln.strip() for ln in log.splitlines()
                    if "warning" in ln.lower()]
        info[name] = {"seconds": secs, "ptxas": ptxas, "warnings": warnings,
                      "cached": False}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for symbol, argtypes in {**SIGNATURES[name],
                                 **QUERIES.get(name, {})}.items():
            fn = getattr(lib, symbol)
            fn.restype, fn.argtypes = _I, argtypes
        for symbol, argtypes in ROUTES.get(name, {}).items():
            fn = getattr(lib, symbol)
            fn.restype, fn.argtypes = ctypes.c_char_p, argtypes
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [_I]
        _LIBS[name] = lib
    return lib


def _cuobjdump() -> Optional[str]:
    found = shutil.which("cuobjdump")
    if found:
        return found
    nvcc = Path(_nvcc())
    path = nvcc.with_name("cuobjdump")
    return str(path) if path.exists() else None


def sass_text(name: str) -> Optional[str]:
    """The built library's SASS (``cuobjdump -sass``); None where the
    toolkit has no ``cuobjdump``.  Builds the library first if it is
    missing."""
    tool = _cuobjdump()
    if tool is None:
        return None
    path = lib_path(name)
    if not path.exists():
        build([name])
    return subprocess.run([tool, "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout


# a tensor-core instruction of the SASS: HMMA (mma.sync) or HGMMA (wgmma),
# with its modifiers (shape, accumulator and operand types)
_TC_OP = re.compile(r"\b(HG?MMA)((?:\.\w+)*)")


def tensor_core_counts(sass: str) -> Dict[str, Dict[str, int]]:
    """Tensor-core instructions in SASS text, by kernel function (mangled
    name) and kind: ``"HMMA.TF32"``, ``"HMMA.BF16"``, ``"HGMMA.BF16"``,
    ... (the opcode and the operand type among its modifiers, ``other``
    where it names neither bf16 nor TF32).  A function with none maps to
    an empty dict."""
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = {}
            continue
        match = _TC_OP.search(line) if fn is not None else None
        if match:
            mods = match.group(2).split(".")
            kind = next((k for k in ("BF16", "TF32") if k in mods), "other")
            key = f"{match.group(1)}.{kind}"
            counts[fn][key] = counts[fn].get(key, 0) + 1
    return counts


def tensor_core_faults(name: str, counts: Dict[str, Dict[str, int]],
                       gated: Optional[Iterable[str]] = None) -> List[str]:
    """What is wrong with source ``name``'s tensor-core counts
    (:func:`tensor_core_counts`); empty when nothing is.  A function named
    in :data:`BF16_TC_KERNELS` must hold its bf16 instruction and no TF32
    product; one named in :data:`TF32_WGMMA_KERNELS` ``HGMMA.TF32`` and no
    bf16 product; one named in :data:`MIXED_TC_KERNELS` its bf16
    instruction, TF32 beside it allowed; one named in
    :data:`NO_PRODUCT_KERNELS` is not gated; every other gated function must
    hold an ``HMMA``.  ``gated``: parts of the names of the functions that
    must multiply on the tensor cores, each naming one at least; None, every
    function of the source."""
    faults = []
    bf16 = BF16_TC_KERNELS.get(name)
    tf32wg = TF32_WGMMA_KERNELS.get(name)
    free = NO_PRODUCT_KERNELS.get(name, ())
    mixed_parts, mixed_kind = MIXED_TC_KERNELS.get(name, ((), None))
    fns = list(counts) if gated is None else [
        fn for fn in counts if any(k in fn for k in gated)]
    fns = [fn for fn in fns if not any(part in fn for part in free)]
    if not fns:
        faults.append(f"{name}: no kernel function")
    for part in list(gated or ()) + ([bf16[0]] if bf16 else []) \
            + ([tf32wg] if tf32wg else []) + list(mixed_parts):
        if not any(part in fn for fn in counts):
            faults.append(f"{name}: no function named {part}")
    for fn in fns:
        c = counts[fn]
        if bf16 and bf16[0] in fn:
            if not c.get(bf16[1]) or any("TF32" in k for k in c):
                faults.append(f"{name}: {fn} takes bf16 products as "
                              f"{bf16[1]} only, has {c}")
        elif tf32wg and tf32wg in fn:
            if not c.get("HGMMA.TF32") or any("BF16" in k for k in c):
                faults.append(f"{name}: {fn} takes 3xTF32 products as "
                              f"HGMMA.TF32 only, has {c}")
        elif any(part in fn for part in mixed_parts):
            if not c.get(mixed_kind):
                faults.append(f"{name}: {fn} takes C B^T as {mixed_kind}, "
                              f"has {c}")
        elif not sum(n for k, n in c.items() if k.startswith("HMMA.")):
            faults.append(f"{name}: {fn} has no HMMA: {c}")
    return faults


def dtype_suffix(kernel: str, tensors) -> str:
    """The launch-function suffix (``"f32"``, ``"bf16"``) for these
    operands; raises ``TypeError`` unless all are float32 or all bfloat16
    (the kernels compute in f32 either way, as the reference's do)."""
    names = {str(t.dtype).rsplit(".", 1)[-1] for t in tensors}
    if len(names) != 1 or next(iter(names)) not in DTYPE_SUFFIX:
        raise TypeError(f"{kernel}: the kernel takes float32 or bfloat16 "
                        f"operands, all of one type; got "
                        f"{[str(t.dtype) for t in tensors]}")
    return DTYPE_SUFFIX[names.pop()]


def ssd_dtype_suffix(kernel: str, x, cum, Bm, Cm) -> str:
    """The SSD chunk kernel's launch-function suffix (``"f32"``,
    ``"bf16"``, ``"mixed"``) for these operands: x and cum of one type, B
    and C of one type, and the pair one of :data:`SSD_DTYPE_SUFFIX`'s
    (the reference hands its kernel B and C in the model's type beside f32
    x and cum); raises ``TypeError`` on any other mix."""
    name = lambda t: str(t.dtype).rsplit(".", 1)[-1]
    pair = (name(x), name(Bm))
    if name(cum) != pair[0] or name(Cm) != pair[1] \
            or pair not in SSD_DTYPE_SUFFIX:
        raise TypeError(f"{kernel}: the kernel takes x and cum float32 or "
                        f"bfloat16 and B and C of x's type, or bfloat16 "
                        f"beside float32 x; got "
                        f"{[str(t.dtype) for t in (x, cum, Bm, Cm)]}")
    return SSD_DTYPE_SUFFIX[pair]


def refuse_grad(kernel: str, tensors) -> None:
    """Raise where autograd is on and an input (None skipped) requires
    grad: a kernel fills its outputs through ctypes, outside the graph, so
    the gradient would be lost without a word.  The wrappers call it for
    tensors on the card; CPU tensors take the plain, differentiable
    version."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: an input requires grad and the CUDA "
                           f"kernel has no backward; run under "
                           f"torch.no_grad(), or take the plain route "
                           f"(use_kernels=False) to differentiate")


def check(lib: ctypes.CDLL, kernel: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} "
                           f"({msg})")
