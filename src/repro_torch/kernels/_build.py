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
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# the sources whose every kernel multiplies on the tensor cores (SASS
# HMMA), each with an f32 and a bf16 launch function; fused_eval does no
# product, and in ssd_state (f32 only) the walk and the split's outputs do
# but the scan does not
TENSOR_CORE_SOURCES = ("tiled_matmul", "flash_attention", "mamba_ssd")
SOURCES = TENSOR_CORE_SOURCES + ("fused_eval", "ssd_state")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_MM = [_P] * 3 + [_I] * 4 + [_P]
_FLASH = [_P] * 4 + [_I] * 8 + [_P]
_FLASH_STATS = [_P] * 6 + [_I] * 8 + [_P]
_SSD = [_P] * 6 + [_I] * 6 + [_P]
# argument types of each source's launch functions, one per element type
# (f32, bf16) for the three tensor-core sources (flash also with its
# statistics); every one returns the launch's cudaError_t as an int
SIGNATURES = {
    "tiled_matmul": {"tiled_matmul_f32": _MM, "tiled_matmul_bf16": _MM},
    "flash_attention": {"flash_attention_f32": _FLASH,
                        "flash_attention_bf16": _FLASH,
                        "flash_attention_stats_f32": _FLASH_STATS,
                        "flash_attention_stats_bf16": _FLASH_STATS},
    "mamba_ssd": {"ssd_chunk_dual_f32": _SSD, "ssd_chunk_dual_bf16": _SSD},
    "fused_eval": {"fused_eval_f32": [_P, _P, _L, _I, _I] + [_P] * 7
                   + [_I, _P, _P, _I, _P],
                   "segment_replay_f64": [_P, _P, _L, _P, _L, _I, _P]},
    "ssd_state": {"ssd_state_walk_f32": [_P] * 7 + [_I] * 8 + [_P],
                  "ssd_state_scan_f32": [_P] * 5 + [_I] * 7 + [_P],
                  "ssd_state_out_f32": [_P] * 5 + [_I] * 9 + [_P]},
}
# argument types of the functions that name the configuration a launch
# takes (the last argument the operands' bytes an element); each returns a
# C string
ROUTES = {
    "tiled_matmul": {"tiled_matmul_route": [_I] * 3 + [_P] * 2 + [_I] * 2},
    "flash_attention": {"flash_attention_route": [_I] + [_P] * 3 + [_I]},
    "mamba_ssd": {"ssd_chunk_dual_route": [_I] * 2 + [_P] * 3 + [_I]},
    "ssd_state": {"ssd_state_pass_route": [_I] * 2 + [_P] * 2},
}
# the suffix of a launch function's name, by operand dtype name
DTYPE_SUFFIX = {"float32": "f32", "bfloat16": "bf16"}

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

    Returns ``{name: {"seconds": s, "ptxas": [lines], "cached": bool}}``;
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    info: Dict[str, Dict] = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            info[name] = {"seconds": 0.0, "ptxas": [], "cached": True}
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
        info[name] = {"seconds": secs, "ptxas": ptxas, "cached": False}
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
        for symbol, argtypes in SIGNATURES[name].items():
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


def hmma_counts(name: str) -> Optional[Dict[str, int]]:
    """Tensor-core ``HMMA`` instructions in the built library's SASS, by
    kernel function (mangled name); None where the toolkit has no
    ``cuobjdump``.  Builds the library first if it is missing."""
    tool = _cuobjdump()
    if tool is None:
        return None
    path = lib_path(name)
    if not path.exists():
        build([name])
    sass = subprocess.run([tool, "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    counts: Dict[str, int] = {}
    fn = None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


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
