"""Tiled GEMM: the port of the Pallas ``tiled_matmul``
(``src/repro/kernels/tiled_matmul.py:51``).

``tiled_matmul(a, b)`` launches a CUDA kernel of ``csrc/tiled_matmul.cu``
for tensors on the card: for f32 operands one in 3xTF32 on the tensor
cores (f32 accuracy); for bf16 operands ``wgmma`` fed by TMA where K and N
are multiples of 8 and both operands 16-byte aligned, else the 3xTF32
kernel on bf16 tiles (f32 arithmetic either way; the output of the
operands' type, as the reference) and runs
the plain version (:func:`repro_torch.kernels.ref.matmul_ref`) for tensors
on the CPU.  A CUDA tensor never falls back: what the kernel does not take
raises.  ``tiled_matmul.launches`` counts kernel launches;
:func:`kernel_route` names the tile and copy configuration a launch takes.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import matmul_ref

_INT_MAX = 2**31 - 1


def tiled_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) of a's type, f32 accumulation."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"tiled_matmul: operands on {a.device} and "
                         f"{b.device}; the kernel takes both on one card")
    _build.refuse_grad("tiled_matmul", (a, b))
    suffix = _build.dtype_suffix("tiled_matmul", (a, b))
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} are not (M, K) @ (K, N)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("tiled_matmul: operands must be contiguous")
    M, K = a.shape
    N = b.shape[1]
    if min(M, N, K) < 1 or max(M * K, K * N, M * N) > _INT_MAX \
            or -(-M // 64) > 65535:
        raise ValueError(f"tiled_matmul: sizes M={M} K={K} N={N} out of "
                         f"the kernel's range")
    out = torch.empty((M, N), device=a.device, dtype=a.dtype)
    lib = _build.load("tiled_matmul")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    launch = getattr(lib, f"tiled_matmul_{suffix}")
    code = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                  a.device.index or 0, stream)
    _build.check(lib, "tiled_matmul", code)
    tiled_matmul.launches += 1
    return out


tiled_matmul.launches = 0


def kernel_route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel configuration ``tiled_matmul(a, b)`` launches for these
    CUDA operands, e.g. ``"128x128 cp.async16"``: the block tile (chosen
    from M and N) and the copy width (16 bytes where K and N are multiples
    of 4 f32 or 8 bf16 elements and both operands are 16-byte aligned,
    else one element: ``cp.async4`` for f32).  bf16 routes end in
    `` bf16``: the ``wgmma`` kernel's tile where the copies would be 16
    bytes (``"128x256 wgmma tma bf16"``), else the 3xTF32 kernel's with
    one-element loads (``"64x64 ld2 bf16"``)."""
    M, K = a.shape
    lib = _build.load("tiled_matmul")
    return lib.tiled_matmul_route(M, b.shape[1], K, a.data_ptr(),
                                  b.data_ptr(), a.device.index or 0,
                                  a.element_size()).decode()
