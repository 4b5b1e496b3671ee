"""Tiled GEMM: the port of the Pallas ``tiled_matmul``
(``src/repro/kernels/tiled_matmul.py:51``).

``tiled_matmul(a, b)`` launches a CUDA kernel of ``csrc/tiled_matmul.cu``
for tensors on the card.  Operands whose K and N are multiples of 16 bytes'
worth of elements (4 f32, 8 bf16), both 16-byte aligned, take ``wgmma`` fed
by TMA: for f32 in 3xTF32 (f32 accuracy; B's transpose, split into its TF32
parts, is written first into scratch this wrapper allocates), for bf16 in
bf16 products.  Other operands take the ``mma.sync`` kernel in 3xTF32 (on
bf16 tiles for bf16).  Choosing that route by shape is not a fallback: a
failed build or launch raises.  f32 arithmetic either way; the output of
the operands' type, as the reference.  For tensors on the CPU it runs the
plain version (:func:`repro_torch.kernels.ref.matmul_ref`).  A CUDA tensor
never falls back: what the kernel does not take raises.
``tiled_matmul.launches`` counts calls that launch, and
``tiled_matmul.wgmma_f32_launches`` those of f32 operands that took the
wgmma kernel; :func:`kernel_route` names the tile and copy configuration a
launch takes.
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
    tail = (M, N, K, a.device.index or 0, stream)
    wgmma = suffix == "f32" and _wgmma_operands(a, b)
    if suffix == "f32":
        # the wgmma route's scratch: B's split transpose (2, N, K); the
        # kernel's own rule (vec_copies) decides, this one only sizes it
        scratch = torch.empty((2, N, K), device=a.device) if wgmma else None
        code = lib.tiled_matmul_f32(
            a.data_ptr(), b.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), *tail)
    else:
        code = lib.tiled_matmul_bf16(a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), *tail)
    _build.check(lib, "tiled_matmul", code)
    tiled_matmul.launches += 1
    tiled_matmul.wgmma_f32_launches += wgmma
    return out


tiled_matmul.launches = 0
# of those, the f32 launches that took the TF32 wgmma kernel
tiled_matmul.wgmma_f32_launches = 0


def _wgmma_operands(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether f32 operands take the wgmma kernel: K and N multiples of 4,
    both operands 16-byte aligned (the output, a fresh allocation, is)."""
    K, N = b.shape
    return K % 4 == 0 and N % 4 == 0 and a.data_ptr() % 16 == 0 \
        and b.data_ptr() % 16 == 0


def kernel_route(a: torch.Tensor, b: torch.Tensor,
                 sync: bool = False) -> str:
    """The kernel configuration ``tiled_matmul(a, b)`` launches for these
    CUDA operands: where K and N are multiples of 4 f32 or 8 bf16 elements
    and both operands are 16-byte aligned, the ``wgmma`` kernel's tile
    (chosen from M and N): ``"128x128 wgmma tma tf32x3"`` for f32,
    ``"128x256 wgmma tma bf16"`` for bf16; else the ``mma.sync`` kernel's
    tile and one-element copies, ``"64x64 cp.async4"`` for f32, ``"64x64
    ld2 bf16"`` for bf16.  ``sync``: the route of the ``mma.sync`` kernel
    forced for f32 (``tiled_matmul_sync_f32``, the kernel the f32 wgmma
    route replaced), ``"128x128 cp.async16"`` with 16-byte copies."""
    M, K = a.shape
    lib = _build.load("tiled_matmul")
    return lib.tiled_matmul_route(M, b.shape[1], K, a.data_ptr(),
                                  b.data_ptr(), a.device.index or 0,
                                  a.element_size(), int(sync)).decode()
