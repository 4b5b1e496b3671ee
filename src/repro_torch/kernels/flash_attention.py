"""Flash attention forward: the port of the Pallas ``flash_attention_mha``
(``src/repro/kernels/flash_attention.py:90``).

``flash_attention_mha(q, k, v, causal, q_offset)`` launches a CUDA kernel
of ``csrc/flash_attention.cu`` for tensors on the card: for f32 operands
one in 3xTF32 on the tensor cores (f32 accuracy), for bf16 operands one
on bf16 ``mma.sync.m16n8k16`` products with the probabilities split into
two bf16 parts (f32 arithmetic either way; the output of the operands'
type, as the reference; with ``return_stats`` also each row's softmax
statistics (m, l), as the reference's flash path returns them) and runs the plain version
(:func:`repro_torch.kernels.ref.attention_ref`) for tensors on the CPU.  A
CUDA tensor never falls back: what the kernel does not take raises.
``flash_attention_mha.launches`` counts kernel launches;
:func:`kernel_route` names the head-dim template and copy width a launch
takes.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from . import _build
from .ref import NEG_INF, attention_ref

MAX_HEAD_DIM = 256


def flash_attention_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        return_stats: bool = False
                        ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """q (B, H, Sq, D); k, v (B, H, Sk, D), MHA layout -> (B, H, Sq, D)
    of q's type.  With ``causal``, query row i sits at position
    ``q_offset + i`` and sees keys 0 .. q_offset + i.  With
    ``return_stats``, ``(out, m, l)``: each row's max of the scaled scores
    and ``sum exp(s - m)``, f32 (B, H, Sq), in the reference's units.  No
    key (Sk = 0) launches nothing and gives zeros, ``m`` -2e38 and ``l``
    0, as the plain version does."""
    qkv = (q, k, v)
    if int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"flash_attention_mha: q_offset={q_offset!r} is "
                         f"not an int >= 0")
    if all(x.device.type == "cpu" for x in qkv):
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                             return_stats=return_stats)
    if q.device.type != "cuda" or any(x.device != q.device for x in qkv):
        raise ValueError("flash_attention_mha: q, k, v must lie on one card")
    _build.refuse_grad("flash_attention_mha", qkv)
    suffix = _build.dtype_suffix("flash_attention_mha", qkv)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention_mha: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not "
                         f"(B, H, Sq, D), (B, H, Sk, D) x 2")
    if not all(x.is_contiguous() for x in qkv):
        raise ValueError("flash_attention_mha: q, k, v must be contiguous")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if Sk == 0 and min(B, H, Sq, D) >= 1 and D <= MAX_HEAD_DIM:
        out = torch.zeros_like(q)
        if not return_stats:
            return out
        return (out, torch.full((B, H, Sq), NEG_INF, device=q.device),
                torch.zeros((B, H, Sq), device=q.device))
    if min(B, H, Sq, Sk, D) < 1 or D > MAX_HEAD_DIM \
            or -(-Sq // 32) > 65535 or max(q.numel(), k.numel()) > 2**31 - 1 \
            or q_offset + Sq > 2**31 - 1:
        raise ValueError(f"flash_attention_mha: B={B} H={H} Sq={Sq} Sk={Sk} "
                         f"D={D} out of the kernel's range "
                         f"(D <= {MAX_HEAD_DIM}, Sq <= 32 * 65535)")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (B, H, Sq, Sk, D, int(causal), int(q_offset), q.device.index or 0,
            stream)
    if return_stats:
        m, l = (torch.empty((B, H, Sq), device=q.device) for _ in range(2))
        launch = getattr(lib, f"flash_attention_stats_{suffix}")
        code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), m.data_ptr(), l.data_ptr(), *tail)
    else:
        launch = getattr(lib, f"flash_attention_{suffix}")
        code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), *tail)
    _build.check(lib, "flash_attention_mha", code)
    flash_attention_mha.launches += 1
    return (out, m, l) if return_stats else out


flash_attention_mha.launches = 0


def kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel configuration ``flash_attention_mha(q, k, v)`` launches
    for these CUDA tensors, e.g. ``"D128 kv64 cp.async16"``: the head-dim
    template, its kv tile, and the copy width (16 bytes where D is a
    multiple of 4 f32 or 8 bf16 elements and q, k, v are 16-byte aligned,
    else one element: ``cp.async4`` for f32, ``ld2`` for bf16).  bf16
    routes also name the query rows a block and the product, and end in
    `` bf16``: ``"D64 q64 kv64 m16n8k16 cp.async16 bf16"``."""
    lib = _build.load("flash_attention")
    return lib.flash_attention_route(q.shape[3], q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), q.element_size()).decode()
