"""Plain PyTorch versions of the kernels (the allclose targets).

Port of the matmul and attention oracles of ``src/repro/kernels/ref.py``:
f32 math, the JAX package's layouts.  On the CPU the kernel wrappers run
these; on the card they are what each kernel is held against.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Naive softmax attention.  q/k/v: (B, H, S, D), MHA layout.  The causal
    mask is ``q_pos >= k_pos`` counted from 0 for both (top-left aligned);
    masked scores are the finite -1e30, as in the reference."""
    D = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(Sq, device=s.device)[:, None]
                >= torch.arange(Sk, device=s.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) in f32, cast to ``out_dtype`` (default: a's)."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)
