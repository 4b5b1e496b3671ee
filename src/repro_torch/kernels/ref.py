"""Plain PyTorch versions of the kernels (the allclose targets).

Port of the oracles of ``src/repro/kernels/ref.py``: f32 math, the JAX
package's layouts.  On the CPU the kernel wrappers run these; on the card
they are what each kernel is held against.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def ssd_chunk_ref(x: torch.Tensor, cum: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk SSD quadratic form (oracle of ``ssd_chunk_dual``), f32.

    x (BC, Q, H, P); cum (BC, Q, H) cumulative log-decay within the chunk;
    Bm/Cm (BC, Q, N).  Returns ``y = ((C Bᵀ) ⊙ L) X`` (BC, Q, H, P) with
    ``L[i, j, h] = exp(cum_i - cum_j)`` for i >= j, else 0, and the chunk
    state ``S = Σ_j B_j ⊗ exp(cum_last - cum_j) X_j`` (BC, H, N, P).

    The masked decay is exp(-inf) = 0 above the diagonal, so no
    overflowing exp is ever formed; ``(scores ⊙ L)`` meets x in a batched
    product over (chunk, head), so no (BC, Q, Q, H, P) tensor exists."""
    xf, cumf = x.float(), cum.float()
    Bf, Cf = Bm.float(), Cm.float()
    Q = x.shape[1]
    scores = torch.bmm(Cf, Bf.transpose(1, 2))                 # (BC, Qi, Qj)
    keep = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    diff = cumf.transpose(1, 2)[:, :, :, None] \
        - cumf.transpose(1, 2)[:, :, None, :]                  # (BC, H, Qi, Qj)
    L = diff.masked_fill(~keep, float("-inf")).exp()
    xh = xf.permute(0, 2, 1, 3)                                # (BC, H, Qj, P)
    y = torch.matmul(scores[:, None] * L, xh).permute(0, 2, 1, 3)
    decay_end = (cumf[:, -1:, :] - cumf).exp()                 # (BC, Q, H)
    xd = (xf * decay_end[..., None]).permute(0, 2, 1, 3)       # (BC, H, Q, P)
    state = torch.matmul(Bf.transpose(1, 2)[:, None], xd)      # (BC, H, N, P)
    return y.contiguous(), state


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) in f32, cast to ``out_dtype`` (default: a's)."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)
