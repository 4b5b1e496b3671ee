"""Public wrappers of the kernels, in the JAX package's layouts
(port of ``src/repro/kernels/ops.py``).

For a CPU tensor each wrapper runs the plain PyTorch version; for a CUDA
tensor, the hand-written kernel.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from .flash_attention import flash_attention_mha
from .mamba_ssd import ssd_chunk_dual
from .tiled_matmul import tiled_matmul


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Sk, KV, D) -> (B, Sq, H, D).

    GQA (KV < H) is expanded to MHA by repeating each kv head H // KV times
    (``jnp.repeat`` order)."""
    H = q.shape[2]
    KV = k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    heads_first = lambda x: x.transpose(1, 2).contiguous()
    out = flash_attention_mha(heads_first(q), heads_first(k), heads_first(v),
                              causal=causal)
    return out.transpose(1, 2)


def ssd_forward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
                chunk_dual: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
                = ssd_chunk_dual) -> Tuple[torch.Tensor, None]:
    """Chunked SSD: the per-chunk kernel plus the inter-chunk recurrence.

    x (B, L, H, P), dt (B, L, H), A (H,), Bm/Cm (B, L, 1, N) (n_groups = 1).
    Returns (y (B, L, H, P), None), as the reference does.  ``chunk_dual``
    computes the per-chunk quadratic form: the kernel by default,
    :func:`.ref.ssd_chunk_ref` for the plain route.  The recurrence
    ``h <- h * exp(tot_c) + S_c`` is a sequential loop over chunks, outside
    any kernel as in the reference (``lax.scan`` there)."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Lp = L + pad
    nc = Lp // chunk
    xb = (x * dt[..., None]).float()
    dA = dt.float() * A.float()
    cum = torch.cumsum(dA.reshape(Bsz, nc, chunk, H), dim=2)

    Cc = Cm.reshape(Bsz, nc, chunk, N).float()
    y_intra, S = chunk_dual(
        xb.reshape(Bsz * nc, chunk, H, P).contiguous(),
        cum.reshape(Bsz * nc, chunk, H).contiguous(),
        Bm.reshape(Bsz * nc, chunk, N).float().contiguous(),
        Cc.reshape(Bsz * nc, chunk, N).contiguous())
    y_intra = y_intra.reshape(Bsz, nc, chunk, H, P)
    S = S.reshape(Bsz, nc, H, N, P)

    tot = cum[:, :, -1]                                  # (B, nc, H)
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    h_before = []                                        # state before chunk
    for c in range(nc):
        h_before.append(h)
        h = h * tot[:, c].exp()[..., None, None] + S[:, c]
    hb = torch.stack(h_before, dim=1)                    # (B, nc, H, N, P)
    # y_inter[b,c,q,h,p] = sum_n C[b,c,q,n] hb[b,c,h,n,p] exp(cum[b,c,q,h])
    y_inter = torch.matmul(Cc[:, :, None], hb).permute(0, 1, 3, 2, 4) \
        * cum.exp()[..., None]
    y = (y_intra + y_inter).reshape(Bsz, Lp, H, P)[:, :L]
    return y.to(x.dtype), None


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) through the tiled GEMM."""
    return tiled_matmul(a, b)
