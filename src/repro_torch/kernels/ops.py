"""Public wrappers of the kernels, in the JAX package's layouts
(port of ``src/repro/kernels/ops.py``).

For a CPU tensor each wrapper runs the plain PyTorch version; for a CUDA
tensor, the hand-written kernel.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from .flash_attention import flash_attention_mha
from .mamba_ssd import ssd_chunk_dual
from .ssd_state import ssd_state_pass
from .tiled_matmul import tiled_matmul


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    return_stats: bool = False):
    """q (B, Sq, H, D); k/v (B, Sk, KV, D) -> (B, Sq, H, D).

    GQA (KV < H) is expanded to MHA by repeating each kv head H // KV times
    (``jnp.repeat`` order).  With ``causal``, query row i sits at position
    ``q_offset + i``.  With ``return_stats`` also each row's softmax
    statistics (m, l), f32 (B, H, Sq) (:func:`flash_attention_mha`)."""
    H = q.shape[2]
    KV = k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    heads_first = lambda x: x.transpose(1, 2).contiguous()
    got = flash_attention_mha(heads_first(q), heads_first(k), heads_first(v),
                              causal=causal, q_offset=q_offset,
                              return_stats=return_stats)
    if return_stats:
        out, m, l = got
        return out.transpose(1, 2), m, l
    return got.transpose(1, 2)


def ssd_chunks(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
               init_state: Optional[torch.Tensor] = None,
               chunk_dual: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
               = ssd_chunk_dual,
               state_pass: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
               = ssd_state_pass) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD with G groups: pad to whole chunks, discretize, take the
    chunk cumsum, run ``chunk_dual`` once per group on the group's
    contiguous heads (heads g*H/G ... share B_g and C_g, ``jnp.repeat``
    order), then ``state_pass`` over every chunk and group.

    x (B, L, H, P), dt (B, L, H), A (H,), Bm/Cm (B, L, G, N), init_state
    (B, H, N, P) or None.  Returns (y (B, L, H, P) of x's type, final
    state (B, H, N, P) f32).  The kernels by default; their plain versions
    for CPU tensors, or passed as :func:`.ref.ssd_chunk_ref` and
    :func:`.ref.ssd_state_ref`."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (L + pad) // chunk
    xb = (x * dt[..., None]).float().reshape(Bsz * nc, chunk, H, P)
    cum = torch.cumsum((dt.float() * A.float()).reshape(Bsz, nc, chunk, H),
                       dim=2)
    Bc = Bm.float().reshape(Bsz * nc, chunk, G, N)
    Cc = Cm.float().reshape(Bsz, nc, chunk, G, N).contiguous()
    cum_f = cum.reshape(Bsz * nc, chunk, H)
    parts = [chunk_dual(xb[:, :, g * rep:(g + 1) * rep].contiguous(),
                        cum_f[:, :, g * rep:(g + 1) * rep].contiguous(),
                        Bc[:, :, g].contiguous(),
                        Cc[:, :, :, g].reshape(Bsz * nc, chunk, N)
                        .contiguous())
             for g in range(G)]
    y_intra = torch.cat([p[0] for p in parts], dim=2)
    S = torch.cat([p[1] for p in parts], dim=1)
    y, h = state_pass(y_intra.reshape(Bsz, nc, chunk, H, P),
                      S.reshape(Bsz, nc, H, N, P), cum, Cc,
                      None if init_state is None
                      else init_state.float().contiguous())
    return y.reshape(Bsz, nc * chunk, H, P)[:, :L].to(x.dtype), h


def ssd_forward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
                chunk_dual: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
                = ssd_chunk_dual,
                state_pass: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
                = ssd_state_pass) -> Tuple[torch.Tensor, None]:
    """Chunked SSD: the per-chunk kernel, then the inter-chunk pass.

    x (B, L, H, P), dt (B, L, H), A (H,), Bm/Cm (B, L, 1, N) (n_groups = 1).
    Returns (y (B, L, H, P), None), as the reference does.  ``chunk_dual``
    computes the per-chunk quadratic form and ``state_pass`` the recurrence
    ``h <- h * exp(tot_c) + S_c`` with the inter-chunk output (``lax.scan``
    and an einsum in the reference, one program under ``jax.jit``); see
    :func:`ssd_chunks`."""
    y, _ = ssd_chunks(x, dt, A, Bm, Cm, chunk=chunk, chunk_dual=chunk_dual,
                      state_pass=state_pass)
    return y, None


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) through the tiled GEMM."""
    return tiled_matmul(a, b)
