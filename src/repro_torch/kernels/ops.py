"""Public wrappers of the kernels, in the JAX package's layouts
(port of ``src/repro/kernels/ops.py``).

For a CPU tensor each wrapper runs the plain PyTorch version; for a CUDA
tensor, the hand-written kernel.  ``ssd_forward`` and its SSD kernel come
with the next port slice (ROADMAP, queue 1).
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention_mha
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


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) through the tiled GEMM."""
    return tiled_matmul(a, b)
