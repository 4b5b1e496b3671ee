"""Rotary position embeddings (llama/qwen convention).

Port of ``src/repro/nn/rope.py``."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)        # (hd/2,)
    ang = positions[..., None].float() * freqs     # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]             # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
