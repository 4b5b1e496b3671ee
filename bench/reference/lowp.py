"""The control's product: the reference's linear layers in FP8.

The configuration states bfloat16 compute; the next precision below it
is FP8, the step that would tempt a later change on this card (its FP8
tensor cores run at twice the bf16 rate).  :func:`fp8_matmul` rounds both
operands to ``float8_e4m3fn`` with one scale a tensor (its largest
magnitude onto 448, the format's largest), multiplies in f32, and in the
backward pass rounds the incoming gradient to ``float8_e5m2`` the same
way: the usual FP8 training recipe.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def quantize(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under one scale, returned in f32."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _FP8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq = quantize(x, torch.float8_e4m3fn, E4M3_MAX)
        wq = quantize(w, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = quantize(g, torch.float8_e5m2, E5M2_MAX)
        gx = gq @ wq.transpose(-1, -2)
        gw = (xq.reshape(-1, xq.shape[-1]).t()
              @ gq.reshape(-1, gq.shape[-1])).reshape(wq.shape)
        return gx, gw


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _FP8MatMul.apply(x, w)
