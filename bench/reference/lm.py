"""The plain reference: a Mamba-2 language model in float32 PyTorch,
written from the published equations.

It imports nothing of the program.  Each function takes the weights of
:mod:`bench.reference.weights` by name and the configuration's ``model``
fields.  ``mm`` is the product of every linear layer (the control puts a
lower precision there); everything else is f32.  Callers turn TF32 off
(:func:`f32_exact`).

- Mamba-2 block (Dao and Gu, 2024): ``in_proj`` to ``[z, x, B, C, dt]``,
  a depthwise causal conv of width 4 with SiLU over ``[x, B, C]``,
  ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``, the SSD
  ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T``, ``y_t = C_t h_t + D x_t``,
  gated by ``silu(z)``, RMS-normed, ``out_proj``.  The SSD is computed in
  the chunked "minimal" form of the paper's listing 1 (segment sums of
  ``dt A`` within a chunk, states carried between chunks by one product
  with the chunks' decay matrix), exact for any chunk length.
- Residual stream with pre-norms (RMSNorm, eps 1e-6), final RMSNorm, the
  head tied to the token table.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Weights = Dict[str, torch.Tensor]
MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
EPS = 1e-6


@contextlib.contextmanager
def f32_exact() -> Iterator[None]:
    """TF32 off for matmuls and convolutions, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * scale


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): ``out[i, j] = sum(a[j+1 .. i])`` for
    ``i >= j``, ``-inf`` above the diagonal."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)                  # x[.., i, j] = a_i
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device),
                       -1)
    s = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return s.masked_fill(~keep, -math.inf)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """x (b, l, h, p), dt (b, l, h), A (h,), Bm/Cm (b, l, g, n) ->
    y (b, l, h, p) without the ``D`` skip, from a zero state."""
    b, L, h, p = x.shape
    g = Bm.shape[2]
    pad = (-L) % chunk
    if pad:      # zero steps at the end change nothing before them
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in (x, dt, Bm, Cm))
    c = (L + pad) // chunk
    rep = h // g
    X = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    Ad = (dt * A).reshape(b, c, chunk, h).permute(0, 3, 1, 2)   # b h c l
    Bh = Bm.repeat_interleave(rep, dim=2).reshape(b, c, chunk, h, -1)
    Ch = Cm.repeat_interleave(rep, dim=2).reshape(b, c, chunk, h, -1)
    Acum = torch.cumsum(Ad, dim=-1)
    Lm = torch.exp(segsum(Ad))                                  # b h c l s
    scores = torch.einsum("bclhn,bcshn->bhcls", Ch, Bh) * Lm
    y = torch.einsum("bhcls,bcshp->bclhp", scores, X)
    decay = torch.exp(Acum[..., -1:] - Acum)                    # b h c l
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    dchunk = torch.exp(segsum(F.pad(Acum[..., -1], (1, 0))))    # b h z c
    states = torch.einsum("bhzc,bchpn->bzhpn", dchunk, states)[:, :-1]
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, states,
                         torch.exp(Acum))
    return y.reshape(b, c * chunk, h, p)[:, :L]


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv with SiLU: x (b, l, ch), w (K, ch)."""
    K = w.shape[0]
    y = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)), w.t()[:, None, :],
                 bias, groups=x.shape[2])
    return silu(y.transpose(1, 2))


def mamba2(W: Weights, p: str, m: dict, x: torch.Tensor, mm: MatMul
           ) -> torch.Tensor:
    d = int(m["d_model"])
    d_in = int(m["ssm_expand"]) * d
    P = int(m["ssm_headdim"])
    H = d_in // P
    G, N = int(m["ssm_groups"]), int(m["ssm_state"])
    b, L, _ = x.shape
    z, xbc, dt = torch.split(mm(x, W[p + "in_proj.w"]),
                             [d_in, d_in + 2 * G * N, H], dim=-1)
    xbc = causal_conv(xbc, W[p + "conv_w"], W[p + "conv_b"])
    xs, Bm, Cm = torch.split(xbc, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(b, L, H, P)
    dt = F.softplus(dt + W[p + "dt_bias"])
    A = -torch.exp(W[p + "A_log"])
    y = ssd(xs, dt, A, Bm.reshape(b, L, G, N), Cm.reshape(b, L, G, N))
    y = (y + xs * W[p + "D"][:, None]).reshape(b, L, d_in) * silu(z)
    return mm(rmsnorm(y, W[p + "norm.scale"]), W[p + "out_proj.w"])


def layer(W: Weights, m: dict, i: int, h: torch.Tensor, mm: MatMul
          ) -> torch.Tensor:
    p = f"blocks.{i}."
    return h + mamba2(W, p + "mamba.", m, rmsnorm(h, W[p + "norm1.scale"]),
                      mm)


def hidden(W: Weights, m: dict, tokens: torch.Tensor, mm: MatMul = torch.matmul,
           remat: bool = False) -> torch.Tensor:
    """tokens (b, l) -> the final-normed hidden states (b, l, d).  With
    ``remat`` each layer is recomputed in the backward pass."""
    h = W["embed.embedding"][tokens.long()]
    for i in range(int(m["n_layers"])):
        if remat and torch.is_grad_enabled():
            h = checkpoint(layer, W, m, i, h, mm, use_reentrant=False)
        else:
            h = layer(W, m, i, h, mm)
    return rmsnorm(h, W["final_norm.scale"])


def logits(W: Weights, h: torch.Tensor, mm: MatMul = torch.matmul
           ) -> torch.Tensor:
    """Tied head: (..., d) -> (..., padded vocab)."""
    return mm(h, W["embed.embedding"].t())


def loss(W: Weights, m: dict, tokens: torch.Tensor, labels: torch.Tensor,
         mask: Optional[torch.Tensor] = None, mm: MatMul = torch.matmul
         ) -> torch.Tensor:
    """Mean next-token NLL over the masked positions, the softmax over the
    whole table, each layer recomputed in the backward pass so that it
    fits."""
    mask = torch.ones_like(labels, dtype=torch.float32) if mask is None \
        else mask.float()
    lg = logits(W, hidden(W, m, tokens, mm, remat=True), mm)
    nll = torch.logsumexp(lg, -1) - torch.gather(
        lg, -1, labels.long()[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1)
