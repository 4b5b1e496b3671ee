"""Mamba-2 (SSD, state-space duality) block.

Port of ``src/repro/nn/mamba2.py``.  The chunked SSD (Dao & Gu 2024): within
a chunk the dual quadratic form mixes tokens; across chunks a small
(H, N, P) state is carried by a recurrence.  Decode is the O(1) recurrent
update.  The reference's ``ssd_chunked`` is the twin of its jitted
``ops.ssd_forward`` around the Pallas chunk kernel, and XLA compiles it.
Here CUDA tensors take the port's two kernels: ``ssd_chunk_dual`` for the
intra-chunk form (in chunks of at most 128, its range; the chunked SSD is
exact for any chunk length, only the rounding differs) and
``ssd_state_pass`` for the inter-chunk pass.  :func:`ssd_chunked_ref`
mirrors the reference line for line as the plain version, for CPU tensors
or ``use_kernels=False``.

With DTensor inputs (a mesh), :func:`ssd_chunked` runs on each rank's
shards through ``local_map``: batch on the ``batch`` rule and heads on the
``heads`` rule where they split evenly (groups with them when there are
several), the kernels or the plain version alike.

Shapes: x (B, L, H, P) heads x headdim; B/C (B, L, G, N) groups x state;
dt (B, L, H); A (H,) negative reals.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels import ops
from ..kernels.mamba_ssd import MAX_CHUNK
from .layers import Linear, RMSNorm, draw_normal, param, silu
from .params import (ShardingRules, default_rules, even_placements,
                     grad_placements, local_io, placed)


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero rows appended along dim 1."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256,
                    init_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``ssd_chunked``, line for line (the plain version).
    Returns (y (B,L,H,P) of x's type, final_state (B,H,N,P) f32)."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    pad = (-L) % chunk
    x, dt, Bm, Cm = (_pad_seq(t, pad) for t in (x, dt, Bm, Cm))
    Lp = L + pad
    nc = Lp // chunk

    f32 = torch.float32
    xb = (x * dt[..., None]).to(f32)                       # discretized input
    dA = dt.to(f32) * A.to(f32)                            # (B, Lp, H), <= 0
    xc = xb.reshape(Bsz, nc, chunk, H, P)
    dAc = dA.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, G, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, chunk, G, N).to(f32)

    cum = torch.cumsum(dAc, dim=2)                         # (B,nc,Q,H)
    tot = cum[:, :, -1]                                    # (B,nc,H)

    # intra-chunk (dual quadratic form): L[b,c,i,j,h] = exp(cum_i - cum_j)
    # for i >= j, masked to -inf before the exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Qi,Qj,H)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    Lmat = torch.exp(diff.masked_fill(~causal, -math.inf))
    scores = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc)
    scores = scores.repeat_interleave(rep, dim=-1)         # (B,nc,Qi,Qj,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores * Lmat, xc)

    # chunk states
    decay_to_end = torch.exp(tot[:, :, None, :] - cum)     # (B,nc,Q,H)
    Bh = Bc.repeat_interleave(rep, dim=3)                  # (B,nc,Q,H,N)
    S = torch.einsum("bcqhn,bcqhp->bchnp", Bh,
                     decay_to_end[..., None] * xc)

    # inter-chunk recurrence: the state before each chunk
    h = (torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    h_before = []
    for c in range(nc):
        h_before.append(h)
        h = h * torch.exp(tot[:, c])[..., None, None] + S[:, c]
    hb = torch.stack(h_before, dim=1)                      # (B,nc,H,N,P)

    Ch = Cc.repeat_interleave(rep, dim=3)                  # (B,nc,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", Ch, hb) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, Lp, H, P)[:, :L]
    return y.to(x.dtype), h


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256,
                init_state: Optional[torch.Tensor] = None,
                use_kernels: bool = True,
                rules: Optional[ShardingRules] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,L,H,P) of x's type, final_state (B,H,N,P) f32).

    CUDA tensors with ``use_kernels`` run the kernels
    (:func:`repro_torch.kernels.ops.ssd_chunks`) in chunks of
    ``min(chunk, 128)``: ``ssd_chunk_dual`` once per group, then one
    ``ssd_state_pass`` (the walk, or the split's two kernels where the
    walk would leave SMs idle).  The chunk kernel takes 1 <= N <= 128
    (every registered config: mamba2-370m 128, zamba2-1.2b 64); past 128
    it raises, and nothing falls back.  DTensors take
    :func:`_ssd_local_map`."""
    if isinstance(x, DTensor):
        return _ssd_local_map(x, dt, A, Bm, Cm, chunk=chunk,
                              init_state=init_state, use_kernels=use_kernels,
                              rules=rules or default_rules())
    if not (use_kernels and x.device.type == "cuda"):
        return ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk,
                               init_state=init_state)
    return ops.ssd_chunks(x, dt, A, Bm, Cm, chunk=min(chunk, MAX_CHUNK),
                          init_state=init_state)


def _ssd_placements(rules: ShardingRules, mesh, B: int, H: int, G: int
                    ) -> Dict[str, Tuple]:
    """The SSD's local layout: batch on ``batch`` and heads on ``heads``
    where they split evenly (the groups shard with the heads when there
    are several, else heads stay whole; with one group, B and C are whole
    on every rank), the sequence whole.  Keys: ``x`` (B,L,H,P), ``dt``
    (B,L,H), ``A`` (H,), ``bc`` (B,L,G,N), ``st`` (B,H,N,P)."""
    hx = ("batch", None, "heads", None)
    xp = even_placements(rules, hx, (B, 1, H, 1), mesh)
    if G > 1 and even_placements(rules, hx, (B, 1, G, 1), mesh) != xp:
        hx = ("batch", None, None, None)
        xp = even_placements(rules, hx, (B, 1, H, 1), mesh)
    gx = hx if G > 1 else ("batch", None, None, None)
    return dict(x=xp, dt=even_placements(rules, hx[:3], (B, 1, H), mesh),
                A=even_placements(rules, hx[2:3], (H,), mesh),
                bc=even_placements(rules, gx, (B, 1, G, 1), mesh),
                st=even_placements(rules, (hx[0], hx[2], None, None),
                                   (B, H, 1, 1), mesh))


def _drop_seq(placements) -> Tuple:
    """Placements of a tensor with its (whole) dim 1 taken out."""
    return tuple(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
                 else p for p in placements)


def _ssd_local_map(x, dt, A, Bm, Cm, *, chunk, init_state, use_kernels,
                   rules: ShardingRules):
    """:func:`ssd_chunked` on each rank's shards (:func:`_ssd_placements`)."""
    mesh = x.device_mesh
    pl = _ssd_placements(rules, mesh, x.shape[0], x.shape[2], Bm.shape[2])

    def local(*ts):
        y, st = ssd_chunked(*(local_io(t) for t in ts[:5]), chunk=chunk,
                            init_state=local_io(ts[5]),
                            use_kernels=use_kernels)
        return y.contiguous(), st.contiguous()

    in_pl = (pl["x"], pl["dt"], pl["A"], pl["bc"], pl["bc"],
             None if init_state is None else pl["st"])
    args = [t if p is None else placed(t, p)
            for t, p in zip((x, dt, A, Bm, Cm, init_state), in_pl)]
    return local_map(local, out_placements=(pl["x"], pl["st"]),
                     in_placements=in_pl,
                     in_grad_placements=grad_placements(in_pl),
                     device_mesh=mesh)(*args)


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor,
                    rules: Optional[ShardingRules] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrent update.  x (B,H,P), dt (B,H), Bm/Cm (B,G,N),
    state (B,H,N,P).  DTensors (a mesh) run on each rank's shards, laid
    out as :func:`ssd_chunked`'s by ``rules``."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        pl = _ssd_placements(rules or default_rules(), mesh, x.shape[0],
                             x.shape[1], Bm.shape[1])
        in_pl = (_drop_seq(pl["x"]), _drop_seq(pl["dt"]), pl["A"],
                 _drop_seq(pl["bc"]), _drop_seq(pl["bc"]), pl["st"])
        args = [placed(t, p)
                for t, p in zip((x, dt, A, Bm, Cm, state), in_pl)]
        return local_map(ssd_decode_step, out_placements=(in_pl[0], pl["st"]),
                         in_placements=in_pl, device_mesh=mesh)(*args)
    H = x.shape[1]
    G = Bm.shape[1]
    rep = H // G
    f32 = torch.float32
    dA = torch.exp(dt.to(f32) * A.to(f32))                 # (B,H)
    Bh = Bm.to(f32).repeat_interleave(rep, dim=1)          # (B,H,N)
    Ch = Cm.to(f32).repeat_interleave(rep, dim=1)
    xb = (x * dt[..., None]).to(f32)                       # (B,H,P)
    new_state = state * dA[..., None, None] \
        + Bh[..., None] * xb[:, :, None, :]                # (B,H,N,P)
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    return y.to(x.dtype), new_state


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x (B,L,C), w (K,C).  Returns (y, tail)."""
    K = w.shape[0]
    ctx = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                      device=x.device) if prev is None else prev.to(x.dtype)
    xp = torch.cat([ctx, x], dim=1)                        # (B, L+K-1, C)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(K))
    tail = xp[:, xp.shape[1] - (K - 1):] if K > 1 else xp[:, :0]
    return silu(y + b[None, None]), tail


class Mamba2(nn.Module):
    """``{"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm",
    "out_proj"}`` of the reference's ``init_mamba2``."""

    def __init__(self, d_model: int, *, d_state: int = 128,
                 headdim: int = 64, expand: int = 2, n_groups: int = 1,
                 d_conv: int = 4, chunk: int = 256,
                 dtype: torch.dtype = torch.float32, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        d_inner = expand * d_model
        n_heads = d_inner // headdim
        conv_ch = d_inner + 2 * n_groups * d_state
        self.d_state, self.headdim, self.expand = d_state, headdim, expand
        self.n_groups, self.d_conv, self.chunk = n_groups, d_conv, chunk
        kw = dict(dtype=dtype, device=device)
        self.in_proj = Linear(d_model,
                              2 * d_inner + 2 * n_groups * d_state + n_heads,
                              gen=gen, **kw)
        self.conv_w = param(draw_normal((d_conv, conv_ch), 1.0 / d_conv ** 0.5,
                                        gen, **kw))
        self.conv_b = param(torch.zeros(conv_ch, **kw))
        self.A_log = param(torch.log(torch.linspace(
            1.0, 16.0, n_heads, device=device)).to(dtype))
        self.D = param(torch.ones(n_heads, **kw))
        if gen is None:
            dt_bias = torch.empty(n_heads, **kw)
        else:
            u = torch.rand(n_heads, generator=gen, device=device)
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt_bias = torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u)))
        self.dt_bias = param(dt_bias.to(dtype))
        self.norm = RMSNorm(d_inner, **kw)
        self.out_proj = Linear(d_inner, d_model, gen=gen, **kw)

    def forward(self, x: torch.Tensor, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                update_cache: bool = False,
                compute_dtype: torch.dtype = torch.bfloat16,
                use_kernels: bool = True,
                rules: Optional[ShardingRules] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """The reference's ``mamba2_block``: x (B, S, d_model).  Cache:
        {"conv": (B,K-1,Cc), "state": (B,H,N,P)}; a new one is returned
        with ``update_cache``.  ``rules`` lays out the chunked SSD's shards
        under a mesh."""
        B, S, d = x.shape
        d_inner = self.expand * d
        H = d_inner // self.headdim
        GN = self.n_groups * self.d_state

        zxbcdt = self.in_proj(x, compute_dtype)
        z, xin, Bm, Cm, dt = torch.split(
            zxbcdt, [d_inner, d_inner, GN, GN, H], dim=-1)
        conv_in = torch.cat([xin, Bm, Cm], dim=-1)
        conv_prev = cache["conv"] if cache is not None else None
        conv_out, conv_tail = _causal_conv(
            conv_in, self.conv_w.to(compute_dtype),
            self.conv_b.to(compute_dtype), conv_prev)
        xin, Bm, Cm = torch.split(conv_out, [d_inner, GN, GN], dim=-1)
        xh = xin.reshape(B, S, H, self.headdim)
        Bm = Bm.reshape(B, S, self.n_groups, self.d_state)
        Cm = Cm.reshape(B, S, self.n_groups, self.d_state)
        dt = F.softplus(dt.float() + self.dt_bias.float())
        A = -torch.exp(self.A_log.float())

        new_cache = None
        if cache is not None and S == 1:
            y1, new_state = ssd_decode_step(xh[:, 0], dt[:, 0], A, Bm[:, 0],
                                            Cm[:, 0], cache["state"], rules)
            y = y1[:, None]
        else:
            init_state = cache["state"] if cache is not None else None
            y, new_state = ssd_chunked(xh, dt, A, Bm, Cm, chunk=self.chunk,
                                       init_state=init_state,
                                       use_kernels=use_kernels, rules=rules)
        if update_cache:
            new_cache = {"conv": conv_tail.to(torch.bfloat16),
                         "state": new_state.float()}

        y = y + xh * self.D.to(compute_dtype)[None, None, :, None]
        y = y.reshape(B, S, d_inner) * silu(z)
        y = self.norm(y)
        return self.out_proj(y, compute_dtype), new_cache


def init_ssm_cache(batch: int, d_model: int, *, d_state: int,
                   headdim: int = 64, expand: int = 2, n_groups: int = 1,
                   d_conv: int = 4, device=None) -> Dict[str, torch.Tensor]:
    d_inner = expand * d_model
    H = d_inner // headdim
    conv_ch = d_inner + 2 * n_groups * d_state
    return {"conv": torch.zeros((batch, d_conv - 1, conv_ch),
                                dtype=torch.bfloat16, device=device),
            "state": torch.zeros((batch, H, d_state, headdim),
                                 dtype=torch.float32, device=device)}
