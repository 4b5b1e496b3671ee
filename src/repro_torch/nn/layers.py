"""Core layers: linear, norms, embedding.

Port of ``src/repro/nn/layers.py``.  Each ``init_*`` of the reference
becomes an ``nn.Module`` whose parameters carry the reference's pytree
keys (``w``, ``b``, ``scale``, ``bias``, ``embedding``), so a module's
``state_dict`` names are the reference's tree paths.  Parameters are
stored in ``param_dtype``; compute happens in ``compute_dtype``.  A module
built with a ``torch.Generator`` draws its random parameters from the
reference's distributions (not its numbers: the two generators differ);
built without one, they are left uninitialized for a state dict to fill.

``Linear`` stays ``torch.matmul`` in ``compute_dtype``: the reference
computes it as an XLA dot, outside any Pallas kernel.  Under a mesh
(DTensors) :func:`matmul` runs it on each rank's shards with the layout
stated (Megatron's column/row-parallel products, FSDP's gathered
weights), and the embedding lookup is vocab-parallel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .params import grad_placements, local_io, placed, seq_shard_index

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def draw_normal(shape: Sequence[int], scale: float,
                gen: Optional[torch.Generator], device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``normal(shape) * scale`` drawn in f32 and stored in ``dtype``, as
    the reference draws; uninitialized without a generator."""
    if gen is None:
        return torch.empty(tuple(shape), device=device, dtype=dtype)
    w = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32) * scale
    return w.to(dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Linear(nn.Module):
    """``{"w": (d_in, d_out)[, "b": (d_out,)]}``; w ~ normal / sqrt(d_in),
    b zeros."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.w = param(draw_normal((d_in, d_out), d_in ** -0.5, gen, device,
                                   dtype))
        self.b = param(torch.zeros(d_out, device=device, dtype=dtype)) \
            if bias else None

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        y = matmul(x.to(compute_dtype), self.w.to(compute_dtype))
        if self.b is not None:
            y = y + self.b.to(compute_dtype)
        return y


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.scale = param(torch.ones(d, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        return (y * self.scale.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.scale = param(torch.ones(d, device=device, dtype=dtype))
        self.bias = param(torch.zeros(d, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * self.scale + self.bias).to(x.dtype)


def make_norm(kind: str, d: int, *, dtype: torch.dtype = torch.float32,
              device=None) -> nn.Module:
    """``rmsnorm`` or ``layernorm``, as the config's ``norm`` names."""
    if kind == "rmsnorm":
        return RMSNorm(d, dtype=dtype, device=device)
    if kind == "layernorm":
        return LayerNorm(d, dtype=dtype, device=device)
    raise ValueError(f"unknown norm {kind!r}")


class Embedding(nn.Module):
    """``{"embedding": (vocab, d)}`` ~ normal * 0.02."""

    def __init__(self, vocab: int, d: int, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = param(draw_normal((vocab, d), 0.02, gen, device,
                                           dtype))

    def forward(self, tokens: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """``embedding.astype(compute_dtype)[tokens]``: the rows are
        gathered first, then cast (the same values).  A DTensor table
        takes :func:`_embed_local_map`."""
        if isinstance(self.embedding, DTensor):
            return _embed_local_map(tokens, self.embedding).to(compute_dtype)
        return F.embedding(tokens.long(), self.embedding).to(compute_dtype)

    def unembed(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """Tied logits: (..., d) @ (vocab, d)^T -> (..., vocab), f32."""
        return matmul(x.to(compute_dtype),
                      self.embedding.to(compute_dtype).t()).float()


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., k) @ w (k, n)``; DTensors take :func:`_matmul_local_map`."""
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return _matmul_local_map(x, w)
    return x @ w


def _matmul_local_map(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The product on each rank's shards, x's layout leading: on a mesh
    axis that shards a leading dim of x, w is whole and the output shards
    the same dim; on one that shards x's last dim, w shards its rows and
    the output is a partial sum; on one where x is whole, w keeps a column
    shard (the output shards its last dim) and is gathered otherwise (the
    FSDP gather).  Shards that would split a dim unevenly are gathered."""
    mesh = w.device_mesh
    last = x.dim() - 1
    sizes = [mesh.size(md) for md in range(mesh.ndim)]

    def even(n: int, mds) -> bool:
        return n % math.prod(sizes[md] for md in mds) == 0

    xp = []
    for md, p in enumerate(x.placements):
        keep = isinstance(p, Shard) and even(x.shape[p.dim], [md])
        xp.append(p if keep else Replicate())
    if not even(x.shape[last], [md for md, p in enumerate(xp)
                                if p == Shard(last)]):
        xp = [Replicate() if p == Shard(last) else p for p in xp]
    cols = [md for md, p in enumerate(w.placements)
            if p == Shard(1) and xp[md] == Replicate()]
    if not even(w.shape[1], cols):
        cols = []
    wp, op = [], []
    for md, p in enumerate(xp):
        if p == Shard(last):
            wp.append(Shard(0))
            op.append(Partial())
        elif isinstance(p, Shard):
            wp.append(Replicate())
            op.append(p)
        elif md in cols:
            wp.append(Shard(1))
            op.append(Shard(last))
        else:
            wp.append(Replicate())
            op.append(Replicate())
    in_pl = (tuple(xp), tuple(wp))
    return local_map(lambda xl, wl: (local_io(xl) @ local_io(wl))
                     .contiguous(),
                     out_placements=list(op), in_placements=in_pl,
                     in_grad_placements=grad_placements(in_pl),
                     device_mesh=mesh)(placed(x, xp), placed(w, wp))


def _embed_local_map(tokens: torch.Tensor, table: torch.Tensor
                     ) -> torch.Tensor:
    """The vocab-parallel lookup (Megatron's): on each rank, the rows of
    the tokens that fall in its vocab block, zeros for the others; the
    result is a partial sum over the mesh axes that shard the vocab, and
    the table is whole on every other axis.  ``tokens`` (a DTensor) keep
    their batch layout."""
    mesh = table.device_mesh
    tp = tuple(p if p == Shard(0) else Replicate() for p in table.placements)
    kp = tuple(Replicate() if tp[md] == Shard(0) else p
               for md, p in enumerate(tokens.placements))
    op = tuple(Partial() if t == Shard(0) else k for t, k in zip(tp, kp))
    rows = -(-table.shape[0] // math.prod(
        mesh.size(md) for md, p in enumerate(tp) if p == Shard(0)))

    def local(tl, wl):
        v0 = seq_shard_index(mesh, tp, 0) * rows
        t = tl.long() - v0
        hit = (t >= 0) & (t < wl.shape[0])
        out = F.embedding(t.clamp(0, max(wl.shape[0] - 1, 0)), local_io(wl))
        return torch.where(hit[..., None], out, 0.0).contiguous()

    in_pl = (kp, tp)
    return local_map(local, out_placements=list(op), in_placements=in_pl,
                     in_grad_placements=grad_placements(in_pl),
                     device_mesh=mesh)(placed(tokens, kp),
                                       placed(table, tp))


# silu and gelu are jax.nn's op sequences, each op rounded to the input's
# type, so that bf16 rounds where XLA rounds (F.silu and F.gelu compute in
# f32 and round once, a bf16 ulp away in a third of the elements)

def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * logistic(x)``, the logistic as ``1 / (1 + exp(-x))``."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return silu(gate) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form, its constants in the input's type as jax.nn takes
    them."""
    k = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    inner = k((2.0 / math.pi) ** 0.5) * (x + k(0.044715) * x ** 3)
    return x * (k(0.5) * (k(1.0) + torch.tanh(inner)))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean token NLL; logits (..., V) f32, labels int (...).  For a
    DTensor (whose vocab dim may shard) the label's logit is picked by a
    comparison with the vocab ids and a sum over the vocab dim."""
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        ids = torch.arange(logits.shape[-1], device=logits.device)
        ll = torch.where(labels.long()[..., None] == ids, logits,
                         0.0).sum(dim=-1)
    else:
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp_min(1)
    return nll.mean()
