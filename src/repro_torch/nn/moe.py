"""Mixture-of-Experts with capacity-based scatter dispatch.

Port of ``src/repro/nn/moe.py``: top-k routing, the position of each
(token, slot) in its expert by cumulative sums, a scatter of the kept
tokens into an (E, C, d) buffer, a batched expert SwiGLU, and a combine
with the router weights.  Tokens past an expert's capacity are dropped
(their gate weight zeroed), the capacity-factor scheme.  The router runs
in f32 and returns the Switch auxiliary load-balancing loss.  Group-local
dispatch (``dispatch_groups > 1``) gives each group of tokens its own
capacity, as a data-parallel deployment does; one card has no data
shards, but the groups change which tokens drop, so the port keeps them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .layers import Linear, draw_normal, param, swiglu
from .params import (ShardingRules, default_rules, even_placements,
                     grad_placements, local_io, placed)


class MoE(nn.Module):
    """``{"router": {"w"}, "w_gate", "w_up", "w_down"}`` of the
    reference's ``init_moe``; the router is f32 whatever the dtype."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        s_in, s_out = 1.0 / d_model ** 0.5, 1.0 / d_ff ** 0.5
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.router = Linear(d_model, n_experts, dtype=torch.float32,
                             device=device, gen=gen)
        self.w_gate = param(draw_normal((n_experts, d_model, d_ff), s_in,
                                        **kw))
        self.w_up = param(draw_normal((n_experts, d_model, d_ff), s_in, **kw))
        self.w_down = param(draw_normal((n_experts, d_ff, d_model), s_out,
                                        **kw))

    def forward(self, x: torch.Tensor, *, n_experts: int, top_k: int,
                capacity_factor: float = 1.25, dispatch_groups: int = 0,
                compute_dtype: torch.dtype = torch.bfloat16,
                rules: Optional[ShardingRules] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``moe_block``: x (B, S, d) -> (out, aux).

        Under a mesh (DTensor ``x``) the routing and scatter, and the
        combine, run on each rank's whole groups through ``local_map``
        (groups on the ``batch`` rule where they split evenly, the router
        and the expert outputs whole on every rank), and so do the expert
        products, on the buffer laid out as the reference constrains it
        (experts on ``experts``, the hidden dim on ``expert_mlp``, whose
        partial sums the output carries), each cut to the mesh axes that
        split its dims evenly: the tokens and the buffer take exactly the
        local layouts, where the reference's constraints would shard 16
        groups over 32 ranks."""
        B, S, d = x.shape
        T = B * S
        G = dispatch_groups if dispatch_groups and T % dispatch_groups == 0 \
            and (T // dispatch_groups) >= top_k else 1
        Tl = T // G
        cdt = compute_dtype
        capacity = max(1, int(capacity_factor * top_k * Tl / n_experts))
        if isinstance(x, DTensor):
            x = _whole_groups(x, G, rules or default_rules())
        xt = x.reshape(G, Tl, d)
        dispatch = lambda xl, wl: _dispatch(xl, wl, n_experts, top_k,
                                            capacity, cdt)
        combine = lambda el, il, pl, gl: _combine(el, il, pl, gl, capacity,
                                                  S)
        if isinstance(xt, DTensor):
            dispatch, combine = _on_shards(dispatch), _on_shards(combine)
            mesh = xt.device_mesh
            gp = even_placements(rules or default_rules(),
                                 ("batch", None, None), xt.shape, mesh)
            rep = tuple(Replicate() for _ in gp)
            dispatch = local_map(
                dispatch, out_placements=(gp,) * 6, in_placements=(gp, rep),
                in_grad_placements=grad_placements((gp, rep)),
                device_mesh=mesh)
            combine = local_map(
                combine, out_placements=list(gp), in_placements=(gp,) * 4,
                in_grad_placements=grad_placements((gp,) * 4),
                device_mesh=mesh)
            xt = placed(xt, gp)
            router = placed(self.router.w, rep)
        else:
            router = self.router.w
        buf, gate_idx, flat_p, gate_vals, probs, counts = dispatch(xt,
                                                                   router)
        experts = lambda bl, wg, wu, wd: _experts(bl, wg, wu, wd, cdt)
        if isinstance(buf, DTensor):
            ep = even_placements(rules or default_rules(),
                                 ("batch", "experts", None, None), buf.shape,
                                 mesh)
            wp = even_placements(rules or default_rules(),
                                 ("experts", None, "expert_mlp"),
                                 self.w_gate.shape, mesh)
            dp = tuple(Shard(1) if p == Shard(2) else p for p in wp)
            op = tuple(Partial() if w == Shard(2) else e
                       for e, w in zip(ep, wp))
            eo = local_map(_on_shards(experts), out_placements=list(op),
                           in_placements=(ep, wp, wp, dp),
                           in_grad_placements=grad_placements(
                               (ep, wp, wp, dp)),
                           device_mesh=mesh)(
                placed(buf, ep), placed(self.w_gate, wp),
                placed(self.w_up, wp), placed(self.w_down, dp))
            eo = placed(eo, gp)
        else:
            eo = experts(buf, self.w_gate, self.w_up, self.w_down)
        out = combine(eo, gate_idx, flat_p, gate_vals)       # (B, S, d)
        me = probs.mean(dim=(0, 1))                          # (E,)
        ce = counts.mean(dim=(0, 1))
        aux = n_experts * (me * ce).sum()
        return out.to(x.dtype), aux


def _whole_groups(x: torch.Tensor, G: int, rules: ShardingRules
                  ) -> torch.Tensor:
    """DTensor ``x`` (B, S, d) with its batch dim sharded only over the mesh
    axes whose blocks hold whole dispatch groups (the ``batch`` rule's
    prefix whose product divides ``G``), so that the reshape to (G, T / G,
    d) stays on each rank's rows."""
    keep = even_placements(rules, ("batch", None, None), (G, 1, 1),
                           x.device_mesh)
    want = tuple(Shard(0) if k == Shard(0)
                 else Replicate() if p == Shard(0) else p
                 for k, p in zip(keep, x.placements))
    return placed(x, want)


def _on_shards(fn):
    """``fn`` as a ``local_map`` body: gradients and outputs contiguous."""
    def local(*ts):
        out = fn(*(local_io(t) for t in ts))
        if isinstance(out, tuple):
            return tuple(t.contiguous() for t in out)
        return out.contiguous()
    return local


def _experts(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """The batched expert SwiGLU: (G, E, C, d) -> (G, E, C, d)."""
    g = torch.einsum("gecd,edf->gecf", buf, w_gate.to(cdt))
    u = torch.einsum("gecd,edf->gecf", buf, w_up.to(cdt))
    return torch.einsum("gecf,efd->gecd", swiglu(g, u), w_down.to(cdt))


def _dispatch(xt: torch.Tensor, router_w: torch.Tensor, n_experts: int,
              top_k: int, capacity: int, cdt: torch.dtype):
    """Routing and the scatter of whole groups xt (G, Tl, d): returns the
    (G, E, C, d) buffer, the expert and slot of each (token, slot)
    (G, Tl, k), the kept gate weights, the router probabilities and the
    per-token expert counts (G, Tl, E)."""
    G, Tl, d = xt.shape
    logits = xt.float() @ router_w.float()               # (G, Tl, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)   # (G, Tl, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True) \
        .clamp_min(1e-9)
    # position of each (token, slot) within its expert, by slot then
    # token order (Switch Transformer), counted per group
    onehot = F.one_hot(gate_idx, n_experts).to(torch.int32)  # (G,Tl,k,E)
    slot_rank = torch.cumsum(onehot.reshape(G, Tl * top_k, n_experts),
                             dim=1).reshape(G, Tl, top_k, n_experts) - 1
    pos = (slot_rank * onehot).sum(-1)                   # (G, Tl, k)
    keep = pos < capacity
    gate_vals = gate_vals * keep
    flat_p = torch.where(keep, pos, capacity)            # drops: slot C

    # scatter into (G, E, C + 1, d); slot C collects the drops
    gi = torch.arange(G, device=xt.device)[:, None, None].expand_as(pos)
    tok = torch.arange(Tl, device=xt.device)[None, :, None].expand_as(pos)
    buf = torch.zeros((G, n_experts, capacity + 1, d), dtype=cdt,
                      device=xt.device)
    buf[gi, gate_idx, flat_p] = xt.to(cdt)[gi, tok]
    return buf[:, :, :capacity], gate_idx, flat_p, gate_vals, probs, \
        onehot.sum(dim=2).float()


def _combine(eo: torch.Tensor, gate_idx: torch.Tensor, flat_p: torch.Tensor,
             gate_vals: torch.Tensor, capacity: int, S: int) -> torch.Tensor:
    """Each token's kept expert outputs, weighted and summed, back in its
    batch row: (G, Tl, ...) groups -> (G * Tl / S, S, d) (on a rank, its
    whole groups are whole batch rows)."""
    G = eo.shape[0]
    gi = torch.arange(G, device=eo.device)[:, None, None] \
        .expand_as(gate_idx)
    out = eo[gi, gate_idx, flat_p.clamp_max(capacity - 1)] \
        * gate_vals.to(eo.dtype)[..., None]              # (G, Tl, k, d)
    return out.sum(dim=2).reshape(-1, S, eo.shape[-1])