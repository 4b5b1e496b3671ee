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

from .layers import Linear, draw_normal, param, swiglu


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
                compute_dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``moe_block``: x (B, S, d) -> (out, aux)."""
        B, S, d = x.shape
        T = B * S
        G = dispatch_groups if dispatch_groups and T % dispatch_groups == 0 \
            and (T // dispatch_groups) >= top_k else 1
        Tl = T // G
        xt = x.reshape(G, Tl, d)
        logits = xt.float() @ self.router.w                  # (G, Tl, E)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)   # (G, Tl, k)
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True) \
            .clamp_min(1e-9)

        capacity = max(1, int(capacity_factor * top_k * Tl / n_experts))
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
        gi = torch.arange(G, device=x.device)[:, None, None].expand_as(pos)
        tok = torch.arange(Tl, device=x.device)[None, :, None] \
            .expand_as(pos)
        buf = torch.zeros((G, n_experts, capacity + 1, d),
                          dtype=compute_dtype, device=x.device)
        buf[gi, gate_idx, flat_p] = xt.to(compute_dtype)[gi, tok]
        buf = buf[:, :, :capacity]

        cdt = compute_dtype
        g = torch.einsum("gecd,edf->gecf", buf, self.w_gate.to(cdt))
        u = torch.einsum("gecd,edf->gecf", buf, self.w_up.to(cdt))
        eo = torch.einsum("gecf,efd->gecd", swiglu(g, u),
                          self.w_down.to(cdt))

        out = eo[gi, gate_idx, flat_p.clamp_max(capacity - 1)] \
            * gate_vals.to(cdt)[..., None]                   # (G, Tl, k, d)
        out = out.sum(dim=2)
        me = probs.mean(dim=(0, 1))                          # (E,)
        ce = onehot.sum(dim=2).float().mean(dim=(0, 1))
        aux = n_experts * (me * ce).sum()
        return out.reshape(B, S, d).to(x.dtype), aux
