"""AdamW as Loshchilov and Hutter give it, with the schedule and clipping
of a training mix's ``optimizer`` settings, in f32: the gradient clipped
to a global norm of ``grad_clip``; ``m`` and ``v`` moving averages with
bias corrections; ``p -= lr_t * (m_hat / (sqrt(v_hat) + eps) +
weight_decay * p)`` on every leaf; ``lr_t`` a linear warm-up over
``warmup_steps`` then a cosine from ``lr`` down to ``min_lr_ratio * lr``
at ``total_steps``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


class AdamW:
    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor]):
        self.cfg = cfg
        self.params = params
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    def lr(self, t: int) -> float:
        c = self.cfg
        warm = min(t / max(c["warmup_steps"], 1), 1.0)
        frac = min(max((t - c["warmup_steps"])
                       / max(c["total_steps"] - c["warmup_steps"], 1), 0.0),
                   1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return c["lr"] * warm * (c["min_lr_ratio"]
                                 + (1.0 - c["min_lr_ratio"]) * cos)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update; returns the gradient as applied (clipped)."""
        c = self.cfg
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = min(1.0, c["grad_clip"] / max(float(norm), 1e-9)) \
            if c["grad_clip"] > 0 else 1.0
        self.t += 1
        lr = self.lr(self.t)
        b1, b2 = c["b1"], c["b2"]
        out = {}
        for k, p in self.params.items():
            g = grads[k] * scale
            out[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mh = self.m[k] / (1 - b1 ** self.t)
            vh = self.v[k] / (1 - b2 ** self.t)
            p.sub_(lr * (mh / (vh.sqrt() + c["eps"])
                         + c["weight_decay"] * p))
        return out
