"""AdamW with decoupled weight decay, global-norm clipping, a warmup then
cosine schedule, and int8 error-feedback gradient compression.

Port of ``src/repro/optim/adamw.py``.  The reference's functions take
pytrees and return new ones; here a tree is a dict of tensors keyed by
parameter name (``dict(model.named_parameters())``), the arithmetic is the
reference's, in f32, and :func:`adamw_update` updates the parameters and
the moments in place under ``torch.no_grad`` with ``torch._foreach_*``
ops (a few launches a step, not a few a parameter).  ``zero1_axes`` gives
the moments' logical axes for ZeRO-1 (``launch.steps.make_train_bundle``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch

Tree = Mapping[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio (f32, on ``step``'s
    device)."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params: Tree) -> Dict:
    """``{"m", "v"}`` zeros in f32 like each parameter, ``"step"`` an int32
    scalar, on the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = next(iter(params.values())).device
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every element's square, in f32."""
    norms = torch._foreach_norm([x.float() for x in tree.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(tree: Tree, max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """New tensors scaled by ``min(1, max_norm / norm)``, and the norm."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return dict(zip(tree, torch._foreach_mul(list(tree.values()), scale))), \
        norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree, opt: Dict
                 ) -> Tuple[Tree, Dict, Dict[str, torch.Tensor]]:
    """One AdamW step.  ``params`` (updated in place), ``grads`` and
    ``opt["m"]``/``opt["v"]`` (updated in place) share their keys;
    ``opt["step"]`` is replaced by ``step + 1``.  Per leaf, in f32:
    ``delta = mh / (sqrt(vh) + eps) + weight_decay * p`` with the bias
    corrections ``1 - b**step``, and ``p -= lr * delta`` in ``p``'s dtype.
    Returns (params, opt, {"grad_norm", "lr"}): the norm before clipping
    and the step's learning rate."""
    names = list(params)
    grads = {k: grads[k].float() for k in names}
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = opt["step"] + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    g = [grads[k] for k in names]
    m = [opt["m"][k] for k in names]
    v = [opt["v"][k] for k in names]
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, g, alpha=1 - cfg.b1)
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
    delta = torch._foreach_div(m, b1c)                     # mh
    den = torch._foreach_div(v, b2c)                       # vh
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    torch._foreach_div_(delta, den)
    del den
    p = [params[k] for k in names]
    torch._foreach_add_(delta, [x.float() for x in p], alpha=cfg.weight_decay)
    torch._foreach_mul_(delta, lr)
    torch._foreach_sub_(p, [d.to(x.dtype) for d, x in zip(delta, p)])
    opt["step"] = step
    return params, opt, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression
# ---------------------------------------------------------------------------

def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_tree(grads: Tree, error: Tree
                     ) -> Tuple[Dict, Dict, Dict]:
    """Error-feedback int8: returns (quantized, scales, new_error)."""
    q, s, e = {}, {}, {}
    for k, g in grads.items():
        gf = g.float() + error[k]
        q[k], s[k] = compress_int8(gf)
        e[k] = gf - decompress_int8(q[k], s[k])
    return q, s, e


def init_error_state(params: Tree) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


# ---------------------------------------------------------------------------
# ZeRO-1 sharding helper
# ---------------------------------------------------------------------------

def zero1_axes(param_axes: Mapping[str, tuple], shapes: Tree,
               shard_axis: str = "data", mesh_size: int = 16
               ) -> Dict[str, tuple]:
    """Optimizer-state logical axes: add ``opt_shard`` on the largest
    unsharded divisible dim of each param (maps to the data axis).
    ``shapes`` holds tensors (meta ones will do) under the same names."""
    def one(axes, shape):
        axes = tuple(axes)
        best, best_dim = None, -1
        for i, (a, d) in enumerate(zip(axes, shape)):
            if a is None and d % mesh_size == 0 and d > best_dim:
                best, best_dim = i, d
        if best is None:
            return axes
        return axes[:best] + ("opt_shard",) + axes[best + 1:]
    return {k: one(ax, tuple(shapes[k].shape)) for k, ax in param_axes.items()}
