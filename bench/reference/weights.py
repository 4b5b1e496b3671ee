"""The model's weights, made by the benchmark from ``--seed``.

Both sides get these tensors: the program loads them into its model by
name (``load_state_dict``, strict), and the plain reference reads them.
The names follow the parameter tree that the architecture's equations
need (``blocks.<i>.mamba.in_proj.w`` and so on, each ``w`` laid out
(d_in, d_out) so that ``y = x @ w``); ``in_proj`` packs its outputs as
Mamba-2 does, ``[z, x, B, C, dt]``.

The draws follow the usual initialisation of each kind of tensor:
linear weights normal with variance ``1 / d_in``, the token table normal
with standard deviation 0.02, the causal conv's taps normal with variance
``1 / K``, ``A = -exp(A_log)`` with ``exp(A_log)`` uniform on [1, 16],
``softplus(dt_bias)`` log-uniform on [1e-3, 1e-1], ``D``, norm scales 1,
conv biases 0.  They are made on ``device`` in two calls of one
``torch.Generator`` (one normal, one uniform draw for everything), so
set-up stays short and the same seed gives the same weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str, float]


def padded_vocab(m: dict) -> int:
    """The token table's rows: the vocabulary rounded up to 256."""
    return -(-int(m["vocab"]) // 256) * 256


def ssm_widths(m: dict) -> Dict[str, int]:
    d = int(m["d_model"])
    d_in = int(m["ssm_expand"]) * d
    H = d_in // int(m["ssm_headdim"])
    GN = int(m["ssm_groups"]) * int(m["ssm_state"])
    return {"d": d, "d_in": d_in, "H": H, "GN": GN, "K": 4,
            "conv": d_in + 2 * GN, "proj": 2 * d_in + 2 * GN + H}


def param_specs(m: dict) -> List[Spec]:
    """(name, shape, kind, scale) of every weight of an ``ssm`` model
    described by the configuration's ``model`` fields; ``kind`` is
    ``normal``, ``ones``, ``zeros``, ``a_log`` or ``dt_bias``."""
    if m["family"] != "ssm":
        raise ValueError(f"no weight layout for family {m['family']!r}")
    w = ssm_widths(m)
    d, d_in, H = w["d"], w["d_in"], w["H"]
    specs: List[Spec] = [("embed.embedding", (padded_vocab(m), d),
                          "normal", 0.02)]
    for i in range(int(m["n_layers"])):
        p = f"blocks.{i}."
        specs += [
            (p + "norm1.scale", (d,), "ones", 1.0),
            (p + "mamba.in_proj.w", (d, w["proj"]), "normal", d ** -0.5),
            (p + "mamba.conv_w", (w["K"], w["conv"]), "normal",
             w["K"] ** -0.5),
            (p + "mamba.conv_b", (w["conv"],), "zeros", 0.0),
            (p + "mamba.A_log", (H,), "a_log", 0.0),
            (p + "mamba.D", (H,), "ones", 1.0),
            (p + "mamba.dt_bias", (H,), "dt_bias", 0.0),
            (p + "mamba.norm.scale", (d_in,), "ones", 1.0),
            (p + "mamba.out_proj.w", (d_in, d), "normal", d_in ** -0.5),
        ]
    specs.append(("final_norm.scale", (d,), "ones", 1.0))
    return specs


def make_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of :func:`param_specs`, f32 on ``device``, from
    ``seed``: one normal draw and one uniform draw, sliced."""
    specs = param_specs(m)
    numel = lambda s: math.prod(s[1])
    n_norm = sum(numel(s) for s in specs if s[2] == "normal")
    n_unif = sum(numel(s) for s in specs if s[2] in ("a_log", "dt_bias"))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(n_norm, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    i_n = i_u = 0
    lo, hi = math.log(1e-3), math.log(1e-1)
    for name, shape, kind, scale in specs:
        n = math.prod(shape)
        if kind == "normal":
            t = normal[i_n:i_n + n].view(shape).mul_(scale)
            i_n += n
        elif kind in ("a_log", "dt_bias"):
            u = unif[i_u:i_u + n].view(shape)
            i_u += n
            if kind == "a_log":
                t = torch.log(1.0 + 15.0 * u)
            else:
                dt = torch.exp(lo + (hi - lo) * u)
                t = dt + torch.log(-torch.expm1(-dt))   # softplus^-1(dt)
        elif kind == "ones":
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        out[name] = t
    return out
