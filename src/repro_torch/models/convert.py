"""Weights across the two packages: the reference's parameter pytree, as
numpy arrays, into the port's modules.

The port's parameter names are the reference's pytree paths joined with
dots, with the layer index after ``blocks`` (``enc_blocks`` and
``dec_blocks`` for the encoder-decoder; the reference stacks the layers
on a leading axis), so conversion is a name walk.  Dtypes are kept:
a bfloat16 array (numpy's ``bfloat16`` extension type) is carried bit for
bit.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from .encdec import EncDec
from .lm import LM


def to_tensor(a: Any, device=None) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor of the
    same dtype; bfloat16 arrays through their 16-bit pattern."""
    a = np.array(a)                     # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def flatten_tree(tree: Mapping[str, Any], prefix: str = ""
                 ) -> Dict[str, Any]:
    """``{"a": {"b": x}}`` -> ``{"a.b": x}``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, name + "."))
        else:
            out[name] = v
    return out


def load_tree(module: nn.Module, tree: Mapping[str, Any],
              device=None) -> nn.Module:
    """Load a (nested) parameter tree into ``module`` by name.  Every
    parameter must be given, with its shape and dtype."""
    want = dict(module.named_parameters())
    got = {k: to_tensor(v, device) for k, v in flatten_tree(tree).items()}
    if set(want) != set(got):
        raise KeyError(f"parameter names differ: missing "
                       f"{sorted(set(want) - set(got))}, unexpected "
                       f"{sorted(set(got) - set(want))}")
    for name, t in got.items():
        p = want[name]
        if tuple(p.shape) != tuple(t.shape) or p.dtype != t.dtype:
            raise ValueError(f"{name}: given {tuple(t.shape)} {t.dtype}, the "
                             f"module holds {tuple(p.shape)} {p.dtype}")
        p.data.copy_(t)
    return module


def split_blocks(tree: Mapping[str, Any], key: str = "blocks"
                 ) -> Dict[str, Any]:
    """The reference's stacked ``tree[key]`` (leading layer axis) as
    ``{key: {"0": ..., "1": ...}}``."""
    out = dict(tree)
    flat = flatten_tree(tree[key])
    n = len(next(iter(flat.values())))
    out[key] = {str(i): {k: np.asarray(v)[i] for k, v in flat.items()}
                for i in range(n)}
    return out


def params_from_jax(cfg: ModelConfig, tree: Mapping[str, Any],
                    device=None) -> nn.Module:
    """The port's model holding the reference's ``init_params`` pytree
    (numpy arrays), split along the stacked layer axes: an ``LM``, or an
    ``EncDec`` for ``family="encdec"``."""
    if cfg.family == "encdec":
        tree = split_blocks(split_blocks(tree, "enc_blocks"), "dec_blocks")
        return load_tree(EncDec(cfg, device=device), tree, device)
    return load_tree(LM(cfg, device=device), split_blocks(tree), device)
