"""Parameter counting over a model's tensors.

Reduced copy of ``src/repro/nn/params.py``: ``count_params`` and
``param_bytes``, over an ``nn.Module`` or a dict of tensors.  The sharding
layer (``ShardingRules``, the logical-axis trees, ``shard_constraint`` and
the ``rules=`` arguments that thread it through the model) is dropped: one
card has no mesh.  It returns with the multi-device slice, on
``torch.distributed``.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Union

import torch
from torch import nn

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def _tensors(tree: Params) -> Iterable[torch.Tensor]:
    if isinstance(tree, nn.Module):
        return tree.parameters()
    return tree.values()


def count_params(tree: Params) -> int:
    return sum(t.numel() for t in _tensors(tree))


def param_bytes(tree: Params) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))
