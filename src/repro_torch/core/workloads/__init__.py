"""Workload registry: the port's part of ``src/repro/core/workloads/__init__.py``.

The port builds the transformer presets (``tf-quick``, ``tf-paper``) and the
``transformer:k=v,...`` grammar.  Every other kind of the reference
registry (CNNs, MoE, MLA, ``lm:<config>``) raises, naming what the port has.
"""

from __future__ import annotations

from typing import Callable, Dict, Union

from ..workload import Graph
from .transformer import transformer

WORKLOAD_SPECS: Dict[str, Callable[[], Graph]] = {
    "tf-quick": lambda: transformer(n_layers=2, d_model=128, d_ff=256,
                                    seq=64, name="tf-s"),
    "tf-paper": lambda: transformer(),
}

_GRAMMARS = ("transformer:k=v,...",)


def _kwargs(rest: str) -> Dict[str, Union[int, str]]:
    kw: Dict[str, Union[int, str]] = {}
    for item in filter(None, rest.split(",")):
        k, _, v = item.partition("=")
        kw[k] = v if k == "name" else int(v)
    return kw


def make_workload(spec: str) -> Graph:
    """Build a workload graph from a preset name or a
    ``transformer:k=v,...`` spec (builder kwargs, ints except ``name``)."""
    if spec in WORKLOAD_SPECS:
        return WORKLOAD_SPECS[spec]()
    kind, _, rest = spec.partition(":")
    if kind == "transformer" and rest:
        return transformer(**_kwargs(rest))
    raise ValueError(
        f"unknown workload spec {spec!r}; the PyTorch port has the presets "
        f"{', '.join(sorted(WORKLOAD_SPECS))} and the spec "
        f"{'; '.join(_GRAMMARS)}")


__all__ = ["transformer", "WORKLOAD_SPECS", "make_workload"]
