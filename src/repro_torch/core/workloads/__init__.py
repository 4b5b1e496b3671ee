"""Workload registry: the port's part of ``src/repro/core/workloads/__init__.py``.

The port builds the transformer presets (``tf-quick``, ``tf-paper``), the
``transformer:k=v,...`` grammar and the ``lm:<config>[:seq=S,n_layers=L]``
grammar (:func:`.lm_graph.lm_graph`; routed-MoE configs raise).  Every other
kind of the reference registry (CNNs, MoE, MLA) raises, naming what the
port has.
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

_GRAMMARS = ("transformer:k=v,...", "lm:<config>[:seq=S,n_layers=L]")


def _kwargs(rest: str) -> Dict[str, Union[int, str]]:
    kw: Dict[str, Union[int, str]] = {}
    for item in filter(None, rest.split(",")):
        k, _, v = item.partition("=")
        kw[k] = v if k == "name" else int(v)
    return kw


def make_workload(spec: str) -> Graph:
    """Build a workload graph from a preset name, a ``transformer:k=v,...``
    spec (``transformer()`` keyword arguments, ints except ``name``) or an
    ``lm:<config>[:seq=S,n_layers=L]`` spec (a registered architecture's
    layer DAG)."""
    if spec in WORKLOAD_SPECS:
        return WORKLOAD_SPECS[spec]()
    kind, _, rest = spec.partition(":")
    if kind == "transformer" and rest:
        return transformer(**_kwargs(rest))
    if kind == "lm" and rest:
        from ...configs import get_config
        from .lm_graph import lm_graph
        name, _, params = rest.partition(":")
        kw2 = {k: int(v) for k, v in
               (item.partition("=")[::2] for item in
                filter(None, params.split(",")))}
        return lm_graph(get_config(name), **kw2)
    raise ValueError(
        f"unknown workload spec {spec!r}; the PyTorch port has the presets "
        f"{', '.join(sorted(WORKLOAD_SPECS))} and the specs "
        f"{'; '.join(_GRAMMARS)}")


__all__ = ["transformer", "WORKLOAD_SPECS", "make_workload"]
