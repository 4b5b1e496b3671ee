"""Workload DAGs: the paper's five DNNs, the registered LM architectures,
and the expected-traffic MoE/MLA graphs, plus the by-name registry the CLIs
(``launch/realize.py --workload``, ``realize/plan.py::graph_from_spec``)
resolve specs through.

Copy of ``src/repro/core/workloads/__init__.py``: the same presets, spec
grammars and error text, so a spec names the same graph in both packages.
"""

from __future__ import annotations

from typing import Callable, Dict, Union

from ..workload import Graph
from .cnn import inception_resnet_v1, pnasnet, resnet50, resnext50
from .mla import add_mla_attention, mla_transformer
from .moe import add_moe_ffn, moe_transformer
from .transformer import transformer

PAPER_WORKLOADS = {
    "RN-50": resnet50,
    "RNX": resnext50,
    "IRes": inception_resnet_v1,
    "PNas": pnasnet,
    "TF": transformer,
}

# ---------------------------------------------------------------------------
# By-name registry (presets) + spec grammar
# ---------------------------------------------------------------------------

WORKLOAD_SPECS: Dict[str, Callable[[], Graph]] = {
    # the table1 --quick grid's workload (and the CI realize smoke's)
    "tf-quick": lambda: transformer(n_layers=2, d_model=128, d_ff=256,
                                    seq=64, name="tf-s"),
    # the full Table-I workload
    "tf-paper": lambda: transformer(),
    # routed-MoE encoder stacks (expected-traffic expert branches)
    "moe-quick": lambda: moe_transformer(n_layers=2, d_model=128, d_ff=128,
                                         n_experts=4, top_k=2, n_shared=1,
                                         seq=64, name="moe-s"),
    "moe-paper": lambda: moe_transformer(),
    # multi-head latent attention stacks (low-rank KV compression cubes)
    "mla-quick": lambda: mla_transformer(n_layers=2, d_model=128, n_heads=4,
                                         q_rank=32, kv_rank=16, d_ff=256,
                                         seq=64, name="mla-s"),
    "mla-paper": lambda: mla_transformer(),
}

_GRAMMARS = ("transformer:k=v,...", "moe:k=v,...", "mla:k=v,...",
             "lm:<config>[:seq=S,n_layers=L]")


def _kwargs(rest: str) -> Dict[str, Union[int, str]]:
    kw: Dict[str, Union[int, str]] = {}
    for item in filter(None, rest.split(",")):
        k, _, v = item.partition("=")
        kw[k] = v if k == "name" else int(v)
    return kw


def make_workload(spec: str) -> Graph:
    """Build a workload graph from a by-name preset or a CLI spec.

    Presets are the keys of :data:`WORKLOAD_SPECS`; parameterized specs use
    ``<kind>:k=v,...`` with kinds ``transformer`` / ``moe`` / ``mla``
    (builder kwargs, ints except ``name``) or
    ``lm:<config>[:seq=S,n_layers=L]`` for an assigned LM architecture's
    layer DAG.  Unknown names raise listing what is registered.
    """
    if spec in WORKLOAD_SPECS:
        return WORKLOAD_SPECS[spec]()
    kind, _, rest = spec.partition(":")
    if kind == "transformer" and rest:
        return transformer(**_kwargs(rest))
    if kind == "moe" and rest:
        return moe_transformer(**_kwargs(rest))
    if kind == "mla" and rest:
        kw = _kwargs(rest)
        if "moe_ffn" in kw:
            kw["moe_ffn"] = bool(kw["moe_ffn"])
        return mla_transformer(**kw)
    if kind == "lm" and rest:
        from ...configs import get_config
        from .lm_graph import lm_graph
        name, _, params = rest.partition(":")
        kw2 = {k: int(v) for k, v in
               (item.partition("=")[::2] for item in
                filter(None, params.split(",")))}
        return lm_graph(get_config(name), **kw2)
    raise ValueError(
        f"unknown workload spec {spec!r}; registered presets: "
        f"{', '.join(sorted(WORKLOAD_SPECS))}; or a parameterized spec: "
        f"{'; '.join(_GRAMMARS)}")


__all__ = ["resnet50", "resnext50", "inception_resnet_v1", "pnasnet",
           "transformer", "moe_transformer", "mla_transformer",
           "add_moe_ffn", "add_mla_attention", "PAPER_WORKLOADS",
           "WORKLOAD_SPECS", "make_workload"]
