"""The port's workload families (``repro_torch.core.workloads``: the
paper's five DNNs, the routed-MoE and MLA graphs, their presets and
grammars, and routed-MoE ``lm:`` graphs) against the reference's
(``repro.core.workloads``).

Graphs are compared field for field: every layer's dataclass fields (the
expected-traffic scales included, which ``repr`` and so the fingerprint
leave out), the edges in order with their multiplicities, the inputs, the
MACs and expected MACs, and the graph fingerprint.  Everything is exact:
both packages build the same integers and the same float scales.
"""

import dataclasses

import pytest

from repro.core.explore import graph_fingerprint as ref_fingerprint
from repro.core.workloads import PAPER_WORKLOADS as REF_PAPER
from repro.core.workloads import WORKLOAD_SPECS as REF_SPECS
from repro.core.workloads import make_workload as ref_workload
from repro.core.workloads.mla import mla_transformer as ref_mla
from repro.core.workloads.moe import add_moe_ffn as ref_add_moe
from repro.core.workloads.moe import moe_transformer as ref_moe
from repro.core.workload import Graph as RefGraph
from repro.core.workload import Layer as RefLayer
from repro_torch.core.explore import graph_fingerprint
from repro_torch.core.workloads import (PAPER_WORKLOADS, WORKLOAD_SPECS,
                                        make_workload)
from repro_torch.core.workloads.mla import mla_transformer
from repro_torch.core.workloads.moe import add_moe_ffn, moe_transformer
from repro_torch.core.workload import Graph, Layer

# (spec, whether the graph carries expected-traffic scales): routed
# experts with top_k < n_experts do; top_k == n_experts routes every token
# to every expert, a dense graph
GRAMMAR_SPECS = [
    ("moe:n_layers=1,d_model=64,d_ff=64,n_experts=4,top_k=2,n_shared=0,"
     "seq=32,name=moe-t", True),
    ("moe:n_layers=2,n_experts=3,top_k=3,seq=16", False),
    ("mla:n_layers=1,d_model=64,n_heads=2,q_rank=16,kv_rank=8,d_ff=64,"
     "seq=32,name=mla-t", False),
    ("mla:n_layers=2,d_model=128,n_heads=4,seq=32,moe_ffn=1,n_experts=4,"
     "top_k=1", True),
    ("mla:n_layers=1,seq=16,moe_ffn=0", False),
    ("lm:granite-moe-3b-a800m:seq=64,n_layers=1", True),
    ("lm:phi3.5-moe-42b-a6.6b:seq=64,n_layers=1", True),
    ("lm:granite-moe-3b-a800m:seq=4096,n_layers=2", True),
]


def _layer_fields(layer):
    return {f.name: getattr(layer, f.name)
            for f in dataclasses.fields(layer)}


def assert_same_graph(g, rg):
    assert g.name == rg.name
    assert list(g.layers) == list(rg.layers)
    for name, layer in g.layers.items():
        rl = rg.layers[name]
        assert _layer_fields(layer) == _layer_fields(rl), name
        assert layer.macs(3) == rl.macs(3)
        assert layer.expected_macs(3) == rl.expected_macs(3)
        assert layer.weight_bytes() == rl.weight_bytes()
    assert g.edges == rg.edges
    assert g.edge_mults == rg.edge_mults
    assert g.input_layers == rg.input_layers
    assert g.is_scaled == rg.is_scaled
    assert g.topo_order() == rg.topo_order()
    assert graph_fingerprint(g) == ref_fingerprint(rg)


@pytest.mark.parametrize("name", sorted(REF_SPECS))
def test_every_preset_equals_reference(name):
    assert sorted(WORKLOAD_SPECS) == sorted(REF_SPECS)
    assert_same_graph(make_workload(name), ref_workload(name))


@pytest.mark.parametrize("name", sorted(REF_PAPER))
def test_paper_workloads_equal_reference(name):
    assert list(PAPER_WORKLOADS) == list(REF_PAPER)
    g, rg = PAPER_WORKLOADS[name](), REF_PAPER[name]()
    assert_same_graph(g, rg)
    assert sum(l.macs(1) for l in g.layers.values()) > 0


@pytest.mark.parametrize("spec,scaled", GRAMMAR_SPECS)
def test_grammars_equal_reference(spec, scaled):
    g, rg = make_workload(spec), ref_workload(spec)
    assert_same_graph(g, rg)
    assert g.is_scaled == scaled
    assert ({l.traffic_scale for l in g.layers.values()} != {1.0}) == scaled


def test_routed_experts_sum_to_the_dense_active_width():
    """Expected routed-FFN MACs equal one dense FFN of width top_k * d_ff
    (moe.py's docstring), in both packages."""
    g, rg = Graph("m"), RefGraph("m")
    g.add(Layer(name="x", kind="fc", K=64, H=16, C=64, bytes_per_elem=2))
    rg.add(RefLayer(name="x", kind="fc", K=64, H=16, C=64, bytes_per_elem=2))
    out = add_moe_ffn(g, "t", "x", 64, 32, 8, 2, 16)
    rout = ref_add_moe(rg, "t", "x", 64, 32, 8, 2, 16)
    assert out == rout
    assert_same_graph(g, rg)
    routed = sum(l.expected_macs(1) for n, l in g.layers.items()
                 if "_e" in n and (n.endswith("_up") or n.endswith("_down")))
    assert routed == pytest.approx(16 * 64 * 2 * (2 * 32) + 16 * 32 * 2 * 64)


@pytest.mark.parametrize("bad", [
    "nope", "moe:", "mla", "transformer", "cnn:resnet50"])
def test_unknown_specs_raise_the_reference_error(bad):
    with pytest.raises(ValueError) as mine:
        make_workload(bad)
    with pytest.raises(ValueError) as ref:
        ref_workload(bad)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("top_k", [0, 5])
def test_top_k_out_of_range_raises_as_the_reference(top_k):
    with pytest.raises(ValueError) as mine:
        moe_transformer(n_layers=1, n_experts=4, top_k=top_k)
    with pytest.raises(ValueError) as ref:
        ref_moe(n_layers=1, n_experts=4, top_k=top_k)
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match="top_k"):
        mla_transformer(n_layers=1, moe_ffn=True, n_experts=2, top_k=3)
    with pytest.raises(ValueError, match="top_k"):
        ref_mla(n_layers=1, moe_ffn=True, n_experts=2, top_k=3)
