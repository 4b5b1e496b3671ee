"""The port's cost model (``repro_torch.core``: intra-core search, analyzer,
evaluator) against the reference's scalar engine (``repro.core``).

Both packages are fed the committed fixtures' own graphs and mappings
(``tests/data/realize``), at full size: every stage of ``tf-paper`` (37),
``mamba2-370m`` (96), ``granite-moe-3b-a800m`` at 2 of its 32 layers (162,
a routed-MoE graph with expected-traffic scales) and ``mla-paper`` (5).  The port's copies are float64 host numpy with
the reference's arithmetic in the reference's order, so the tolerance is
relative 1e-9 (they agree to the bit today; the tolerance leaves room for
a numpy whose pairwise sums group differently).  The reference's batched
path is never the oracle: it differs from its own scalar path in the last
bit on this toolchain (``ROADMAP.md``, reference caveats).
"""

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest

from repro.core.analyzer import router_grid as ref_router_grid
from repro.core.encoding import MS as RefMS
from repro.core.encoding import ifmap_region as ref_ifmap_region
from repro.core.encoding import parse_regions as ref_parse_regions
from repro.core.evaluator import Evaluator as RefEvaluator
from repro.core.hw import TECH_12NM as REF_TECH
from repro.core.hw import ArchConfig as RefArch
from repro.core.intra_core import (core_workload_signature as
                                   ref_core_signature)
from repro.core.intra_core import explore_intra_core as ref_explore
from repro.core.workload import Graph as RefGraph
from repro.core.workload import Layer as RefLayer
from repro.core.workload import dense_twin as ref_dense_twin
from repro.core.workload import edge_volume as ref_edge_volume
from repro.realize.plan import graph_from_spec as ref_graph_from_spec
from repro.realize.plan import load_realize_candidates as ref_load
from repro_torch.core.analyzer import router_grid
from repro_torch.core.encoding import ifmap_region, parse_regions
from repro_torch.core.evaluator import Evaluator, evaluator_for
from repro_torch.core.hw import TECH_12NM, ArchConfig, simba_arch
from repro_torch.core.intra_core import (core_workload_signature,
                                         explore_intra_core,
                                         explore_intra_core_many)
from repro_torch.core.workload import Graph, Layer, dense_twin, edge_volume
from repro_torch.realize.plan import graph_from_spec, load_realize_candidates

DATA = Path(__file__).resolve().parent / "data" / "realize"
FIXTURES = {
    "tf-paper": ("tf-paper.simba.ckpt.jsonl", "TF", "tf-paper", 37),
    "mamba2-370m": ("mamba2-370m.simba.ckpt.jsonl", "MAMBA",
                    "lm:mamba2-370m", 96),
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m.simba.ckpt.jsonl",
                             "GRANITE",
                             "lm:granite-moe-3b-a800m:seq=4096,n_layers=2",
                             162),
    "mla-paper": ("mla-paper.simba.ckpt.jsonl", "MLA", "mla-paper", 5),
}
# the seven traffic_summary keys, and the per-pass predicted totals of
# each fixture (the port's CPU values, equal to the reference's; pinned
# beside want_flops in chip_smoke.py)
SUMMARY_KEYS = ("flops", "noc_bytes", "d2d_bytes", "dram_bytes", "delay_s",
                "energy_j", "glb_overflow_bytes")
PRED_TOTALS = {
    "tf-paper": {"flops": 90_244_644_864.0, "noc_bytes": 109_003_176.0,
                 "d2d_bytes": 2_166_178_741.0, "dram_bytes": 325_844_992.0},
    "mamba2-370m": {"flops": 3_002_987_446_272.0,
                    "noc_bytes": 3_068_313_600.0,
                    "d2d_bytes": 77_788_781_360.0,
                    "dram_bytes": 11_575_820_288.0},
    "granite-moe-3b-a800m": {"flops": 1_501_086_036_787.1953,
                             "noc_bytes": 3_561_259_827.199997,
                             "d2d_bytes": 60_090_000_009.59994,
                             "dram_bytes": 10_500_748_083.199978},
    "mla-paper": {"flops": 12_155_092_992.0, "noc_bytes": 18_646_016.0,
                  "d2d_bytes": 395_304_640.0, "dram_bytes": 32_178_176.0},
}
REL = 1e-9


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


def _candidates(label):
    """(port candidate, reference candidate) of a fixture's winner."""
    fixture, name, spec, _ = FIXTURES[label]
    (port,) = load_realize_candidates(DATA / fixture,
                                      {name: graph_from_spec(spec)},
                                      verbose=False)
    (ref,) = ref_load(DATA / fixture, {name: ref_graph_from_spec(spec)})
    return port, ref


def _ref_arch(arch: ArchConfig, tech=REF_TECH) -> RefArch:
    return RefArch(**{f.name: getattr(arch, f.name)
                      for f in dataclasses.fields(arch) if f.name != "tech"},
                   tech=tech)


@pytest.mark.parametrize("label", sorted(FIXTURES))
def test_traffic_summary_equals_reference_on_every_stage(label):
    port, ref = _candidates(label)
    assert len(port.mapping) == FIXTURES[label][3]
    ev, rev = evaluator_for(port.arch, port.graph), \
        RefEvaluator(ref.arch, ref.graph)
    totals = dict.fromkeys(SUMMARY_KEYS, 0.0)
    for (grp, lms), (rgrp, rlms) in zip(port.mapping, ref.mapping):
        got = ev.traffic_summary(grp, lms, grp.batch_unit)
        want = rev.traffic_summary(rgrp, rlms, rgrp.batch_unit)
        assert set(got) == set(SUMMARY_KEYS)
        for k in SUMMARY_KEYS:
            assert _close(got[k], want[k]), (grp.names, k, got[k], want[k])
            totals[k] += got[k]
        assert got["flops"] > 0
    for k, v in PRED_TOTALS[label].items():
        assert totals[k] == v


@pytest.mark.parametrize("label", sorted(FIXTURES))
def test_eval_group_and_evaluate_equal_reference(label):
    """GroupEval per stage (delay, energy and its breakdown, bottleneck,
    pipeline depth, passes, overflow) at the DSE's batch, and the mapping's
    total delay and energy."""
    port, ref = _candidates(label)
    ev, rev = Evaluator(port.arch, port.graph), \
        RefEvaluator(ref.arch, ref.graph)
    batch = 4                    # the fixtures' DSEConfig(batch=4)
    for (grp, lms), (rgrp, rlms) in zip(port.mapping, ref.mapping):
        got, an = ev.eval_group(grp, lms, batch)
        want, ran = rev.eval_group(rgrp, rlms, batch)
        assert (got.bottleneck, got.depth, got.n_passes) == \
            (want.bottleneck, want.depth, want.n_passes)
        for f in ("delay_s", "energy_j", "stage_time_s",
                  "glb_overflow_bytes"):
            assert _close(getattr(got, f), getattr(want, f)), f
        assert got.energy_breakdown.keys() == want.energy_breakdown.keys()
        for k, v in want.energy_breakdown.items():
            assert _close(got.energy_breakdown[k], v), k
        np.testing.assert_allclose(an.edge_bytes, ran.edge_bytes, rtol=REL)
        np.testing.assert_allclose(an.core_time_s, ran.core_time_s,
                                   rtol=REL)
    res = ev.evaluate(port.mapping, batch)
    rres = rev.evaluate(ref.mapping, batch)
    assert _close(res.delay_s, rres.delay_s)
    assert _close(res.energy_j, rres.energy_j)
    # the checkpoint's own prediction came from the reference's DSE
    assert math.isclose(res.energy_j, port.energy_j, rel_tol=1e-6)
    assert math.isclose(res.delay_s, port.delay_s, rel_tol=1e-6)


def test_multicast_union_without_path_bitsets_equals_reference():
    """The analyzer unions multicast XY paths through packed bitsets, or,
    on a grid too large for them (or a big-endian host), by sorting edge
    ids; both give the reference's traffic on every ``tf-paper`` stage."""
    port, ref = _candidates("tf-paper")
    ev, rev = Evaluator(port.arch, port.graph), \
        RefEvaluator(ref.arch, ref.graph)
    assert ev.analyzer._path_bits is not None
    ev.analyzer._path_bits = None
    for (grp, lms), (rgrp, rlms) in zip(port.mapping, ref.mapping):
        got = ev.traffic_summary(grp, lms, grp.batch_unit)
        want = rev.traffic_summary(rgrp, rlms, rgrp.batch_unit)
        for k in SUMMARY_KEYS:
            assert _close(got[k], want[k]), (grp.names, k)


@pytest.mark.parametrize("arch", [
    simba_arch(),
    ArchConfig(x_cores=6, y_cores=4, xcut=3, ycut=2, n_dram=4),
    ArchConfig(x_cores=4, y_cores=4, xcut=2, ycut=2, n_dram=3),
], ids=["simba", "6x4-cut3x2", "4x4-cut2x2"])
def test_router_grid_equals_reference(arch):
    got, want = router_grid(arch), ref_router_grid(_ref_arch(arch))
    assert (got.n_nodes, got.n_edges) == (want.n_nodes, want.n_edges)
    for f in ("edge_is_d2d", "paths", "path_len", "hops_d2d"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.edge_is_d2d.any()
    ra = _ref_arch(arch)
    assert arch.chiplet_of_core == ra.chiplet_of_core
    assert [arch.dram_node(d) for d in range(1, arch.n_dram + 1)] == \
        [ra.dram_node(d) for d in range(1, ra.n_dram + 1)]
    assert [arch.node_chiplet(n) for n in range(got.n_nodes)] == \
        [ra.node_chiplet(n) for n in range(want.n_nodes)]


@pytest.mark.parametrize("label", sorted(FIXTURES))
def test_regions_and_intra_core_equal_reference_on_fixture_layers(label):
    """``parse_regions``, ``ifmap_region`` against every producer's K, and
    the intra-core search of every region's signature, on every layer of
    the fixture's mapping."""
    port, ref = _candidates(label)
    arch = port.arch
    n_sigs = 0
    for grp, lms in port.mapping:
        for name, ms in lms.ms.items():
            lyr, rlyr = port.graph.layers[name], ref.graph.layers[name]
            regs = parse_regions(ms, lyr, grp.batch_unit)
            rregs = ref_parse_regions(RefMS(part=ms.part, cg=ms.cg,
                                            fd=ms.fd), rlyr, grp.batch_unit)
            assert [(c, dataclasses.astuple(r)) for c, r in regs.items()] \
                == [(c, dataclasses.astuple(r)) for c, r in rregs.items()]
            for pname in port.graph.preds(name):
                pk = port.graph.layers[pname].K
                for r, rr in zip(regs.values(), rregs.values()):
                    assert dataclasses.astuple(ifmap_region(lyr, r, pk)) \
                        == dataclasses.astuple(ref_ifmap_region(rlyr, rr, pk))
            for r in regs.values():
                sig = core_workload_signature(lyr.K, lyr.C, r.elems,
                                              r.k1 - r.k0, lyr.R, lyr.S)
                assert sig == ref_core_signature(lyr.K, lyr.C, r.elems,
                                                 r.k1 - r.k0, lyr.R, lyr.S)
                # the analyzer's full signature (``_intra_geometry``)
                full = sig + (lyr.bytes_per_elem, arch.core_glb_bytes,
                              arch.macs_per_core, lyr.kind)
                df, = explore_intra_core_many([full])
                assert df == explore_intra_core(*full)
                assert dataclasses.astuple(df) == \
                    dataclasses.astuple(ref_explore(*full))
                n_sigs += 1
    assert n_sigs > len(port.mapping)


def _scaled_pair(spec: str):
    """The same graph in both packages with expected-traffic scales on
    every third layer and multiplicities on every fifth edge."""
    g, rg = graph_from_spec(spec), ref_graph_from_spec(spec)
    for i, name in enumerate(list(g.layers)):
        if i % 3 == 1:
            kw = dict(traffic_scale=0.25, weight_traffic_scale=0.5)
            g.layers[name] = dataclasses.replace(g.layers[name], **kw)
            rg.layers[name] = dataclasses.replace(rg.layers[name], **kw)
    for i, edge in enumerate(list(g.edges)):
        if i % 5 == 2:
            g.edge_mults[edge] = rg.edge_mults[edge] = 0.5
    return g, rg


def test_scaled_graph_cost_model_equals_reference():
    """Expected-traffic scales and edge multiplicities (no graph the port
    builds carries them yet): ``is_scaled``, ``edge_volume``, ``dense_twin``
    and every stage's ``traffic_summary`` equal the reference's."""
    port, ref = _candidates("tf-paper")
    g, rg = _scaled_pair("tf-paper")
    assert g.is_scaled and rg.is_scaled
    assert not port.graph.is_scaled and dense_twin(port.graph) is port.graph
    for s, d in g.edges:
        assert edge_volume(g, s, d, 4) == ref_edge_volume(rg, s, d, 4)
    twin, rtwin = dense_twin(g), ref_dense_twin(rg)
    assert not twin.is_scaled and twin.edges == rtwin.edges
    assert {n: repr(lyr) for n, lyr in twin.layers.items()} == \
        {n: repr(lyr) for n, lyr in rtwin.layers.items()}
    assert [ly.traffic_scale for ly in twin.layers.values()] == \
        [ly.traffic_scale for ly in rtwin.layers.values()]
    ev, rev = Evaluator(port.arch, g), RefEvaluator(ref.arch, rg)
    dense = Evaluator(port.arch, port.graph)
    lower = 0
    for (grp, lms), (rgrp, rlms) in zip(port.mapping, ref.mapping):
        got = ev.traffic_summary(grp, lms, grp.batch_unit)
        want = rev.traffic_summary(rgrp, rlms, rgrp.batch_unit)
        for k in SUMMARY_KEYS:
            assert _close(got[k], want[k]), (grp.names, k)
        lower += got["flops"] < dense.traffic_summary(
            grp, lms, grp.batch_unit)["flops"]
    assert lower > 0


def test_layer_sizes_equal_reference():
    """The per-sample sizes the analyzer and the partitioner read, on one
    layer of each kind."""
    kinds = [dict(kind="conv", K=64, H=14, W=14, C=32, R=3, S=3, stride=2,
                  groups=2),
             dict(kind="fc", K=128, H=16, C=256),
             dict(kind="matmul", K=64, H=32, C=48),
             dict(kind="depthwise", K=32, H=8, W=8, R=3, S=3, stride=2),
             dict(kind="pool", K=16, H=7, W=7, stride=2),
             dict(kind="eltwise", K=16, H=7, W=7, n_inputs=2)]
    for kw in kinds:
        a, b = Layer(name="l", **kw), RefLayer(name="l", **kw)
        for f in ("has_weight", "is_scaled", "ofmap_elems", "ifmap_elems",
                  "weight_elems"):
            assert getattr(a, f) == getattr(b, f), (kw["kind"], f)
        assert (a.macs(3), a.ofmap_bytes(3), a.weight_bytes()) == \
            (b.macs(3), b.ofmap_bytes(3), b.weight_bytes())
    g, rg = Graph("g"), RefGraph("g")
    for graph, L in ((g, Layer), (rg, RefLayer)):
        graph.add(L(name="a", kind="fc", K=8, H=4, C=8))
        graph.add(L(name="b", kind="fc", K=8, H=4, C=8), [("a", 0.5)])
    assert g.edge_mult("a", "b") == rg.edge_mult("a", "b") == 0.5
    assert g.is_scaled and rg.is_scaled


def test_tech_constants_equal_reference():
    assert dataclasses.astuple(TECH_12NM) == dataclasses.astuple(REF_TECH)
