"""Plan execution in the port (``repro_torch.core.bridge``,
``repro_torch.runtime.pipeline``, ``repro_torch.examples.map_to_mesh``)
against the reference's, and the reference methods the port's reduced
copies left out until now.

Tolerances: plans, stage ranges and the cost model's methods are equal
(the port's search is the reference's, same seeds); the pipelined logits
on the reference's own weights (``params_from_jax``) are held to the
reference test's atol = rtol = 2e-3 in f32 compute
(``tests/test_train_serve.py::test_gemini_bridge_and_pipeline``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as jall_archs
from repro.configs import get_config as jget_config
from repro.core import analyzer as janalyzer
from repro.core import bridge as jbridge
from repro.core import encoding as jencoding
from repro.core.graph_partition import partition_graph as jpartition_graph
from repro.core.workloads import make_workload as jmake_workload
from repro.core.workloads.lm_graph import lm_graph as jlm_graph
from repro.models import lm as jlm
from repro.models import model_api as jmodel_api
from repro.runtime.pipeline import PipelineExec as JPipelineExec
from repro_torch.configs import get_config
from repro_torch.core import analyzer, bridge, encoding
from repro_torch.core.graph_partition import partition_graph
from repro_torch.core.workloads import make_workload
from repro_torch.core.workloads.lm_graph import lm_graph
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.pipeline import PipelineExec, stage_ranges

TINY = dict(n_layers=2, d_model=64, vocab=256, d_ff=128)
PIPE_TOL = 2e-3


def _plans(seq, sa_iters, total_batch=4, **kw):
    """The port's and the reference's plan of one reduced smollm graph on
    the 2x2 abstract mesh."""
    pc = get_config("smollm-135m").reduced().replace(**kw)
    jc = jget_config("smollm-135m").reduced().replace(**kw)
    mine = bridge.plan_for_graph(lm_graph(pc, seq=seq),
                                 bridge.mesh_as_arch(2, 2, 1), total_batch,
                                 sa_iters=sa_iters)
    ref = jbridge.plan_for_graph(jlm_graph(jc, seq=seq),
                                 jbridge.mesh_as_arch(2, 2, 1), total_batch,
                                 sa_iters=sa_iters)
    return pc, jc, mine, ref


def _same_plan(mine, ref):
    assert len(mine.stages) == len(ref.stages)
    for a, b in zip(mine.stages, ref.stages):
        assert (a.layers, a.devices, a.parts, a.cgs) \
            == (b.layers, b.devices, b.parts, b.cgs)
    assert (mine.batch_unit, mine.cost_delay_s, mine.cost_energy_j) \
        == (ref.batch_unit, ref.cost_delay_s, ref.cost_energy_j)
    assert mine.n_devices_needed == ref.n_devices_needed


def test_mesh_as_arch_and_tech_equal_reference():
    assert dataclasses.asdict(bridge.TECH_TPUPOD) \
        == dataclasses.asdict(jbridge.TECH_TPUPOD)
    for args in ((), (2, 2, 1), (4, 2, 2, 25.0, 3.0, 400.0)):
        assert dataclasses.asdict(bridge.mesh_as_arch(*args)) \
            == dataclasses.asdict(jbridge.mesh_as_arch(*args))


@pytest.mark.parametrize("seq,sa_iters,kw", [
    (16, 150, TINY),                        # the reference test's plan
    (64, 600, dict(n_layers=8)),            # the example's plan
])
def test_plan_for_graph_equals_reference(seq, sa_iters, kw):
    _, _, mine, ref = _plans(seq, sa_iters, **kw)
    _same_plan(mine, ref)
    assert mine.cost_delay_s > 0


def test_stage_of_equals_reference():
    _, _, mine, ref = _plans(16, 150, **TINY)
    for st in ref.stages:
        for name in st.layers:
            assert mine.stage_of(name) == ref.stage_of(name)
    with pytest.raises(KeyError):
        mine.stage_of("no_such_layer")


def test_stage_ranges_at_full_width_equal_reference():
    """smollm-135m at seq 1024 on the 2x2 mesh, 600 SA iterations (the
    card's phase): one stage a Gemini layer; the first 30 stages run a
    block each and the rest none, as the reference's executor does."""
    cfg = get_config("smollm-135m")
    jc = jget_config("smollm-135m")
    mine = bridge.plan_for_graph(lm_graph(cfg, seq=1024),
                                 bridge.mesh_as_arch(2, 2, 1), 4,
                                 sa_iters=600)
    ref = jbridge.plan_for_graph(jlm_graph(jc, seq=1024),
                                 jbridge.mesh_as_arch(2, 2, 1), 4,
                                 sa_iters=600)
    _same_plan(mine, ref)
    assert len(mine.stages) == 240
    want = JPipelineExec(cfg=jc, params=None, plan=ref)._ranges
    got = stage_ranges(mine, cfg.n_layers)
    assert got == want
    assert got[:30] == [(i, i + 1) for i in range(30)]
    assert set(got[30:]) == {(30, 30)}


@pytest.fixture(scope="module")
def pipe_pair():
    """The reference's and the port's executor of the reference test's
    plan, on the reference's weights, f32 compute."""
    pc, jc, mine, ref = _plans(16, 150, compute_dtype="float32", **TINY)
    jparams, _ = jmodel_api(jc).init_params(jax.random.PRNGKey(0))
    params = params_from_jax(pc, jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(1).integers(0, pc.vocab, (4, 16))
    return pc, jc, mine, ref, jparams, params, toks


@pytest.mark.parametrize("n_micro", [1, 2])
def test_pipeline_equals_reference(pipe_pair, n_micro):
    pc, jc, mine, ref, jparams, params, toks = pipe_pair
    jpipe = JPipelineExec(cfg=jc, params=jparams, plan=ref)
    want = np.asarray(jpipe.forward(jnp.asarray(toks), n_micro=n_micro))
    pipe = PipelineExec(pc, params, mine, devices=[torch.device("cpu")])
    assert pipe._ranges == jpipe._ranges
    got = pipe.forward(torch.from_numpy(toks), n_micro=n_micro)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    print(f"max |port - reference| pipelined logits: {err:.3e}")
    np.testing.assert_allclose(got.numpy(), want, atol=PIPE_TOL,
                               rtol=PIPE_TOL)
    assert len(pipe.stage_times) == len(jpipe.stage_times) \
        == len(mine.stages)
    assert all(t >= 0 for t in pipe.stage_times)
    # and the port's own monolithic forward (the same blocks, in order)
    with torch.no_grad():
        mono, _, _ = lm.forward(pc, params, {"tokens": torch.from_numpy(toks)},
                                mode="train")
    np.testing.assert_allclose(got.numpy(), mono.numpy(), atol=PIPE_TOL,
                               rtol=PIPE_TOL)
    jmono, _, _ = jlm.forward(jc, jparams, {"tokens": jnp.asarray(toks)},
                              mode="train")
    np.testing.assert_allclose(got.numpy(), np.asarray(jmono),
                               atol=PIPE_TOL, rtol=PIPE_TOL)


def test_pipeline_devices_and_refusals(pipe_pair):
    pc, _, mine, _, _, params, toks = pipe_pair
    cpu = torch.device("cpu")
    # a pool smaller than the plan folds modulo its size
    pipe = PipelineExec(pc, params, mine, devices=[cpu, "cpu"])
    assert [pipe._stage_device(i) for i in range(len(mine.stages))] \
        == [cpu] * len(mine.stages)
    with pytest.raises(ValueError, match="equal microbatches"):
        pipe.forward(torch.from_numpy(toks), n_micro=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PipelineExec(pc, params, mine)
    ssm = get_config("mamba2-370m").reduced()
    with pytest.raises(ValueError, match="dense family"):
        PipelineExec(ssm, params, mine, devices=[cpu])


def test_pipeline_leaves_the_callers_params_in_place(pipe_pair):
    """A stage on another device than the caller's blocks runs a copy of
    them there: the caller's ``params`` stay where they were (the
    reference never moves its params), and a stage on their own device
    shares them."""
    pc, _, mine, _, _, params, _ = pipe_pair
    before = [p.device for p in params.parameters()]
    away = PipelineExec(pc, params, mine, devices=[torch.device("meta")])
    assert [p.device for p in params.parameters()] == before
    lo, hi = away._ranges[0]
    assert hi > lo
    for got, bp in zip(away._blocks[0], params.blocks[lo:hi]):
        assert got is not bp
        assert all(p.device.type == "meta" for p in got.parameters())
    home = PipelineExec(pc, params, mine, devices=[torch.device("cpu")])
    assert all(got is bp for blocks, (lo, hi) in zip(home._blocks,
                                                     home._ranges)
               for got, bp in zip(blocks, params.blocks[lo:hi]))


def test_map_to_mesh_example_reduced(capsys):
    """The port's example at 2 layers, seq 32, 150 SA iterations on the
    CPU: its plan equals the reference's at the same size, its lines are
    the reference example's, and the pipelined logits equal the
    monolithic forward."""
    from repro_torch.examples import map_to_mesh
    out = map_to_mesh.main(["--device", "cpu", "--layers", "2", "--seq",
                            "32", "--sa-iters", "150"])
    text = capsys.readouterr().out.splitlines()
    _, jc, _, ref = _plans(32, 150, n_layers=2)
    _same_plan(out["plan"], ref)
    assert text[0] == (f"[map] exported {jc.name} -> "
                       f"{len(jlm_graph(jc, seq=32).layers)} Gemini layers")
    assert text[1].startswith(f"[map] Gemini SA produced {len(ref.stages)} "
                              f"stages in ")
    assert text[1].endswith(f"(modelled delay {ref.cost_delay_s * 1e3:.2f} "
                            f"ms, energy {ref.cost_energy_j * 1e3:.2f} mJ)")
    for i, st in enumerate(ref.stages):
        assert text[2 + i] == (f"  stage {i}: {len(st.layers):2d} layers on "
                               f"devices {st.devices[:8]}"
                               f"{'...' if len(st.devices) > 8 else ''}")
    assert text[-2].startswith("[map] pipelined logits (4, 32, ")
    assert text[-1] == f"[map] max |pipelined - monolithic| = " \
        f"{out['err']:.2e}  (OK)"
    assert out["err"] < 0.05
    assert len(out["stage_times"]) == len(ref.stages)


# ---------------------------------------------------------------------------
# the reference methods the reduced copies left out
# ---------------------------------------------------------------------------

GRAPHS = ["tf-quick", "moe-quick", "mla-quick", "lm:mamba2-370m:n_layers=2"]


@pytest.mark.parametrize("spec", GRAPHS)
def test_graph_totals_and_subgraph_equal_reference(spec):
    g, jg = make_workload(spec), jmake_workload(spec)
    assert g.output_layers() == jg.output_layers()
    for batch in (1, 3):
        assert g.total_macs(batch) == jg.total_macs(batch)
        assert g.total_expected_macs(batch) == jg.total_expected_macs(batch)
    assert g.total_weight_bytes() == jg.total_weight_bytes()
    names = g.topo_order()
    for keep, name in ((names[1:len(names) // 2], None),
                       (names[::3], "every third")):
        sub, jsub = g.subgraph(keep, name), jg.subgraph(keep, name)
        assert sub.name == jsub.name
        assert list(sub.layers) == list(jsub.layers)
        assert sub.edges == jsub.edges
        assert sub.edge_mults == jsub.edge_mults
        assert sub.input_layers == jsub.input_layers
        assert sub.output_layers() == jsub.output_layers()


def test_ms_core_of_and_region_overlap_equal_reference():
    rng = np.random.default_rng(0)
    for part in ((1, 1, 2, 2), (2, 3, 1, 2), (1, 2, 2, 3)):
        n = int(np.prod(part))
        cg = tuple(int(c) for c in rng.permutation(16)[:n])
        ms = encoding.MS(part=part, cg=cg, fd=(0, 0, 0))
        jms = jencoding.MS(part=part, cg=cg, fd=(0, 0, 0))
        for hwbk in np.ndindex(*part):
            assert ms.part_index(*hwbk) == jms.part_index(*hwbk)
            assert ms.core_of(*hwbk) == jms.core_of(*hwbk)
    # the reference's own example (tests/test_encoding.py)
    ms = encoding.MS(part=(1, 1, 2, 2), cg=(2, 1, 5, 4), fd=(1, 1, -1))
    assert [ms.core_of(0, 0, b, k) for b in (0, 1) for k in (0, 1)] \
        == [2, 1, 5, 4]
    for _ in range(200):
        a, b = (rng.integers(0, 6, size=(4, 2)) for _ in range(2))
        a.sort(axis=1)
        b.sort(axis=1)
        ra = encoding.Region(*a.ravel().tolist())
        rb = encoding.Region(*b.ravel().tolist())
        ja = jencoding.Region(*a.ravel().tolist())
        jb = jencoding.Region(*b.ravel().tolist())
        assert ra.overlap(rb) == ja.overlap(jb) == rb.overlap(ra)


@pytest.mark.parametrize("spec", ["tf-quick", "moe-quick"])
def test_group_analysis_hops_and_d2d_equal_reference(spec):
    from repro_torch.core.hw import ArchConfig
    from repro.core.hw import ArchConfig as JArchConfig
    kw = dict(x_cores=4, y_cores=3, xcut=2, ycut=1, noc_bw=16.0, d2d_bw=8.0,
              dram_bw=64.0, glb_kb=512, macs_per_core=256)
    arch, jarch = ArchConfig(**kw), JArchConfig(**kw)
    g, jg = make_workload(spec), jmake_workload(spec)
    groups = partition_graph(g, arch, 4)
    jgroups = jpartition_graph(jg, jarch, 4)
    rng = np.random.default_rng(3)
    an, jan = analyzer.Analyzer(arch, g), janalyzer.Analyzer(jarch, jg)
    seen_d2d = False
    for grp, jgrp in zip(groups, jgroups):
        lms = encoding.random_lms(grp, g, arch.n_cores, arch.n_dram, rng)
        jlms = jencoding.LMS({n: jencoding.MS(m.part, m.cg, m.fd)
                              for n, m in lms.ms.items()})
        ga, jga = an.analyze(grp, lms, 4), jan.analyze(jgrp, jlms, 4)
        assert ga.total_hops_bytes == jga.total_hops_bytes
        assert ga.d2d_bytes == jga.d2d_bytes
        seen_d2d |= ga.d2d_bytes > 0
    assert seen_d2d


def test_attn_free_equals_reference():
    for name in jall_archs():
        assert get_config(name).attn_free == jget_config(name).attn_free
    assert get_config("mamba2-370m").attn_free
    assert not get_config("zamba2-1.2b").attn_free
