"""The port's search and DSE sweep (``repro_torch.core``: ``mc``,
``graph_partition``, ``tangram``, ``sa``, ``dse`` and the search side of
``encoding``, ``hw`` and ``evaluator``) against the reference's
(``repro.core``), on identical inputs at small sizes.

Every comparison here is equality, to the bit: both packages run the same
float64 arithmetic in the same order and consume their
``np.random.default_rng`` streams in the same order.  Replica exchange is
compared mode for mode: each package's batched lockstep against the
other's, and each serial loop (``lockstep=False``, scored by the scalar
evaluator) against the other's; the two modes may differ in the last bits
on this toolchain.  The committed fixtures are reproduced by the port's
``run_dse`` at the bound the reference's own fixture test uses (header and
mapping equal, energy/delay rel 1e-9).
"""

import json
from pathlib import Path

import numpy as np
import pytest

from repro.core import dse as ref_dse
from repro.core import encoding as ref_enc
from repro.core import explore as ref_explore
from repro.core import hw as ref_hw
from repro.core import sa as ref_sa
from repro.core.evaluator import Evaluator as RefEvaluator
from repro.core.graph_partition import partition_graph as ref_partition
from repro.core.mc import evaluate_mc as ref_mc
from repro.core.tangram import tangram_map as ref_tangram
from repro.core.workloads import make_workload as ref_workload
from repro_torch.core import dse, encoding, explore, hw, sa
from repro_torch.core.evaluator import (CachedEvaluator, Evaluator,
                                        analysis_signature)
from repro_torch.core.graph_partition import partition_graph
from repro_torch.core.mc import evaluate_mc
from repro_torch.core.tangram import tangram_map
from repro_torch.core.workloads import make_workload

DATA = Path(__file__).resolve().parent / "data" / "realize"
SMALL = "transformer:n_layers=1,d_model=64,d_ff=128,seq=32,name=tf-t"
SPECS = ["tf-quick", SMALL]

ARCHS = {
    "simba": hw.simba_arch(),
    "gemini72": hw.gemini_arch_72t(),
    "gemini72-3x2": hw.gemini_arch_72t().replace(xcut=3, ycut=2),
    "tenstorrent": hw.tenstorrent_arch(),
    "4core": hw.ArchConfig(x_cores=2, y_cores=2, xcut=2, ycut=1, noc_bw=32,
                           d2d_bw=16, dram_bw=64, glb_kb=512),
    "8core": hw.ArchConfig(x_cores=4, y_cores=2, xcut=2, ycut=2, noc_bw=16,
                           d2d_bw=8, dram_bw=32, glb_kb=256,
                           macs_per_core=512),
}
SEARCH_ARCHS = ["simba", "gemini72-3x2", "4core", "8core"]


def ref_arch(arch):
    """The reference's ArchConfig with the same fields and tech name."""
    return ref_explore.arch_from_dict(explore.arch_to_dict(arch))


def jsonable(mapping):
    return explore.mapping_to_jsonable(mapping)


def ref_jsonable(mapping):
    return ref_explore.mapping_to_jsonable(mapping)


def small_grid():
    """16 candidates of 4 and 8 cores (the Table-I grid's generator)."""
    kw = dict(tops=8, mac_options=(512, 1024), cut_options=(1, 2),
              dram_per_tops=(1.0,), noc_options=(16, 32), d2d_ratio=(0.5,),
              glb_options=(512,))
    return dse.grid_candidates(**kw), ref_dse.grid_candidates(**kw)


def small_cfg(**kw):
    return (dse.DSEConfig(batch=4, sa=sa.SAConfig(iters=60, seed=3), **kw),
            ref_dse.DSEConfig(batch=4, sa=ref_sa.SAConfig(iters=60, seed=3),
                              **kw))


def point_tuple(p):
    return (explore.candidate_key(p.arch), p.mc, p.energy_j, p.delay_s,
            p.objective, sorted(p.per_workload.items()))


def ref_point_tuple(p):
    return (ref_explore.candidate_key(p.arch), p.mc, p.energy_j, p.delay_s,
            p.objective, sorted(p.per_workload.items()))


# ---------------------------------------------------------------------------
# hardware presets, MC, encoding generators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_arch_presets_and_mc_equal_reference(name):
    arch = ARCHS[name]
    ref = ref_arch(arch)
    assert arch.label() == ref.label()
    assert arch.d2d_interfaces_per_chiplet == ref.d2d_interfaces_per_chiplet
    mine, theirs = evaluate_mc(arch), ref_mc(ref)
    assert mine.total == theirs.total
    for f in ("silicon", "dram", "packaging", "compute_die_area",
              "io_die_area", "total_silicon_area", "d2d_area_fraction"):
        assert getattr(mine, f) == getattr(theirs, f), f


def test_named_presets_equal_reference():
    for fn in ("simba_arch", "gemini_arch_72t", "tenstorrent_arch"):
        assert explore.arch_to_dict(getattr(hw, fn)()) == \
            ref_explore.arch_to_dict(getattr(ref_hw, fn)())


def test_grid_candidates_equal_reference():
    for tops in (8, 72):
        mine = dse.grid_candidates(tops)
        ref = ref_dse.grid_candidates(tops)
        assert [explore.candidate_key(a) for a in mine] == \
            [ref_explore.candidate_key(a) for a in ref]
        assert [evaluate_mc(a).total for a in mine[::37]] == \
            [ref_mc(a).total for a in ref[::37]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encoding_generators_draw_as_the_reference(seed):
    g, rg = make_workload("tf-quick"), ref_workload("tf-quick")
    rng, rrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for n, dims in [(12, (64, 1, 4, 128)), (7, (7, 1, 1, 7)),
                    (36, (512, 1, 4, 512)), (5, (1, 1, 1, 2))]:
        try:
            mine = encoding.factor_parts(n, dims, rng)
        except ValueError:
            with pytest.raises(ValueError):
                ref_enc.factor_parts(n, dims, rrng)
            continue
        assert mine == ref_enc.factor_parts(n, dims, rrng)
    for grp, rgrp in zip(partition_graph(g, ARCHS["8core"], 4),
                         ref_partition(rg, ref_arch(ARCHS["8core"]), 4)):
        lms = encoding.random_lms(grp, g, 8, 2, rng)
        rlms = ref_enc.random_lms(rgrp, rg, 8, 2, rrng)
        assert jsonable([(grp, lms)]) == ref_jsonable([(rgrp, rlms)])
        for name in grp.names:
            assert encoding.default_fd(g.layers[name], g, grp, 2) == \
                ref_enc.default_fd(rg.layers[name], rg, rgrp, 2)
    assert rng.random() == rrng.random()      # streams still in step


def test_space_size_bounds_equal_reference():
    for n, m in [(1, 4), (3, 8), (5, 36), (12, 144)]:
        assert encoding.space_size_lower_bound(n, m) == \
            ref_enc.space_size_lower_bound(n, m)
        assert encoding.tangram_space_upper_bound(n, m) == \
            ref_enc.tangram_space_upper_bound(n, m)


# ---------------------------------------------------------------------------
# graph partition, T-Map, the bandwidth-vectorized evaluator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS + ["tf-paper"])
@pytest.mark.parametrize("arch", SEARCH_ARCHS)
def test_partition_and_tangram_equal_reference(spec, arch):
    g, rg = make_workload(spec), ref_workload(spec)
    a, ra = ARCHS[arch], ref_arch(ARCHS[arch])
    groups, rgroups = partition_graph(g, a, 4), ref_partition(rg, ra, 4)
    assert [(x.names, x.batch_unit) for x in groups] == \
        [(x.names, x.batch_unit) for x in rgroups]
    assert jsonable(tangram_map(groups, g, a)) == \
        ref_jsonable(ref_tangram(rgroups, rg, ra))


@pytest.mark.parametrize("spec", SPECS)
def test_eval_mapping_archs_equals_scalar_and_reference(spec):
    """Each column equals the scalar evaluator of its arch, the port's and
    the reference's, to the bit.  The reference's own
    ``eval_mapping_archs`` adds the group terms into a numpy array, which
    on Python 3.12 (compensated ``sum``) differs from the scalar path in
    the last bit (``tests/test_batched_engine.py``'s known failure), so it
    is held at rel 1e-12."""
    g, rg = make_workload(spec), ref_workload(spec)
    base = ARCHS["gemini72"]
    sibs = [base, base.replace(noc_bw=8.0), base.replace(d2d_bw=4.0),
            base.replace(dram_bw=36.0), base.replace(noc_bw=64.0,
                                                      d2d_bw=64.0)]
    assert len({analysis_signature(a) for a in sibs}) == 1
    groups = partition_graph(g, base, 8)
    mapping = tangram_map(groups, g, base)
    E, D = Evaluator(base, g).eval_mapping_archs(mapping, 8, sibs)
    rsibs = [ref_arch(a) for a in sibs]
    rmapping = ref_tangram(ref_partition(rg, rsibs[0], 8), rg, rsibs[0])
    for i, (a, ra) in enumerate(zip(sibs, rsibs)):
        r = Evaluator(a, g).evaluate(mapping, 8)
        assert (E[i], D[i]) == (r.energy_j, r.delay_s)
        rr = RefEvaluator(ra, rg).evaluate(rmapping, 8)
        assert (E[i], D[i]) == (rr.energy_j, rr.delay_s)
        assert r.cost(1.0, 2.0) == r.energy_j * r.delay_s ** 2
    rE, rD = RefEvaluator(rsibs[0], rg).eval_mapping_archs(rmapping, 8,
                                                            rsibs)
    assert E == pytest.approx(rE, rel=1e-12)
    assert D == pytest.approx(rD, rel=1e-12)
    with pytest.raises(ValueError, match="analysis signature"):
        Evaluator(base, g).eval_mapping_archs(mapping, 8,
                                              [base.replace(glb_kb=512)])


# ---------------------------------------------------------------------------
# simulated annealing
# ---------------------------------------------------------------------------

def _sa_pair(spec, arch, cfg_kw, ref_kw=None):
    g, rg = make_workload(spec), ref_workload(spec)
    a, ra = ARCHS[arch], ref_arch(ARCHS[arch])
    groups, rgroups = partition_graph(g, a, 4), ref_partition(rg, ra, 4)
    mine = sa.sa_optimize(g, a, groups, 4, sa.SAConfig(**cfg_kw))
    ref = ref_sa.sa_optimize(rg, ra, rgroups, 4,
                             ref_sa.SAConfig(**cfg_kw, **(ref_kw or {})))
    return mine, ref


def _assert_same_result(mine, ref):
    assert jsonable(mine.mapping) == ref_jsonable(ref.mapping)
    assert (mine.cost, mine.energy_j, mine.delay_s) == \
        (ref.cost, ref.energy_j, ref.delay_s)
    assert (mine.accepted, mine.proposed) == (ref.accepted, ref.proposed)
    assert mine.history == ref.history
    assert (mine.swap_attempts, mine.swap_accepts) == \
        (ref.swap_attempts, ref.swap_accepts)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("arch", ["gemini72-3x2", "8core"])
@pytest.mark.parametrize("spec", SPECS)
def test_single_chain_sa_equals_reference(spec, arch, seed):
    mine, ref = _sa_pair(spec, arch, dict(iters=250, seed=seed,
                                          log_every=10, beta=1.0, gamma=2.0))
    assert mine.proposed > 0 and mine.accepted > 0
    _assert_same_result(mine, ref)


@pytest.mark.parametrize("seed", [0, 5])
def test_replica_exchange_equals_reference_serial_loop(seed):
    """Port serial loop == reference serial loop (``lockstep=False``), and
    port lockstep (batched) == reference lockstep (batched)."""
    kw = dict(iters=150, seed=seed, n_chains=3, log_every=10, swap_every=10)
    serial, ref = _sa_pair("tf-quick", "8core", {**kw, "lockstep": False})
    assert sum(serial.swap_attempts) > 0
    _assert_same_result(serial, ref)
    mine, ref_lockstep = _sa_pair("tf-quick", "8core", kw)
    _assert_same_result(mine, ref_lockstep)


def test_two_chains_warn_and_run_three():
    with pytest.warns(RuntimeWarning, match="n_chains=3"):
        two, ref = _sa_pair(SMALL, "4core",
                            dict(iters=60, seed=1, n_chains=2))
    assert len(two.swap_attempts) == 1
    _assert_same_result(two, ref)


def test_group_draw_cdf_is_shared_and_read_only():
    g = make_workload("tf-quick")
    groups = partition_graph(g, ARCHS["8core"], 4)
    a = sa.group_draw_cdf(groups, 8)
    assert a is sa.group_draw_cdf(list(groups), 8)
    assert not a.flags.writeable and a[-1] == 1.0
    rg = ref_workload("tf-quick")
    ref = ref_sa.group_draw_cdf(ref_partition(rg, ref_arch(ARCHS["8core"]),
                                              4), 8)
    assert a.tolist() == ref.tolist()


# ---------------------------------------------------------------------------
# the DSE sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("screen_keep", [1.0, 0.5, "auto"])
def test_run_dse_equals_reference(screen_keep):
    cands, rcands = small_grid()
    cfg, rcfg = small_cfg()
    wl = {"B": make_workload(SMALL), "A": make_workload("tf-quick")}
    rwl = {"B": ref_workload(SMALL), "A": ref_workload("tf-quick")}
    mine = dse.run_dse(cands, wl, cfg, screen_keep=screen_keep)
    ref = ref_dse.run_dse(rcands, rwl, rcfg, screen_keep=screen_keep)
    assert len(mine) < len(cands) or screen_keep == 1.0
    assert [point_tuple(p) for p in mine] == [ref_point_tuple(p) for p in ref]


def test_run_dse_weighted_portfolio_equals_reference():
    cands, rcands = small_grid()
    cfg, rcfg = small_cfg(workload_weights={"A": 0.75, "B": 0.25})
    wl = {"A": make_workload("tf-quick"), "B": make_workload(SMALL)}
    rwl = {"A": ref_workload("tf-quick"), "B": ref_workload(SMALL)}
    mine = dse.run_dse(cands[:6], wl, cfg, use_sa=False)
    ref = ref_dse.run_dse(rcands[:6], rwl, rcfg, use_sa=False)
    assert [point_tuple(p) for p in mine] == [ref_point_tuple(p) for p in ref]
    with dse._explore.ExplorationEngine(wl, cfg) as eng:
        fp = eng._fingerprint(True)
    with ref_explore.ExplorationEngine(rwl, rcfg) as eng:
        assert fp == eng._fingerprint(True)
    assert ":w=A:0.75,B:0.25:wl=" in fp


def test_parallel_workers_equal_serial():
    cands, _ = small_grid()
    cfg, _ = small_cfg(keep_mappings=True)
    wl = {"A": make_workload("tf-quick")}
    serial = dse.run_dse(cands[:5], wl, cfg)
    par = dse.run_dse(cands[:5], wl, cfg, n_workers=2)
    assert [point_tuple(p) for p in par] == [point_tuple(p) for p in serial]
    assert [jsonable(p.mappings["A"]) for p in par] == \
        [jsonable(p.mappings["A"]) for p in serial]


def test_evaluate_candidate_matches_run_dse_index():
    cands, rcands = small_grid()
    cfg, rcfg = small_cfg()
    wl = {"A": make_workload("tf-quick"), "B": make_workload(SMALL)}
    rwl = {"A": ref_workload("tf-quick"), "B": ref_workload(SMALL)}
    one = dse.evaluate_candidate(cands[3], wl, cfg, cand_idx=3)
    swept = {explore.candidate_key(p.arch): p
             for p in dse.run_dse(cands[:4], wl, cfg)}
    assert point_tuple(one) == \
        point_tuple(swept[explore.candidate_key(cands[3])])
    assert point_tuple(one) == ref_point_tuple(
        ref_dse.evaluate_candidate(rcands[3], rwl, rcfg, cand_idx=3))
    with pytest.raises(ValueError, match="either seed"):
        dse.evaluate_candidate(cands[3], wl, cfg, seed=1, cand_idx=3)


def test_joint_reuse_dse_equals_reference():
    base = [hw.ArchConfig(x_cores=2, y_cores=2, xcut=1, ycut=1, noc_bw=32,
                          d2d_bw=16, dram_bw=32, glb_kb=512),
            hw.ArchConfig(x_cores=2, y_cores=1, xcut=1, ycut=1, noc_bw=16,
                          d2d_bw=16, dram_bw=16, glb_kb=1024)]
    cfg, rcfg = small_cfg()
    mine = dse.joint_reuse_dse(base, (1, 2), {"A": make_workload(SMALL)},
                               cfg)
    ref = ref_dse.joint_reuse_dse([ref_arch(a) for a in base], (1, 2),
                                  {"A": ref_workload(SMALL)}, rcfg)
    assert [(explore.candidate_key(a), v) for a, v in mine] == \
        [(ref_explore.candidate_key(a), v) for a, v in ref]
    assert explore.arch_to_dict(dse.scaled_arch(base[0], 6)) == \
        ref_explore.arch_to_dict(ref_dse.scaled_arch(ref_arch(base[0]), 6))


@pytest.mark.parametrize("fixture,name,spec", [
    ("tf-paper.simba.ckpt.jsonl", "TF", "tf-paper"),
    ("mamba2-370m.simba.ckpt.jsonl", "MAMBA", "lm:mamba2-370m"),
    ("granite-moe-3b-a800m.simba.ckpt.jsonl", "GRANITE",
     "lm:granite-moe-3b-a800m:seq=4096,n_layers=2"),
    ("mla-paper.simba.ckpt.jsonl", "MLA", "mla-paper")])
def test_port_dse_writes_the_committed_fixture(tmp_path, fixture, name, spec):
    """What ``tests/test_torch_realize.py`` asks of the reference's fresh
    DSE, asked of the port's."""
    cfg = dse.DSEConfig(batch=4, sa=sa.SAConfig(iters=200, seed=0),
                        keep_mappings=True)
    ck = tmp_path / fixture
    dse.run_dse([hw.simba_arch()], {name: make_workload(spec)}, cfg,
                checkpoint=ck)
    header = lambda p: json.loads(Path(p).read_text().splitlines()[0])
    assert header(ck) == header(DATA / fixture)
    fresh = explore.ResumableSweep.read(ck).as_dict()
    fixed = explore.ResumableSweep.read(DATA / fixture).as_dict()
    assert fresh.keys() == fixed.keys() and len(fixed) == 1
    for key, rec in fixed.items():
        now = fresh[key]
        assert rec.keys() == now.keys()
        for f in ("arch", "seed", "workload", "mapping"):
            assert rec[f] == now[f], f
        for f in ("energy_j", "delay_s"):
            assert rec[f] == pytest.approx(now[f], rel=1e-9)


# ---------------------------------------------------------------------------
# objective="slo": the serving stack's SLO model scores the sweep
# ---------------------------------------------------------------------------

# the reference's re-ranking traffic (tests/test_serve_harness.py): its
# rate sits near the quick grid's service capacity, so the queueing tail
# bites
RERANK_TRAFFIC = "poisson:rate=71267.4,n=48,seed=0,plen=4..32,new=8..32"


def slo_tuple(p):
    return point_tuple(p) + (sorted(p.slo.items()),)


def ref_slo_tuple(p):
    return ref_point_tuple(p) + (sorted(p.slo.items()),)


def quick_dse():
    """The reference's SLO test grid: 16 72-TOPS candidates, a two-layer
    transformer, batch 8, SA 150 iterations."""
    from repro.core.workloads import transformer as ref_transformer
    from repro_torch.core.workloads import transformer
    kw = dict(mac_options=(512, 1024), cut_options=(1, 2),
              dram_per_tops=(2.0,), noc_options=(16, 32), d2d_ratio=(0.5,),
              glb_options=(1024, 2048))
    tf = dict(n_layers=2, d_model=128, d_ff=256, seq=64, name="tf-s")
    return (dse.grid_candidates(72.0, **kw), {"TF": transformer(**tf)},
            dse.DSEConfig(batch=8, sa=sa.SAConfig(iters=150, seed=0)),
            ref_dse.grid_candidates(72.0, **kw),
            {"TF": ref_transformer(**tf)},
            ref_dse.DSEConfig(batch=8, sa=ref_sa.SAConfig(iters=150, seed=0)))


def test_slo_objective_is_accepted_everywhere():
    """``run_dse``, ``reduce_tasks`` and ``joint_reuse_dse`` score
    ``objective="slo"`` as the reference does, to the bit, with each
    point's predicted SLO metrics; an unknown objective still raises."""
    cands, rcands = small_grid()
    wl = {"A": make_workload(SMALL)}
    rwl = {"A": ref_workload(SMALL)}
    cfg, rcfg = small_cfg()
    mine = dse.run_dse(cands[:4], wl, cfg, use_sa=False, objective="slo",
                       traffic="chat-quick")
    ref = ref_dse.run_dse(rcands[:4], rwl, rcfg, use_sa=False,
                          objective="slo", traffic="chat-quick")
    assert [slo_tuple(p) for p in mine] == [ref_slo_tuple(p) for p in ref]
    slo_cfg, rslo_cfg = small_cfg(objective="slo", traffic="diurnal-quick")
    tasks = {"A": (1.5e-3, 2e-4), "B": (3e-3, 5e-4)}
    got = dse.reduce_tasks(cands[0], slo_cfg, {
        k: dse.TaskResult(energy_j=e, delay_s=d) for k, (e, d) in
        tasks.items()})
    want = ref_dse.reduce_tasks(rcands[0], rslo_cfg, {
        k: ref_dse.TaskResult(energy_j=e, delay_s=d) for k, (e, d) in
        tasks.items()})
    assert slo_tuple(got) == ref_slo_tuple(want)
    base = [hw.ArchConfig(x_cores=2, y_cores=2, xcut=1, ycut=1, noc_bw=32,
                          d2d_bw=16, dram_bw=32, glb_kb=512)]
    joint = dse.joint_reuse_dse(base, (1, 2), wl, cfg, objective="slo",
                                traffic="chat-quick")
    rjoint = ref_dse.joint_reuse_dse([ref_arch(a) for a in base], (1, 2),
                                     rwl, rcfg, objective="slo",
                                     traffic="chat-quick")
    assert [(explore.candidate_key(a), v) for a, v in joint] == \
        [(ref_explore.candidate_key(a), v) for a, v in rjoint]
    assert all(p.slo is None for p in dse.run_dse(cands[:2], wl, cfg,
                                                  use_sa=False))
    with pytest.raises(ValueError, match="unknown DSE objective"):
        explore.ExplorationEngine(wl, dse.DSEConfig(objective="p99"))


def test_slo_objective_requires_traffic():
    """Without ``traffic`` each entry point raises the reference's
    ``ValueError`` before any task runs."""
    cands, _, cfg, rcands, _, rcfg = quick_dse()
    wl = {"A": make_workload(SMALL)}
    rwl = {"A": ref_workload(SMALL)}
    for run, c, w, conf in ((dse.run_dse, cands, wl, cfg),
                            (ref_dse.run_dse, rcands, rwl, rcfg)):
        with pytest.raises(ValueError, match="needs cfg.traffic"):
            run(c[:2], w, conf, use_sa=False, objective="slo")
    with pytest.raises(ValueError, match="needs cfg.traffic"):
        dse.reduce_tasks(cands[0], dse.DSEConfig(objective="slo"),
                         {"A": dse.TaskResult(energy_j=1.0, delay_s=1.0)})
    with pytest.raises(KeyError, match="unknown traffic model"):
        explore.ExplorationEngine(wl, dse.DSEConfig(objective="slo",
                                                    traffic="no-such"))


def test_slo_objective_reranks_sa_grid():
    """The reference's acceptance recipe, on the port: with SA mappings
    the quick grid's (E, D) order is not monotone in D, so the convex
    queueing tail re-ranks the candidates; every point equals the
    reference's SLO sweep to the bit."""
    grid, wl, cfg, rgrid, rwl, rcfg = quick_dse()
    base = dse.run_dse(grid, wl, cfg, use_sa=True)
    slo = dse.run_dse(grid, wl, cfg, use_sa=True, objective="slo",
                      traffic=RERANK_TRAFFIC)
    ref = ref_dse.run_dse(rgrid, rwl, rcfg, use_sa=True, objective="slo",
                          traffic=RERANK_TRAFFIC)
    assert sorted((p.arch.label(), p.energy_j, p.delay_s) for p in base) \
        == sorted((p.arch.label(), p.energy_j, p.delay_s) for p in slo)
    assert [p.arch.label() for p in base] != [p.arch.label() for p in slo]
    assert [slo_tuple(p) for p in slo] == [ref_slo_tuple(p) for p in ref]
    from repro_torch.serve.slo import SLO_SCALAR_KEY
    for p in slo:
        assert p.objective == pytest.approx(
            p.mc * p.energy_j * p.slo[SLO_SCALAR_KEY])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_chains", [1, 3])
def test_jax_backend_is_refused(n_chains):
    """The reference's ``"jax"`` is the port's ``"fused"``: ``"jax"`` gets
    the reference's unknown-backend error wherever the backend is read."""
    g = make_workload(SMALL)
    a = ARCHS["4core"]
    groups = partition_graph(g, a, 4)
    cfg = sa.SAConfig(iters=5, n_chains=n_chains, backend="jax")
    with pytest.raises(ValueError, match="unknown eval batch backend"):
        sa.sa_optimize(g, a, groups, 4, cfg)
    with pytest.raises(ValueError, match="unknown eval batch backend"):
        explore.replica_exchange_sa(g, a, groups, 4, cfg)
    ev = CachedEvaluator(a, g)
    chains = [sa.SAChain(g, a, groups, 4, cfg, None, ev, seed=0,
                         cum_w=sa.group_draw_cdf(groups, a.n_cores))
              for _ in range(n_chains)]
    with pytest.raises(ValueError, match="unknown eval batch backend"):
        for _ in range(20):           # until a chain draws a proposal
            sa.step_chains_lockstep(chains, backend="jax")
