"""The cost model, the DSE and the realization path of the port on the
paper's five DNNs, the routed-MoE and MLA zoo and routed-MoE ``lm:``
graphs, against the reference.

* Scalar ``eval_group`` and ``traffic_summary`` are bit-equal to the
  reference's (float64, the same order), on every group of a DSE mapping.
* ``run_dse`` writes the reference's checkpoint byte for byte, for each of
  the five DNNs at a small ``iters`` and for a weighted MoE + MLA + dense
  portfolio (the reference's ``test_portfolio_quick_flow``).
* Realization (CPU, plain versions): a routed graph
  (``lm:granite-moe-3b-a800m:seq=128,n_layers=1``) and ``mla-quick`` give
  every stage cube within 2e-4 of the reference's plain route
  (``tests/test_realize.py``'s bound), the reference's ``pred_*`` to the
  bit and its expected-traffic factors within rel 1e-12; a conv with a
  kernel window or groups is refused up front (neither package can realize
  one).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.core import dse as ref_dse
from repro.core import explore as ref_explore
from repro.core.evaluator import Evaluator as RefEvaluator
from repro.core.sa import SAConfig as RefSAConfig
from repro.core.workloads import PAPER_WORKLOADS as REF_PAPER
from repro.core.workloads import make_workload as ref_workload
from repro_torch.core import dse, explore
from repro_torch.core.bridge import lms_to_plan
from repro_torch.core.evaluator import Evaluator
from repro_torch.core.hw import ArchConfig
from repro_torch.core.sa import SAConfig
from repro_torch.core.workloads import PAPER_WORKLOADS, make_workload
from repro_torch.core.workloads.mla import mla_transformer
from repro_torch.core.workloads.moe import moe_transformer
from repro_torch.core.workloads.transformer import transformer
from repro_torch.realize.program import build_program

REPO = Path(__file__).resolve().parent.parent
ARCH_KW = dict(x_cores=4, y_cores=3, xcut=2, ycut=1, noc_bw=32.0,
               d2d_bw=16.0, dram_bw=64.0, glb_kb=1024, macs_per_core=1024)
ZOO = ("tf-quick", "moe-quick", "mla-quick", "moe-paper", "mla-paper")


def _dse_pair(name, g, rg, iters, tmp_path):
    """Both packages' keep_mappings DSE of one workload on one arch, each
    with its checkpoint: (port points, ref points, port bytes, ref bytes)."""
    arch = ArchConfig(**ARCH_KW)
    rarch = ref_explore.arch_from_dict(explore.arch_to_dict(arch))
    cfg = dse.DSEConfig(batch=4, sa=SAConfig(iters=iters, seed=0),
                        keep_mappings=True)
    rcfg = ref_dse.DSEConfig(batch=4, sa=RefSAConfig(iters=iters, seed=0),
                             keep_mappings=True)
    ck, rck = tmp_path / "port.ckpt.jsonl", tmp_path / "ref.ckpt.jsonl"
    mine = dse.run_dse([arch], {name: g}, cfg, checkpoint=ck)
    ref = ref_dse.run_dse([rarch], {name: rg}, rcfg, checkpoint=rck)
    return mine, ref, ck.read_bytes(), rck.read_bytes()


def _assert_scalar_engine_equal(arch, g, mapping, rarch, rg, rmapping):
    ev, rev = Evaluator(arch, g), RefEvaluator(rarch, rg)
    for (grp, lms), (rgrp, rlms) in zip(mapping, rmapping):
        assert grp.names == rgrp.names
        for batch in (grp.batch_unit, 4):
            got, _ = ev.eval_group(grp, lms, batch)
            want, _ = rev.eval_group(rgrp, rlms, batch)
            assert vars(got) == vars(want)
        assert ev.traffic_summary(grp, lms, grp.batch_unit) == \
            rev.traffic_summary(rgrp, rlms, rgrp.batch_unit)
    res, rres = ev.evaluate(mapping, 4), rev.evaluate(rmapping, 4)
    assert (res.energy_j, res.delay_s) == (rres.energy_j, rres.delay_s)


@pytest.mark.parametrize("name", sorted(REF_PAPER))
def test_paper_dnn_dse_and_cost_model_equal_reference(name, tmp_path):
    iters = 20 if name in ("TF", "RN-50") else 10
    mine, ref, ck, rck = _dse_pair(name, PAPER_WORKLOADS[name](),
                                   REF_PAPER[name](), iters, tmp_path)
    assert ck == rck
    (p,), (rp,) = mine, ref
    assert (p.objective, p.energy_j, p.delay_s, p.mc) == \
        (rp.objective, rp.energy_j, rp.delay_s, rp.mc)
    _assert_scalar_engine_equal(p.arch, PAPER_WORKLOADS[name](),
                                p.mappings[name], rp.arch,
                                REF_PAPER[name](), rp.mappings[name])


@pytest.mark.parametrize("spec", ZOO)
def test_zoo_dse_and_cost_model_equal_reference(spec, tmp_path):
    g, rg = make_workload(spec), ref_workload(spec)
    mine, ref, ck, rck = _dse_pair("Z", g, rg, 30, tmp_path)
    assert ck == rck
    (p,), (rp,) = mine, ref
    _assert_scalar_engine_equal(p.arch, g, p.mappings["Z"], rp.arch, rg,
                                rp.mappings["Z"])


def test_portfolio_moe_mla_quick_flow_equals_reference(tmp_path):
    """MoE + MLA + dense through the weighted quick flow (the reference's
    ``test_portfolio_quick_flow``): the checkpointed weighted sweep, a
    2-way shard + merge, byte for byte the reference's."""
    from repro.core.workloads.mla import mla_transformer as ref_mla
    from repro.core.workloads.moe import moe_transformer as ref_moe
    from repro.core.workloads.transformer import transformer as ref_tf

    def portfolio(tf, moe, mla):
        return {"TF": tf(n_layers=1, d_model=64, d_ff=128, seq=32,
                         name="tf-t"),
                "MOE": moe(n_layers=1, d_model=64, d_ff=64, n_experts=4,
                           top_k=2, n_shared=0, seq=32, name="moe-t"),
                "MLA": mla(n_layers=1, d_model=64, n_heads=2, q_rank=16,
                           kv_rank=8, d_ff=64, seq=32, name="mla-t")}

    kw = dict(mac_options=(512,), cut_options=(1, 2), dram_per_tops=(2.0,),
              noc_options=(32,), d2d_ratio=(0.5,), glb_options=(1024,))
    cands = dse.grid_candidates(72.0, **kw)[:2]
    rcands = ref_dse.grid_candidates(72.0, **kw)[:2]
    weights = {"TF": 0.6, "MOE": 0.25, "MLA": 0.15}
    cfg = dse.DSEConfig(batch=4, sa=SAConfig(iters=60, seed=0),
                        keep_mappings=True, workload_weights=weights)
    rcfg = ref_dse.DSEConfig(batch=4, sa=RefSAConfig(iters=60, seed=0),
                             keep_mappings=True, workload_weights=weights)
    wls = portfolio(transformer, moe_transformer, mla_transformer)
    rwls = portfolio(ref_tf, ref_moe, ref_mla)
    out = {}
    for tag, run, c, w, conf, merge in (
            ("port", dse.run_dse, cands, wls, cfg,
             explore.merge_checkpoints),
            ("ref", ref_dse.run_dse, rcands, rwls, rcfg,
             ref_explore.merge_checkpoints)):
        d = tmp_path / tag              # same file names: merge records them
        d.mkdir()
        ck = d / "portfolio.ckpt.jsonl"
        pts = run(c, w, conf, screen_keep=1.0, checkpoint=ck)
        shards = []
        for i in range(2):
            sck = d / f"shard{i}.jsonl"
            run(c, w, conf, shard=(i, 2), checkpoint=sck)
            shards.append(sck)
        merged = d / "merged.jsonl"
        merge(shards, merged)
        out[tag] = (pts, ck.read_bytes(), merged.read_bytes())
    (pts, ck, merged), (rpts, rck, rmerged) = out["port"], out["ref"]
    assert ck == rck and merged == rmerged
    assert len(pts) == 2 and set(pts[0].per_workload) == set(weights)
    assert [(p.objective, sorted(p.per_workload.items())) for p in pts] == \
        [(p.objective, sorted(p.per_workload.items())) for p in rpts]
    header = json.loads(ck.decode().splitlines()[0])["_config"]
    assert ":w=MLA:0.15,MOE:0.25,TF:0.6:" in header


# ---------------------------------------------------------------------------
# realization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["RN-50", "RNX", "IRes", "PNas"])
def test_windowed_or_grouped_convs_are_refused_up_front(name):
    g = PAPER_WORKLOADS[name]()
    arch = ArchConfig(**ARCH_KW)
    from repro_torch.core.graph_partition import partition_graph
    from repro_torch.core.tangram import tangram_map
    plan = lms_to_plan(tangram_map(partition_graph(g, arch, 4), g, arch))
    with pytest.raises(ValueError, match=r"R\*S = .* groups = .*no route"):
        build_program(g, plan, device="cpu")


_PARITY = textwrap.dedent("""
    import json
    import numpy as np
    from repro.core.bridge import lms_to_plan as ref_lms_to_plan
    from repro.core.dse import DSEConfig, run_dse
    from repro.core.evaluator import evaluator_for as ref_evaluator_for
    from repro.core.explore import mapping_to_jsonable
    from repro.core.hw import ArchConfig
    from repro.core.sa import SAConfig
    from repro.core.workload import dense_twin as ref_dense_twin
    from repro.core.workloads import make_workload as ref_workload
    from repro.realize.program import build_program as ref_build
    from repro_torch.core.bridge import lms_to_plan
    from repro_torch.core.explore import mapping_from_jsonable
    from repro_torch.core.workloads import make_workload
    from repro_torch.realize.measure import measure_candidate
    from repro_torch.realize.plan import RealizeCandidate
    from repro_torch.realize.program import build_program

    arch = ArchConfig(x_cores=4, y_cores=3, xcut=2, ycut=1, noc_bw=32,
                      d2d_bw=16, dram_bw=64, glb_kb=1024,
                      macs_per_core=1024)
    out = {}
    for spec in ("lm:granite-moe-3b-a800m:seq=128,n_layers=1", "mla-quick"):
        rg, pg = ref_workload(spec), make_workload(spec)
        mapping = run_dse([arch], {"W": rg}, DSEConfig(
            batch=4, sa=SAConfig(iters=40, seed=0),
            keep_mappings=True))[0].mappings["W"]
        pmapping = mapping_from_jsonable(mapping_to_jsonable(mapping))
        rprog = ref_build(rg, ref_lms_to_plan(mapping), use_pallas=False)
        rrun = rprog.execute(seed=0)
        prog = build_program(pg, lms_to_plan(pmapping), device="cpu")
        run = prog.execute(seed=0)
        errs = []
        for name, b in rrun["outputs"].items():
            a = run["outputs"][name].numpy()
            b = np.asarray(b)
            assert a.shape == b.shape, (name, a.shape, b.shape)
            errs.append(float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9)))
        # the reference's predicted side and expected-traffic factors, as
        # its measure_candidate computes them (realize/measure.py:166-200)
        rev = ref_evaluator_for(arch, rg)
        twin = ref_dense_twin(rg)
        rdense = None if twin is rg else ref_evaluator_for(arch, twin)
        want_pred, want_esc = [], []
        for grp, lms in mapping:
            p = rev.traffic_summary(grp, lms, grp.batch_unit)
            want_pred.append(p)
            esc = {}
            if rdense is not None:
                d = rdense.traffic_summary(grp, lms, grp.batch_unit)
                esc = {k: (p[k] / d[k]) if d[k] > 0 else 1.0
                       for k in ("flops", "dram_bytes", "noc_bytes",
                                 "d2d_bytes")}
            want_esc.append(esc)
        from repro_torch.core.hw import ArchConfig as PortArch
        parch = PortArch(x_cores=4, y_cores=3, xcut=2, ycut=1, noc_bw=32,
                         d2d_bw=16, dram_bw=64, glb_kb=1024,
                         macs_per_core=1024)
        cand = RealizeCandidate(key="k", workload="W", arch=parch,
                                graph=pg, mapping=pmapping, energy_j=1.0,
                                delay_s=1.0)
        rep = measure_candidate(cand, prog, execute=False)
        out[spec] = {
            "scaled": pg.is_scaled, "n_stages": len(prog.stages),
            "routes_equal": all(r.routes == p.routes for r, p
                                in zip(rprog.stages, prog.stages)),
            "max_rel_err": max(errs), "n_cubes": len(errs),
            "ref_dci": [float(x) for x in rrun["dci_bytes"]],
            "port_dci": [float(x) for x in run["dci_bytes"]],
            "pred": [[s.pred_flops, s.pred_dram_bytes, s.pred_noc_bytes,
                      s.pred_d2d_bytes, s.pred_delay_s, s.pred_energy_j,
                      s.pred_glb_overflow] for s in rep.stages],
            "want_pred": [[p["flops"], p["dram_bytes"], p["noc_bytes"],
                           p["d2d_bytes"], p["delay_s"], p["energy_j"],
                           p["glb_overflow_bytes"]] for p in want_pred],
            "esc": [s.expected_scale for s in rep.stages],
            "want_esc": want_esc,
        }
    print(json.dumps(out))
""")


def test_routed_moe_and_mla_realize_as_the_reference():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=12"
    env["PYTHONPATH"] = str(REPO / "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    r = subprocess.run([sys.executable, "-c", _PARITY], capture_output=True,
                       text=True, timeout=900, env=env, cwd=REPO)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    rec = json.loads(r.stdout.splitlines()[-1])
    granite = rec["lm:granite-moe-3b-a800m:seq=128,n_layers=1"]
    mla = rec["mla-quick"]
    assert granite["scaled"] and not mla["scaled"]
    for res in (granite, mla):
        assert res["routes_equal"] and res["n_cubes"] > 0
        assert res["max_rel_err"] < 2e-4
        assert res["port_dci"] == res["ref_dci"]
        assert res["pred"] == res["want_pred"]
        assert len(res["esc"]) == res["n_stages"] == len(res["want_esc"])
        for got, want in zip(res["esc"], res["want_esc"]):
            assert got.keys() == want.keys()
            for k, v in want.items():
                assert got[k] == pytest.approx(v, rel=1e-12, abs=0.0)
    assert all(e for e in granite["esc"])          # every stage scaled
    assert any(e["flops"] != 1.0 for e in granite["esc"])
    assert not any(mla["esc"])                      # a dense twin is itself
