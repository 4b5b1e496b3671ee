"""PyTorch port of the realization loop against the JAX reference.

* the committed ``tf-paper`` and ``mamba2-370m`` keep_mappings fixtures
  equal what the reference DSE writes now;
* graph fingerprints, lowered plans and kernel routes of the port equal the
  reference's;
* realized stages: the port on the CPU against the reference program built
  with ``use_pallas=False`` on forced XLA host devices, on identical
  numpy-drawn inputs — argument shapes equal, every stage cube within
  2e-4 of the cube's max (``tests/test_realize.py``'s bound), DCI bytes
  exactly equal, and the port's DCI billing decision equal to
  ``NamedSharding.is_equivalent_to`` on every inter-stage cube of the
  fixture's 37-stage plan; the same on a two-layer ``mamba2-370m`` graph
  at full width, whose ``*_ssd`` stages run the chunked SSD (the
  reference's plain route runs its Pallas SSD kernel in interpret mode);
* the port's CLI end to end on the CPU, resumed run included;
* the entry points raise when asked for the card on a machine without one.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.dse import DSEConfig, run_dse
from repro.core.explore import ResumableSweep as RefSweep
from repro.core.explore import graph_fingerprint as ref_fingerprint
from repro.core.hw import ArchConfig as RefArch
from repro.core.hw import simba_arch as ref_simba
from repro.core.sa import SAConfig
from repro.configs import get_config as ref_config
from repro.core.workloads import make_workload as ref_workload
from repro.realize.plan import load_realize_candidates as ref_load
from repro.realize.program import _route_layers as ref_routes
from repro_torch.configs import get_config
from repro_torch.configs.archs import ALL as ALL_CONFIGS
from repro_torch.core.explore import graph_fingerprint
from repro_torch.core.hw import simba_arch
from repro_torch.core.workloads import make_workload
from repro_torch.realize.measure import attention_pairs, launch_cost
from repro_torch.realize.plan import load_realize_candidates, plans_for
from repro_torch.realize.program import _fit, _route_layers, build_program

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "realize" / "tf-paper.simba.ckpt.jsonl"
MAMBA_FIXTURE = FIXTURE.with_name("mamba2-370m.simba.ckpt.jsonl")
GRANITE_FIXTURE = FIXTURE.with_name("granite-moe-3b-a800m.simba.ckpt.jsonl")
MLA_FIXTURE = FIXTURE.with_name("mla-paper.simba.ckpt.jsonl")
GRANITE_SPEC = "lm:granite-moe-3b-a800m:seq=4096,n_layers=2"
SMALL_SPEC = "transformer:n_layers=1,d_model=64,d_ff=128,seq=32,name=tf-t"


def _plan_tuple(plan):
    return ([(st.layers, st.devices, st.parts, st.cgs) for st in plan.stages],
            plan.batch_unit)


# ---------------------------------------------------------------------------
# the fixture and the plan it lowers to
# ---------------------------------------------------------------------------

def _assert_fixture_equals_fresh_dse(tmp_path, fixture, name, spec):
    cfg = DSEConfig(batch=4, sa=SAConfig(iters=200, seed=0),
                    keep_mappings=True)
    ck = tmp_path / fixture.name
    run_dse([ref_simba()], {name: ref_workload(spec)}, cfg, checkpoint=ck)
    header = lambda p: json.loads(Path(p).read_text().splitlines()[0])
    assert header(ck) == header(fixture)
    fresh, fixed = RefSweep.read(ck).as_dict(), RefSweep.read(fixture).as_dict()
    assert fresh.keys() == fixed.keys() and len(fixed) == 1
    for key, rec in fixed.items():
        now = fresh[key]
        assert rec.keys() == now.keys()
        assert rec["arch"] == now["arch"] and rec["seed"] == now["seed"]
        assert rec["workload"] == now["workload"]
        assert rec["mapping"] == now["mapping"]
        for f in ("energy_j", "delay_s"):
            assert rec[f] == pytest.approx(now[f], rel=1e-9)


def test_fixture_equals_fresh_reference_dse(tmp_path):
    _assert_fixture_equals_fresh_dse(tmp_path, FIXTURE, "TF", "tf-paper")


def test_mamba_fixture_equals_fresh_reference_dse(tmp_path):
    _assert_fixture_equals_fresh_dse(tmp_path, MAMBA_FIXTURE, "MAMBA",
                                     "lm:mamba2-370m")


def test_granite_fixture_equals_fresh_reference_dse(tmp_path):
    """Full width, depth cut to 2 of 32 layers: the routed-MoE fixture."""
    _assert_fixture_equals_fresh_dse(tmp_path, GRANITE_FIXTURE, "GRANITE",
                                     GRANITE_SPEC)


def test_mla_fixture_equals_fresh_reference_dse(tmp_path):
    _assert_fixture_equals_fresh_dse(tmp_path, MLA_FIXTURE, "MLA",
                                     "mla-paper")


@pytest.mark.parametrize("fixture,name,spec,stages,launches", [
    (GRANITE_FIXTURE, "GRANITE", GRANITE_SPEC, 162,
     {"tiled_matmul": 166, "flash_attention_mha": 2}),
    (MLA_FIXTURE, "MLA", "mla-paper", 5,
     {"tiled_matmul": 16, "flash_attention_mha": 2})])
def test_family_fixture_plans_and_routes_match_reference(
        fixture, name, spec, stages, launches):
    """The two family fixtures lower to the reference's plan and routes,
    with the stages and kernel launches ``chip_smoke.py`` pins."""
    g, rg = make_workload(spec), ref_workload(spec)
    (cand, plan), = plans_for(load_realize_candidates(
        fixture, {name: g}, top=0, verbose=False))
    rcand, = ref_load(fixture, {name: rg}, top=0, verbose=False)
    assert _plan_tuple(plan) == _plan_tuple(rcand.lower())
    prog = build_program(g, plan, device="cpu")
    assert len(prog.stages) == stages
    for sp, rst in zip(prog.stages, rcand.lower().stages):
        assert sp.routes == ref_routes(rg, rst)
    counted = {}
    for sp in prog.stages:
        for kernel, _ in sp.launches:
            counted[kernel] = counted.get(kernel, 0) + 1
    assert counted == launches
    assert g.is_scaled == (name == "GRANITE")


@pytest.mark.parametrize("spec", [
    "tf-paper", "tf-quick", SMALL_SPEC, "lm:mamba2-370m",
    "lm:mamba2-370m:seq=256,n_layers=2", "lm:zamba2-1.2b:seq=128,n_layers=2",
    "lm:qwen3-0.6b:seq=64,n_layers=2", "lm:whisper-small:seq=32,n_layers=1",
    GRANITE_SPEC, "mla-paper", "moe-paper"])
def test_graph_fingerprint_matches_reference(spec):
    assert graph_fingerprint(make_workload(spec)) == \
        ref_fingerprint(ref_workload(spec))


def test_unknown_workload_names_what_the_port_has():
    """An unknown spec raises the reference's error, naming every preset
    and grammar."""
    with pytest.raises(ValueError) as mine:
        make_workload("moe-huge")
    with pytest.raises(ValueError) as ref:
        ref_workload("moe-huge")
    assert str(mine.value) == str(ref.value)
    assert "mla-paper" in str(mine.value) and "moe:k=v" in str(mine.value)


def test_routed_moe_lm_spec_names_the_roadmap_item():
    """A routed-MoE ``lm:`` spec builds the reference's scaled graph."""
    spec = "lm:granite-moe-3b-a800m:seq=64,n_layers=1"
    g, rg = make_workload(spec), ref_workload(spec)
    assert g.is_scaled and rg.is_scaled
    assert graph_fingerprint(g) == ref_fingerprint(rg)
    assert g.edge_mults == rg.edge_mults


def test_configs_match_reference():
    """Every field the port keeps has the reference's value."""
    for cfg in ALL_CONFIGS:
        rcfg = ref_config(cfg.name)
        assert get_config(cfg.name) is cfg
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(rcfg, f.name), \
                (cfg.name, f.name)
        assert cfg.hd == rcfg.hd


def test_fixture_plans_and_routes_match_reference():
    g, rg = make_workload("tf-paper"), ref_workload("tf-paper")
    (cand, plan), = plans_for(load_realize_candidates(
        FIXTURE, {"TF": g}, top=0, verbose=False))
    rcand, = ref_load(FIXTURE, {"TF": rg}, top=0, verbose=False)
    rplan = rcand.lower()
    assert cand.key == rcand.key and cand.arch.label() == rcand.arch.label()
    assert cand.arch.n_cores == 36
    assert _plan_tuple(plan) == _plan_tuple(rplan)
    assert len(plan.stages) == 37 and plan.batch_unit == 4
    tags = []
    for st, rst in zip(plan.stages, rplan.stages):
        routes = _route_layers(g, st)
        assert routes == ref_routes(rg, rst)
        tags += [r.split(":")[0] for r in routes.values()]
    assert (tags.count("matmul"), tags.count("flash"),
            tags.count("add")) == (36, 6, 12)
    prog = build_program(g, plan, device="cpu")
    launched = [k for sp in prog.stages for k, _ in sp.launches]
    assert (launched.count("tiled_matmul"),
            launched.count("flash_attention_mha")) == (36, 6)


def test_mamba_fixture_plans_and_routes_match_reference():
    spec = "lm:mamba2-370m"
    g, rg = make_workload(spec), ref_workload(spec)
    (cand, plan), = plans_for(load_realize_candidates(
        MAMBA_FIXTURE, {"MAMBA": g}, top=0, verbose=False))
    rcand, = ref_load(MAMBA_FIXTURE, {"MAMBA": rg}, top=0, verbose=False)
    rplan = rcand.lower()
    assert cand.key == rcand.key and cand.arch.label() == rcand.arch.label()
    assert _plan_tuple(plan) == _plan_tuple(rplan)
    assert len(plan.stages) == 96 and plan.batch_unit == 1
    tags = []
    for st, rst in zip(plan.stages, rplan.stages):
        routes = _route_layers(g, st)
        assert routes == ref_routes(rg, rst)
        tags += [r.split(":")[0] for r in routes.values()]
    assert (tags.count("matmul"), tags.count("ssd"), tags.count("add"),
            tags.count("flash")) == (96, 48, 48, 0)
    prog = build_program(g, plan, device="cpu")
    launched = [(k, tuple(s.items())) for sp in prog.stages
                for k, s in sp.launches]
    mm = lambda M, K, N: ("tiled_matmul", (("M", M), ("K", K), ("N", N)))
    ssd = ("ssd_chunk_dual", (("BC", 32), ("Q", 128), ("H", 16), ("P", 128),
                              ("N", 64)))
    kinds = (mm(4096, 1024, 4384), mm(4096, 2048, 1024), ssd)
    assert set(launched) == set(kinds)
    assert [launched.count(x) for x in kinds] == [48, 48, 48]
    flops = sum(launch_cost(k, dict(s))[0] for k, s in launched)
    assert flops == 2_694_970_343_424


def test_mamba_plan_declares_the_state_pass_route():
    """After each of its 48 chunk launches the mamba2-370m plan declares
    the state pass's kernels for the route ``ssd_state_pass`` takes: the
    split at (B 1, H 16, P 128), 32 walk blocks on an H100's 132 SMs (the
    count a plan on the CPU assumes).  The measured side counts the
    layers' work (``launches``) only, so the pass's FLOPs stay those of
    the GEMMs and the chunk form."""
    g = make_workload("lm:mamba2-370m")
    (_, plan), = plans_for(load_realize_candidates(
        MAMBA_FIXTURE, {"MAMBA": g}, top=0, verbose=False))
    prog = build_program(g, plan, device="cpu")
    state = [(k, tuple(s.items())) for sp in prog.stages
             for k, s in sp.state_launches]
    shape = (("B", 1), ("nc", 32), ("Q", 128), ("H", 16), ("P", 128),
             ("N", 64), ("G", 1))
    assert state == [("ssd_state_scan", shape), ("ssd_state_out", shape)] * 48
    assert sum(len(sp.kernel_launches) for sp in prog.stages) == 96 + 48 + 96
    flops = sum(launch_cost(k, s)[0] for sp in prog.stages
                for k, s in sp.launches)
    assert flops == 2_694_970_343_424


def test_corrupt_fixture_mapping_is_refused(tmp_path):
    rec = [json.loads(line) for line in FIXTURE.read_text().splitlines()]
    rec[1]["mapping"][0]["lms"]["l0_q"]["cg"][0] = 99
    bad = tmp_path / "bad.ckpt.jsonl"
    bad.write_text("".join(json.dumps(r) + "\n" for r in rec))
    with pytest.raises(ValueError, match="out of range"):
        load_realize_candidates(bad, {"TF": make_workload("tf-paper")},
                                verbose=False)


@pytest.mark.parametrize("n,shape", [(10, (3, 7)), (12, (2, 2, 3)),
                                     (50, (4, 5)), (7, (1, 40))])
def test_fit_has_jnp_resize_semantics(n, shape):
    x = np.arange(n, dtype=np.float32) * 0.5 - 1.0
    want = np.resize(x, shape)
    np.testing.assert_array_equal(_fit(torch.from_numpy(x), shape).numpy(),
                                  want)


def test_ssd_cost_counts_the_pairs_the_decay_keeps():
    flops, nbytes = launch_cost("ssd_chunk_dual", {
        "BC": 32, "Q": 128, "H": 16, "P": 128, "N": 64})
    assert (flops, nbytes) == (2_189_688_832, 86_245_376)
    # a brute count of the kept (i, j <= i) pairs at a ragged chunk
    BC, Q, H, P, N = 3, 70, 2, 32, 16
    kept = int((np.arange(Q)[:, None] >= np.arange(Q)[None, :]).sum())
    flops, _ = launch_cost("ssd_chunk_dual", {"BC": BC, "Q": Q, "H": H,
                                              "P": P, "N": N})
    assert flops == 2 * BC * (kept * N + kept * H * P + Q * H * N * P)


@pytest.mark.parametrize("Sq,Sk", [(512, 512), (96, 96), (100, 300),
                                   (256, 128), (1, 7), (7, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_flops_count_the_pairs_the_mask_keeps(Sq, Sk, causal):
    q_pos, k_pos = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    kept = int((q_pos >= k_pos).sum()) if causal else Sq * Sk
    assert attention_pairs(Sq, Sk, causal) == kept
    flops, nbytes = launch_cost("flash_attention_mha", {
        "B": 2, "H": 3, "Sq": Sq, "Sk": Sk, "D": 16, "causal": int(causal)})
    assert flops == 4.0 * 2 * 3 * 16 * kept
    assert nbytes == 4.0 * 2 * 3 * 16 * (2 * Sq + 2 * Sk)


# ---------------------------------------------------------------------------
# realized stages: port (CPU) vs reference (use_pallas=False), one process
# with forced host devices
# ---------------------------------------------------------------------------

_PARITY = textwrap.dedent("""
    import json
    import numpy as np
    import jax
    from repro.core.bridge import lms_to_plan as ref_lms_to_plan
    from repro.core.dse import DSEConfig, run_dse
    from repro.core.explore import mapping_to_jsonable
    from repro.core.hw import ArchConfig
    from repro.core.sa import SAConfig
    from repro.core.tangram import tangram_map
    from repro.core.workload import LayerGroup
    from repro.core.workloads import make_workload as ref_workload
    from repro.core.workloads import transformer
    from repro.realize.plan import load_realize_candidates as ref_load
    from repro.realize.program import _stage_mesh, build_program as ref_build
    from repro.realize.program import cube_spec_for
    from jax.sharding import NamedSharding
    from repro_torch.core.bridge import lms_to_plan
    from repro_torch.core.explore import mapping_from_jsonable
    from repro_torch.core.workloads import make_workload
    from repro_torch.realize.plan import load_realize_candidates, plans_for
    from repro_torch.realize.program import build_program

    arch = ArchConfig(x_cores=4, y_cores=3, xcut=2, ycut=1, noc_bw=32,
                      d2d_bw=16, dram_bw=64, glb_kb=1024,
                      macs_per_core=1024)
    g = transformer(n_layers=1, d_model=64, d_ff=128, seq=32, name="tf-par")
    pg = make_workload("transformer:n_layers=1,d_model=64,d_ff=128,seq=32,"
                       "name=tf-par")
    devs = jax.devices()


    def moves(rplan, prog, pg):
        # per inter-stage cube: does the reference bill it, does the port
        meshes = [_stage_mesh(st, devs) for st in rplan.stages]
        stage_of = {n: i for i, sp in enumerate(prog.stages)
                    for n in sp.stage.layers}
        ref_m, port_m = [], []
        for si, sp in enumerate(prog.stages):
            for name in sp.ext_inputs:
                pi = stage_of[name]
                lyr = pg.layers[name]
                shape = (prog.batch_unit, lyr.H, lyr.W, lyr.K)
                src = NamedSharding(meshes[pi],
                                    cube_spec_for(shape, meshes[pi]))
                dst = NamedSharding(meshes[si],
                                    cube_spec_for(shape, meshes[si]))
                ref_m.append(not src.is_equivalent_to(dst, 4))
                port_m.append(prog.stages[pi].layout(shape)
                              != sp.layout(shape))
        return ref_m, port_m


    names = tuple(g.topo_order())
    tf_mappings = {
        "tangram": tangram_map([LayerGroup(names=names, batch_unit=2)], g,
                               arch),
        "per_layer": tangram_map([LayerGroup(names=(n,), batch_unit=2)
                                  for n in names], g, arch),
        "dse": run_dse([arch], {"TF": g}, DSEConfig(
            batch=4, sa=SAConfig(iters=40, seed=0),
            keep_mappings=True))[0].mappings["TF"],
    }
    cases = [(label, g, pg, m) for label, m in tf_mappings.items()]
    # full-width mamba2-370m, two layers: the ssd route
    mspec = "lm:mamba2-370m:seq=256,n_layers=2"
    gm = ref_workload(mspec)
    cases.append(("mamba", gm, make_workload(mspec), run_dse(
        [arch], {"M": gm}, DSEConfig(batch=4, sa=SAConfig(iters=40, seed=0),
                                     keep_mappings=True))[0].mappings["M"]))
    out = {}
    for label, g, pg, mapping in cases:
        rplan = ref_lms_to_plan(mapping)
        rprog = ref_build(g, rplan, use_pallas=False)
        rrun = rprog.execute(seed=0)
        prog = build_program(pg, lms_to_plan(mapping_from_jsonable(
            mapping_to_jsonable(mapping))), device="cpu")
        run = prog.execute(seed=0)
        errs = {}
        for name, b in rrun["outputs"].items():
            a = run["outputs"][name].numpy()
            b = np.asarray(b)
            assert a.shape == b.shape, (name, a.shape, b.shape)
            errs[name] = float(np.abs(a - b).max()
                               / (np.abs(b).max() + 1e-9))
        ref_m, port_m = moves(rplan, prog, pg)
        out[label] = {
            "n_stages": len(prog.stages),
            "shapes_equal": [[tuple(s.shape) for s in rsp.arg_structs]
                             == [tuple(s) for s in sp.arg_shapes]
                             for rsp, sp in zip(rprog.stages, prog.stages)],
            "routes_equal": [rsp.routes == sp.routes
                             for rsp, sp in zip(rprog.stages, prog.stages)],
            "has_flash": any(r.startswith("flash:") for sp in prog.stages
                             for r in sp.routes.values()),
            "n_ssd": sum(r == "ssd" for sp in prog.stages
                         for r in sp.routes.values()),
            "max_rel_err": max(errs.values()),
            "n_cubes": len(errs),
            "ref_dci": [float(x) for x in rrun["dci_bytes"]],
            "port_dci": [float(x) for x in run["dci_bytes"]],
            "ref_moves": ref_m, "port_moves": port_m,
        }

    # billing decisions on the full tf-paper fixture plan (no execution)
    ck = "tests/data/realize/tf-paper.simba.ckpt.jsonl"
    rcand, = ref_load(ck, {"TF": ref_workload("tf-paper")}, verbose=False)
    pg = make_workload("tf-paper")
    (_, plan), = plans_for(load_realize_candidates(ck, {"TF": pg},
                                                   verbose=False))
    ref_m, port_m = moves(rcand.lower(), build_program(pg, plan, "cpu"), pg)
    out["fixture"] = {"ref_moves": ref_m, "port_moves": port_m}
    print(json.dumps(out))
""")


def test_realized_stages_match_reference_program():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=36"
    env["PYTHONPATH"] = str(REPO / "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    r = subprocess.run([sys.executable, "-c", _PARITY], capture_output=True,
                       text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    rec = json.loads(r.stdout.splitlines()[-1])
    for label in ("tangram", "per_layer", "dse", "mamba"):
        res = rec[label]
        assert all(res["shapes_equal"]) and all(res["routes_equal"])
        assert res["max_rel_err"] < 2e-4
        assert res["port_dci"] == res["ref_dci"]
        assert res["port_moves"] == res["ref_moves"]
    assert rec["tangram"]["n_stages"] == 1 and rec["tangram"]["has_flash"]
    assert rec["dse"]["n_stages"] > 1 and any(rec["dse"]["ref_dci"])
    assert rec["mamba"]["n_stages"] > 1 and rec["mamba"]["n_ssd"] == 2
    assert rec["mamba"]["n_cubes"] == 6
    # both billing outcomes occur: cubes that move and cubes that stay
    billed = [m for label in ("per_layer", "dse")
              for m in rec[label]["ref_moves"]]
    assert any(billed) and not all(billed)
    fx = rec["fixture"]
    assert fx["port_moves"] == fx["ref_moves"] and len(fx["ref_moves"]) > 36


# ---------------------------------------------------------------------------
# CLI end to end (CPU) and the entry points' refusal without a card
# ---------------------------------------------------------------------------

def _keep_ckpt(tmp_path):
    archs = [RefArch(x_cores=2, y_cores=2, xcut=xcut, ycut=1, noc_bw=32.0,
                     d2d_bw=16.0, dram_bw=64.0, glb_kb=512,
                     macs_per_core=1024) for xcut in (1, 2)]
    cfg = DSEConfig(batch=4, sa=SAConfig(iters=40, seed=0),
                    keep_mappings=True)
    ck = tmp_path / "rt.ckpt.jsonl"
    run_dse(archs, {"TF": ref_workload(SMALL_SPEC)}, cfg, checkpoint=ck)
    return ck


def test_realize_cli_end_to_end_cpu(tmp_path):
    """``--device cpu --calibrate``: a report with the predicted side and
    the ratios, and an overlay fitted from it; the re-run resumes every
    record and fits the same overlay from disk."""
    ck = _keep_ckpt(tmp_path)
    out = tmp_path / "realize.jsonl"
    overlay = tmp_path / "realize.overlay.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.realize",
           "--ckpt", str(ck), "--workload", f"TF={SMALL_SPEC}",
           "--top", "2", "--device", "cpu", "--out", str(out),
           "--calibrate"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    assert "DCI/D2D m/p MB" in r.stdout
    assert "measured/predicted geomean" in r.stdout
    lines = out.read_text().splitlines()
    assert json.loads(lines[0])["_config"].startswith("realize-torch:v2:TF:")
    recs = [json.loads(line) for line in lines[1:]]
    assert len(recs) == 2
    for rec in recs:
        assert rec["totals"]["flops"] > 0 and rec["totals"]["wall_s"] > 0
        assert rec["totals"]["ici_bytes"] == 0
        assert rec["pred_energy_j"] > 0 and rec["stages"]
        assert rec["totals"]["pred_flops"] > 0
        assert rec["totals"]["pred_dram_bytes"] > 0
        assert rec["predict_s"] > 0
        assert 0.2 < rec["ratio_summary"]["flops"] < 20
        assert "noc_bytes" not in rec["ratio_summary"]
        assert all(st["ratios"] for st in rec["stages"])
    first = json.loads(overlay.read_text())
    assert first["n_stages"] == sum(len(rec["stages"]) for rec in recs) > 0
    assert first["source"].startswith("repro_torch:rt.ckpt.jsonl|")
    assert first["source"].endswith("device=cpu")
    assert first["f_noc"] == 1.0
    overlay.unlink()
    r2 = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                        env=env)
    assert r2.returncode == 0, f"stderr:\n{r2.stderr[-3000:]}"
    assert r2.stdout.count("resumed from") == 2
    assert len(out.read_text().splitlines()) == 3
    assert json.loads(overlay.read_text()) == first


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = make_workload("tf-paper")
    (_, plan), = plans_for(load_realize_candidates(FIXTURE, {"TF": g},
                                                   verbose=False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_program(g, plan)
    from repro_torch.launch.realize import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--ckpt", str(FIXTURE), "--workload", "TF=tf-paper",
              "--out", str(tmp_path / "r.jsonl")])


def test_mamba_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = make_workload("lm:mamba2-370m")
    (_, plan), = plans_for(load_realize_candidates(MAMBA_FIXTURE,
                                                   {"MAMBA": g},
                                                   verbose=False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_program(g, plan)
    from repro_torch.launch.realize import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--ckpt", str(MAMBA_FIXTURE), "--workload",
              "MAMBA=lm:mamba2-370m", "--out", str(tmp_path / "r.jsonl")])


def test_mamba_fixture_cli_counts_on_the_cpu(tmp_path):
    """``--device cpu --no-exec``: the plan's kernel work, counted."""
    from repro_torch.launch.realize import main
    out = tmp_path / "r.jsonl"
    main(["--ckpt", str(MAMBA_FIXTURE), "--workload", "MAMBA=lm:mamba2-370m",
          "--device", "cpu", "--no-exec", "--out", str(out)])
    rec = json.loads(out.read_text().splitlines()[-1])
    assert len(rec["stages"]) == 96 and rec["batch_unit"] == 1
    assert rec["totals"]["flops"] == 2_694_970_343_424
    # the predicted side, and the reference's sanity band on each stage's
    # measured/predicted FLOPs (tests/test_realize.py)
    assert all(st["pred_flops"] > 0 for st in rec["stages"])
    for st in rec["stages"]:
        assert 0.2 < st["ratios"]["flops"] < 20, st["index"]
    assert 0.2 < rec["ratio_summary"]["flops"] < 20


def test_one_layer_ssd_plan_builds_and_runs():
    """The one-layer SSD plan builds on the CPU, lists one
    ``ssd_chunk_dual`` launch of its shape, and runs."""
    from repro_torch.core.bridge import MeshPlan, StagePlan
    from repro_torch.core.workload import Graph, Layer
    g = Graph("ssd")
    g.add(Layer(name="l0_ssd", kind="matmul", K=64, H=32, C=64))
    plan = MeshPlan(stages=[StagePlan(layers=("l0_ssd",), devices=(0,),
                                      parts={"l0_ssd": (1, 1, 1, 1)},
                                      cgs={"l0_ssd": (0,)})], batch_unit=1)
    prog = build_program(g, plan, device="cpu")
    sp, = prog.stages
    assert sp.routes == {"l0_ssd": "ssd"}
    # K = 64 -> 1 head of 64; S = 32 -> one chunk of 32; N = min(64, C)
    assert sp.launches == [("ssd_chunk_dual",
                            {"BC": 1, "Q": 32, "H": 1, "P": 64, "N": 64})]
    out = prog.execute(seed=0)["outputs"]["l0_ssd"]
    assert tuple(out.shape) == (1, 32, 1, 64) and torch.isfinite(out).all()


def test_execute_times_its_stages_with_garbage_collection_paused(
        monkeypatch):
    """A full collection of the host's objects inside a timed stage would
    count in its wall, so ``execute`` pauses cyclic garbage collection
    while it runs the stages and restores the caller's setting after."""
    import gc

    from repro_torch.core.bridge import MeshPlan, StagePlan
    from repro_torch.core.workload import Graph, Layer
    from repro_torch.realize import program
    g = Graph("ssd")
    g.add(Layer(name="l0_ssd", kind="matmul", K=64, H=32, C=64))
    plan = MeshPlan(stages=[StagePlan(layers=("l0_ssd",), devices=(0,),
                                      parts={"l0_ssd": (1, 1, 1, 1)},
                                      cgs={"l0_ssd": (0,)})], batch_unit=1)
    prog = build_program(g, plan, device="cpu")
    seen = []
    elapsed = program._elapsed
    monkeypatch.setattr(program, "_elapsed", lambda fn, device: (
        seen.append(gc.isenabled()) or elapsed(fn, device)))
    assert gc.isenabled()
    prog.execute(seed=0)
    assert seen == [False] and gc.isenabled()
    gc.disable()
    try:
        prog.execute(seed=0)
        assert not gc.isenabled()
    finally:
        gc.enable()


def _one_device_plans(g, bridge):
    """A plan of ``bridge``'s classes that puts every layer of ``g`` in a
    stage of its own on device 0, batch unit 2."""
    return bridge.MeshPlan(stages=[
        bridge.StagePlan(layers=(n,), devices=(0,), parts={n: (1, 1, 1, 1)},
                         cgs={n: (0,)}) for n in g.topo_order()],
        batch_unit=2)


def test_logical_mode_arg_bytes_equal_the_reference_argument_sizes(
        tmp_path):
    """Logical mode records each stage's argument bytes, equal to the
    reference's compiled ``argument_size_in_bytes`` for the same one-device
    plan (jax on the CPU fills it), and its scratch as 0 on the CPU; a
    logical-mode report from ``measure_candidate`` carries both for every
    stage, taken outside the timed window (the walls are the executor's)."""
    from repro.core import bridge as ref_bridge
    from repro.realize.program import build_program as ref_build
    from repro_torch.core import bridge
    from repro_torch.realize.measure import measure_candidate
    g, pg = ref_workload(SMALL_SPEC), make_workload(SMALL_SPEC)
    rprog = ref_build(g, _one_device_plans(g, ref_bridge), use_pallas=False)
    want = [float(sp.lower_and_compile().memory_analysis()
                  .argument_size_in_bytes) for sp in rprog.stages]
    prog = build_program(pg, _one_device_plans(pg, bridge), device="cpu")
    run = prog.execute(seed=0)
    assert run["arg_bytes"] == want and all(b > 0 for b in want)
    assert run["temp_bytes"] == [0.0] * len(want)
    arg_bytes = lambda prog: [4.0 * sum(math.prod(s) for s in sp.arg_shapes)
                              for sp in prog.stages]
    assert run["arg_bytes"] == arg_bytes(prog)
    cand, plan = plans_for(load_realize_candidates(
        _keep_ckpt(tmp_path), {"TF": pg}, verbose=False))[0]
    prog = build_program(pg, plan, device="cpu")
    rep = measure_candidate(cand, prog, execute=True)
    assert [st.arg_bytes for st in rep.stages] == arg_bytes(prog)
    assert all(st.arg_bytes > 0 and st.temp_bytes == 0.0
               for st in rep.stages)


def test_simba_arch_matches_reference():
    assert simba_arch().label() == ref_simba().label()
    assert simba_arch().n_cores == ref_simba().n_cores
