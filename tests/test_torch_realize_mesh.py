"""The realization in mesh mode: each plan stage on a sub-mesh of
``torch.distributed`` ranks, against the JAX reference's sharded programs.

* ``cube_spec_for`` gives the reference's ``PartitionSpec`` on a grid of
  shapes and ``Part``s, and the slices ``cube_layout`` puts on each grid
  position are the reference's ``devices_indices_map`` (the reference runs
  in a subprocess with forced host devices);
* four gloo ranks (one subprocess spawning them) against the reference on
  four forced host devices (another subprocess), on identical numpy-drawn
  inputs: the two best records of a small transformer DSE on two 2 x
  2-core archs, a two-stage plan whose ``*_ssd`` layer splits heads and
  batch, and a one-stage flash plan that splits query rows and heads.  Per
  stage the same ``n_devices``, routes, DCI bytes and predicted side, and
  every stage cube within 2e-4 of the cube's max (``tests/test_realize.py``'s
  bound);
* one rank gives the logical route's cubes and DCI bit for bit, with no
  collective bytes;
* a hand-built two-stage plan bills exactly the all-gathers worked out by
  hand;
* the CLI with ``--mesh 4 --host-ranks 4 --device cpu --calibrate`` end to
  end, resumed, with ``f_noc`` fitted; the logical report's fingerprint
  unchanged; the refusals of a pool too small.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.dse import DSEConfig, run_dse
from repro.core.hw import ArchConfig as RefArch
from repro.core.sa import SAConfig
from repro.core.workloads import make_workload as ref_workload
from repro_torch.core.bridge import MeshPlan, StagePlan, plan_from_tuples
from repro_torch.realize.calibrate import fit_overlay
from repro_torch.realize.plan import hand_plans, validate_plan
from repro_torch.realize.program import (STAGE_AXES, build_program,
                                         cube_layout, cube_spec_for,
                                         local_slices)
from torch.distributed.tensor import Shard

REPO = Path(__file__).resolve().parent.parent
SMALL_SPEC = "transformer:n_layers=1,d_model=64,d_ff=128,seq=32,name=tf-t"
SUB_TIMEOUT = 600

# (shape, dim axes) x Part grid of the placement test
SHAPES = [((4, 32, 1, 64), None), ((2, 6, 3, 8), None), ((1, 7, 2, 5), None),
          ((3, 9, 1, 12), None), ((64, 32), (None, "k")),
          ((30, 7), (None, "k"))]
PARTS = [(1, 1, 1, 1), (2, 1, 1, 1), (1, 2, 1, 1), (1, 1, 2, 1),
         (1, 1, 1, 2), (2, 1, 1, 2), (1, 1, 3, 1), (2, 2, 1, 1),
         (1, 1, 2, 2), (3, 1, 1, 1), (1, 1, 1, 4), (1, 2, 2, 1)]

# hand-built plans (``realize.plan.hand_plans``), built in both packages
# by ``core.bridge.plan_from_tuples``
HAND_PLANS = hand_plans()


def _hand_plan(name):
    return plan_from_tuples(*HAND_PLANS[name])


def _keep_ckpt(tmp_path):
    archs = [RefArch(x_cores=2, y_cores=2, xcut=xcut, ycut=1, noc_bw=32.0,
                     d2d_bw=16.0, dram_bw=64.0, glb_kb=512,
                     macs_per_core=1024) for xcut in (1, 2)]
    cfg = DSEConfig(batch=4, sa=SAConfig(iters=40, seed=0),
                    keep_mappings=True)
    ck = tmp_path / "rt.ckpt.jsonl"
    run_dse(archs, {"TF": ref_workload(SMALL_SPEC)}, cfg, checkpoint=ck)
    return ck


def _env(devices: int = 0) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "src")
    env["OMP_NUM_THREADS"] = "1"
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
        env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def _run(code: str, *argv, devices: int = 0):
    r = subprocess.run([sys.executable, "-c", code, *map(str, argv)],
                       capture_output=True, text=True, timeout=SUB_TIMEOUT,
                       env=_env(devices), cwd=REPO)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-4000:]}"
    return r


def _spec_tuple(spec, shape, dim_axes):
    """The port's placements as the reference's PartitionSpec entries."""
    out = []
    for d, ax in enumerate(dim_axes):
        sharded = ax is not None and spec[STAGE_AXES.index(ax)] == Shard(d)
        out.append(ax if sharded else None)
    return out


# ---------------------------------------------------------------------------
# placements against the reference's PartitionSpec and device indices
# ---------------------------------------------------------------------------

_REF_SPECS = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    from jax.sharding import Mesh, NamedSharding
    from repro.realize.program import CUBE_DIM_AXES, STAGE_AXES, cube_spec_for
    cases = json.loads(sys.argv[1])
    devs = np.asarray(jax.devices(), dtype=object)
    out = []
    for shape, axes, part in cases:
        axes = tuple(axes) if axes else CUBE_DIM_AXES
        n = int(np.prod(part))
        mesh = Mesh(devs[:n].reshape(part), STAGE_AXES)
        spec = cube_spec_for(tuple(shape), mesh, axes)
        idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
        slices = [[[s.start or 0, shape[d] if s.stop is None else s.stop]
                   for d, s in enumerate(idx[dev])]
                  for dev in mesh.devices.flat]
        out.append([list(spec), slices])
    print(json.dumps(out))
""")


def test_cube_spec_for_and_cube_layout_match_the_reference():
    cases = [(list(shape), list(axes) if axes else None, list(part))
             for shape, axes in SHAPES for part in PARTS]
    r = _run(_REF_SPECS, json.dumps(cases), devices=4)
    ref = json.loads(r.stdout.splitlines()[-1])
    assert len(ref) == len(cases)
    n_split = 0
    for (shape, axes, part), (rspec, rslices) in zip(cases, ref):
        shape, part = tuple(shape), tuple(part)
        axes = tuple(axes) if axes else ("b", "h", "w", "k")
        spec = cube_spec_for(shape, part, axes)
        assert _spec_tuple(spec, shape, axes) == rspec, (shape, part)
        got = [[[s.start, s.stop] for s in local_slices(shape, part, pos,
                                                        axes)]
               for pos in range(int(np.prod(part)))]
        assert got == rslices, (shape, part)
        if axes == ("b", "h", "w", "k"):
            layout = cube_layout(shape, part, list(range(len(got))))
            assert [list(map(list, sl)) for _, sl in layout] == rslices
        n_split += any(x is not None for x in rspec)
    assert n_split > 20          # the grid exercises real splits


# ---------------------------------------------------------------------------
# four gloo ranks against the reference on four host devices
# ---------------------------------------------------------------------------

_REF_RUN = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    import numpy as np
    import jax
    from repro.core.bridge import MeshPlan, StagePlan
    from repro.core.workload import Graph, Layer
    from repro.core.workloads import make_workload
    from repro.realize.measure import measure_candidate
    from repro.realize.plan import load_realize_candidates, plans_for
    from repro.realize.program import build_program
    from repro_torch.core.bridge import plan_from_tuples
    ck, out = Path(sys.argv[1]), Path(sys.argv[2])
    SMALL_SPEC, HAND_PLANS = json.loads(sys.argv[3])
    devs = jax.devices()[:4]
    res, arrays = {}, {}

    def run(label, g, plan, cand=None):
        prog = build_program(g, plan, devices=devs, use_pallas=False)
        rec = None
        if cand is not None:
            rec = measure_candidate(cand, prog, execute=True).to_record()
        run = prog.execute(seed=0)
        res[label] = {"dci": [float(x) for x in run["dci_bytes"]],
                      "n_devices": [sp.n_devices for sp in prog.stages],
                      "routes": [sp.routes for sp in prog.stages],
                      "record": rec}
        for name, x in run["outputs"].items():
            arrays[f"{label}/{name}"] = np.asarray(x)

    g = make_workload(SMALL_SPEC)
    for i, (cand, plan) in enumerate(plans_for(load_realize_candidates(
            ck, {"TF": g}, top=2, verbose=False), 4)):
        run(f"dse{i}", g, plan, cand)
    for name, hand in HAND_PLANS.items():
        run(name, *plan_from_tuples(
            *hand, classes=(Graph, Layer, MeshPlan, StagePlan)))
    np.savez(out / "ref.npz", **arrays)
    (out / "ref.json").write_text(json.dumps(res))
""")

_PORT_RUN = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    import numpy as np
    import torch
    import torch.distributed as dist

    def rank_main(ck, out, consts):
        torch.set_num_threads(1)
        SMALL_SPEC, HAND_PLANS = json.loads(consts)
        from repro_torch.core.bridge import plan_from_tuples
        from repro_torch.core.workloads import make_workload
        from repro_torch.realize.measure import measure_candidate
        from repro_torch.realize.plan import load_realize_candidates, plans_for
        from repro_torch.realize.program import build_program
        res, arrays = {}, {}

        def run(label, g, plan, cand=None):
            prog = build_program(g, plan, device="cpu", mesh=range(4))
            rec = None
            if cand is not None:
                rec = measure_candidate(cand, prog, execute=True).to_record()
            run = prog.execute(seed=0)
            logical = build_program(g, plan, device="cpu").execute(seed=0)
            res[label] = {
                "dci": run["dci_bytes"], "ici": run["ici_bytes"],
                "coll_by_kind": run["coll_by_kind"],
                "logical_dci": logical["dci_bytes"],
                "n_devices": [sp.n_devices for sp in prog.stages],
                "routes": [sp.routes for sp in prog.stages],
                "rank_launches": [sp.rank_launches for sp in prog.stages],
                "record": rec}
            for name, x in run["outputs"].items():     # rank 0's
                arrays[f"{label}/{name}"] = x.numpy()
                arrays[f"{label}/logical/{name}"] = \\
                    logical["outputs"][name].numpy()

        g = make_workload(SMALL_SPEC)
        for i, (cand, plan) in enumerate(plans_for(load_realize_candidates(
                Path(ck), {"TF": g}, top=2, verbose=False), 4)):
            run(f"dse{i}", g, plan, cand)
        for name, hand in HAND_PLANS.items():
            run(name, *plan_from_tuples(*hand))
        if dist.get_rank() == 0:
            np.savez(Path(out) / "port.npz", **arrays)
            (Path(out) / "port.json").write_text(json.dumps(res))

    if __name__ == "__main__":
        from repro_torch.launch.mesh import start_local_ranks
        start_local_ranks(4, rank_main, tuple(sys.argv[1:4]),
                          device_type="cpu")
""")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The reference on four host devices and the port on four gloo ranks,
    on the same checkpoint and hand-built plans."""
    tmp = tmp_path_factory.mktemp("mesh4")
    ck = _keep_ckpt(tmp)
    consts = json.dumps([SMALL_SPEC, HAND_PLANS])
    _run(_REF_RUN, ck, tmp, consts, devices=4)
    script = tmp / "ranks.py"
    script.write_text(_PORT_RUN)
    r = subprocess.run([sys.executable, str(script), str(ck), str(tmp),
                        consts], capture_output=True, text=True,
                       timeout=SUB_TIMEOUT, env=_env(), cwd=REPO)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-4000:]}"
    return (json.loads((tmp / "ref.json").read_text()),
            dict(np.load(tmp / "ref.npz")),
            json.loads((tmp / "port.json").read_text()),
            dict(np.load(tmp / "port.npz")))


LABELS = ("dse0", "dse1", "ssd", "flash", "ici")


@pytest.mark.parametrize("label", LABELS)
def test_four_ranks_match_the_reference_on_four_devices(four_ranks, label):
    ref, ref_arrays, port, port_arrays = four_ranks
    r, p = ref[label], port[label]
    assert p["n_devices"] == r["n_devices"]
    assert p["routes"] == r["routes"]
    assert p["dci"] == r["dci"] == p["logical_dci"]
    cubes = [k.split("/", 1)[1] for k in ref_arrays if k.startswith(label)]
    assert cubes
    for name in cubes:
        want = ref_arrays[f"{label}/{name}"]
        got = port_arrays[f"{label}/{name}"]
        assert got.shape == want.shape, name
        err = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        assert err < 2e-4, (name, err)
        # and the port's logical route on the same seed
        lg = port_arrays[f"{label}/logical/{name}"]
        assert np.abs(got - lg).max() <= 2e-4 * (np.abs(lg).max() + 1e-9)
    if r["record"] is not None:
        for rs, ps in zip(r["record"]["stages"], p["record"]["stages"]):
            assert ps["n_devices"] == rs["n_devices"]
            assert ps["dci_bytes"] == rs["dci_bytes"]
            for k in ("pred_flops", "pred_dram_bytes", "pred_noc_bytes",
                      "pred_d2d_bytes", "pred_delay_s", "pred_energy_j"):
                assert ps[k] == pytest.approx(rs[k], rel=1e-9), k


def test_four_ranks_split_what_the_plans_split(four_ranks):
    """The hand-built plans take the routes' splits: the ssd stage's four
    ranks each run the chunk kernel on one head of one batch row and
    all-gather the operand; the flash stage's each run its 16 query rows
    of one head at its query offset; the DSE plans bill ICI somewhere."""
    port = four_ranks[2]
    ssd = port["ssd"]["rank_launches"][1]
    assert [r[0][1]["H"] for r in ssd] == [1, 1, 1, 1]
    assert [r[0][1]["BC"] for r in ssd] == [1, 1, 1, 1]
    assert port["ssd"]["ici"][1] > 0
    flash = [ln for r in port["flash"]["rank_launches"][2] for ln in r
             if ln[0] == "flash_attention_mha"]
    assert [(s["H"], s["Sq"], s["Sk"], s.get("q_offset", 0))
            for _, s in flash] == [(1, 16, 32, 0)] * 2 + [(1, 16, 32, 16)] * 2
    assert any(port["dse0"]["ici"]) and any(port["dse1"]["ici"])
    assert all(set(k) <= {"all-gather"}
               for lb in LABELS for k in port[lb]["coll_by_kind"])


def test_hand_built_plan_bills_exactly_its_all_gathers(four_ranks):
    """Stage 0 (Part (1, 1, 1, 2), ranks 0 and 1) reads its (2, 16, 1, 32)
    source split on k and needs all 32 columns: each of its two ranks
    gathers the whole source, 2 x 2*16*32*4 bytes.  Stage 1 (Part (1, 1,
    2, 1), the same two ranks) receives ``a`` split on b (a move, DCI) and
    needs it whole to fit its activation-side operand: each rank gathers
    the (2, 16, 1, 64) cube, 2 x 2*16*64*4 bytes."""
    port = four_ranks[2]["ici"]
    src, a = 2 * 16 * 1 * 32 * 4, 2 * 16 * 1 * 64 * 4
    assert port["ici"] == [2 * src, 2 * a]
    assert port["coll_by_kind"] == [{"all-gather": 2 * src},
                                    {"all-gather": 2 * a}]
    assert port["dci"] == [0.0, float(a)]


# ---------------------------------------------------------------------------
# one rank: the logical route, bit for bit
# ---------------------------------------------------------------------------

def _on_core_zero(plan):
    """``plan`` with every stage on core 0."""
    return MeshPlan(stages=[
        StagePlan(layers=st.layers, devices=(0,),
                  parts={n: (1, 1, 1, 1) for n in st.layers},
                  cgs={n: (0,) for n in st.layers}) for st in plan.stages],
        batch_unit=plan.batch_unit)


@pytest.fixture
def one_rank():
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world
    assert not dist.is_initialized()
    init_world("cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["ssd", "flash", "ici"])
def test_one_rank_equals_the_logical_route(one_rank, name):
    g, plan = _hand_plan(name)
    plan = _on_core_zero(plan)
    mesh = build_program(g, plan, device="cpu", mesh=[0]).execute(seed=0)
    logical = build_program(g, plan, device="cpu").execute(seed=0)
    assert mesh["outputs"].keys() == logical["outputs"].keys()
    for n, x in logical["outputs"].items():
        assert torch.equal(mesh["outputs"][n], x), n
    assert mesh["dci_bytes"] == logical["dci_bytes"]
    assert mesh["ici_bytes"] == [0.0] * len(plan.stages)
    assert all(w >= 0 for w in mesh["wall_s"])


def test_one_rank_launches_equal_the_logical_plan(one_rank):
    """On one rank each stage's launches are the stage's whole launches."""
    for name in ("ssd", "flash", "ici"):
        g, plan = _hand_plan(name)
        prog = build_program(g, _on_core_zero(plan), device="cpu", mesh=[0])
        for sp in prog.stages:
            assert sp.launches_at(0) == sp.kernel_launches


# ---------------------------------------------------------------------------
# the CLI, calibration and the refusals
# ---------------------------------------------------------------------------

def _cli(ck, out, *extra):
    return [sys.executable, "-m", "repro_torch.launch.realize", "--ckpt",
            str(ck), "--workload", f"TF={SMALL_SPEC}", "--top", "2",
            "--device", "cpu", "--out", str(out), *extra]


def test_mesh_cli_end_to_end_cpu(tmp_path):
    """``--mesh 4 --host-ranks 4 --device cpu --calibrate``: two records
    under a ``:pool=4`` fingerprint, collective bytes measured, an overlay
    whose ``f_noc`` is fitted from them; the re-run resumes both."""
    ck = _keep_ckpt(tmp_path)
    out = tmp_path / "mesh.jsonl"
    overlay = tmp_path / "mesh.overlay.json"
    cmd = _cli(ck, out, "--mesh", "4", "--host-ranks", "4", "--calibrate")
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=SUB_TIMEOUT, env=_env())
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    assert "device pool: 4 ranks x cpu (gloo)" in r.stdout
    assert r.stdout.count("ICI/NoC m/p MB") == 2
    lines = out.read_text().splitlines()
    fp = json.loads(lines[0])["_config"]
    assert fp.startswith("realize-torch:v2:TF:")
    assert fp.endswith(":device=cpu:pool=4:exec=1")
    recs = [json.loads(line) for line in lines[1:]]
    assert len(recs) == 2
    assert any(st["ici_bytes"] > 0 for rec in recs for st in rec["stages"])
    for rec in recs:
        assert "noc_bytes" in rec["ratio_summary"]
        for st in rec["stages"]:
            assert st["ici_bytes"] == sum(st["coll_by_kind"].values())
            assert st["wall_s"] > 0
    first = json.loads(overlay.read_text())
    assert first["source"].endswith("|device=cpu|pool=4")
    assert 0.1 <= first["f_noc"] <= 10 and first["f_noc"] != 1.0
    overlay.unlink()
    r2 = subprocess.run(cmd, capture_output=True, text=True,
                        timeout=SUB_TIMEOUT, env=_env())
    assert r2.returncode == 0, f"stderr:\n{r2.stderr[-3000:]}"
    assert r2.stdout.count("resumed from") == 2
    assert len(out.read_text().splitlines()) == 3
    assert json.loads(overlay.read_text()) == first


def test_logical_report_fingerprint_is_unchanged(tmp_path):
    from repro_torch.launch.realize import main
    from repro_torch.realize.plan import checkpoint_workload_fingerprints
    ck = _keep_ckpt(tmp_path)
    out = tmp_path / "logical.jsonl"
    main(["--ckpt", str(ck), "--workload", f"TF={SMALL_SPEC}", "--top", "1",
          "--device", "cpu", "--no-exec", "--out", str(out)])
    fp = checkpoint_workload_fingerprints(ck)["TF"]
    header = json.loads(out.read_text().splitlines()[0])["_config"]
    assert header == f"realize-torch:v2:TF:{fp}:device=cpu:exec=0"
    rec = json.loads(out.read_text().splitlines()[1])
    assert all(st["ici_bytes"] == 0 for st in rec["stages"])


def test_fit_overlay_fits_f_noc_from_collective_bytes():
    """``fit_overlay`` fits ``f_noc`` from stages with ICI bytes (the
    log-space geomean of their ratios, clamped to [0.1, 10])."""
    def rec(ratios):
        return {"stages": [{"ratios": {"noc_bytes": r}} for r in ratios]}
    ov = fit_overlay([rec([2.0, 8.0]), rec([0.5])])
    assert ov.f_noc == pytest.approx((2.0 * 8.0 * 0.5) ** (1 / 3))
    assert fit_overlay([rec([50.0])]).f_noc == 10.0
    assert fit_overlay([rec([1e-3])]).f_noc == 0.1


def test_a_pool_too_small_is_refused(tmp_path):
    from repro_torch.launch.mesh import pool_size
    from repro_torch.launch.realize import main
    ck = _keep_ckpt(tmp_path)
    with pytest.raises(RuntimeError, match="--mesh 8 asks for 8 ranks, the "
                       "world has 4; pass --host-ranks 8.*torchrun"):
        main(["--ckpt", str(ck), "--workload", f"TF={SMALL_SPEC}",
              "--device", "cpu", "--mesh", "8", "--host-ranks", "4",
              "--out", str(tmp_path / "r.jsonl")])
    with pytest.raises(RuntimeError, match="asks for 256 ranks"):
        pool_size("production", 16)
    with pytest.raises(RuntimeError, match="asks for 512 ranks"):
        pool_size("production2", 256)
    assert pool_size("host", 3) == 3 and pool_size("2", 3) == 2
    g, plan = _hand_plan("flash")
    with pytest.raises(ValueError, match="plan needs 4 devices, mesh/pool "
                       "has 2; start >= 4 local ranks \\(--host-ranks\\)"):
        validate_plan(plan, 2)
    with pytest.raises(SystemExit, match="--host-ranks needs --mesh"):
        main(["--ckpt", str(ck), "--workload", f"TF={SMALL_SPEC}",
              "--device", "cpu", "--host-ranks", "4",
              "--out", str(tmp_path / "r.jsonl")])


def test_mesh_mode_refuses_a_plan_beyond_the_pool(one_rank):
    g, plan = _hand_plan("ici")
    with pytest.raises(ValueError, match="plan needs 2 devices, mesh/pool "
                       "has 1"):
        build_program(g, plan, device="cpu", mesh=[0])
