"""The port's dry-run tooling (``repro_torch.launch.{costs,roofline,
dryrun,hillclimb,report}``).

The traced counts run in one subprocess on a fake process group
(``torch.testing``'s ``"fake"`` backend), as the dry-run itself runs: a
256-way-sharded matmul reports 1/256 of its global FLOPs, a reduced
``qwen3-0.6b`` train cell on a (4, 2) mesh has FLOPs, collectives and a
bottleneck (the reference's ``tests/test_sharding_dryrun.py`` holds its
own bundle to the same), and the full-width ``smollm-135m`` train cell at
two layers reports as ``argument_bytes`` exactly the local shard bytes of
its parameters, moments, step and batch, computed here from the specs and
the shapes.

The command-line drivers run with ``run_cell`` stubbed by the same
function in both packages, each in a subprocess (the reference's scripts
force 512 host devices when imported): the dry-run's cache skip and
``--force``, the hill-climb's artifact, ``--shard`` and the legacy
``.json`` migration give the same files and lines, and ``report``'s three
tables are byte-equal on them.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.launch import report as jreport
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import report, steps
from repro_torch.nn import params

REPO = Path(__file__).resolve().parent.parent
SUB_TIMEOUT = 240


def _run(code: str, cwd: Path, timeout: int = SUB_TIMEOUT):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO / "src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=cwd)
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout


COUNTS_CODE = textwrap.dedent("""
    import json, logging
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.costs import OpCounter, local_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import analyze, model_flops_for
    from repro_torch.launch.steps import make_cell
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    out = {}
    with dryrun.fake_world(256):
        mesh = make_host_mesh((16, 16), device_type="cpu")
        with FakeTensorMode():
            a = distribute_tensor(torch.empty(1024, 4096), mesh,
                                  [Shard(0), Replicate()])
            b = distribute_tensor(torch.empty(4096, 8192), mesh,
                                  [Replicate(), Shard(1)])
            c = OpCounter()
            with c:
                a @ b
        out["mm_flops"] = c.costs.flops
        out["mm_coll"] = c.costs.coll_bytes
    with dryrun.fake_world(8):
        mesh = make_host_mesh((4, 2), device_type="cpu")
        cfg = get_config("qwen3-0.6b").reduced()
        shape = ShapeConfig("t", 64, 8, "train")
        bundle = make_cell(cfg, shape, mesh)
        with FakeTensorMode():
            args = bundle.empty_args()
            c = OpCounter()
            with c:
                res = bundle.fn(*args)
            rl = analyze("t", c.costs, local_bytes(args), local_bytes(res),
                         c.temp_bytes(res), model_flops_for(cfg, shape), 8)
        out["qwen"] = rl.to_dict()
    out["smollm"] = dryrun.run_cell("smollm-135m", "train_4k", "single",
                                    cfg_overrides={"n_layers": 2})
    out["initialized_after"] = dist.is_initialized()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    stdout = _run(COUNTS_CODE, tmp_path_factory.mktemp("counts"))
    lines = stdout.splitlines()
    assert any(l.startswith("  memory_analysis: args=") for l in lines)
    assert any(l.startswith("  cost_analysis: flops/dev=") for l in lines)
    return json.loads(lines[-1])


def test_a_256_way_sharded_matmul_counts_a_256th_of_its_flops(counts):
    assert counts["mm_flops"] == 2 * 1024 * 4096 * 8192 / 256
    assert counts["mm_coll"] == 0


def test_reduced_train_cell_on_a_small_fake_mesh(counts):
    rec = counts["qwen"]
    assert rec["flops_per_device"] > 0
    assert rec["coll_bytes_per_device"] > 0      # FSDP/TP collectives exist
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["coll_bytes_per_device"] == sum(rec["coll_by_kind"].values())
    assert set(rec["coll_by_kind"]) == {"all-gather", "all-reduce",
                                        "reduce-scatter", "all-to-all",
                                        "collective-permute"}


def _local_bytes(shape, spec, itemsize, sizes):
    """Rank 0's shard bytes: each dim split by its spec's mesh axes, rank
    0 holding the first (largest) chunk."""
    n = itemsize
    for d, e in zip(shape, spec):
        names = () if e is None else (e,) if isinstance(e, str) else e
        n *= -(-d // math.prod(sizes[a] for a in names))
    return n


def test_argument_bytes_are_the_local_shards_of_state_and_batch(counts):
    rec = counts["smollm"]
    assert rec["ok"] and rec["desc"] == "train micro=1 zero1=False"
    assert not counts["initialized_after"]       # run_cell's group is gone
    cfg = get_config("smollm-135m").replace(n_layers=2)
    shape = SHAPES["train_4k"]
    sizes = {"data": 16, "model": 16}
    mesh = type("M", (), {"shape": sizes, "axis_names": ("data", "model")})
    rules = steps.derive_attn_rules(cfg, mesh, steps.fit_batch_rules(
        params.default_rules(), shape.global_batch, mesh), "train")
    structs = steps.param_structs(cfg)
    spec = params.tree_spec(steps.get_param_axes(cfg), rules, mesh)
    p = sum(_local_bytes(structs[k].shape, spec[k], 4, sizes) for k in spec)
    batch = 2 * _local_bytes((shape.global_batch, shape.seq_len),
                             rules.spec(("batch", "seq"), mesh), 4, sizes)
    assert rec["argument_bytes"] == 3 * p + 4 + batch   # params, m, v, step
    assert rec["flops_per_device"] > 0 and rec["temp_bytes"] > 0
    assert rec["n_devices"] == 256


# ---------------------------------------------------------------------------
# The command-line drivers, run_cell stubbed
# ---------------------------------------------------------------------------

STUB = textwrap.dedent("""
    def stub(arch, shape_name, mesh_kind, rules_overrides=None,
             cfg_overrides=None, **cell_kw):
        print(f"  stub {arch} {shape_name} {mesh_kind} "
              f"{sorted((rules_overrides or {}).items())} "
              f"{sorted((cfg_overrides or {}).items())} "
              f"{sorted(cell_kw.items())}")
        if (arch, shape_name, mesh_kind) == ("mamba2-370m", "long_500k",
                                             "multi"):
            raise RuntimeError("stubbed failure")
        h = sum(map(ord, arch + shape_name + mesh_kind)) + len(str(cell_kw))
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "ok": True, "t_compute": h * 1e-6, "t_memory": h * 2e-6,
                "t_collective": h * 3e-6, "bottleneck": "collective",
                "roofline_fraction": 0.125, "useful_flops_ratio": 0.5,
                "t_memory_kernel": h * 1e-6, "argument_bytes": h * 1e6,
                "temp_bytes": h * 2e6, "coll_bytes_per_device": h * 3e6,
                "compile_s": 1.0, "desc": str(sorted(cell_kw.items()))}
""")

DRIVER = textwrap.dedent("""
    import sys
    import {pkg}.launch.dryrun as dryrun
    import {pkg}.launch.hillclimb as hillclimb
    {stub}
    dryrun.run_cell = stub
    hillclimb.run_cell = stub
    for mod, argv in {runs!r}:
        sys.argv = [mod] + argv
        try:
            (dryrun if mod == "dryrun" else hillclimb).main()
        except SystemExit as e:
            print("EXIT", e.code)
""")

RUNS = [
    ("dryrun", ["--arch", "smollm-135m,mamba2-370m", "--shape", "all",
                "--mesh", "both", "--out", "dr.json", "--zero1"]),
    ("dryrun", ["--arch", "smollm-135m,mamba2-370m", "--shape", "all",
                "--mesh", "both", "--out", "dr.json"]),
    ("dryrun", ["--arch", "smollm-135m", "--shape", "train_4k,decode_32k",
                "--mesh", "single", "--out", "dr.json", "--force",
                "--micro", "2"]),
    ("hillclimb", ["--cell", "smollm-135m/train_4k", "--variant",
                   "baseline,no_fsdp,fsdp_zero1,micro2", "--out",
                   "hc.json"]),
    ("hillclimb", ["--cell", "smollm-135m/train_4k", "--variant",
                   "baseline,no_fsdp,fsdp_zero1,micro2", "--out",
                   "hc.jsonl"]),
    ("hillclimb", ["--cell", "qwen3-0.6b/decode_32k", "--variant",
                   "baseline,serve_tp_only,decode_batch_2d", "--out",
                   "hc.jsonl", "--shard", "1/2"]),
    ("hillclimb", ["--cell", "qwen3-0.6b/decode_32k", "--variant",
                   "baseline,serve_tp_only,decode_batch_2d", "--out",
                   "hc.jsonl", "--shard", "0/2", "--force"]),
]


def _clean(stdout: str) -> list:
    """Drop the lines that hold wall-clock seconds, tracebacks and the
    package's own name."""
    out = []
    for line in stdout.splitlines():
        if line.startswith(("Traceback", "  File", "    ")) or \
                line.startswith("RuntimeError"):
            continue
        out.append(re.sub(r"\(\d+s\)", "(Ns)", line))
    return out


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    out = {}
    for pkg in ("repro", "repro_torch"):
        d = tmp_path_factory.mktemp(pkg)
        # a legacy dict-format hill-climb file, carried over once
        (d / "hc.json").write_text(json.dumps({
            "smollm-135m/train_4k|single|old": {
                "ok": True, "variant": "old", "t_compute": 1.0,
                "t_memory": 2.0, "t_collective": 3.0,
                "roofline_fraction": 0.5}}))
        stdout = _run(DRIVER.format(pkg=pkg, stub=STUB, runs=RUNS), d)
        out[pkg] = (d, _clean(stdout))
    return out


def test_dryrun_and_hillclimb_drivers_equal_the_references(drivers):
    (jd, jout), (d, out) = drivers["repro"], drivers["repro_torch"]
    assert out == jout
    assert any(l.startswith("[skip]") for l in out)
    assert "EXIT 1" in out and any(l.startswith("[migrate]") for l in out)
    assert json.loads((d / "dr.json").read_text()) == \
        json.loads((jd / "dr.json").read_text())
    names = sorted(p.name for p in d.iterdir())
    assert names == sorted(p.name for p in jd.iterdir())
    assert "hc.shard1of2.jsonl" in names and "hc.jsonl" in names
    for name in names:
        if name.endswith(".jsonl"):
            assert (d / name).read_bytes() == (jd / name).read_bytes(), name


def test_report_tables_equal_the_references(drivers):
    d = drivers["repro_torch"][0]
    for mesh in ("single", "multi"):
        assert report.dryrun_table(str(d / "dr.json"), mesh) == \
            jreport.dryrun_table(str(d / "dr.json"), mesh)
    assert report.multi_pod_table(str(d / "dr.json")) == \
        jreport.multi_pod_table(str(d / "dr.json"))
    got = report.hillclimb_table(str(d / "hc.jsonl"))
    assert got == jreport.hillclimb_table(str(d / "hc.jsonl"))
    assert "serve_tp_only" in got and "| old |" in got
