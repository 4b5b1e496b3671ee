"""Import hygiene of the PyTorch port: ``src/repro_torch`` and
``chip_smoke.py`` import nothing of JAX and nothing of the JAX package."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _banned(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_no_jax_or_reference_import_in_source():
    found = []
    files = _port_files()
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.relative_to(REPO)}: {n}" for n in names
                      if _banned(n)]
    assert not found, found


def test_importing_every_port_module_loads_neither_jax_nor_repro():
    modules = [".".join(("repro_torch",) + p.relative_to(PORT).with_suffix(
        "").parts).removesuffix(".__init__")
        for p in sorted(PORT.rglob("*.py"))]
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(REPO / 'src')!r})\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(n for n in sys.modules if n.split('.')[0]"
        " in ('jax', 'jaxlib', 'repro'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.splitlines()[-1]) == []


def test_core_modules_load_no_torch():
    """``repro_torch.core`` is the numpy cost model and search: the DSE's
    spawned workers import it alone and must not pay for torch."""
    modules = [".".join(("repro_torch", "core") + p.relative_to(
        PORT / "core").with_suffix("").parts).removesuffix(".__init__")
        for p in sorted((PORT / "core").rglob("*.py"))]
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(REPO / 'src')!r})\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(n for n in sys.modules"
        " if n.split('.')[0] == 'torch')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert len(modules) > 10
    assert json.loads(r.stdout.splitlines()[-1]) == []


def test_the_walks_cover_the_family_and_fused_pass_modules():
    """The ``ast`` walk and the clean-interpreter import see the MoE, MLA
    and CNN workload modules and the fused pass."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    for rel in ("core/workloads/moe.py", "core/workloads/mla.py",
                "core/workloads/cnn.py", "kernels/fused_eval.py"):
        assert rel in files, rel
    assert (PORT / "kernels" / "csrc" / "fused_eval.cu").exists()


def test_the_walks_cover_the_model_and_serving_stack():
    """The ``ast`` walk and the clean-interpreter import see the model
    layers, the models, the serve loop and its harness copy, the serving
    entry points and the SSD state pass; ``configs`` stays torch-free for
    ``core``."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    for rel in ("nn/__init__.py", "nn/params.py", "nn/layers.py",
                "nn/rope.py", "nn/attention.py", "nn/mamba2.py",
                "nn/moe.py", "models/__init__.py", "models/lm.py",
                "models/frontends.py", "models/convert.py",
                "serve/__init__.py", "serve/harness.py",
                "runtime/__init__.py", "runtime/serve_loop.py",
                "launch/serve.py", "examples/serve_lm.py",
                "kernels/ssd_state.py"):
        assert rel in files, rel
    assert (PORT / "kernels" / "csrc" / "ssd_state.cu").exists()
    for path in (PORT / "configs").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) else [node.module or ""]
                assert not any(n.split(".")[0] == "torch" for n in names), \
                    path


def test_the_walks_cover_the_trace_replay_and_the_encoder_decoder():
    """The ``ast`` walk and the clean-interpreter import see the trace,
    harness and SLO modules and the encoder-decoder; ``repro_torch.serve``
    (which ``repro_torch.core`` imports for ``objective="slo"``) loads no
    torch."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    for rel in ("serve/trace.py", "serve/harness.py", "serve/slo.py",
                "models/encdec.py", "launch/cli.py"):
        assert rel in files, rel
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(REPO / 'src')!r})\n"
        "import repro_torch.serve, repro_torch.core.dse\n"
        "import repro_torch.core.explore\n"
        "from repro_torch.core.dse import DSEConfig, reduce_tasks, "
        "TaskResult\n"
        "from repro_torch.core.hw import simba_arch\n"
        "reduce_tasks(simba_arch(), DSEConfig(objective='slo', "
        "traffic='chat-quick'), {'A': TaskResult(1.0, 1e-3)})\n"
        "print(json.dumps(sorted(n for n in sys.modules"
        " if n.split('.')[0] == 'torch')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.splitlines()[-1]) == []


def test_the_walks_cover_the_training_modules_and_the_examples():
    """The ``ast`` walk and the clean-interpreter import see the optimizer,
    the checkpoints, the data pipeline, the train step and loop, the
    training entry points and the two top-level examples; the data
    pipeline, a numpy copy, loads no torch."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    for rel in ("optim/__init__.py", "optim/adamw.py",
                "checkpoint/__init__.py", "checkpoint/ckpt.py",
                "data/__init__.py", "data/pipeline.py", "launch/steps.py",
                "runtime/train_loop.py", "launch/train.py",
                "examples/train_lm.py", "examples/quickstart.py",
                "examples/dse_demo.py"):
        assert rel in files, rel
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(REPO / 'src')!r})\n"
        "import repro_torch.data.pipeline\n"
        "print(json.dumps(sorted(n for n in sys.modules"
        " if n.split('.')[0] == 'torch')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.splitlines()[-1]) == []


def test_the_walks_cover_the_sweep_tooling_and_obs_and_dist_load_no_torch():
    """The ``ast`` walk and the clean-interpreter import see the
    observability layer, the supervised-sweep modules and their two CLIs;
    ``repro_torch.obs`` and ``repro_torch.dist`` (which the numpy shard
    children import) load no torch, as ``repro_torch.core`` does not."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    for rel in ("obs/__init__.py", "obs/trace.py", "obs/metrics.py",
                "obs/manifest.py", "obs/report.py", "dist/__init__.py",
                "dist/retrying.py", "dist/faults.py", "dist/hosts.py",
                "dist/supervisor.py", "dist/shard_child.py",
                "launch/sweep_ctl.py", "launch/obs_report.py"):
        assert rel in files, rel
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(REPO / 'src')!r})\n"
        "import repro_torch.obs, repro_torch.obs.report\n"
        "import repro_torch.dist, repro_torch.dist.shard_child\n"
        "import repro_torch.launch.sweep_ctl, repro_torch.launch.obs_report\n"
        "from repro_torch.dist.supervisor import quick_spec\n"
        "quick_spec().fingerprint()\n"
        "print(json.dumps(sorted(n for n in sys.modules"
        " if n.split('.')[0] == 'torch')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.splitlines()[-1]) == []


def test_the_walks_cover_plan_execution_and_the_collective():
    """The ``ast`` walk and the clean-interpreter import see the pipelined
    executor, the mesh, the compressed DP sync and the example that drives
    them; importing them starts no process group, and the bridge with
    ``plan_for_graph`` loads no torch."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    for rel in ("runtime/pipeline.py", "launch/mesh.py",
                "optim/compressed_dp.py", "examples/map_to_mesh.py",
                "core/bridge.py"):
        assert rel in files, rel
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(REPO / 'src')!r})\n"
        "from repro_torch.core.bridge import mesh_as_arch, plan_for_graph\n"
        "no_torch = sorted(n for n in sys.modules"
        " if n.split('.')[0] == 'torch')\n"
        "import repro_torch.runtime.pipeline, repro_torch.launch.mesh\n"
        "import repro_torch.optim.compressed_dp\n"
        "import repro_torch.examples.map_to_mesh\n"
        "import torch.distributed as dist\n"
        "print(json.dumps([no_torch, dist.is_initialized()]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.splitlines()[-1]) == [[], False]
