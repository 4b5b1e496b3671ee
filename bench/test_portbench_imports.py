"""The import check, by whole top-level names: the chip path of
``bench/run.py`` loads neither JAX nor the JAX package ``repro``, and the
reference imports nothing of JAX, ``repro`` or the program."""

import ast
import subprocess
import sys
from pathlib import Path

from bench.lib import harness

ROOT = Path(__file__).resolve().parents[1]


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_forbidden_names_are_compared_whole():
    mods = {"repro_torch": 1, "repro_torch.nn": 1, "reprox": 1,
            "jaxtyping": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"repro": 1, "repro.core.hw": 1, "jax.numpy": 1,
                 "flax": 1, "jaxlib": 1})
    assert harness.forbidden_modules(mods) == [
        "flax", "jax.numpy", "jaxlib", "repro", "repro.core.hw"]


def test_reference_imports_nothing_of_the_program_or_jax():
    files = sorted((ROOT / "bench" / "reference").glob("*.py"))
    assert files
    for f in files:
        names = set(top_level_imports(f))
        assert not names & {"jax", "jaxlib", "flax", "repro",
                            "repro_torch"}, f
        assert names <= {"__future__", "contextlib", "math", "typing",
                         "torch", "bench"}, (f, names)


def test_chip_path_loads_no_forbidden_module():
    """Everything a run imports on the chip path, imported in a clean
    interpreter without the test's hooks, leaves no JAX and no
    ``repro`` in ``sys.modules``."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from bench.lib import harness, trace\n"
        "from bench.drivers import serve_closed, train_packed\n"
        "from bench import control\n"
        "import bench.reference.lowp\n"
        "from repro_torch.runtime.serve_loop import ModelWaveExecutor\n"
        "from repro_torch.launch.steps import make_train_step\n"
        "from repro_torch.kernels import _build, ops\n"
        "b = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    if m['name'] != 'setup_s':\n"
        "        harness.metric_module(m['name'])\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=240,
                         env={"PATH": "/usr/bin:/bin",
                              "REPRO_NO_JAX_COMPAT": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
