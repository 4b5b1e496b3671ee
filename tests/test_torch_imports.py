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
