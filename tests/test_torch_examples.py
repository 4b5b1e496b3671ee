"""The port's two top-level examples (``repro_torch.examples.quickstart``,
``repro_torch.examples.dse_demo``) beside the reference's
(``examples/*.py``), each in its own temporary working directory: the
numpy engine is bit-equal, so the printed text is the same.

The port prints the engine's diagnostics (``[screen]``, ``[explore]``,
the ``[dse i/n]`` progress lines) to stderr where the reference prints
them to stdout, and the DSE's workers finish in any order, so progress
lines and checkpoint records compare as sorted lists."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DIAG = re.compile(r"^\[(screen|explore|dse \d+/\d+)\]")


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout, r.stderr


def _split(lines):
    """(the lines, the progress lines without their i/n) of a stream."""
    keep = [ln for ln in lines if not DIAG.match(ln)]
    diag = sorted(re.sub(r"^\[dse \d+/(\d+)\]", r"[dse n/\1]", ln)
                  for ln in lines if DIAG.match(ln))
    return keep, diag


def test_quickstart_prints_the_references_text(tmp_path):
    (tmp_path / "ref").mkdir(), (tmp_path / "port").mkdir()
    want, _ = _run([str(REPO / "examples" / "quickstart.py")],
                   tmp_path / "ref")
    got, _ = _run(["-m", "repro_torch.examples.quickstart"],
                  tmp_path / "port")
    assert "G-Map (SA):" in got and "D2D hop-bytes" in got
    assert got == want


def test_dse_demo_prints_the_references_text_and_checkpoint(tmp_path):
    (tmp_path / "ref").mkdir(), (tmp_path / "port").mkdir()
    want, _ = _run([str(REPO / "examples" / "dse_demo.py")],
                   tmp_path / "ref")
    got, err = _run(["-m", "repro_torch.examples.dse_demo"],
                    tmp_path / "port")
    want_lines, want_diag = _split(want.splitlines())
    assert got.splitlines() == want_lines
    assert _split(err.splitlines())[1] == want_diag
    assert "[dse] best:" in got and len(want_diag) >= 3
    ckpt = Path("results") / "dse_demo.ckpt.jsonl"
    a = (tmp_path / "ref" / ckpt).read_text().splitlines()
    b = (tmp_path / "port" / ckpt).read_text().splitlines()
    assert a[0] == b[0] and sorted(a[1:]) == sorted(b[1:])
