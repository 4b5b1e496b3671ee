"""Per-run manifests: config fingerprint + seed + grid + provenance.

The provenance block mirrors ``bench_dse/v2`` (``benchmarks/run.py``) —
cpu count, platform, python, short git commit, UTC date — so a sweep
trace and a bench trajectory row measured in the same container are
directly comparable.  :func:`git_head` is the shared commit-stamp helper:
``git rev-parse --short HEAD`` with a ``REPRO_GIT_COMMIT`` env override
for containers that ship the tree without ``.git`` (the bench
trajectory's ``"commit": "unknown"`` failure mode).

Copy of ``src/repro/obs/manifest.py``.  Where the reference records its
``jax`` version, the port records ``torch`` and ``torch.version.cuda``
(``None`` where torch is absent) and the card's ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` line (``gpu``,
``None`` where the command is absent or fails); neither initialises
CUDA.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Union

from . import trace as _trace

GIT_COMMIT_ENV = "REPRO_GIT_COMMIT"


def git_head(repo: Union[str, Path, None] = None) -> str:
    """Short HEAD commit of ``repo`` (default: this package's tree).

    Resolution order: the ``REPRO_GIT_COMMIT`` env override (gitless
    containers stamp their build commit through it), then ``git
    rev-parse --short HEAD``, then ``"unknown"``.
    """
    override = os.environ.get(GIT_COMMIT_ENV)
    if override:
        return override
    import subprocess
    if repo is None:
        repo = Path(__file__).resolve().parents[3]
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=repo,
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def gpu_name_power() -> Optional[str]:
    """The first card's ``name, power.limit`` as ``nvidia-smi`` prints
    them, or None where the command is absent, fails or hangs (10 s)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def provenance(repo: Union[str, Path, None] = None) -> Dict[str, Any]:
    """The bench_dse/v2-shaped provenance block + commit/date stamps."""
    import os as _os
    import platform as _platform
    import sys as _sys
    from datetime import datetime, timezone
    try:
        import torch
        torch_ver = getattr(torch, "__version__", None)
        cuda_ver = getattr(torch.version, "cuda", None)
    except Exception:
        torch_ver = cuda_ver = None
    return {
        "cpu_count": _os.cpu_count(),
        "platform": _platform.platform(),
        "python": _sys.version.split()[0],
        "torch": torch_ver,
        "cuda": cuda_ver,
        "gpu": gpu_name_power(),
        "commit": git_head(repo),
        "date": datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ"),
    }


def write_manifest(fields: Dict[str, Any],
                   directory: Union[str, Path, None] = None,
                   ) -> Optional[Path]:
    """Write ``manifest.json`` into the run dir (no-op while disabled
    unless an explicit ``directory`` is given).  ``fields`` comes from the
    caller (fingerprint, seed, grid size, shard, worker count, ...);
    provenance is stamped here.  Last write wins — a process running
    several sweeps into one run dir keeps the most recent manifest, and
    each sweep's start is also visible as a ``log`` event in the trace.
    """
    if directory is None:
        d = _trace.run_dir()
        if d is None:
            return None
    else:
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
    doc = {"schema": "obs_manifest/v1", "provenance": provenance(), **fields}
    path = d / "manifest.json"
    path.write_text(json.dumps(doc, indent=1, sort_keys=True,
                               default=str) + "\n")
    return path
