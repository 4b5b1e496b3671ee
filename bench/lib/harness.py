"""The harness: finds a cell's configuration, traffic mix, limits, driver
and metric readers by the names in ``BENCHMARK.json``, runs the cell once,
and prints the result line.

Layout (each found by name, so a new one is a new file):
``bench/configs/<config>.json`` (the file ``BENCHMARK.json`` names),
``bench/traffic/<traffic>.json`` (its ``kind`` names the driver,
``bench/drivers/<kind>.py``), ``bench/limits/<workload>.json``,
``bench/metrics/<metric>.py``.

A driver module has ``setup(model, mix, seed, device)``, ``window(state,
seconds, trace_path)``, ``release(state)`` and ``check(record, model,
mix, seed, device, limits)``; a metric module has ``read(record, model,
mix)``, returning a number or None when it finds nothing to read.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def find(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json; have "
                   f"{[e['name'] for e in entries]}")


def cell_spec(bench: Dict, workload: str, root: Path = ROOT) -> Dict:
    """The cell's entry, its configuration's ``model`` fields, its mix and
    its limits, and the metrics it reports, from the checkout ``root``."""
    cell = find(bench["workloads"], workload, "workload")
    conf = find(bench["configs"], cell["config"], "config")
    model = load_json(root / conf["file"])["model"]
    mix = load_json(root / "bench" / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(root / "bench" / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [])
             or ("workloads" not in m and m["moves"] in e2e_names)]
    return {"cell": cell, "model": model, "mix": mix, "limits": limits,
            "end_to_end": e2e, "per_layer": layer}


def metric_module(name: str, root: Path = ROOT):
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_module(kind: str):
    return importlib.import_module(f"bench.drivers.{kind}")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``repro_torch`` is not ``repro``)."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in modules if n.split(".")[0] in FORBIDDEN)


def cache_env(root: Path = ROOT) -> None:
    """Kernel and build caches at fixed paths inside the checkout (the
    program's own CUDA libraries already live in
    ``src/repro_torch/kernels/_build/``)."""
    cache = root / "results" / "cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def power_limit_w() -> Optional[float]:
    """The card's power limit, as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def verdict(numbers: List[Dict]) -> bool:
    """Every compared number within its limit (a missing number fails)."""
    return bool(numbers) and all(
        n["value"] is not None and n["value"] == n["value"]
        and n["value"] <= n["limit"] for n in numbers)


def read_metrics(entries: List[Dict], record, model: Dict, mix: Dict
                 ) -> Dict[str, Dict]:
    out = {}
    for m in entries:
        if m["name"] == "setup_s":
            continue
        value = metric_module(m["name"]).read(record, model, mix)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float) -> int:
    """One run of one cell; prints the result line; returns the exit
    code (non-zero with no result when there is no card to run on, or a
    forbidden module was loaded)."""
    spec = cell_spec(load_json(ROOT / "BENCHMARK.json"), workload)
    cache_env()
    import torch
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    drv = driver_module(spec["mix"]["kind"])
    state = drv.setup(spec["model"], spec["mix"], seed, device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    trace_path = None
    if trace:
        trace_path = ROOT / "results" / "portbench" / f"{workload}.trace.json"
        trace_path.parent.mkdir(parents=True, exist_ok=True)
    record = drv.window(state, seconds, trace_path)
    peak = torch.cuda.max_memory_allocated(device)
    drv.release(state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    numbers = drv.check(record, spec["model"], spec["mix"], seed, device,
                        spec["limits"])
    correct = verdict(numbers) and record.failed == 0
    if trace:
        metrics = read_metrics(spec["per_layer"], record, spec["model"],
                               spec["mix"])
    else:
        metrics = read_metrics(spec["end_to_end"], record, spec["model"],
                               spec["mix"])
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips, "memory_peak_bytes": int(peak),
           "power_limit_w": power_limit_w()}
    out = {"correct": correct, "attempted": record.attempted,
           "failed": record.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = record.trace.busy_s
        dev["window_s"] = record.trace.window_s
        out["breakdown"] = record.trace.breakdown()
    out["checks"] = {n["name"]: {"value": n["value"], "limit": n["limit"]}
                     for n in numbers}
    found = forbidden_modules()
    if found:
        print(f"bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(out))
    sys.stdout.flush()
    for n in numbers:
        print(f"check {n['name']} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr)
    return 0
