"""Multi-pod dry-run: trace every (arch x shape x mesh) cell without
memory and report its roofline terms and memory.

Port of ``src/repro/launch/dryrun.py``.  Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out results/dryrun.json

Where the reference forces 512 virtual devices and lowers and compiles
each cell, :func:`run_cell` starts a fake process group (``"fake"``, from
``torch.testing``) of 256 ranks (``single``: 16 x 16) or 512 (``multi``:
2 x 16 x 16) when none is running, builds the cell's bundle on a
``"cpu"`` device mesh, and runs its step under ``FakeTensorMode`` inside
an :class:`repro_torch.launch.costs.OpCounter`: shapes only, no memory, no
card, as rank 0 of the mesh.  Importing this module starts nothing.

Results stream into the JSON after every cell so interrupted runs resume
(cells already present are skipped unless --force, which re-runs the
selected cells only).  ``lower_s`` is the seconds to build the bundle and
its placed arguments, ``compile_s`` those of the traced step.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from ..configs.base import SHAPES, all_archs, cells_for, get_config
from .mesh import make_production_mesh
from .roofline import analyze, flash_kernel_adjustment, model_flops_for
from .steps import input_specs, make_cell  # noqa: F401  (input_specs is API)


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks (this process is rank 0) for
    the duration, unless a group is already running (a mesh then takes
    the first ranks of it)."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             rules_overrides=None, cfg_overrides=None, **cell_kw) -> dict:
    """Trace one cell; returns the roofline/memory record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..nn.params import default_rules
    from .costs import OpCounter, local_bytes
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = SHAPES[shape_name]
    multi = mesh_kind == "multi"
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        n_dev = mesh.size()
        rules = default_rules(**(rules_overrides or {}))
        t0 = time.time()
        bundle = make_cell(cfg, shape, mesh, rules, **cell_kw)
        with FakeTensorMode():
            args = bundle.empty_args()
            t_lower = time.time() - t0
            counter = OpCounter()
            t1 = time.time()
            with counter:
                out = bundle.fn(*args)
            t_trace = time.time() - t1
            arg_b, out_b = local_bytes(args), local_bytes(out)
            temp_b = counter.temp_bytes(out)
    rl = analyze(f"{arch}/{shape_name}/{mesh_kind}", counter.costs,
                 arg_b, out_b, temp_b, model_flops_for(cfg, shape), n_dev,
                 compile_s=t_trace)
    rec = rl.to_dict()
    adj = flash_kernel_adjustment(cfg, shape, n_pod=2 if multi else 1)
    rec["flash_adj_bytes"] = adj
    rec["t_memory_kernel"] = max(0.0, (rl.bytes_per_device - adj)) \
        / rl.chip.hbm_bw
    rec.update({"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "lower_s": t_lower, "desc": bundle.static_desc,
                "ok": True})
    # the proof-it-fits printout
    print(f"  memory_analysis: args={arg_b/1e9:.2f}GB "
          f"out={out_b/1e9:.2f}GB "
          f"temp={temp_b/1e9:.2f}GB per device")
    print(f"  cost_analysis: flops/dev={rl.flops_per_device:.3e} "
          f"bytes/dev={rl.bytes_per_device:.3e}")
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--micro", type=int, default=0,
                    help="override microbatch count (0 = auto)")
    args = ap.parse_args()
    # DTensor's notes on its collective choices, once per cell
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)

    archs = list(all_archs()) if args.arch == "all" else args.arch.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    # --force re-runs the SELECTED cells only; cached results for other
    # cells are always preserved (a --force on a subset must not wipe the
    # rest of the table)
    results = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())

    n_fail = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = list(cells_for(cfg)) if args.shape == "all" \
            else [s for s in args.shape.split(",") if s in cells_for(cfg)]
        for shape_name in shapes:
            for mesh_kind in meshes:
                key = f"{arch}|{shape_name}|{mesh_kind}"
                if key in results and results[key].get("ok") and not args.force:
                    print(f"[skip] {key} (cached)")
                    continue
                print(f"[cell] {key} ...", flush=True)
                t0 = time.time()
                kw = {}
                if args.micro and SHAPES[shape_name].kind == "train":
                    kw["n_micro"] = args.micro
                if args.zero1 and SHAPES[shape_name].kind == "train":
                    kw["zero1"] = True
                try:
                    rec = run_cell(arch, shape_name, mesh_kind, **kw)
                    print(f"[ok]   {key}  compute={rec['t_compute']*1e3:.2f}ms "
                          f"memory={rec['t_memory']*1e3:.2f}ms "
                          f"coll={rec['t_collective']*1e3:.2f}ms "
                          f"bneck={rec['bottleneck']} "
                          f"({time.time()-t0:.0f}s)", flush=True)
                except Exception as e:  # noqa: BLE001 - report, keep going
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "ok": False,
                           "error": f"{type(e).__name__}: {e}"}
                    n_fail += 1
                    print(f"[FAIL] {key}: {rec['error'][:200]}", flush=True)
                results[key] = rec
                out_path.write_text(json.dumps(results, indent=1))
    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed, "
          f"results -> {out_path}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
