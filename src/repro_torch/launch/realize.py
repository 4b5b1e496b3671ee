"""Realization driver: DSE checkpoint -> stage programs on the card ->
measured-vs-predicted report -> Tech overlay (port of
``src/repro/launch/realize.py``).

Usage:

  PYTHONPATH=src python -m repro_torch.launch.realize \
      --ckpt tests/data/realize/tf-paper.simba.ckpt.jsonl \
      --workload TF=tf-paper --top 1 --out results/realize-torch.jsonl
  PYTHONPATH=src python -m repro_torch.launch.realize \
      --ckpt tests/data/realize/mamba2-370m.simba.ckpt.jsonl \
      --workload MAMBA=lm:mamba2-370m --top 1 --calibrate

``--workload`` binds a checkpoint's workload name to a spec that
:func:`repro_torch.core.workloads.make_workload` resolves: a preset
(``tf-paper``, ``tf-quick``), ``transformer:k=v,...`` or
``lm:<config>[:seq=S,n_layers=L]``.  GEMM layers run the tiled GEMM,
attention pairs flash attention, ``*_ssd`` layers the chunked SSD.

The report is resumable: one JSONL record per realized candidate, keyed by
the checkpoint's task key; a re-run skips recorded candidates ("resumed
from"), ``--force`` re-measures.  Its fingerprint prefix is
``realize-torch:v2:``, so a torch report never resumes a JAX one, nor one
written before the predicted side was ported (whose ``pred_*`` are 0 and
must never feed a fit).  ``--calibrate`` fits the Tech overlay from every
record in the report, resumed ones included, and writes it to
``--overlay-out`` (default: the report's path with the suffix
``.overlay.json``); its ``source`` starts with ``repro_torch:`` and names
the device.  ``--device`` defaults to ``cuda`` and fails without a card;
``--device cpu`` runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ..core.explore import ResumableSweep
from ..realize.calibrate import fit_overlay, save_overlay
from ..realize.measure import measure_candidate
from ..realize.plan import (checkpoint_workload_fingerprints, graph_from_spec,
                            load_realize_candidates, plans_for)
from ..realize.program import build_program, resolve_device
from .cli import resolve_workloads, workload_bindings


def _print_report(rep) -> None:
    print(f"[realize] {rep.arch_label} x {rep.workload} "
          f"(batch_unit={rep.batch_unit}, {len(rep.stages)} stages)")
    print(f"  {'stage':5s} {'devs':>4s} {'route':14s} "
          f"{'GFLOP m/p':>16s} {'HBM m/p MB':>16s} "
          f"{'ICI/NoC m/p MB':>16s} {'DCI/D2D m/p MB':>16s} {'wall ms':>8s}")
    for st in rep.stages:
        # flash-scores is the fused half of a flash pair — not a kernel
        kernels = sorted({r.split(":")[0] for r in st.routes.values()}
                         - {"add", "jnp", "flash-scores"})
        route = "+".join(kernels) if kernels else "add"
        print(f"  {st.index:5d} {st.n_devices:4d} {route:14s} "
              f"{st.flops/1e9:7.2f}/{st.pred_flops/1e9:<8.2f} "
              f"{st.hbm_bytes/1e6:7.2f}/{st.pred_dram_bytes/1e6:<8.2f} "
              f"{st.ici_bytes/1e6:7.2f}/{st.pred_noc_bytes/1e6:<8.2f} "
              f"{st.dci_bytes/1e6:7.2f}/{st.pred_d2d_bytes/1e6:<8.2f} "
              f"{st.wall_s*1e3:8.3f}")
    rs = rep.ratio_summary()
    if rs:
        print("  measured/predicted geomean: "
              + "  ".join(f"{k}={v:.3g}" for k, v in sorted(rs.items())))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="realize DSE checkpoint mappings as PyTorch stage "
                    "programs on one card and measure them")
    ap.add_argument("--ckpt", required=True,
                    help="schema-v2 keep_mappings sweep checkpoint")
    ap.add_argument("--workload", action="append", default=[],
                    metavar="NAME=SPEC",
                    help="workload graph binding (preset name, "
                    "'transformer:k=v,...' or "
                    "'lm:<config>[:seq=S,n_layers=L]'); bare SPEC ok for "
                    "single-workload checkpoints")
    ap.add_argument("--top", type=int, default=2,
                    help="realize the K best-EDP mapped records (0 = all)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; the hand-written kernels) or "
                    "'cpu' (the plain versions)")
    ap.add_argument("--out", default="results/realize-torch.jsonl",
                    help="resumable measured report (JSONL)")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit + write the Tech overlay from all records")
    ap.add_argument("--overlay-out", default=None,
                    help="overlay path (default: <out>.overlay.json)")
    ap.add_argument("--no-exec", action="store_true",
                    help="count kernel work only; skip execution")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ckpt = Path(args.ckpt)
    if not ckpt.exists():
        raise SystemExit(f"checkpoint {ckpt} not found")
    ck_sweep = ResumableSweep.read(ckpt)
    wl_names = sorted({rec["workload"]
                       for rec in ck_sweep.as_dict().values()
                       if "workload" in rec})
    if not args.workload:
        raise SystemExit(
            f"checkpoint has workload(s) {wl_names}; bind each with "
            f"--workload NAME=SPEC (e.g. --workload TF=tf-paper)")
    workloads = resolve_workloads(
        workload_bindings(args.workload, names=wl_names),
        builder=graph_from_spec)
    cands = load_realize_candidates(ckpt, workloads, top=args.top,
                                    sweep=ck_sweep)
    print(f"[realize] {len(cands)} candidate(s) from {ckpt}, "
          f"device: {device}")

    fps = checkpoint_workload_fingerprints(ckpt)
    fp = ("realize-torch:v2:"
          + ",".join(f"{n}:{fps.get(n, '?')}" for n in wl_names)
          + f":device={device.type}:exec={int(not args.no_exec)}")
    out = Path(args.out)
    if args.force and out.exists():
        out.unlink()
    sweep = ResumableSweep(out, fp)

    t0 = time.time()
    for cand, plan in plans_for(cands):
        if cand.key in sweep:
            print(f"[realize] {cand.arch.label()} x {cand.workload}: "
                  f"resumed from {out}")
            continue
        prog = build_program(cand.graph, plan, device=device)
        rep = measure_candidate(cand, prog, execute=not args.no_exec)
        _print_report(rep)
        sweep.add(cand.key, rep.to_record())
    print(f"[realize] report -> {out} ({len(sweep)} records, "
          f"{time.time() - t0:.1f}s)")

    if args.calibrate:
        name = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
        overlay = fit_overlay(list(sweep.as_dict().values()),
                              source=f"repro_torch:{ckpt.name}|"
                                     f"device={name}")
        op = Path(args.overlay_out) if args.overlay_out \
            else out.with_suffix(".overlay.json")
        save_overlay(overlay, op)
        print(f"[realize] Tech overlay (from {overlay.n_stages} stages): "
              f"f_d2d={overlay.f_d2d:.3g} f_noc={overlay.f_noc:.3g} "
              f"f_dram={overlay.f_dram:.3g} -> {op}")


if __name__ == "__main__":
    main()
