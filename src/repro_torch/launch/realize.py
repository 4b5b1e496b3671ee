"""Realization driver: DSE checkpoint -> stage programs on the card ->
measured report (port of ``src/repro/launch/realize.py``).

Usage:

  PYTHONPATH=src python -m repro_torch.launch.realize \
      --ckpt tests/data/realize/tf-paper.simba.ckpt.jsonl \
      --workload TF=tf-paper --top 1 --out results/realize-torch.jsonl
  PYTHONPATH=src python -m repro_torch.launch.realize \
      --ckpt tests/data/realize/mamba2-370m.simba.ckpt.jsonl \
      --workload MAMBA=lm:mamba2-370m --top 1

``--workload`` binds a checkpoint's workload name to a spec that
:func:`repro_torch.core.workloads.make_workload` resolves: a preset
(``tf-paper``, ``tf-quick``), ``transformer:k=v,...`` or
``lm:<config>[:seq=S,n_layers=L]``.  GEMM layers run the tiled GEMM,
attention pairs flash attention, ``*_ssd`` layers the chunked SSD.

The report is resumable: one JSONL record per realized candidate, keyed by
the checkpoint's task key; a re-run skips recorded candidates ("resumed
from"), ``--force`` re-measures.  Its fingerprint prefix is
``realize-torch:v1:``, so a torch report never resumes a JAX one.
``--device`` defaults to ``cuda`` and fails without a card; ``--device cpu``
runs the plain versions on the CPU.  Calibration (``--calibrate``) waits for
the cost-model slice of the port.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from ..core.explore import ResumableSweep
from ..realize.measure import measure_candidate
from ..realize.plan import (checkpoint_workload_fingerprints, graph_from_spec,
                            load_realize_candidates, plans_for)
from ..realize.program import build_program, resolve_device
from .cli import resolve_workloads, workload_bindings


def _print_report(rep) -> None:
    print(f"[realize] {rep.arch_label} x {rep.workload} "
          f"(batch_unit={rep.batch_unit}, {len(rep.stages)} stages)")
    # measured columns only: the predicted ones come with the cost model
    print(f"  {'stage':5s} {'devs':>4s} {'route':14s} {'GFLOP':>8s} "
          f"{'HBM MB':>8s} {'ICI MB':>8s} {'DCI MB':>8s} {'wall ms':>8s}")
    for st in rep.stages:
        # flash-scores is the fused half of a flash pair — not a kernel
        kernels = sorted({r.split(":")[0] for r in st.routes.values()}
                         - {"add", "jnp", "flash-scores"})
        route = "+".join(kernels) if kernels else "add"
        print(f"  {st.index:5d} {st.n_devices:4d} {route:14s} "
              f"{st.flops/1e9:8.2f} {st.hbm_bytes/1e6:8.2f} "
              f"{st.ici_bytes/1e6:8.2f} {st.dci_bytes/1e6:8.2f} "
              f"{st.wall_s*1e3:8.3f}")


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
    fp = ("realize-torch:v1:"
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


if __name__ == "__main__":
    main()
