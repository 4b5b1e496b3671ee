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
  PYTHONPATH=src python -m repro_torch.launch.realize --ckpt C \
      --workload TF=tf-quick --mesh 4 --host-ranks 4 --device cpu

``--workload`` binds a checkpoint's workload name to a spec that
:func:`repro_torch.core.workloads.make_workload` resolves: a preset
(``tf-paper``, ``tf-quick``), ``transformer:k=v,...`` or
``lm:<config>[:seq=S,n_layers=L]``.  GEMM layers run the tiled GEMM,
attention pairs flash attention, ``*_ssd`` layers the chunked SSD.

``--mesh`` picks where the stages run.  ``logical`` (the default) runs
every stage on one device, its grid logical (``realize/program.py``).
``host`` (every rank of the world), ``production`` / ``production2``
(256 / 512 ranks) or a count ``N`` places each stage on its ranks of a
pool of ``torch.distributed`` ranks, core ``c`` on rank ``c``, and
measures the stages' collectives as ICI.  The ranks come from a launcher
(``torchrun --nproc-per-node=N``: NCCL, one rank a card), from
``--host-ranks N`` (N local processes over gloo on ``--device``: the CPU,
or sharing the card; the counterpart of the reference's
``--host-devices``), or, with neither, a one-rank group.  Every rank runs
the candidates; rank 0 alone prints, writes the report and fits the
overlay, and a rank that fails makes the command exit non-zero.

The report is resumable: one JSONL record per realized candidate, keyed by
the checkpoint's task key; a re-run skips recorded candidates ("resumed
from"), ``--force`` re-measures.  Its fingerprint prefix is
``realize-torch:v2:``, so a torch report never resumes a JAX one, nor one
written before the predicted side was ported (whose ``pred_*`` are 0 and
must never feed a fit); in mesh mode it names the pool (``:pool=N``), so a
mesh report never resumes a logical one or one of another pool size.
``--calibrate`` fits the Tech overlay from every record in the report,
resumed ones included, and writes it to ``--overlay-out`` (default: the
report's path with the suffix ``.overlay.json``); its ``source`` starts
with ``repro_torch:`` and names the device (and the pool).  ``--device``
defaults to ``cuda`` and fails without a card; ``--device cpu`` runs the
plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..core.explore import ResumableSweep
from ..realize.calibrate import fit_overlay, save_overlay
from ..realize.measure import measure_candidate
from ..realize.plan import (checkpoint_workload_fingerprints, graph_from_spec,
                            load_realize_candidates, plans_for)
from ..realize.program import build_program, resolve_device
from . import mesh as lmesh
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


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="realize DSE checkpoint mappings as PyTorch stage "
                    "programs, on one device or over a pool of ranks, and "
                    "measure them")
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
    ap.add_argument("--mesh", default="logical",
                    help="'logical' (default: one device), or a pool of "
                    "ranks: 'host' (every rank), 'production' (256), "
                    "'production2' (512) or a count")
    ap.add_argument("--host-ranks", type=int, default=0,
                    help="start this many local ranks over gloo on "
                    "--device (0: the ranks come from a launcher, or one)")
    ap.add_argument("--out", default="results/realize-torch.jsonl",
                    help="resumable measured report (JSONL)")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit + write the Tech overlay from all records")
    ap.add_argument("--overlay-out", default=None,
                    help="overlay path (default: <out>.overlay.json)")
    ap.add_argument("--no-exec", action="store_true",
                    help="count kernel work only; skip execution")
    ap.add_argument("--force", action="store_true")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.mesh == "logical":
        if args.host_ranks:
            raise SystemExit("--host-ranks needs --mesh (a pool of ranks)")
        _realize(args)
    elif args.host_ranks:
        lmesh.pool_size(args.mesh, args.host_ranks)     # refuse before
        lmesh.start_local_ranks(args.host_ranks, _realize, (args,),
                                device_type=device.type)
    else:
        started = not dist.is_initialized()
        lmesh.init_world(device.type)
        try:
            _realize(args)
        finally:
            if started:
                dist.destroy_process_group()


def _realize(args: argparse.Namespace) -> None:
    """The realization on this process: one device (logical), or this
    rank's part of the pool's (every rank of the world runs it)."""
    device = resolve_device(args.device)
    pool = None
    if args.mesh != "logical":
        pool = lmesh.pool_size(args.mesh, dist.get_world_size())
    lead = pool is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
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
                                    sweep=ck_sweep, verbose=lead)
    where = f"device: {device}" if pool is None else (
        f"device pool: {pool} ranks x {device.type} "
        f"({lmesh.transport(lmesh.rank_device(device.type))['backend']})")
    say(f"[realize] {len(cands)} candidate(s) from {ckpt}, {where}")

    fps = checkpoint_workload_fingerprints(ckpt)
    fp = ("realize-torch:v2:"
          + ",".join(f"{n}:{fps.get(n, '?')}" for n in wl_names)
          + f":device={device.type}"
          + ("" if pool is None else f":pool={pool}")
          + f":exec={int(not args.no_exec)}")
    out = Path(args.out)
    sweep = None
    if lead:
        if args.force and out.exists():
            out.unlink()
        sweep = ResumableSweep(out, fp)

    t0 = time.time()
    for cand, plan in plans_for(cands, pool):
        done = [cand.key in sweep] if lead else [None]
        if pool is not None:        # every rank skips what rank 0 has
            dist.broadcast_object_list(done, src=0)
        if done[0]:
            say(f"[realize] {cand.arch.label()} x {cand.workload}: "
                f"resumed from {out}")
            continue
        prog = build_program(cand.graph, plan, device=device,
                             mesh=None if pool is None else range(pool))
        rep = measure_candidate(cand, prog, execute=not args.no_exec)
        if lead:
            _print_report(rep)
            sweep.add(cand.key, rep.to_record())
    if not lead:
        return
    print(f"[realize] report -> {out} ({len(sweep)} records, "
          f"{time.time() - t0:.1f}s)")

    if args.calibrate:
        name = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
        overlay = fit_overlay(list(sweep.as_dict().values()),
                              source=f"repro_torch:{ckpt.name}|"
                                     f"device={name}"
                                     + ("" if pool is None
                                        else f"|pool={pool}"))
        op = Path(args.overlay_out) if args.overlay_out \
            else out.with_suffix(".overlay.json")
        save_overlay(overlay, op)
        print(f"[realize] Tech overlay (from {overlay.n_stages} stages): "
              f"f_d2d={overlay.f_d2d:.3g} f_noc={overlay.f_noc:.3g} "
              f"f_dram={overlay.f_dram:.3g} -> {op}")


if __name__ == "__main__":
    main()
