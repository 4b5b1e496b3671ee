"""Sweep post-mortem CLI over obs run dirs + shard checkpoints.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.obs_report --run RUN_DIR
    PYTHONPATH=src python -m repro_torch.launch.obs_report \\
        --run results/obs/run-X --ckpt results/sweep.shard*.ckpt.jsonl

``--run`` points at a directory written under ``REPRO_OBS=1`` (manifest,
metrics snapshot, per-process trace streams); ``--ckpt`` adds per-shard
liveness/progress (heartbeat records) and a Pareto-frontier snapshot
parsed straight from the checkpoint files — the latter works on a sweep
that is *still running*, which is the liveness view the ROADMAP's
multi-host driver polls.  ``--json`` emits the underlying tables as
machine-readable JSON instead of text.

Copy of ``src/repro/launch/obs_report.py``.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..obs import report as obs_report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="obs_report", description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", default=None, metavar="DIR",
                    help="obs run directory (REPRO_OBS_DIR of the sweep)")
    ap.add_argument("--ckpt", nargs="*", default=[], metavar="PATH",
                    help="shard checkpoint file(s) for liveness + Pareto")
    ap.add_argument("--top", type=int, default=10,
                    help="rows in the slowest-tasks / Pareto tables")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output instead of text tables")
    args = ap.parse_args(argv)
    if args.run is None and not args.ckpt:
        ap.error("need --run and/or --ckpt")
    if args.json:
        data = (obs_report.load_run(args.run) if args.run is not None
                else {"manifest": None, "metrics": None, "events": []})
        doc = {
            "manifest": data["manifest"],
            "metrics": data["metrics"],
            "phases": obs_report.phase_rows(data["metrics"]),
            "top_tasks": obs_report.top_tasks(data["events"], k=args.top),
            "caches": obs_report.cache_rows(data["metrics"]),
            "shards": (obs_report.shard_progress(args.ckpt)
                       if args.ckpt else []),
            "pareto": (obs_report.pareto_snapshot(args.ckpt, top=args.top)
                       if args.ckpt else []),
        }
        json.dump(doc, sys.stdout, indent=1, default=str)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(obs_report.render_report(
            run=args.run, ckpts=args.ckpt, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
