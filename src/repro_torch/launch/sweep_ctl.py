"""Multi-host supervised sweep control CLI.

Usage::

    # CI-sized chaos run: 2 local shard children, injected kill fault,
    # result asserted bit-identical to a clean in-process run
    PYTHONPATH=src python -m repro_torch.launch.sweep_ctl launch --quick \\
        --out /tmp/sweep --hosts 2 --fault kill --fault-seed 0 \\
        --verify-clean

    # real sweep from a spec file over SSH hosts
    PYTHONPATH=src python -m repro_torch.launch.sweep_ctl launch \\
        --spec sweep.json --out results/sweep \\
        --host "ssh dse-01 {cmd}" --host "ssh dse-02 {cmd}"

    PYTHONPATH=src python -m repro_torch.launch.sweep_ctl status --out D
    PYTHONPATH=src python -m repro_torch.launch.sweep_ctl resume --out D
    PYTHONPATH=src python -m repro_torch.launch.sweep_ctl merge  --out D

``launch`` screens once in the supervisor, dispatches explicit
candidate-index shards to the hosts, polls checkpoint heartbeats for
liveness, retries/re-shards failures, and merges under the sweep
fingerprint.  ``status`` renders per-shard progress and the mid-flight
Pareto frontier from whatever the journal says has been launched —
including while the sweep is still running under another process.
``resume`` continues a killed supervisor from its journal.  ``merge``
re-runs just the merge + completeness check over the journal's
checkpoints.

Copy of ``src/repro/launch/sweep_ctl.py``: the same subcommands, flags,
defaults and exit codes (0 done, 1 no journal or no checkpoints, or a
``--verify-clean`` mismatch, 2 a failed supervisor or an incomplete
merge).  A spec file whose ``sa`` says ``"backend": "fused"`` scores the
shard children's SA proposals with the ``fused_eval`` kernel on the card,
and ``--verify-clean`` runs the clean sweep on the card in this process.
The supervisor, the journal and the checkpoints are the reference's, so
either package's ``status`` and ``merge`` read the other's out dir.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..dist.faults import FAULT_KINDS
from ..dist.hosts import parse_hosts
from ..dist.supervisor import (Supervisor, SupervisorError, SweepSpec,
                               quick_spec, read_state, supervised_results)
from ..obs import report as obs_report


def _sig(points):
    return [(p.arch, p.objective, p.energy_j, p.delay_s) for p in points]


def _load_spec(args) -> SweepSpec:
    if args.spec is not None:
        return SweepSpec.from_json(Path(args.spec).read_text())
    if args.quick:
        return quick_spec(seed=args.seed, n_shards=args.shards,
                          screen_keep=args.screen_keep)
    raise SystemExit("need --spec FILE or --quick")


def _supervisor(spec: SweepSpec, args, fault_kind=None,
                fault_k=None) -> Supervisor:
    hosts = parse_hosts(args.host, n_local=args.hosts)
    return Supervisor(spec, out_dir=args.out, hosts=hosts,
                      state_path=args.state, hb_timeout=args.hb_timeout,
                      poll_s=args.poll, max_attempts=args.max_attempts,
                      hb_every=args.hb_every, fault_kind=fault_kind,
                      fault_seed=args.fault_seed, fault_k=fault_k)


def _verify_clean(spec: SweepSpec, merged: Path) -> int:
    """Assert the supervised result is bit-identical to a failure-free
    unsharded in-process run of the same grid + seed."""
    got = _sig(supervised_results(spec, merged))
    from ..core.dse import run_dse
    want = _sig(run_dse(spec.build_candidates(), spec.build_workloads(),
                        spec.build_cfg(), use_sa=spec.use_sa,
                        screen_keep=spec.screen_keep))
    if got != want:
        print(f"verify-clean: MISMATCH ({len(got)} vs {len(want)} points)",
              file=sys.stderr)
        for g, w in zip(got, want):
            if g != w:
                print(f"  supervised: {g}\n  clean:      {w}",
                      file=sys.stderr)
                break
        return 1
    print(f"verify-clean: OK — {len(got)} points bit-identical to the "
          "clean unsharded run")
    return 0


def cmd_launch(args) -> int:
    spec = _load_spec(args)
    fault_kind = fault_k = None
    if args.fault:
        parts = args.fault.split(":")
        fault_kind = parts[0]
        if fault_kind not in FAULT_KINDS:
            raise SystemExit(f"unknown --fault {fault_kind!r}; "
                             f"one of {FAULT_KINDS}")
        fault_k = int(parts[1]) if len(parts) > 1 and parts[1] else None
    sup = _supervisor(spec, args, fault_kind=fault_kind, fault_k=fault_k)
    try:
        merged = sup.run()
    except SupervisorError as e:
        print(f"supervisor failed: {e}", file=sys.stderr)
        return 2
    print(f"merged: {merged}")
    if args.verify_clean:
        return _verify_clean(spec, merged)
    return 0


def cmd_resume(args) -> int:
    out = Path(args.out)
    spec_path = out / "spec.json"
    if args.spec is None and spec_path.exists():
        args.spec = str(spec_path)
    spec = _load_spec(args)
    sup = _supervisor(spec, args)
    try:
        merged = sup.resume()
    except SupervisorError as e:
        print(f"supervisor failed: {e}", file=sys.stderr)
        return 2
    print(f"merged: {merged}")
    if args.verify_clean:
        return _verify_clean(spec, merged)
    return 0


def cmd_status(args) -> int:
    state_path = Path(args.state) if args.state \
        else Path(args.out) / "supervisor_state.jsonl"
    if not state_path.exists():
        print(f"no supervisor journal at {state_path}", file=sys.stderr)
        return 1
    state = read_state(state_path)
    plan = state["plan"]
    counts = {}
    for e in state["events"]:
        counts[e["ev"]] = counts.get(e["ev"], 0) + 1
    if args.json:
        doc = {"plan": plan, "event_counts": counts,
               "checkpoints": state["checkpoints"],
               "merged": state["merged"],
               "shards": obs_report.shard_progress(
                   [p for p in state["checkpoints"] if Path(p).exists()]),
               "pareto": obs_report.pareto_snapshot(
                   [p for p in state["checkpoints"] if Path(p).exists()],
                   top=args.top)}
        json.dump(doc, sys.stdout, indent=1, default=str)
        sys.stdout.write("\n")
        return 0
    lines = [f"supervisor journal: {state_path}"]
    if plan is not None:
        lines.append(f"  fingerprint {plan['fingerprint']}")
        lines.append(f"  keep set: {len(plan['keep'])}/"
                     f"{plan['n_candidates']} candidates over "
                     f"{len(plan['shards'])} shard(s)")
        if plan.get("fault_kind"):
            lines.append(f"  chaos: fault={plan['fault_kind']} "
                         f"plan={plan.get('faults')}")
    lines.append("  events: " + ", ".join(
        f"{k}={v}" for k, v in sorted(counts.items())))
    if state["merged"] is not None:
        lines.append(f"  merged: {state['merged']['out']} "
                     f"({state['merged']['n_records']} records)")
    print("\n".join(lines))
    live = [p for p in state["checkpoints"] if Path(p).exists()]
    if live:
        print()
        print(obs_report.render_report(run=None, ckpts=live, top=args.top))
    return 0


def cmd_merge(args) -> int:
    out = Path(args.out)
    spec = SweepSpec.from_json((out / "spec.json").read_text())
    state = read_state(Path(args.state) if args.state
                       else out / "supervisor_state.jsonl")
    ckpts = [Path(p) for p in state["checkpoints"] if Path(p).exists()]
    if not ckpts:
        print("no shard checkpoints recorded in the journal",
              file=sys.stderr)
        return 1
    from ..core.explore import (merge_checkpoints,
                                remaining_candidate_indices)
    merged = out / "merged.jsonl"
    report = merge_checkpoints(ckpts, out=merged,
                               expect_fingerprint=spec.fingerprint(),
                               on_conflict=args.on_conflict)
    keep = (state["plan"]["keep"] if state["plan"] is not None
            else None)
    left = remaining_candidate_indices(
        spec.build_candidates(), spec.build_workloads(), spec.build_cfg(),
        merged, use_sa=spec.use_sa, indices=keep)
    status = "complete" if not left else f"INCOMPLETE ({len(left)} missing)"
    print(f"merged {report.n_records} records from {len(report.merged)} "
          f"shard(s) -> {merged} [{status}]")
    if report.conflicts:
        print(f"  {len(report.conflicts)} conflicting key(s): "
              f"{report.conflicts[:4]}", file=sys.stderr)
    return 0 if not left else 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sweep_ctl", description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, launchish=True):
        p.add_argument("--out", required=True, metavar="DIR",
                       help="supervisor output dir (journal, shard "
                            "checkpoints, merged.jsonl)")
        p.add_argument("--state", default=None,
                       help="journal path (default OUT/supervisor_state"
                            ".jsonl)")
        if not launchish:
            return
        p.add_argument("--spec", default=None, help="SweepSpec JSON file")
        p.add_argument("--quick", action="store_true",
                       help="built-in CI-sized sweep spec")
        p.add_argument("--seed", type=int, default=3)
        p.add_argument("--shards", type=int, default=2)
        p.add_argument("--screen-keep", type=float, default=1.0)
        p.add_argument("--hosts", type=int, default=0, metavar="N",
                       help="N local-process hosts")
        p.add_argument("--host", action="append", default=[],
                       metavar="TEMPLATE",
                       help="shell-command host template containing "
                            "{cmd}; repeatable")
        p.add_argument("--hb-timeout", type=float, default=60.0,
                       help="seconds without heartbeat progress before a "
                            "shard is declared dead")
        p.add_argument("--poll", type=float, default=0.5)
        p.add_argument("--hb-every", type=float, default=0.0,
                       help="child heartbeat period (0 = every task)")
        p.add_argument("--max-attempts", type=int, default=3)
        p.add_argument("--fault-seed", type=int, default=0)
        p.add_argument("--verify-clean", action="store_true",
                       help="after merge, assert bit-identity against a "
                            "clean unsharded in-process run")

    p = sub.add_parser("launch", help="screen, dispatch, supervise, merge")
    common(p)
    p.add_argument("--fault", default=None, metavar="KIND[:K]",
                   help=f"inject a deterministic fault ({FAULT_KINDS})")
    p.set_defaults(fn=cmd_launch)

    p = sub.add_parser("resume", help="continue a killed supervisor")
    common(p)
    p.set_defaults(fn=cmd_resume)

    p = sub.add_parser("status", help="render journal + shard progress")
    common(p, launchish=False)
    p.add_argument("--top", type=int, default=10)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("merge", help="merge journal checkpoints now")
    common(p, launchish=False)
    p.add_argument("--on-conflict", default="report",
                   choices=("report", "error"))
    p.set_defaults(fn=cmd_merge)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
