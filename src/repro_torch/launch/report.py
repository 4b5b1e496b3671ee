"""Render results/dryrun.json (+ hillclimb.jsonl) into markdown tables.

Port of ``src/repro/launch/report.py``: the same tables from the same
files (either package's dry-run and hill-climb artifacts), the hill-climb
shards merged through :func:`repro_torch.core.explore.merge_checkpoints`.
Usage:  PYTHONPATH=src python -m repro_torch.launch.report > /tmp/tbl.md
"""

from __future__ import annotations

import json
from pathlib import Path


def fmt_s(x: float) -> str:
    return f"{x * 1e3:9.1f}m" if x < 100 else f"{x:9.1f}s"


def dryrun_table(path: str = "results/dryrun.json", mesh: str = "single") -> str:
    d = json.loads(Path(path).read_text())
    rows = sorted(((k, v) for k, v in d.items()
                   if v.get("ok") and v["mesh"] == mesh),
                  key=lambda kv: (kv[1]["arch"], kv[1]["shape"]))
    out = ["| cell | bneck | t_compute | t_memory | t_mem_kernel | "
           "t_collective | frac | useful | args GB/dev | temp GB/dev | "
           "coll GB/dev |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for k, v in rows:
        tmk = v.get("t_memory_kernel", v["t_memory"])
        out.append(
            f"| {v['arch']}/{v['shape']} | {v['bottleneck']} | "
            f"{v['t_compute']*1e3:.1f} ms | {v['t_memory']*1e3:.1f} ms | "
            f"{tmk*1e3:.1f} ms | "
            f"{v['t_collective']*1e3:.1f} ms | {v['roofline_fraction']:.3f} | "
            f"{v['useful_flops_ratio']:.2f} | "
            f"{v['argument_bytes']/1e9:.2f} | {v['temp_bytes']/1e9:.2f} | "
            f"{v['coll_bytes_per_device']/1e9:.2f} |")
    return "\n".join(out)


def multi_pod_table(path: str = "results/dryrun.json") -> str:
    d = json.loads(Path(path).read_text())
    rows = sorted(((k, v) for k, v in d.items()
                   if v.get("ok") and v["mesh"] == "multi"),
                  key=lambda kv: (kv[1]["arch"], kv[1]["shape"]))
    out = ["| cell | compiled | t_coll (multi) | coll GB/dev | "
           "args GB/dev | compile s |",
           "|---|---|---|---|---|---|"]
    for k, v in rows:
        out.append(
            f"| {v['arch']}/{v['shape']} | yes | "
            f"{v['t_collective']*1e3:.1f} ms | "
            f"{v['coll_bytes_per_device']/1e9:.2f} | "
            f"{v['argument_bytes']/1e9:.2f} | {v['compile_s']:.0f} |")
    return "\n".join(out)


def hillclimb_table(path: str = "results/hillclimb.jsonl") -> str:
    p = Path(path)
    legacy = p.with_suffix(".json")
    # merge legacy dict-format records under the JSONL ones, so "before"
    # rows recorded pre-migration stay in the comparison
    d = json.loads(legacy.read_text()) if legacy.exists() else {}
    # the base jsonl plus any per-shard siblings written by
    # hillclimb --shard i/n, merged last-wins in name order (corrupt
    # shards are set aside by merge_checkpoints, not fatal here)
    shards = sorted(p.parent.glob(f"{p.stem}.shard*of*{p.suffix}"))
    paths = ([p] if p.exists() else []) + shards
    if paths:
        from ..core.explore import ResumableSweep, merge_checkpoints
        try:
            # in-memory, quiet: this function's output lands in tables
            report = merge_checkpoints(paths, verbose=False)
            d.update(report.records)
            skipped = [p for p, _ in report.skipped]
        except ValueError:              # no file usable / fps disagree
            skipped = paths
        # merge_checkpoints sets whole corrupt shards aside; a render-only
        # consumer still wants every parseable line (the pre-shard
        # behavior), so salvage set-aside files read-only
        for p in skipped:
            d.update(ResumableSweep.read(p).as_dict())
    if not d:
        return "(no hillclimb results yet)"
    out = ["| cell | variant | t_compute | t_memory | t_collective | "
           "bound | frac |", "|---|---|---|---|---|---|---|"]
    for k, v in sorted(d.items()):
        if not v.get("ok"):
            out.append(f"| {k} | FAILED: {v.get('error', '?')[:60]} | | | | | |")
            continue
        cell = k.rsplit("|", 1)[0]
        bound = max(v["t_compute"], v["t_memory"], v["t_collective"])
        out.append(
            f"| {cell} | {v['variant']} | {v['t_compute']*1e3:.1f} ms | "
            f"{v['t_memory']*1e3:.1f} ms | {v['t_collective']*1e3:.1f} ms | "
            f"{bound*1e3:.1f} ms | {v['roofline_fraction']:.3f} |")
    return "\n".join(out)


def main() -> None:
    print("## Single-pod roofline (16x16 = 256 devices)\n")
    print(dryrun_table())
    print("\n## Multi-pod pass (2x16x16 = 512 devices)\n")
    print(multi_pod_table())
    print("\n## Hillclimb variants\n")
    print(hillclimb_table())


if __name__ == "__main__":
    main()
