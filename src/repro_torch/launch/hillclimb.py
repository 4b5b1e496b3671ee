"""Hillclimbing driver: hypothesis -> change -> re-trace -> measure.

Port of ``src/repro/launch/hillclimb.py``.  Each named VARIANT is a
(rules/cfg/bundle)-override set applied to one (arch x shape) cell on the
single-pod mesh, traced by :func:`repro_torch.launch.dryrun.run_cell` (a
fake process group, no card).  Results append to results/hillclimb.jsonl
keyed cell|mesh|variant, with the three roofline terms.

The sweep is resumable through the same append-only JSON-lines artifact
the DSE checkpoints use (:class:`repro_torch.core.explore.ResumableSweep`):
completed-ok cells are skipped on re-run, failed cells are retried, and a
kill mid-measure loses at most the in-flight cell.  ``--shard i/n`` runs
only every n-th variant into a per-shard jsonl (parallel jobs / hosts);
``launch/report.py`` merges the shard artifacts back into one table via
:func:`repro_torch.core.explore.merge_checkpoints`.  A legacy ``.json``
``--out`` (the pre-JSONL dict format) is redirected to the ``.jsonl``
sibling, and its records are carried over once.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell \
      qwen1.5-110b/train_4k --variant baseline,no_fsdp ...
"""

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Dict

from ..core.explore import ResumableSweep, parse_shard_spec

from .dryrun import run_cell

# variant name -> dict(rules_overrides=..., cfg_overrides=..., cell_kw=...)
VARIANTS: Dict[str, Dict] = {
    "baseline": {},
    # --- sharding-axis changes -------------------------------------------
    "no_fsdp": {        # pure 1-D TP params (kills per-layer all-gathers,
                        # pays replicated-param memory)
        "rules_overrides": {"embed": None}},
    "no_fsdp_zero1": {  # params replicated, optimizer state ZeRO-1 sharded
        "rules_overrides": {"embed": None}, "cell_kw": {"zero1": True}},
    "fsdp_zero1": {"cell_kw": {"zero1": True}},
    "seq_shard_act": {  # context-parallel attention activations
        "rules_overrides": {"act_kv": None, "act_seq": "model"}},
    "experts_on_data": {  # MoE: expert dim over the data axis
        "rules_overrides": {"experts": "data", "expert_mlp": "model"}},
    "moe_grouped16": {    # group-local dispatch aligned with data shards
        "cfg_overrides": {"moe_dispatch_groups": 16}},
    "moe_grouped32": {
        "cfg_overrides": {"moe_dispatch_groups": 32}},
    "moe_flat": {         # naive flat scatter (pre-optimization baseline)
        "cfg_overrides": {"moe_dispatch_groups": 0}},
    "moe_grouped16_micro2": {
        "cfg_overrides": {"moe_dispatch_groups": 16},
        "cell_kw": {"n_micro": 2}},
    # --- schedule / recompute changes ------------------------------------
    "micro1": {"cell_kw": {"n_micro": 1}},
    "micro2": {"cell_kw": {"n_micro": 2}},
    "micro8": {"cell_kw": {"n_micro": 8}},
    "micro16": {"cell_kw": {"n_micro": 16}},
    "no_remat": {"cfg_overrides": {"remat": False}},
    # --- serving-specific --------------------------------------------------
    "serve_tp_only": {  # decode/prefill: params pure-TP (no data-axis shard)
        "rules_overrides": {"embed": None}},
    "decode_batch_2d": {  # decode batch over (data x model), cache unsharded
                          # on seq (per-device full heads)
        "rules_overrides": {"batch": ("pod", "data", "model"),
                            "kv_seq": None, "act_kv_seq": None}},
    "cache_head_shard": {  # decode cache sharded on kv heads (when it fits)
        "rules_overrides": {"kv_seq": None, "act_kv_seq": None,
                            "kv_heads": "model", "act_kv": "model"}},
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True,
                    help="arch/shape, e.g. qwen1.5-110b/train_4k")
    ap.add_argument("--variant", required=True,
                    help="comma-separated variant names")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default="results/hillclimb.jsonl")
    ap.add_argument("--shard", default="0/1", metavar="i/n",
                    help="run only variants with list-index %% n == i, "
                    "into a .shardIofN.jsonl sibling of --out")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    arch, shape = args.cell.split("/")
    si, sn = parse_shard_spec(args.shard)
    # append-only sweep log; duplicate keys are last-wins, so --force simply
    # appends an overriding record without losing history
    out = Path(args.out)
    if out.suffix == ".json":
        # an old-style invocation (pre-JSONL default): never write JSONL
        # into a .json path — redirect to the sibling and migrate below
        print(f"[hillclimb] --out {out} is the legacy dict format; "
              f"writing to {out.with_suffix('.jsonl')} instead")
        out = out.with_suffix(".jsonl")
    if sn > 1:
        # per-shard artifact: report.py merges the shard files with the
        # base jsonl (last-wins), so shards never contend on one file
        out = out.with_name(f"{out.stem}.shard{si}of{sn}{out.suffix}")
    legacy = out.with_suffix(".json")
    migrate = sn == 1 and legacy.exists() and not out.exists()
    sweep = ResumableSweep(out)
    if migrate:
        # one-time carry-over of pre-JSONL records so the before/after
        # comparison keeps its "before" rows
        for key, rec in json.loads(legacy.read_text()).items():
            sweep.add(key, rec)
        print(f"[migrate] {len(sweep)} records from {legacy} -> {out}")

    variants = [v for j, v in enumerate(args.variant.split(","))
                if j % sn == si]
    if sn > 1:
        print(f"[hillclimb] shard {si}/{sn}: {len(variants)} variant(s) "
              f"-> {out}")
    for vname in variants:
        spec = VARIANTS[vname]
        key = f"{args.cell}|{args.mesh}|{vname}"
        prev = sweep.get(key)
        if prev is not None and prev.get("ok") and not args.force:
            print(f"[skip] {key}")
            continue
        print(f"[variant] {key} ...", flush=True)
        t0 = time.time()
        try:
            rec = run_cell(arch, shape, args.mesh,
                           rules_overrides=spec.get("rules_overrides"),
                           cfg_overrides=spec.get("cfg_overrides"),
                           **spec.get("cell_kw", {}))
            rec["variant"] = vname
            print(f"[ok] {key}: compute={rec['t_compute']*1e3:.1f}ms "
                  f"memory={rec['t_memory']*1e3:.1f}ms "
                  f"coll={rec['t_collective']*1e3:.1f}ms "
                  f"bound={rec['t_compute'] and max(rec['t_compute'], rec['t_memory'], rec['t_collective'])*1e3:.1f}ms "
                  f"frac={rec['roofline_fraction']:.3f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            rec = {"ok": False, "variant": vname,
                   "error": f"{type(e).__name__}: {e}"}
            print(f"[FAIL] {key}: {rec['error'][:160]}", flush=True)
        sweep.add(key, rec)


if __name__ == "__main__":
    main()
