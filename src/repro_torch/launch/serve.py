"""Serving launcher: traffic-replay SLO reports + interactive wave demo.

Port of ``src/repro/launch/serve.py``.  Trace replay (the serving harness;
deterministic for a fixed seed):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --trace poisson:rate=8,n=32,plen=4..32,new=8..32 --report \
      --out results/serve_report.jsonl

emits p50/p95/p99 TTFT + end-to-end latency and a saturation-throughput
estimate for BOTH serving paths:

* ``serve_loop`` — the wave-batched scheduling policy of
  ``runtime/serve_loop.py``, timed on a nominal-throughput virtual clock
  derived from the model config (deterministic; add ``--measure`` to
  also replay against the model on ``--device``, wall clock);
* ``realized`` — continuous batch slotting over the service model of the
  best co-explored mapping (an inline Table-I quick screen by default,
  or the best record of a ``--ckpt`` DSE sweep), the program the
  ``realize/`` path would compile.

The two virtual sections are numpy on the host, equal to the reference's
byte for byte; only ``--measure`` touches the device: ``--device cuda``
(the default) runs the model through the port's kernels and raises
without a card, ``--device cpu`` runs the plain versions.

Interactive demo (no --trace): submits synthetic requests through the
``Server`` shim and prints per-request latencies, on ``--device``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..serve import (ServeReport, ServiceModel, make_trace, replay, respec,
                     saturation_sweep, service_model_from_delay)
from . import cli

# Virtual-clock throughput anchor for the serve_loop section: FLOPs per
# token from the model config over a nominal sustained rate.  The absolute
# scale is arbitrary (percentile *ratios* and the saturation knee are what
# the report is for); --measure replays the real model to calibrate it.
NOMINAL_FLOPS_PER_S = 1e12

# Rate ladder (x the trace's base rate) swept for the saturation estimate.
SAT_LADDER = (0.5, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

# The realized path derives its per-token cost from the co-explored
# mapping's delay at the quick-DSE operating point.
DSE_BATCH = 8
SEQ_REF = 64


def _nominal_service_model(cfg) -> ServiceModel:
    """Deterministic per-token cost of the model config (virtual clock)."""
    per_tok_flops = 2.0 * (
        cfg.n_layers * (4 * cfg.d_model ** 2 + 2 * cfg.d_model * cfg.d_ff)
        + cfg.d_model * cfg.vocab)
    c = per_tok_flops / NOMINAL_FLOPS_PER_S
    return ServiceModel(prefill_s_per_token=c, decode_s_per_token=c)


def _coexplored_delay(workloads: Dict, seed: int,
                      ckpt: Optional[str]) -> float:
    """Geomean forward delay of the best co-explored mapping.

    With ``--ckpt``, the best-EDP record of the DSE sweep (the mapping
    ``realize/`` would compile); otherwise an inline T-Map screen of the
    Table-I quick grid — deterministic either way.
    """
    if ckpt:
        from ..realize.plan import load_realize_candidates
        cands = load_realize_candidates(ckpt, workloads, top=1)
        if not cands:
            raise SystemExit(f"--ckpt {ckpt}: no mapped records")
        return cands[0].delay_s
    from ..core.dse import DSEConfig, grid_candidates, run_dse
    from ..core.sa import SAConfig
    grid = grid_candidates(
        72.0, mac_options=(512, 1024), cut_options=(1, 2),
        dram_per_tops=(2.0,), noc_options=(16, 32), d2d_ratio=(0.5,),
        glb_options=(1024, 2048))
    cfg = DSEConfig(batch=DSE_BATCH, sa=SAConfig(iters=150, seed=seed))
    return run_dse(grid, workloads, cfg, use_sa=False)[0].delay_s


def _print_section(name: str, summary: Dict, sat: Dict) -> None:
    ttft, e2e = summary["ttft_s"], summary["e2e_s"]
    print(f"[serve:{name}] mode={summary['mode']} "
          f"timing={summary['timing']} "
          f"n={summary['trace']['n']} occ={summary['mean_occupancy']:.2f}")
    print(f"  TTFT s   p50={ttft['p50']:.4g} p95={ttft['p95']:.4g} "
          f"p99={ttft['p99']:.4g}")
    print(f"  e2e  s   p50={e2e['p50']:.4g} p95={e2e['p95']:.4g} "
          f"p99={e2e['p99']:.4g}")
    if sat:
        sr = sat["sat_rate_rps"]
        print(f"  saturation ~{sr:.4g} req/s "
              f"({sat['sat_throughput_tok_s']:.4g} tok/s, "
              f"knee at p99 > {sat['slo_mult']:g}x unloaded"
              f"{'' if sat['saturated'] else '; ladder never saturated'})")


def _section(name: str, rep: ServeReport, sat: Dict) -> Dict:
    doc = {"section": name, **rep.summary()}
    if sat:
        doc["saturation"] = sat
    return doc


def _replay_trace(args) -> List[Dict]:
    trace = make_trace(args.trace, seed=args.seed)
    print(f"[serve] trace {trace.name} n={len(trace.requests)} "
          f"seed={trace.seed} fp={trace.fingerprint()} "
          f"rate~{trace.arrival_rate():.3g} req/s")
    base_rate = trace.arrival_rate() or 1.0
    rates = [base_rate * m for m in SAT_LADDER]
    sections: List[Dict] = []

    def run_path(name: str, model: ServiceModel, mode: str) -> None:
        rep = replay(trace, model, mode=mode, max_batch=args.max_batch)
        sat = saturation_sweep(
            lambda r: make_trace(respec(args.trace, rate=r), seed=args.seed),
            lambda: model, rates, mode=mode, max_batch=args.max_batch)
        _print_section(name, rep.summary(), sat)
        sections.append(_section(name, rep, sat))

    # path 1: the serve_loop wave policy on the nominal virtual clock
    cfg = cli.model_config(args)
    run_path("serve_loop", _nominal_service_model(cfg), "wave")

    # path 2: continuous slotting over the best co-explored mapping
    bindings = cli.workload_bindings(args.workload or ["TF=tf-quick"])
    workloads = cli.resolve_workloads(bindings)
    delay = _coexplored_delay(workloads, args.seed, args.ckpt)
    model = service_model_from_delay(delay, DSE_BATCH, SEQ_REF)
    print(f"[serve] realized mapping delay {delay:.4g}s "
          f"-> {model.decode_s_per_token:.3e} s/token")
    run_path("realized", model, "continuous")

    if args.measure:
        # wall-clock validation of the virtual serve_loop section: same
        # trace, same wave policy, the model on --device.  Nondeterministic
        # by nature — reported alongside, never replacing, the virtual
        # sections (realize/measure.py's validate-don't-replace pattern).
        from ..models import model_api
        from ..realize.program import resolve_device
        from ..runtime.serve_loop import ModelWaveExecutor
        device = resolve_device(args.device)
        api = model_api(cfg)
        params = api.init_params(
            torch.Generator(device=device).manual_seed(args.seed), device)
        ex = ModelWaveExecutor(cfg, params, max_batch=args.max_batch,
                               max_seq=args.max_seq)
        t0 = time.time()
        rep = replay(trace, ex, mode="wave")
        rep.timing = "measured"
        print(f"[serve] measured replay in {time.time() - t0:.1f}s wall "
              f"on {device}")
        _print_section("serve_loop_measured", rep.summary(), {})
        sections.append(_section("serve_loop_measured", rep, {}))
        virt = next(s for s in sections if s["section"] == "serve_loop")
        ratio = rep.summary()["e2e_s"]["p99"] / virt["e2e_s"]["p99"]
        print(f"[serve] measured/virtual p99 e2e ratio: {ratio:.3g} "
              "(calibration factor for the nominal clock)")
    return sections


def _demo(args) -> None:
    from ..models import model_api
    from ..realize.program import resolve_device
    from ..runtime.serve_loop import Request, Server
    device = resolve_device(args.device)
    cfg = cli.model_config(args)
    api = model_api(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.init_params(gen, device)
    srv = Server(cfg, params, max_batch=args.max_batch,
                 max_seq=args.max_seq)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for i in range(args.requests):
        srv.submit(Request(
            rid=i,
            prompt=rng.integers(1, cfg.vocab, size=int(rng.integers(4, 32))
                                ).astype(np.int32),
            max_new=args.max_new))
    results = srv.run_until_empty()
    dt = time.time() - t0
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[serve] {len(results)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s) on {device}")
    for r in results[:4]:
        print(f"  rid={r.rid} latency={r.latency_s:.3f}s "
              f"tokens={r.tokens[:12].tolist()}...")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="traffic-replay SLO reports / interactive wave serving")
    cli.add_arch_args(ap, required=False, default="smollm-135m")
    ap.add_argument("--trace", default=None, metavar="SPEC",
                    help="traffic trace spec, e.g. 'poisson:rate=8,n=32,"
                    "plen=4..32,new=8..32' or 'diurnal:...,period=120,"
                    "peak=3' (see repro_torch.serve.trace.make_trace); "
                    "omits the trace -> interactive demo mode")
    ap.add_argument("--report", action="store_true",
                    help="print the full SLO report (implied by --out)")
    ap.add_argument("--measure", action="store_true",
                    help="also replay the trace against the model on "
                    "--device (wall clock; nondeterministic) to validate "
                    "the virtual-clock sections")
    ap.add_argument("--ckpt", default=None,
                    help="keep_mappings DSE checkpoint; its best record "
                    "becomes the realized-path service model (default: "
                    "inline Table-I quick screen)")
    cli.add_workload_args(ap, help_extra="Default: TF=tf-quick "
                          "(the realized path's co-explored workload).")
    ap.add_argument("--requests", type=int, default=8,
                    help="demo mode: synthetic request count")
    ap.add_argument("--max-new", type=int, default=16,
                    help="demo mode: decode budget per request")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (the demo, --measure): "
                    "'cuda' (default; the hand-written kernels) or 'cpu' "
                    "(the plain versions)")
    cli.add_out_arg(ap, what="SLO report JSONL (one line per section)")
    cli.add_seed_arg(ap)
    args = ap.parse_args(argv)

    if args.trace is None:
        if args.report or args.out or args.measure:
            raise SystemExit("--report/--out/--measure need --trace SPEC")
        _demo(args)
        return
    sections = _replay_trace(args)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("".join(json.dumps(s, sort_keys=True) + "\n"
                               for s in sections))
        print(f"[serve] report -> {out} ({len(sections)} sections)")


if __name__ == "__main__":
    main()
