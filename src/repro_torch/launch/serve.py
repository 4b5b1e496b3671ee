"""Serving launcher: the interactive wave demo.

Port of ``src/repro/launch/serve.py``'s demo mode: submits synthetic
requests through the ``Server`` shim and prints per-request latencies.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b

runs on the card (``--device cuda``, the default, which raises without
one); ``--device cpu --reduced`` runs the plain versions on the CPU.  The
trace-replay SLO reports (``--trace``, ``--report``, ``--out``,
``--measure``, ``--ckpt``) come with slice 4b of the port and are refused.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from . import cli

SLICE_4B = ("the trace-replay SLO reports (--trace, --report, --out, "
            "--measure, --ckpt) are not ported yet; they come with slice 4b "
            "of the port")


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
    ap = argparse.ArgumentParser(description="interactive wave serving")
    cli.add_arch_args(ap, required=False, default="smollm-135m")
    ap.add_argument("--trace", default=None, metavar="SPEC",
                    help="traffic trace spec (slice 4b: refused)")
    ap.add_argument("--report", action="store_true",
                    help="SLO report (slice 4b: refused)")
    ap.add_argument("--measure", action="store_true",
                    help="measured trace replay (slice 4b: refused)")
    ap.add_argument("--ckpt", default=None,
                    help="DSE checkpoint of the realized path (slice 4b: "
                    "refused)")
    ap.add_argument("--requests", type=int, default=8,
                    help="synthetic request count")
    ap.add_argument("--max-new", type=int, default=16,
                    help="decode budget per request")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; the hand-written kernels) or "
                    "'cpu' (the plain versions)")
    cli.add_out_arg(ap, what="SLO report JSONL (slice 4b: refused)")
    cli.add_seed_arg(ap)
    args = ap.parse_args(argv)
    if args.trace or args.report or args.out or args.measure or args.ckpt:
        raise SystemExit(SLICE_4B)
    _demo(args)


if __name__ == "__main__":
    main()
