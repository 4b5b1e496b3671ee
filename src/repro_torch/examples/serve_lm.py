"""Batched serving example: wave-based batching of mixed-length requests
against a reduced qwen3-0.6b (qk-norm GQA decoder) by default.

Port of ``examples/serve_lm.py``.  Runs on the card unless asked for the
CPU:

  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch zamba2-1.2b

``--arch NAME`` serves that config at full size (``--reduced`` for its
CPU variant); without ``--arch`` the reduced qwen3-0.6b.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..launch import cli
from ..models import model_api
from ..realize.program import resolve_device
from ..runtime.serve_loop import Request, Server


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_arch_args(ap, required=False)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; the hand-written kernels) or "
                    "'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("qwen3-0.6b").reduced() if args.arch is None \
        else cli.model_config(args)
    api = model_api(cfg)
    params = api.init_params(torch.Generator(device=device).manual_seed(0),
                             device)
    srv = Server(cfg, params, max_batch=4, max_seq=256)

    rng = np.random.default_rng(0)
    n_req = 10
    t0 = time.time()
    for i in range(n_req):
        srv.submit(Request(
            rid=i,
            prompt=rng.integers(1, cfg.vocab, size=int(rng.integers(4, 48)))
            .astype(np.int32),
            max_new=24))
    results = srv.run_until_empty()
    dt = time.time() - t0
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[serve] {cfg.name}: {len(results)} requests -> {n_tok} tokens "
          f"in {dt:.1f}s ({n_tok / dt:.1f} tok/s on {device})")
    for r in results[:5]:
        print(f"  rid={r.rid:2d} new_tokens={len(r.tokens):3d} "
              f"head={r.tokens[:8].tolist()}")


if __name__ == "__main__":
    main()
