"""End-to-end driver: train the ~135M-param smollm-135m on the synthetic
packed-LM pipeline, with checkpointing and the straggler watchdog.

Port of ``examples/train_lm.py``: the full-size config (not reduced) at
batch 4, on the card unless asked for the CPU.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
  PYTHONPATH=src python -m repro_torch.examples.train_lm --small \
      --device cpu

(``--small`` trains a 4-layer variant without remat at sequence <= 128.)
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

from ..configs import get_config
from ..data.pipeline import DataConfig
from ..optim.adamw import AdamWConfig
from ..runtime.train_loop import TrainConfig, Trainer


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--small", action="store_true",
                    help="4-layer variant (fast demo)")
    ap.add_argument("--ckpt-dir", default="results/train_lm")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-135m")
    if args.small:
        cfg = cfg.replace(n_layers=4, remat=False)
        args.seq = min(args.seq, 128)
    print(f"[train_lm] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.steps} steps x batch {args.batch} x seq {args.seq}")

    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    tcfg = TrainConfig(
        steps=args.steps, ckpt_every=max(20, args.steps // 5),
        ckpt_dir=args.ckpt_dir, log_every=10,
        opt=AdamWConfig(lr=6e-4, warmup_steps=args.steps // 10,
                        total_steps=args.steps))
    out = Trainer(cfg, data, tcfg, device=args.device).run(resume=True)
    first = sum(out["losses"][:10]) / max(1, len(out["losses"][:10]))
    last = sum(out["losses"][-10:]) / max(1, len(out["losses"][-10:]))
    print(f"[train_lm] loss {first:.3f} -> {last:.3f} over "
          f"{len(out['losses'])} steps; straggler events: "
          f"{out['slow_steps']}")
    return out


if __name__ == "__main__":
    main()
