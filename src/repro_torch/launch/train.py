"""Training launcher.

Port of ``src/repro/launch/train.py``, plus ``--device``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 200 --batch 8 --seq 256 --ckpt-dir results/ck [--reduced]

Trains on one device, the card by default (it raises without one);
``--device cpu`` runs on the CPU.  Fault tolerance: resumes from the
latest checkpoint in --ckpt-dir automatically.
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
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="results/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant of the arch")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    tcfg = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, log_every=10,
                       opt=AdamWConfig(lr=args.lr, warmup_steps=20,
                                       total_steps=args.steps))
    trainer = Trainer(cfg, data, tcfg, device=args.device)
    out = trainer.run(resume=not args.no_resume)
    print(f"[train] done: final loss {out['losses'][-1]:.4f}, "
          f"slow steps {out['slow_steps']}")
    return out


if __name__ == "__main__":
    main()
