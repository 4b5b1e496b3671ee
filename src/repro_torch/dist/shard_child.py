"""``python -m repro_torch.dist.shard_child`` — one supervised shard.

The supervisor launches this module through a
:class:`~repro_torch.dist.hosts.Host` with an explicit candidate-index list
(screening already happened upstream) and a dedicated checkpoint path.
Fault hooks install FIRST, before any sweep machinery is touched, so an
armed chaos fault governs the entire run.

Exit code 0 means the child believes its checkpoint is complete; the
supervisor re-verifies against the engine's resume gate either way (a
lying or killed child is indistinguishable from a crashed one, and both
are handled by retry/re-shard).

Copy of ``src/repro/dist/shard_child.py``.  The child imports the numpy
engine only; where the spec's SA scores on ``backend="fused"`` the
engine imports torch and the ``fused_eval`` wrapper at its first fused
batch, after the hooks are armed, and a machine without a card fails
there, naming ``fused_device`` (there is no numpy fallback).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    # arm the chaos fault before importing anything that could be hooked
    from .faults import install_fault_hooks
    spec_armed = install_fault_hooks()

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--spec", required=True,
                    help="path to the supervisor's spec.json")
    ap.add_argument("--indices", required=True,
                    help="comma-separated global candidate indices")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--shard-label", default=None)
    ap.add_argument("--n-workers", type=int, default=1)
    args = ap.parse_args(argv)

    from ..core.dse import run_dse
    from .supervisor import SweepSpec

    spec = SweepSpec.from_json(Path(args.spec).read_text())
    indices = [int(i) for i in args.indices.split(",") if i.strip()]
    if spec_armed is not None:
        print(f"[shard_child] fault armed: {spec_armed.encode()}",
              file=sys.stderr)
    if not indices:
        return 0
    pts = run_dse(spec.build_candidates(), spec.build_workloads(),
                  spec.build_cfg(), use_sa=spec.use_sa,
                  n_workers=args.n_workers, checkpoint=args.checkpoint,
                  indices=indices, shard_label=args.shard_label)
    print(json.dumps({"shard": args.shard_label, "n_points": len(pts)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
