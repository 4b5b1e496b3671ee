#!/usr/bin/env python3
"""``segment_replay`` of one tree beside another's: whether it gives the
same bits launch after launch, and its time a launch beside
``index_add_``.

Run from the root of a checkout, on a machine with an NVIDIA card and the
CUDA toolkit:

    python3 benchmarks/port_segment_replay.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is run
(default: this checkout's), so that two versions of the kernel, each
unpacked with ``git archive``, are held to the same inputs by the same
code: run it once a tree, parent, change, change, parent, in one session
on the card.  Each line is ``chip_smoke.replay_line`` at one of
``chip_smoke.cost_layouts()`` and one of ``chip_smoke.REPLAY_B``, the
line ``chip_smoke.py`` gates, here printed ungated with ``--label``
(``REPLAY_REPS`` launches and their distinct results, bit equality with
``np.bincount``, the kernel's time, ``index_add_``'s and the bound).
Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is run")
    ap.add_argument("--label", default="", help="printed on every line")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    for layout, arch, g, batch in chip_smoke.cost_layouts():
        for B in chip_smoke.REPLAY_B:
            line = chip_smoke.replay_line(dev, layout, arch, g, batch, B)
            print(json.dumps({"label": args.label, **line}), flush=True)
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
