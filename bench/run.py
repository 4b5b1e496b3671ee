"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
limits and metrics are found by name from ``BENCHMARK.json``
(``bench/lib/harness.py``).  The last line of standard output is the
result as one JSON object; the numbers compared with their limits are the
last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "bench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    return harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                            T_START)


if __name__ == "__main__":
    sys.exit(main())
