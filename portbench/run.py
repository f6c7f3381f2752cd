"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload bar128-bj.twist --seed 7 --seconds 30 --trace 0

from the root of a checkout. See portbench/README.md.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
