"""The comparison on other particle placements: a cell run with the
lattice's jitter drawn from each seed, in place of the configuration's
fixed jitter, and judged as every run is.

    python3 portbench/placements.py --workload bar128-mg.twist --seeds 21,22,23 --seconds 1

prints one result line per seed (its checks, its window with the Newton
and CG counts). A fault that depends on where the particles lie, and not
on the order of the sums that the run's seed draws, shows here. Its
readings stand beside the limits in PERF.md; the benchmark's own runs do
not run it.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import cells, harness  # noqa: E402


def placed(resolved: dict, seed: int) -> dict:
    """The resolved cell with its scene's jitter drawn from `seed`."""
    out = copy.deepcopy(resolved)
    out["config"]["scene"]["jitter_seed"] = int(seed)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench placements: no CUDA device", file=sys.stderr)
        return 2
    resolved = cells.resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(placed(resolved, seed), seed, args.seconds, False,
                               torch.device("cuda", 0), time.perf_counter())
        print(json.dumps({"seed": seed, "correct": out["correct"], "failed": out["failed"],
                          "checks": out["checks"], "window": out["window"],
                          "setup_s": out["metrics"]["setup_s"]["value"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
