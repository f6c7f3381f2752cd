"""The 64^3 main path of two checkouts of the repo in alternating turns on one GPU.

    python -m hot_tpu_torch.ab_main_path --other DIR [--cubic]

DIR is another checkout (for example the parent commit, unpacked with
``git archive`` into a git-ignored directory). Each turn is a fresh process
that imports hot_tpu_torch from one checkout, in the order DIR, this, this,
DIR; builds that checkout's kernels; runs the twisting bar at 64^3 (ppc 8,
dt 2e-3, fp32, block-Jacobi: chip_smoke.py's phase main) for 12 steps from
rest once to warm up, then 5 times from rest, timed: steps/s,
(newton, cg), the particle kernels' launches, peak device memory. With
--cubic the turns of this checkout also time the same bar with cubic
transfers. Prints the card's name and power limit, one JSON line per timed
run, then one summary line per checkout and path (min, median, max steps/s).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
STEPS, DT, REPS = 12, 2e-3, 5
ORDER = (0, 1, 1, 0)                    # the other checkout, this, this, the other


def worker(root: str, cubic: bool):
    sys.path[0] = root                  # import hot_tpu_torch from that checkout
    import torch

    from hot_tpu_torch.ops import cuda_lib
    from hot_tpu_torch.ops import fused_apply as fa
    from hot_tpu_torch.ops import fused_linearize as fl
    from hot_tpu_torch.scenes import build_scene
    from hot_tpu_torch.sim import Simulation
    from hot_tpu_torch.utils import timing
    from hot_tpu_torch.utils.config import config_from_overrides

    def launches():
        """The particle kernels' launches so far: the tracer's counters, or
        the module counters of a checkout from before the tracer."""
        tracer = getattr(timing, "TRACER", None)
        if tracer is None:
            return {"fused_apply": fa.launches, "fused_linearize": fl.launches}
        return {k: tracer.counts["launches." + k] for k in ("fused_apply", "fused_linearize")}

    assert Path(fa.__file__).resolve().is_relative_to(Path(root).resolve()), fa.__file__
    cuda_lib.load()

    def run(overrides):
        scene = build_scene("twisting_bar_3d", device="cuda", res=64, ppc=8)
        cfg = config_from_overrides(scene["cfg"], overrides)
        sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
        torch.cuda.reset_peak_memory_stats()
        before = launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = [sim.step(DT) for _ in range(STEPS)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        assert all(s.converged for s in stats) and sim.retry_count == 0, stats
        return dict(steps=STEPS, seconds=seconds, steps_per_s=STEPS / seconds,
                    newton=[s.newton_iters for s in stats], cg=[s.cg_iters for s in stats],
                    launches={k: v - before[k] for k, v in launches().items()},
                    max_memory_allocated=torch.cuda.max_memory_allocated())

    paths = {"quadratic": {}}
    if cubic:
        paths["cubic"] = {"transfer_kernel": "cubic"}
    for overrides in paths.values():
        run(overrides)                  # warm-up: cuBLAS handles, allocator, kernels
    for rep in range(REPS):
        for path, overrides in paths.items():
            print(json.dumps(dict(root=root, path=path, rep=rep, **run(overrides))), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--cubic", action="store_true")
    ap.add_argument("--worker", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.cubic)
        return 0
    if not args.other:
        ap.error("--other is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    roots = [str(Path(args.other).resolve()), str(HERE)]
    rows = []
    for turn, root in enumerate(roots[i] for i in ORDER):
        cmd = [sys.executable, __file__, "--worker", root]
        if args.cubic and root == str(HERE):
            cmd.append("--cubic")
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            raise RuntimeError(f"turn {turn} ({root}) failed with {out.returncode}")
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                row = dict(json.loads(line), turn=turn)
                rows.append(row)
                print(json.dumps(row), flush=True)
    for root in roots:
        for path in ("quadratic", "cubic"):
            rates = [r["steps_per_s"] for r in rows if r["root"] == root and r["path"] == path]
            if rates:
                print(json.dumps(dict(summary=True, card=card, root=root, path=path,
                                      runs=len(rates), min=min(rates),
                                      median=statistics.median(rates), max=max(rates))),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
