"""The fp32 stiffness sweep of two checkouts of the repo, each member against its lone runs.

    python -m hot_tpu_torch.ab_batch_sweep --other DIR [--reps N]

DIR is another checkout (for example the parent commit, unpacked with
``git archive`` into a git-ignored directory). Each turn is a fresh process
that imports hot_tpu_torch from one checkout, in the order DIR, this, this,
DIR, and builds that checkout's kernels. A turn runs N times (default 3):
the twisting bar at 64^3 (ppc 8, fp32, block-Jacobi, dt 2e-3) at the 8
stiffnesses E = 1e6 * 2^(k/2), k = -4..3, 6 steps from rest as one batch
(chip_smoke.py's phase batch), then each member alone twice. Per run and
member: the batch's and the lone runs' (newton, cg) per step, the largest
|x_batch - x_alone| / dx against the first lone run, the two lone runs'
largest difference, and whether the one-run check holds (Newton equal to
the first lone run, CG within 2, x within 1e-4 dx). Prints the card's name
and power limit, one JSON line per run, then one summary line per checkout.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SWEEP_E = [1e6 * 2.0 ** (k / 2) for k in range(-4, 4)]
RES, STEPS, DT, X_TOL, LONE_RUNS = 64, 6, 2e-3, 1e-4, 2
ORDER = (0, 1, 1, 0)                    # the other checkout, this, this, the other


def worker(root: str, reps: int):
    sys.path[0] = root                  # import hot_tpu_torch from that checkout
    import torch

    from hot_tpu_torch.models.constitutive import lame_parameters
    from hot_tpu_torch.ops import cuda_lib
    from hot_tpu_torch.scenes import build_scene
    from hot_tpu_torch.sim import Simulation
    from hot_tpu_torch.sim.state import stack_states

    cuda_lib.load()
    scene = build_scene("twisting_bar_3d", device="cuda", res=RES, ppc=8)
    cfg, base = scene["cfg"], scene["state"]

    def member(E):
        mu, lam = lame_parameters(E, 0.3)
        return base.replace(mu=torch.full_like(base.mu, mu), lam=torch.full_like(base.lam, lam))

    def run(state):
        sim = Simulation(cfg, state, scene["model"], scene["colliders"])
        stats, xs = [], []
        for _ in range(STEPS):
            stats.append(sim.step(DT))
            xs.append(sim.state.x)
        return stats, xs, sim.retry_count

    def diff(xa, xb):
        return max(float((a - b).abs().max()) for a, b in zip(xa, xb)) / cfg.dx

    for rep in range(reps):
        bstats, bxs, bretries = run(stack_states([member(E) for E in SWEEP_E]))
        rows = []
        for b, E in enumerate(SWEEP_E):
            lone = [run(member(E)) for _ in range(LONE_RUNS)]
            newton = [s.newton_iters[b] for s in bstats]
            cg = [s.cg_iters[b] for s in bstats]
            first = lone[0][0]
            x_diff = diff([x[b] for x in bxs], lone[0][1])
            holds = ([s.newton_iters for s in first] == newton and x_diff <= X_TOL
                     and all(abs(s.cg_iters - c) <= 2 for s, c in zip(first, cg)))
            rows.append(dict(member=b, E=E, newton=newton, cg=cg,
                             newton_alone=[[s.newton_iters for s in o[0]] for o in lone],
                             cg_alone=[[s.cg_iters for s in o[0]] for o in lone],
                             x_diff_over_dx=x_diff,
                             lone_spread_over_dx=diff(lone[0][1], lone[1][1]),
                             retries=[o[2] for o in lone], one_run_check=holds))
        print(json.dumps(dict(checkout=root, rep=rep, retries=bretries,
                              one_run_check=all(r["one_run_check"] for r in rows),
                              members=rows)), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout of the repo")
    ap.add_argument("--reps", type=int, default=3, help="sweeps per turn")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.reps)
        return 0
    if not args.other:
        ap.error("--other is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    roots = (str(Path(args.other).resolve()), str(HERE))
    runs = {r: [] for r in roots}
    for turn, i in enumerate(ORDER):
        out = subprocess.run([sys.executable, __file__, "--reps", str(args.reps), "--worker",
                              roots[i]], cwd=roots[i], capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            raise RuntimeError(f"turn {turn} ({roots[i]}) failed with {out.returncode}")
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                runs[roots[i]].append(json.loads(line))
    for root, rs in runs.items():
        members = [m for r in rs for m in r["members"]]
        print(json.dumps(dict(
            checkout=root, runs=len(rs),
            one_run_check_failed=sum(not r["one_run_check"] for r in rs),
            failing_members=sorted({m["member"] for m in members if not m["one_run_check"]}),
            max_x_diff_over_dx=max(m["x_diff_over_dx"] for m in members),
            max_lone_spread_over_dx=max(m["lone_spread_over_dx"] for m in members),
            newton_counts_of_lone_pairs_differ=sum(
                m["newton_alone"][0] != m["newton_alone"][1] for m in members))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
