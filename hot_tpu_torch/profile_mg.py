"""Where a config-3 step's time goes on the GPU.

    python -m hot_tpu_torch.profile_mg [--res 64 128]

For each resolution (twisting bar, ppc 8, fp32, dt 2e-3, config 3 =
assembled Galerkin multigrid, 4 levels, Chebyshev, direct coarse solve):
2 warm steps, then 2 steps with synchronised wall timers around each build
piece (assembly, RAP, smoother data, coarse factor, the whole build, the
V-cycle, the static hierarchy), then torch.profiler over one step: the top
entries by self device time (a kernel's time shows under its own name and
again under the op that launched it, so the entries do not add up). Prints
one JSON line per measurement. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import torch

from hot_tpu_torch.ops import bsr as bsr_mod
from hot_tpu_torch.ops import spgemm
from hot_tpu_torch.scenes import build_scene
from hot_tpu_torch.sim import Simulation
from hot_tpu_torch.solver import multigrid as mg
from hot_tpu_torch.utils.config import config_from_overrides

CONFIG3 = {"solver.preconditioner": "multigrid", "solver.multigrid.levels": 4,
           "solver.multigrid.smoother": "chebyshev", "solver.multigrid.coarse_solver": "direct",
           "solver.multigrid.assembled": True}
PIECES = ((bsr_mod, "assemble_hessian", "assemble"), (spgemm, "rap", "rap"),
          (mg, "_level_smoother_data", "smoother_data"),
          (mg, "_dense_factor_from_mat", "coarse_factor"), (mg, "build_precond", "build_precond"),
          (mg, "mg_precondition", "vcycle"), (mg, "build_static", "build_static"))


def run_steps(sim, steps, dt=2e-3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = [sim.step(dt) for _ in range(steps)]
    torch.cuda.synchronize()
    return stats, time.perf_counter() - t0


def timed_pieces(sim):
    """Seconds and calls per build piece over 2 synchronised steps."""
    acc = collections.defaultdict(lambda: [0.0, 0])
    originals = []
    for mod, name, label in PIECES:
        fn = getattr(mod, name)
        originals.append((mod, name, fn))

        def wrapped(*args, _fn=fn, _label=label, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            acc[_label][0] += time.perf_counter() - t0
            acc[_label][1] += 1
            return out

        setattr(mod, name, wrapped)
    try:
        stats, seconds = run_steps(sim, 2)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    return stats, seconds, dict(acc)


def main(argv=None):
    p = argparse.ArgumentParser(prog="hot_tpu_torch.profile_mg")
    p.add_argument("--res", type=int, nargs="+", default=[64, 128])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_mg needs a CUDA device", file=sys.stderr)
        return 1
    for res in args.res:
        sc = build_scene("twisting_bar_3d", device="cuda", res=res, ppc=8)
        sim = Simulation(config_from_overrides(sc["cfg"], CONFIG3), sc["state"], sc["model"],
                         sc["colliders"])
        run_steps(sim, 2)
        stats, seconds, pieces = timed_pieces(sim)
        print(json.dumps({"res": res, "synced_steps_s": seconds,
                          "newton": [s.newton_iters for s in stats],
                          "cg": [s.cg_iters for s in stats], "pieces_s_calls": pieces}),
              flush=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            stats, seconds = run_steps(sim, 1)
        ka = prof.key_averages()
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:15]
        print(json.dumps({"res": res, "profiled_step_s": seconds,
                          "newton": stats[0].newton_iters, "cg": stats[0].cg_iters,
                          "top_self_device_ms": [(e.key[:70], e.self_device_time_total / 1e3,
                                                  e.count) for e in top]}), flush=True)
        del sim
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
