"""Readings of the comparison's control: the reference put in the program's
place, in TF32 (``reference/control.py``), judged by the same numbers as the
program (``reference/judge.py``), on the cell's own inputs and steps.

    python3 portbench/control.py --workload bar128-bj.twist --seeds 11,12,13

prints one JSON line per seed with the numbers, the control's Newton and CG
counts per step, and its seconds. ``--arith fp32`` runs the same reference
in float32 with no rounding, the precision the configuration states. It
loads nothing of the program; the benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import cells, scene  # noqa: E402
from portbench.reference import control, judge, mpm  # noqa: E402



def inputs(config: dict, seed: int, device):
    """The cell's initial particles and material, as the benchmark makes
    them (``scene.particles``), for the first member of the mix."""
    sc = config["scene"]
    dtype = getattr(torch, config["dtype"])
    x, vol = scene.particles(config, seed, device)
    n = x.shape[0]
    mu, lam = scene.lame(sc["E"], sc["nu"])
    full = lambda value: torch.full((n,), value, dtype=dtype, device=device)  # noqa: E731
    state = {"x": x, "v": torch.zeros_like(x),
             "Cf": torch.zeros((n, 9), dtype=dtype, device=device),
             "Ff": torch.eye(3, dtype=dtype, device=device).reshape(1, 9).expand(n, 9).clone()}
    material = {"m": full(sc["density"] * vol), "V0": full(vol), "mu": full(mu), "lam": full(lam)}
    return state, material


SOLVER_KEYS = ("max_newton", "cn_eps", "cg_tol", "max_cg")


def solver_of(config: dict) -> dict:
    """The Newton and CG settings the configuration runs, read from its
    overrides, which state each of them."""
    return {k: config["overrides"][f"solver.{k}"] for k in SOLVER_KEYS}


def readings(config: dict, traffic: dict, seed: int, device, arith: str = "tf32") -> dict:
    """The control's numbers over the mix's loading steps and one segment."""
    t0 = time.perf_counter()
    state, material = inputs(config, seed, device)
    start = {k: v.to("cpu") for k, v in state.items()}
    sc = mpm.scene_from(config["scene"], material, device, state["x"].dtype)
    ar = mpm.Arith(torch.float32, tf32=True) if arith == "tf32" else mpm.Arith(state["x"].dtype)
    records, stats = [], []
    for _ in range(traffic["loading_steps"] + traffic["segment_steps"]):
        rec, st = control.control_step(sc, state, traffic["dt"], solver_of(config), ar)
        state = rec["out"]
        records.append({**rec, "node_pos": rec["node_pos"].cpu(), "v_star": rec["v_star"].cpu(),
                        "v_new": rec["v_new"].cpu(),
                        "out": {k: v.cpu() for k, v in rec["out"].items()}})
        stats.append(st)
    del state
    step_s = time.perf_counter() - t0
    sc64 = mpm.scene_from(config["scene"], material, device, torch.float64)
    got = judge.judge(sc64, start, records, len(records), device)
    return {"seed": seed, "arith": arith, "numbers": got["numbers"],
            "per_step": got["per_step"], "solver": stats, "step_seconds": step_s,
            "judge_seconds": time.perf_counter() - t0 - step_s}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--arith", choices=("tf32", "fp32"), default="tf32")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    resolved = cells.resolve(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(resolved["config"], resolved["traffic"], seed, device,
                                  args.arith)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
