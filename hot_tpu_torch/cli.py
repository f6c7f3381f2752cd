"""Command-line driver: scene, solver overrides, frame loop, output.

    python -m hot_tpu_torch --scene twisting_bar_3d --frames 24 -o runs/twist \
        --scene-arg res=64 --scene-arg ppc=8 --set solver.cn_eps=1e-3

Runs on the GPU (``--device cuda``, the default); it refuses to start when
no GPU is present unless ``--device cpu`` is given. Writes config.json,
metrics.jsonl (one record per step), timers.txt and one .npz per frame
(x, v) into the run directory.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
import time


def _parse_value(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _pairs(items):
    out = {}
    for item in items:
        k, _, v = item.partition("=")
        out[k] = _parse_value(v)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hot_tpu_torch",
                                description="Implicit MPM (HOT-class solver) on PyTorch/CUDA")
    p.add_argument("--scene", help="scene name (see --list-scenes)")
    p.add_argument("--list-scenes", action="store_true")
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("-o", "--output", default=None, help="run directory")
    p.add_argument("--set", action="append", default=[], metavar="PATH=VALUE",
                   help="config override, e.g. solver.cn_eps=1e-3 (repeatable)")
    p.add_argument("--scene-arg", action="append", default=[], metavar="KEY=VALUE",
                   help="scene builder argument, e.g. res=64 (repeatable)")
    p.add_argument("--max-steps", type=int, default=0, help="stop after N steps (0 = off)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--f64", action="store_true", help="simulate in float64")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from hot_tpu_torch.scenes import SCENES, build_scene
    from hot_tpu_torch.sim import Simulation
    from hot_tpu_torch.utils.config import config_from_overrides
    from hot_tpu_torch.utils.metrics import MetricsLogger

    if args.list_scenes:
        for name in sorted(SCENES):
            print(name)
        return 0
    if args.scene is None:
        raise SystemExit("--scene is required")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")

    scene_kwargs = _pairs(args.scene_arg)
    if args.f64:
        scene_kwargs["dtype"] = torch.float64
    scene = build_scene(args.scene, device=device, **scene_kwargs)
    cfg = config_from_overrides(scene["cfg"], _pairs(args.set))

    out_dir = args.output or os.path.join("runs", f"{args.scene}-{int(time.time())}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        fh.write(cfg.to_json())
    metrics = MetricsLogger(os.path.join(out_dir, "metrics.jsonl"), echo=not args.quiet)
    sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"],
                     plasticity=scene["plasticity"], metrics=metrics)
    print(f"scene={args.scene} particles={sim.state.n} grid={cfg.grid_res} "
          f"device={device} precond={cfg.solver.preconditioner}", flush=True)

    try:
        for frame in range(args.frames):
            t0 = time.perf_counter()
            sim.advance_frame(max_steps=args.max_steps)
            np.savez_compressed(os.path.join(out_dir, f"frame_{frame:05d}.npz"),
                                x=sim.state.x.cpu().numpy(), v=sim.state.v.cpu().numpy())
            if not args.quiet:
                print(f"frame {frame}: t={sim.t:.4f} steps={sim.step_count} "
                      f"({time.perf_counter() - t0:.2f}s)", flush=True)
            if args.max_steps and sim.step_count >= args.max_steps:
                break
        with open(os.path.join(out_dir, "timers.txt"), "w") as fh:
            fh.write(sim.timer.report())
    finally:
        metrics.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
