"""Command-line driver: scene, solver overrides, frame loop, output.

    python -m hot_tpu_torch --scene twisting_bar_3d --frames 24 -o runs/twist \
        --scene-arg res=64 --scene-arg ppc=8 --set solver.cn_eps=1e-3 \
        --set transfer_kernel=cubic --model neo_hookean

Runs on the GPU (``--device cuda``, the default); it refuses to start when
no GPU is present unless ``--device cpu`` is given. Writes config.json,
metrics.jsonl (one record per step), timers.txt (the tracer's spans per
name: count, total, self and device ms, and its counters; the spans are
folded into these totals after every frame), one render frame per frame
(``--frame-format``: bgeo, the default, ply or npz; frame_NNNNN.<format>)
and a checkpoint every ``--checkpoint-every`` frames (ckpt_NNNNN.npz) into
the run directory. ``--resume ckpt_NNNNN.npz`` continues a run from a
checkpoint: it starts at the frame after the checkpoint's time and repeats
the uninterrupted run's frames (bit for bit on the CPU).

A device mesh (``--set mesh.shape="(-1,)"``, any shape but (1,)) runs the
sharded step (``parallel.ShardedSimulation``), one process per rank, as
``torchrun`` starts them:

    torchrun --standalone --nproc-per-node 4 -m hot_tpu_torch \
        --scene stacked_boxes_3d --set mesh.shape="(-1,)" -o runs/boxes

NCCL with one rank per GPU on cuda (more local ranks than visible GPUs
raise before any step), gloo on the CPU. Rank 0 prints, writes the frames
(the particles gathered in their original order) and the metrics; a
checkpoint is a directory ckpt_NNNNN/ of one shard_pNNNN.npz per rank, and
``--resume`` takes such a directory.
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
    p.add_argument("--resume", default=None, help="checkpoint .npz to resume from")
    p.add_argument("--frame-format", default="bgeo", choices=["bgeo", "ply", "npz"],
                   help="render frame format (bgeo: partio's classic Houdini format)")
    p.add_argument("--checkpoint-every", type=int, default=1, metavar="FRAMES",
                   help="write a checkpoint every N frames (0 = never)")
    p.add_argument("--max-steps", type=int, default=0,
                   help="stop after the frame in which the step count reaches N (0 = off)")
    p.add_argument("--model", default=None,
                   choices=["fixed_corotated", "stvk_hencky", "neo_hookean", "linear_corotated"],
                   help="constitutive model in place of the scene's")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--f64", action="store_true", help="simulate in float64")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from hot_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint, save_frame
    from hot_tpu_torch.models.constitutive import MODEL_REGISTRY
    from hot_tpu_torch.scenes import SCENES, build_scene
    from hot_tpu_torch.sim import Simulation
    from hot_tpu_torch.utils.config import config_from_overrides
    from hot_tpu_torch.utils.metrics import MetricsLogger
    from hot_tpu_torch.utils.timing import TRACER

    if args.list_scenes:
        for name in sorted(SCENES):
            print(name)
        return 0
    if args.scene is None:
        raise SystemExit("--scene is required")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")

    overrides = _pairs(args.set)
    sharded = tuple(overrides.get("mesh.shape", (1,))) != (1,)
    rank = 0
    if sharded:
        # before anything touches the GPU: this process's device, or the
        # refusal of more ranks than GPUs
        from hot_tpu_torch.parallel import distributed
        from hot_tpu_torch.parallel.sharded_step import ShardedSimulation

        mesh = distributed.initialize(device)
        rank = mesh.rank
    scene_kwargs = _pairs(args.scene_arg)
    if args.f64:
        scene_kwargs["dtype"] = torch.float64
    scene = build_scene(args.scene, device=device, **scene_kwargs)
    cfg = config_from_overrides(scene["cfg"], overrides)

    out_dir = args.output or os.path.join("runs", f"{args.scene}-{int(time.time())}")
    os.makedirs(out_dir, exist_ok=True)
    if rank == 0:
        with open(os.path.join(out_dir, "config.json"), "w") as fh:
            fh.write(cfg.to_json())
    metrics = (MetricsLogger(os.path.join(out_dir, "metrics.jsonl"), echo=not args.quiet)
               if rank == 0 else MetricsLogger())
    model = MODEL_REGISTRY[args.model] if args.model else scene["model"]
    if sharded:
        mesh = distributed.mesh_from_config(cfg.mesh, mesh)
        if device.type == "cuda":
            _build_kernels_once(mesh)
        sim = ShardedSimulation(mesh, cfg, scene["state"], model, scene["colliders"],
                                plasticity=scene["plasticity"],
                                metrics=metrics)
    else:
        sim = Simulation(cfg, scene["state"], model, scene["colliders"],
                         plasticity=scene["plasticity"], metrics=metrics)
    start_frame = 0
    if args.resume:
        if sharded:
            sim.restore(args.resume)
        else:
            sim.state, sim.t, sim.step_count = load_checkpoint(
                args.resume, device=device, dtype=scene["state"].x.dtype)
        start_frame = int(sim.t / cfg.frame_dt + 0.5)
        if rank == 0:
            print(f"resumed from {args.resume} at t={sim.t:.4f} (frame {start_frame})")
    if rank == 0:
        mesh_note = f" mesh={sim.mesh.size} ranks ({sim.mesh.backend})" if sharded else ""
        print(f"scene={args.scene} particles={scene['state'].n} grid={cfg.grid_res} "
              f"device={device} model={model.name} precond={cfg.solver.preconditioner}"
              f"{mesh_note}", flush=True)

    TRACER.enable()
    try:
        for frame in range(start_frame, args.frames):
            t0 = time.perf_counter()
            sim.advance_frame()
            TRACER.fold()
            state = sim.state          # on a mesh, every rank takes part in the gather
            if rank == 0:
                save_frame(os.path.join(out_dir, f"frame_{frame:05d}.{args.frame_format}"),
                           state)
            if args.checkpoint_every and (frame + 1) % args.checkpoint_every == 0:
                path = os.path.join(out_dir, f"ckpt_{frame:05d}")
                if sharded:
                    sim.save_checkpoint(path)
                else:
                    save_checkpoint(path + ".npz", state, sim.t, sim.step_count)
            if not args.quiet and rank == 0:
                print(f"frame {frame}: t={sim.t:.4f} steps={sim.step_count} "
                      f"({time.perf_counter() - t0:.2f}s)", flush=True)
            if args.max_steps and sim.step_count >= args.max_steps:
                break
        if rank == 0:
            with open(os.path.join(out_dir, "timers.txt"), "w") as fh:
                fh.write(TRACER.report())
    finally:
        TRACER.disable()
        metrics.close()
    return 0


def _build_kernels_once(mesh):
    """Rank 0 builds the CUDA library while the others wait, so that the
    ranks of a cold start do not run one nvcc build each."""
    import torch.distributed as dist

    from hot_tpu_torch.ops import cuda_lib

    if mesh.rank == 0:
        cuda_lib.load()
    dist.barrier(group=mesh.group)
    cuda_lib.load()


if __name__ == "__main__":
    sys.exit(main())
