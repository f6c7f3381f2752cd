#!/usr/bin/env python3
"""Smoke run of hot_tpu_torch on one NVIDIA GPU (run from the repo root).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1 env       nvidia-smi name and power limit, torch/CUDA/nvcc versions
  2 build     nvcc build of hot_tpu_torch/csrc (time, ptxas registers/spills)
  3 kernels   each CUDA kernel against its plain PyTorch version on the card:
              64^3 twisting bar (both models, F perturbed by seeded noise) and
              a 64^2 block drop, in fp32 and fp64; errors and CUDA-event times
  4 main      Simulation.step x12 at 64^3 (ppc 8, dt 2e-3, fp32): finite,
              converged, and the kernels' launch counters equal
              sum(newton + 1) and sum(cg + newton)
  5 cpu       3 steps at 32^3 (ppc 4) on the card (fp32) and on the CPU
              (plain versions, fp64) from one state
  6 scale     2 steps at 128^3 (ppc 8): steps/s and peak device memory
Then the kernels' summary and, last, {"ok": true, "device": {...}}.
Any failure raises and exits non-zero; it needs a CUDA device and exits
non-zero without one.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances are relative to the largest entry of the plain result. The
# kernel and the plain version round differently (FMA contraction, atomic
# order); both kernels are compared on the same inputs, so the apply sees no
# difference carried over from the linearize. Measured on an H100 at 64^3:
# fp32 at most 4.4e-6 (StVK-Hencky b-), fp64 below 1e-14.
TOL = {torch.float32: {"linearize": 2e-5, "apply": 2e-5},
       torch.float64: {"linearize": 1e-10, "apply": 1e-10}}
# card (fp32) against CPU (fp64), 32^3: positions within X_TOL * dx. One fp32
# rounding of x ~ 0.5 is 2e-6 dx at dx = 1/32, and that is what the card
# showed after 3 steps (3.1e-6 dx); 1e-4 dx leaves room for CG stopping an
# iteration apart (a change of ~1e-3 of one Newton update).
X_TOL = 1e-4
DT = 2e-3


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want):
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-300)


def kernel_inputs(scene_name, model_name, dtype, rng, res):
    from hot_tpu_torch.models.constitutive import MODEL_REGISTRY
    from hot_tpu_torch.ops import transfer
    from hot_tpu_torch.scenes import build_scene

    kw = dict(res=res, ppc=8) if scene_name == "twisting_bar_3d" else dict(res=res)
    state = build_scene(scene_name, device="cuda", dtype=dtype, **kw)["state"]
    d = state.dim
    n = state.n
    F = state.F + torch.as_tensor(0.1 * rng.standard_normal((n, d, d)), dtype=dtype,
                                  device="cuda")
    st = transfer.particle_stencil(state.x, 1.0 / res, (res,) * d)
    n_nodes = res ** d
    s = st.wn.shape[1]
    v = torch.as_tensor(rng.standard_normal((n_nodes, d)), dtype=dtype, device="cuda")
    w = torch.as_tensor(rng.standard_normal((n_nodes, d)), dtype=dtype, device="cuda")
    return dict(
        model=MODEL_REGISTRY[model_name], v=v, w=w, F=F,
        ids=st.node_ids.T.to(torch.int32).contiguous(),
        gwn=st.gwn.reshape(n, s * d).T.contiguous(),
        F_soa=F.reshape(n, d * d).T.contiguous(),
        mu=state.mu, lam=state.lam, V0=state.V0, st=st, n=n, d=d)


def check_kernels(case, timing):
    """Both kernels against their plain versions on one input set."""
    from hot_tpu_torch.ops import fused_apply as fa
    from hot_tpu_torch.ops import fused_linearize as fl
    from hot_tpu_torch.ops import transfer

    c = case
    d, dtype = c["d"], c["v"].dtype
    lin_args = (c["v"], c["ids"], c["gwn"], c["F_soa"], c["mu"], c["lam"], c["V0"], DT, c["model"])
    got = fl.fused_linearize_cuda(*lin_args)
    want = fl.fused_linearize_plain(*lin_args)
    out = {}
    for name, g, w in zip(("f", "A", "b_plus", "b_minus"), (got[0], got[3], got[4], got[5]),
                          (want[0], want[3], want[4], want[5])):
        out[f"lin_{name}"] = rel_err(g, w)
    # the kernel's SVD is valid: orthogonal U, V with det +1, and U^T F_new V
    # diagonal (U, V may differ from the plain SVD by paired column signs)
    U = got[1].T.reshape(-1, d, d)
    V = got[2].T.reshape(-1, d, d)
    eye = torch.eye(d, dtype=dtype, device="cuda")
    F_new = (eye + DT * transfer.velocity_gradient(c["st"], c["v"])) @ c["F"]
    S = U.transpose(1, 2) @ F_new @ V
    off = S - torch.diag_embed(torch.diagonal(S, dim1=1, dim2=2))
    out["svd_offdiag"] = (float(off.abs().max()), float(off.abs().max() / F_new.abs().max()))
    out["orth_UV"] = (float(max((U.transpose(1, 2) @ U - eye).abs().max(),
                                (V.transpose(1, 2) @ V - eye).abs().max())),) * 2
    out["det_UV"] = (float(max((torch.linalg.det(U) - 1).abs().max(),
                               (torch.linalg.det(V) - 1).abs().max())),) * 2
    ctx = want[1:]
    apply_args = (c["w"], c["ids"], c["gwn"], c["F_soa"], *ctx, c["V0"], DT)
    out["apply_df"] = rel_err(fa.fused_apply_cuda(*apply_args), fa.fused_apply_plain(*apply_args))

    tol = TOL[dtype]
    limits = {k: tol["apply"] if k == "apply_df" else tol["linearize"] for k in out}
    # SVD identities hold to the working precision times a small factor
    eps = torch.finfo(dtype).eps
    limits.update(svd_offdiag=200 * eps, orth_UV=50 * eps, det_UV=50 * eps)
    bad = {k: v[1] for k, v in out.items() if not v[1] <= limits[k]}
    times = {}
    if timing:
        times = dict(
            linearize_ms=cuda_time_ms(lambda: fl.fused_linearize_cuda(*lin_args), 20),
            linearize_plain_ms=cuda_time_ms(lambda: fl.fused_linearize_plain(*lin_args), 5),
            apply_ms=cuda_time_ms(lambda: fa.fused_apply_cuda(*apply_args), 50),
            apply_plain_ms=cuda_time_ms(lambda: fa.fused_apply_plain(*apply_args), 10))
    return out, limits, bad, times


def run_steps(sim, steps, dt):
    stats = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        stats.append(sim.step(dt))
    torch.cuda.synchronize()
    return stats, time.perf_counter() - t0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from hot_tpu_torch.ops import cuda_lib
    from hot_tpu_torch.ops import fused_apply as fa
    from hot_tpu_torch.ops import fused_linearize as fl
    from hot_tpu_torch.scenes import build_scene
    from hot_tpu_torch.sim import Simulation
    from hot_tpu_torch.sim.state import state_from_numpy

    # ---- 1 env
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    nvcc = subprocess.run([cuda_lib.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    emit("env", card=card, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc, python=sys.version.split()[0])

    # ---- 2 build
    t0 = time.perf_counter()
    cuda_lib.load()
    report = cuda_lib.build_report()
    ptxas = [line.strip() for line in report["ptxas"].splitlines()
             if "registers" in line or "spill" in line]
    emit("build", seconds=round(time.perf_counter() - t0, 3), nvcc_seconds=report["seconds"],
         library=report["path"], ptxas=ptxas)

    # ---- 3 kernels against their plain versions
    rng = np.random.default_rng(0)
    summary = {}
    for dtype in (torch.float32, torch.float64):
        for scene_name, res in (("twisting_bar_3d", 64), ("block_drop_2d", 64)):
            for model_name in ("fixed_corotated", "stvk_hencky"):
                case = kernel_inputs(scene_name, model_name, dtype, rng, res)
                main_shape = (dtype == torch.float32 and scene_name == "twisting_bar_3d"
                              and model_name == "fixed_corotated")
                errs, limits, bad, times = check_kernels(case, timing=main_shape)
                emit("kernels", scene=scene_name, res=res, n=case["n"], model=model_name,
                     dtype=str(dtype), rel_err={k: v[1] for k, v in errs.items()},
                     max_abs_err={k: v[0] for k, v in errs.items()}, limits=limits, **times)
                if bad:
                    raise AssertionError(f"kernel disagrees with its plain version: {bad}")
                if main_shape:
                    summary = dict(errs=errs, times=times)
                del case
    torch.cuda.empty_cache()

    # ---- 4 the main path at 64^3
    scene = build_scene("twisting_bar_3d", device="cuda", res=64, ppc=8)
    sim = Simulation(scene["cfg"], scene["state"], scene["model"], scene["colliders"])
    fa.launches = 0
    fl.launches = 0
    stats, seconds = run_steps(sim, 12, DT)
    launches = {"fused_apply": fa.launches, "fused_linearize": fl.launches}
    newton = [s.newton_iters for s in stats]
    cg = [s.cg_iters for s in stats]
    emit("main", particles=sim.state.n, steps=len(stats), seconds=seconds,
         steps_per_s=len(stats) / seconds, newton=newton, cg=cg,
         max_velocity=[s.max_velocity for s in stats], launches=launches,
         retries=sim.retry_count, step_s=sim.timer.snapshot())
    assert bool(torch.isfinite(sim.state.x).all() and torch.isfinite(sim.state.Ff).all())
    assert all(s.converged for s in stats) and sim.retry_count == 0, stats
    assert all(k > 0 for k in newton[6:]), newton
    assert all(count > 0 for count in launches.values()), launches
    assert launches["fused_linearize"] == sum(k + 1 for k in newton), (launches, newton)
    assert launches["fused_apply"] == sum(cg) + sum(newton), (launches, newton, cg)
    vmax = max(s.max_velocity for s in stats)
    assert 1.0 < vmax < 3.0, vmax   # clamps spin at 4 pi rad/s, 0.14 from the axis: ~1.76

    # ---- 5 the card against the CPU (32^3, ppc 4, 3 steps)
    base = build_scene("twisting_bar_3d", device="cpu", res=32, ppc=4, dtype=torch.float64)
    arrays = base["state"].to_numpy()
    sims = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        sc = build_scene("twisting_bar_3d", device=dev, res=32, ppc=4, dtype=dtype)
        sims[dev] = Simulation(sc["cfg"], state_from_numpy(arrays, dev, dtype), sc["model"],
                               sc["colliders"])
    dx = base["cfg"].dx
    rows = []
    for _ in range(3):
        g, c = sims["cuda"].step(DT), sims["cpu"].step(DT)
        dxmax = float((sims["cuda"].state.x.double().cpu() - sims["cpu"].state.x).abs().max())
        rows.append(dict(newton=(g.newton_iters, c.newton_iters), cg=(g.cg_iters, c.cg_iters),
                         x_diff_over_dx=dxmax / dx))
    emit("cpu", particles=base["state"].n, steps=rows,
         limits=dict(newton="equal", cg_diff=2, x_diff_over_dx=X_TOL))
    for r in rows:
        # Newton stops on CN <= 1e-2, far above fp32 noise: counts agree.
        # CG stops on a relative residual of ~1e-3 whose crossing can move by
        # an iteration or two under fp32 rounding and atomic order.
        assert r["newton"][0] == r["newton"][1], rows
        assert abs(r["cg"][0] - r["cg"][1]) <= 2, rows
        assert r["x_diff_over_dx"] <= X_TOL, rows
    del sims
    torch.cuda.empty_cache()

    # ---- 6 scale: 128^3
    scene = build_scene("twisting_bar_3d", device="cuda", res=128, ppc=8)
    sim = Simulation(scene["cfg"], scene["state"], scene["model"], scene["colliders"])
    torch.cuda.reset_peak_memory_stats()
    stats, seconds = run_steps(sim, 2, DT)
    emit("scale", res=128, particles=sim.state.n, nodes=128 ** 3, steps=len(stats),
         seconds=seconds, steps_per_s=len(stats) / seconds,
         newton=[s.newton_iters for s in stats], cg=[s.cg_iters for s in stats],
         max_memory_allocated=torch.cuda.max_memory_allocated())
    assert bool(torch.isfinite(sim.state.x).all()) and all(s.converged for s in stats), stats

    errs, times = summary["errs"], summary["times"]
    print(json.dumps({"kernels": [
        {"name": "fused_linearize", "route": "cuda",
         "source": "hot_tpu_torch/csrc/fused_linearize.cu",
         "replaces": "hot_tpu/ops/pallas_linearize.py:374",
         "launches": launches["fused_linearize"], "max_abs_err": errs["lin_f"][0],
         "ms": times["linearize_ms"], "plain_ms": times["linearize_plain_ms"]},
        {"name": "fused_apply", "route": "cuda", "source": "hot_tpu_torch/csrc/fused_apply.cu",
         "replaces": "hot_tpu/ops/pallas_apply.py:143",
         "launches": launches["fused_apply"], "max_abs_err": errs["apply_df"][0],
         "ms": times["apply_ms"], "plain_ms": times["apply_plain_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
