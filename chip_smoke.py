#!/usr/bin/env python3
"""Smoke run of hot_tpu_torch on one NVIDIA GPU (run from the repo root).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1 env       nvidia-smi name and power limit, torch/CUDA/nvcc versions, and
              the device-to-device copy rate of a 1 GiB buffer
  2 build     nvcc build of hot_tpu_torch/csrc (time, ptxas registers/spills)
  3 kernels   each CUDA kernel against its plain PyTorch version on the card:
              the particle kernels on the 64^3 twisting bar (both models, F
              perturbed by seeded noise) and a 64^2 block drop, in fp32 and
              fp64, and on the 64^3 bar with its particles in a random order
              (the blocks' node windows overflow: the share that took the
              global-atomic branch); bsr_spmv on the four operators of the
              64^3 config-3 multigrid hierarchy (K = 125, 343, 729, 729), in
              fp32 and fp64, beside torch.sparse_bsr_tensor @ x; errors, each
              kernel's device time per launch (torch.profiler) and CUDA-event
              times of whole calls (the kernel's wrapper, its plain version,
              the library call)
  3b timing   the particle kernels at 64^3 and 128^3 (fp32, fixed-corotated):
              device time, plain time, the bound from the run's inputs (x and
              the touched nodes) beside the stencil-table input set's; with
              --baseline DIR, the kernels built from DIR (an earlier csrc/)
              on the same particles, in turns; and a sweep of block size and
              window budget
  4 main      Simulation.step x12 at 64^3 (ppc 8, dt 2e-3, fp32, block-Jacobi):
              finite, converged, and the kernels' launch counters equal
              sum(newton + 1) and sum(cg + newton); the particle kernels'
              window counters (box sizes, overflow share, global atomics per
              launch)
  5 mg        the same 12 steps under config 3 (assembled Galerkin multigrid,
              4 levels, Chebyshev, direct coarse solve): finite, converged,
              no dt retry, and all three launch counters equal the counts
              derived from the code; then 3 steps of the default
              (matrix-free) multigrid in fp32 (finite; convergence
              recorded) and fp64 (finite and converged)
  6 cpu       3 steps at 32^3 (ppc 4) on the card (fp32) and on the CPU
              (plain versions, fp64) from one state, under block-Jacobi and
              under config 3 with 3 levels
  7 scale     128^3 (ppc 8): config 3 and block-Jacobi as whole steps from
              one state, in alternating turns: steps/s, (newton, cg), MG
              build ms per Newton, peak device memory
Then the kernels' summary and, last, {"ok": true, "device": {...}}.
Any failure raises and exits non-zero; it needs a CUDA device and exits
non-zero without one.

    python3 chip_smoke.py --baseline build/baseline_csrc

also times the particle kernels of an earlier csrc/ (its C interface takes
the stencil as node ids and weight gradients), for the record in PERF.md.
"""

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

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
# bsr_spmv against its plain version, relative to the plain result's
# largest entry (summation order only, as for the other kernels)
SPMV_TOL = {torch.float32: 2e-5, torch.float64: 1e-10}
# published H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s and
# fp32 (non-tensor-core) flop/s; fp64 runs at half the fp32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# flops per 3D particle, counted from the kernels' sources (a multiply-add
# is 2, a division or square root 1):
#   apply: stencil 60, node weights 2 x 108, gather 486, chain 324, scatter
#     486: about 1,600;
#   linearize: stencil 60, node weights 2 x 108, gather 486, F_new 63, SVD
#     (F^T F, 6 Jacobi sweeps of 3 rotations, F V, Givens QR) 1,440, model
#     and b+ 110, the positive-definiteness test of sym(A) 20, P and P F^T
#     117, scatter 486: about 3,030 (fixed-corotated); plus 1,290 for the
#     clamp's eigensolve (6 sweeps and the product back) where sym(A) is not
#     positive definite, counted on each run's inputs
FLOPS_PER_PARTICLE = {"fused_apply": 1600, "fused_linearize": 3030}
CLAMP_FLOPS = 1290
# the C interface of the earlier particle kernels (--baseline), which took
# the stencil as a table: node ids (s, n) int32 and weight gradients (s*d, n)
TABLE_SIGNATURES = {
    "hot_fused_apply": [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_double, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
    "hot_fused_linearize": [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                           + [ctypes.c_double, ctypes.c_int] + [ctypes.c_void_p] * 6
                           + [ctypes.c_longlong, ctypes.c_void_p],
}
SWEEP = {"threads": (128, 256), "window_nodes": (0, 512, 1024, 1536, 2048)}
CONFIG3 = {"solver.preconditioner": "multigrid", "solver.multigrid.levels": 4,
           "solver.multigrid.smoother": "chebyshev", "solver.multigrid.coarse_solver": "direct",
           "solver.multigrid.assembled": True}


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


def device_ms(fn, reps, kernel):
    """(ms, source): the device time per launch of the CUDA kernel whose name
    contains `kernel`, from torch.profiler over `reps` calls of fn; CUDA
    events around the calls (host launch cost included) where the profiler
    records no such kernel."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key and e.device_time_total > 0]
    count = sum(e.count for e in evs)
    if count:
        return sum(e.device_time_total for e in evs) / count / 1e3, "profiler"
    return cuda_time_ms(fn, reps), "cuda_events"


def rel_err(got, want):
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-300)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and flops
    over the fp32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _per_particle_values(name, d):
    dd, pairs = d * d, 1 if d == 2 else 3
    if name == "fused_apply":   # F, U, V, A, b+, b-, V0
        return 4 * dd + 2 * pairs + 1
    return dd + 3 + 3 * dd + 2 * pairs  # in: F, mu, lam, V0; out: U, V, A, b+, b-


def particle_kernel_bytes(name, n, touched, d, itemsize):
    """Bytes each input read once and each output written once: x and the
    per-particle SoA arrays, and the grid vector read (w or v) and written
    (df or f) over the `touched` nodes, the unique stencil nodes."""
    return n * (d + _per_particle_values(name, d)) * itemsize + 2 * touched * d * itemsize


def table_kernel_bytes(name, n, n_nodes, d, itemsize):
    """The same for the stencil-table input set, as its bound counted it:
    node ids (int32) and weight gradients per particle in place of x, and
    two whole-grid vectors."""
    s = 3 ** d
    return n * (s * 4 + (s * d + _per_particle_values(name, d)) * itemsize) \
        + 2 * n_nodes * d * itemsize


def copy_rate():
    """Device-to-device copy rate of a 1 GiB buffer, bytes/s (read + write)."""
    src = torch.empty(2 ** 28, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = cuda_time_ms(lambda: dst.copy_(src), 10)
    del src, dst
    return 2 * 2 ** 30 / (ms * 1e-3)


def mg_hierarchy(dtype, rng):
    """The 64^3 config-3 hierarchy's per-Newton operators at one stressed
    state (F perturbed by seeded noise), through the port's own builders."""
    from hot_tpu_torch.ops import transfer
    from hot_tpu_torch.scenes import build_scene
    from hot_tpu_torch.sim import objective as obj_mod
    from hot_tpu_torch.solver import multigrid as mg_mod
    from hot_tpu_torch.utils.config import MultigridConfig

    scene = build_scene("twisting_bar_3d", device="cuda", dtype=dtype, res=64, ppc=8)
    state, cfg = scene["state"], scene["cfg"]
    res = tuple(cfg.grid_res[:3])
    n_nodes = transfer.n_nodes_of(res)
    F = state.F + torch.as_tensor(0.1 * rng.standard_normal((state.n, 3, 3)), dtype=dtype,
                                  device="cuda")
    st = transfer.particle_stencil(state.x, cfg.dx, res)
    grid_m = transfer.scatter_sum(st.node_ids, st.wn * state.m[:, None], n_nodes)
    eye = torch.eye(3, dtype=dtype, device="cuda")
    obj = obj_mod.make_objective(scene["model"], st, F, state.V0, state.mu, state.lam, grid_m,
                                 torch.zeros((n_nodes, 3), dtype=dtype, device="cuda"),
                                 eye.expand(n_nodes, 3, 3), DT, cfg.dx, state.x, res)
    _, hess = obj_mod.linearize(scene["model"], obj, obj.v_star)
    mcfg = MultigridConfig(levels=4, smoother="chebyshev", coarse_solver="direct",
                           assembled=True)
    mgs = mg_mod.build_static(state.x, state.m, res, cfg.dx, 4,
                              torch.zeros(n_nodes, dtype=torch.bool, device="cuda"), dtype,
                              assembled_from=0)
    return mg_mod.build_precond(mgs, F, hess, state.V0, DT, mcfg, 3).mats


def library_bsr(mat):
    """torch.sparse_bsr_tensor of a BSR operator (cuSPARSE bsrmv): the
    yardstick beside the kernel; nothing in the port calls it."""
    ok = mat.col_row >= 0
    crow = torch.zeros(mat.n_rows + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(ok.sum(1), 0)
    d = mat.dim
    return torch.sparse_bsr_tensor(crow, mat.col_row[ok].long(), mat.vals[ok],
                                   size=(mat.n_rows * d, mat.n_rows * d))


def check_spmv(mats, dtype, rng, timing):
    """bsr_spmv against its plain version on each level's operator."""
    from hot_tpu_torch.ops import bsr_spmv as sp

    rows = []
    for level, mat in enumerate(mats):
        R, K, d = mat.n_rows, mat.K, mat.dim
        x = torch.as_tensor(rng.standard_normal((R, d)), dtype=dtype, device="cuda")
        args = (mat.vals, mat.col_row, x)
        got, want = sp.bsr_spmv_cuda(*args), sp.bsr_spmv_plain(*args)
        err, rel = rel_err(got, want)
        nnz = int((mat.col_row >= 0).sum())
        item = x.element_size()
        nbytes = nnz * d * d * item + R * K * 4 + 2 * R * d * item
        flops = 2 * nnz * d * d * (1 if dtype == torch.float32 else 2)
        row = dict(level=level, R=R, K=K, nnz_blocks=nnz, bytes=nbytes, max_abs_err=err,
                   rel_err=rel, limit=SPMV_TOL[dtype])
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
        if timing:
            A = library_bsr(mat)
            lib = lambda: (A @ x.reshape(-1, 1)).reshape(R, d)  # noqa: E731
            ms, src = device_ms(lambda: sp.bsr_spmv_cuda(*args), 50, "bsr_spmv_kernel")
            row.update(lib_rel_err=rel_err(lib(), want)[1], ms=ms, ms_source=src,
                       event_ms=cuda_time_ms(lambda: sp.bsr_spmv_cuda(*args), 50),
                       plain_ms=cuda_time_ms(lambda: sp.bsr_spmv_plain(*args), 10),
                       library_ms=cuda_time_ms(lib, 50))
        rows.append(row)
        if not rel <= SPMV_TOL[dtype]:
            raise AssertionError(f"bsr_spmv disagrees with its plain version: {row}")
    return rows


def kernel_inputs(scene_name, model_name, dtype, rng, res, permute=False, noise=0.1):
    """One input set of the particle kernels: a scene's particles (F
    perturbed by seeded noise of scale `noise`; in a random order if
    `permute`), random grid vectors v and w, and the particles' stencil on
    the grid."""
    from hot_tpu_torch.models.constitutive import MODEL_REGISTRY
    from hot_tpu_torch.ops import transfer
    from hot_tpu_torch.ops.fused_apply import soa
    from hot_tpu_torch.scenes import build_scene

    kw = dict(res=res, ppc=8) if scene_name == "twisting_bar_3d" else dict(res=res)
    state = build_scene(scene_name, device="cuda", dtype=dtype, **kw)["state"]
    d = state.dim
    n = state.n
    x, mu, lam, V0 = state.x, state.mu, state.lam, state.V0
    F = state.F + torch.as_tensor(noise * rng.standard_normal((n, d, d)), dtype=dtype,
                                  device="cuda")
    if permute:
        perm = torch.as_tensor(rng.permutation(n), device="cuda")
        x, F, mu, lam, V0 = (t[perm].contiguous() for t in (x, F, mu, lam, V0))
    grid = (res,) * d
    st = transfer.particle_stencil(x, 1.0 / res, grid)
    n_nodes = res ** d
    v = torch.as_tensor(rng.standard_normal((n_nodes, d)), dtype=dtype, device="cuda")
    w = torch.as_tensor(rng.standard_normal((n_nodes, d)), dtype=dtype, device="cuda")
    return dict(model=MODEL_REGISTRY[model_name], v=v, w=w, F=F, x_soa=soa(x), F_soa=soa(F),
                dx=1.0 / res, res=grid, mu=mu, lam=lam, V0=V0, st=st, n=n, d=d)


def lin_args(c):
    return (c["v"], c["x_soa"], c["dx"], c["res"], c["F_soa"], c["mu"], c["lam"], c["V0"], DT,
            c["model"])


def apply_args(c, ctx):
    return (c["w"], c["x_soa"], c["dx"], c["res"], c["F_soa"], *ctx, c["V0"], DT)


class WindowStats:
    """The particle kernels' window counters over the calls inside."""

    def __enter__(self):
        from hot_tpu_torch.ops import fused_apply as fa
        from hot_tpu_torch.ops import fused_linearize as fl

        self.mods = {"fused_apply": fa, "fused_linearize": fl}
        self.bufs = {k: fa.new_window_stats("cuda") for k in self.mods}
        self.launches = {k: m.launches for k, m in self.mods.items()}
        for k, m in self.mods.items():
            m.window_stats = self.bufs[k]
        return self

    def __exit__(self, *exc):
        for m in self.mods.values():
            m.window_stats = None

    def read(self):
        from hot_tpu_torch.ops import fused_apply as fa

        out = {}
        for k, m in self.mods.items():
            st = fa.read_window_stats(self.bufs[k])
            launches = m.launches - self.launches[k]
            blocks = max(st["blocks"], 1)
            out[k] = dict(launches=launches, blocks=st["blocks"],
                          overflow_share=st["overflow_blocks"] / blocks,
                          mean_window_nodes=st["window_nodes"] / blocks,
                          max_window_nodes=st["max_window_nodes"],
                          global_atomics_per_launch=st["global_atomics"] / max(launches, 1),
                          log2_nodes_histogram=st["log2_nodes_histogram"])
        return out


def check_kernels(case):
    """Both kernels against their plain versions on one input set; the
    kernels' window counters of the two checked launches."""
    from hot_tpu_torch.ops import fused_apply as fa
    from hot_tpu_torch.ops import fused_linearize as fl
    from hot_tpu_torch.ops import transfer

    c = case
    d, dtype = c["d"], c["v"].dtype
    with WindowStats() as ws:
        got = fl.fused_linearize_cuda(*lin_args(c))
        want = fl.fused_linearize_plain(*lin_args(c))
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
        args = apply_args(c, want[1:])
        out["apply_df"] = rel_err(fa.fused_apply_cuda(*args), fa.fused_apply_plain(*args))
        windows = ws.read()

    tol = TOL[dtype]
    limits = {k: tol["apply"] if k == "apply_df" else tol["linearize"] for k in out}
    # SVD identities hold to the working precision times a small factor
    eps = torch.finfo(dtype).eps
    limits.update(svd_offdiag=200 * eps, orth_UV=50 * eps, det_UV=50 * eps)
    bad = {k: v[1] for k, v in out.items() if not v[1] <= limits[k]}
    return out, limits, bad, windows


def load_baseline(csrc_dir):
    """The particle kernels of an earlier csrc/ (the stencil-table C
    interface), built with the same flags into build/, for timing beside the
    current ones."""
    from hot_tpu_torch.ops import cuda_lib

    path, seconds, _ = cuda_lib.build(Path(csrc_dir), "libbaseline")
    lib = ctypes.CDLL(str(path))
    for name, argtypes in TABLE_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib, seconds


def baseline_calls(lib, c, ctx):
    """Launchers of the baseline kernels on input set c, with its stencil table."""
    from hot_tpu_torch.ops import cuda_lib

    d, n = c["d"], c["n"]
    s = 3 ** d
    ids = c["st"].node_ids.T.to(torch.int32).contiguous()
    gwn = c["st"].gwn.reshape(n, s * d).T.contiguous()
    v, w = c["v"], c["w"]
    stream = cuda_lib.stream_ptr(v.device)
    outs = [torch.empty((d * d, n), dtype=v.dtype, device="cuda") for _ in range(3)] + [
        torch.empty((3 if d == 3 else 1, n), dtype=v.dtype, device="cuda") for _ in range(2)]

    def linearize():
        f = torch.zeros_like(v)
        rc = lib.hot_fused_linearize(
            0, cuda_lib.dtype_code(v), d, v.data_ptr(), ids.data_ptr(), gwn.data_ptr(),
            c["F_soa"].data_ptr(), c["mu"].data_ptr(), c["lam"].data_ptr(), c["V0"].data_ptr(),
            DT, 1, f.data_ptr(), *(o.data_ptr() for o in outs), n, stream)
        cuda_lib.check(rc, "baseline fused_linearize")
        return f

    def apply():
        df = torch.zeros_like(w)
        rc = lib.hot_fused_apply(
            cuda_lib.dtype_code(w), d, w.data_ptr(), ids.data_ptr(), gwn.data_ptr(),
            c["F_soa"].data_ptr(), *(t.data_ptr() for t in ctx), c["V0"].data_ptr(), DT,
            df.data_ptr(), n, stream)
        cuda_lib.check(rc, "baseline fused_apply")
        return df

    return {"fused_linearize": linearize, "fused_apply": apply}


def clamp_share(c):
    """The share of particles whose sym(A) at F_new is not positive definite
    by its leading minors (the linearize's clamp eigensolve runs for them)."""
    from hot_tpu_torch.models import constitutive as cm
    from hot_tpu_torch.ops import transfer

    d = c["d"]
    eye = torch.eye(d, dtype=c["F"].dtype, device="cuda")
    F_new = (eye + DT * transfer.velocity_gradient(c["st"], c["v"])) @ c["F"]
    A = cm.hessian_context(c["model"], F_new, c["mu"], c["lam"], project=False).A
    S = 0.5 * (A + A.transpose(1, 2))
    minors = [S[:, 0, 0], S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]]
    if d == 3:
        minors.append(torch.linalg.det(S))
    pd = torch.stack([m > 0 for m in minors]).all(0)
    return 1.0 - float(pd.double().mean())


def time_particle_kernels(res, rng, baseline_lib, sweep):
    """fp32 3D fixed-corotated twisting bar at res^3: each particle kernel's
    device time per launch (profiler), its plain version's time, the bounds
    from this run's inputs; the baseline kernels on the same particles in
    turns (baseline, current, current, baseline) when given; a sweep of
    block size and window budget when asked."""
    from hot_tpu_torch.ops import fused_apply as fa
    from hot_tpu_torch.ops import fused_linearize as fl

    c = kernel_inputs("twisting_bar_3d", "fixed_corotated", torch.float32, rng, res)
    n, d = c["n"], c["d"]
    ctx = fl.fused_linearize_plain(*lin_args(c))[1:]
    cur = {"fused_linearize": lambda **kw: fl.fused_linearize_cuda(*lin_args(c), **kw),
           "fused_apply": lambda **kw: fa.fused_apply_cuda(*apply_args(c, ctx), **kw)}
    plain = {"fused_linearize": lambda: fl.fused_linearize_plain(*lin_args(c)),
             "fused_apply": lambda: fa.fused_apply_plain(*apply_args(c, ctx))}
    old = baseline_calls(baseline_lib, c, ctx) if baseline_lib is not None else None
    touched = int(torch.unique(c["st"].node_ids).numel())
    clamped = clamp_share(c)
    out = dict(res=res, particles=n, touched_nodes=touched, clamp_share=clamped)
    for name, fn in cur.items():
        kernel = name + "_kernel"
        row = {}
        if old is not None:
            want = plain[name]()
            want = want[0] if isinstance(want, tuple) else want
            row["baseline_rel_err"] = rel_err(old[name](), want)[1]
            turns = [("baseline", old[name]), ("current", fn), ("current", fn),
                     ("baseline", old[name])]
            for who, f in turns:
                row.setdefault(who + "_ms", []).append(device_ms(f, 50, kernel)[0])
        row["ms"], row["ms_source"] = device_ms(fn, 50, kernel)
        row["plain_ms"] = cuda_time_ms(plain[name], 3 if res > 64 else 5)
        nbytes = particle_kernel_bytes(name, n, touched, d, 4)
        flops = FLOPS_PER_PARTICLE[name] + (CLAMP_FLOPS * clamped if name == "fused_linearize"
                                            else 0)
        row["bytes"], row["flops"] = nbytes, n * flops
        row["bound_ms"], row["bound_by"] = bound(nbytes, row["flops"])
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["table_bytes"] = table_kernel_bytes(name, n, res ** d, d, 4)
        row["table_bound_ms"] = bound(row["table_bytes"], row["flops"])[0]
        if sweep:
            row["sweep"] = []
            for threads in SWEEP["threads"]:
                for nodes in SWEEP["window_nodes"]:
                    with WindowStats() as ws:
                        fn(threads=threads, window_nodes=nodes)
                        share = ws.read()[name]["overflow_share"]
                    ms = device_ms(lambda: fn(threads=threads, window_nodes=nodes), 20,
                                   kernel)[0]
                    row["sweep"].append(dict(threads=threads, window_nodes=nodes, ms=ms,
                                             overflow_share=share))
        out[name] = row
    return out


def run_steps(sim, steps, dt):
    stats = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        stats.append(sim.step(dt))
    torch.cuda.synchronize()
    return stats, time.perf_counter() - t0


def config3(cfg, levels=4):
    from hot_tpu_torch.utils.config import config_from_overrides

    return config_from_overrides(cfg, dict(CONFIG3, **{"solver.multigrid.levels": levels}))


class BuildTimer:
    """CUDA-event time of every multigrid preconditioner build, without a
    synchronisation in the step (read after it)."""

    def __init__(self, mg_mod):
        self.mg_mod, self.orig, self.events = mg_mod, mg_mod.build_precond, []

    def __enter__(self):
        def timed(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = self.orig(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out

        self.mg_mod.build_precond = timed
        return self

    def __exit__(self, *exc):
        self.mg_mod.build_precond = self.orig

    def ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", metavar="DIR",
                    help="an earlier csrc/ whose particle kernels are timed beside these")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from hot_tpu_torch.ops import bsr_spmv as sp
    from hot_tpu_torch.ops import cuda_lib
    from hot_tpu_torch.ops import fused_apply as fa
    from hot_tpu_torch.ops import fused_linearize as fl
    from hot_tpu_torch.scenes import build_scene
    from hot_tpu_torch.sim import Simulation
    from hot_tpu_torch.sim.state import state_from_numpy
    from hot_tpu_torch.solver import multigrid as mg_mod
    from hot_tpu_torch.utils.config import config_from_overrides

    # ---- 1 env
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    nvcc = subprocess.run([cuda_lib.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    copy_bytes_per_s = copy_rate()
    emit("env", card=card, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc, python=sys.version.split()[0], copy_bytes_per_s=copy_bytes_per_s)

    # ---- 2 build
    t0 = time.perf_counter()
    cuda_lib.load()
    report = cuda_lib.build_report()
    ptxas = [line.strip() for line in report["ptxas"].splitlines()
             if "registers" in line or "spill" in line or "Compiling entry" in line]
    emit("build", seconds=round(time.perf_counter() - t0, 3), nvcc_seconds=report["seconds"],
         library=report["path"], ptxas=ptxas)
    baseline_lib = None
    if args.baseline:
        baseline_lib, seconds = load_baseline(args.baseline)
        emit("build", baseline=args.baseline, nvcc_seconds=seconds)

    # ---- 3 kernels against their plain versions
    rng = np.random.default_rng(0)
    summary = {}
    for dtype in (torch.float32, torch.float64):
        models = ("fixed_corotated", "stvk_hencky")
        # (scene, res, model, random order, F noise). With F perturbed by 0.5
        # a share of the particles needs the clamp's eigensolve and the rest
        # skip it; StVK-Hencky is ill-conditioned there in fp32 (its plain
        # version in fp32 and fp64 differ by 1e-3), so it is held in fp64
        cases = [(scene_name, 64, m, False, 0.1) for scene_name in ("twisting_bar_3d",
                                                                    "block_drop_2d")
                 for m in models]
        cases += [("twisting_bar_3d", 64, "fixed_corotated", True, 0.1)]
        cases += [("twisting_bar_3d", 64, m, False, 0.5) for m in models
                  if dtype == torch.float64 or m == "fixed_corotated"]
        for scene_name, res, model_name, permute, noise in cases:
            case = kernel_inputs(scene_name, model_name, dtype, rng, res, permute, noise)
            clamped = clamp_share(case)
            errs, limits, bad, windows = check_kernels(case)
            emit("kernels", scene=scene_name, res=res, n=case["n"], model=model_name,
                 dtype=str(dtype), order="random" if permute else "lattice", F_noise=noise,
                 clamp_share=clamped, rel_err={k: v[1] for k, v in errs.items()},
                 max_abs_err={k: v[0] for k, v in errs.items()}, limits=limits,
                 windows=windows)
            if bad:
                raise AssertionError(f"kernel disagrees with its plain version: {bad}")
            if permute:
                # a random order spreads every block over the bar: the
                # global-atomic branch must have run
                assert all(w["overflow_share"] > 0.5 for w in windows.values()), windows
            if noise > 0.1:
                assert 0 < clamped < 1, clamped
            if (dtype == torch.float32 and scene_name == "twisting_bar_3d"
                    and model_name == "fixed_corotated" and not permute and noise == 0.1):
                summary["errs"] = errs
            del case
    for res in (64, 128):
        timing = time_particle_kernels(res, rng, baseline_lib, sweep=True)
        emit("timing", card=card, **timing)
        summary[res] = timing
        torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.float64):
        mats = mg_hierarchy(dtype, rng)
        rows = check_spmv(mats, dtype, rng, timing=dtype == torch.float32)
        for row in rows:
            row["copy_bound_ms"] = row["bytes"] / copy_bytes_per_s * 1e3
        emit("kernels", kernel="bsr_spmv", scene="twisting_bar_3d", res=64,
             hierarchy="config 3, 4 levels", dtype=str(dtype), levels=rows)
        if dtype == torch.float32:
            summary["spmv"] = rows[0]
        del mats
    emit("bounds", copy_bytes_per_s=copy_bytes_per_s, **{
        f"{name}_{res}": dict(bound_ms=summary[res][name]["bound_ms"],
                              bound_by=summary[res][name]["bound_by"],
                              copy_bound_ms=summary[res][name]["bytes"] / copy_bytes_per_s * 1e3)
        for res in (64, 128) for name in ("fused_apply", "fused_linearize")})
    torch.cuda.empty_cache()

    # ---- 4 the main path at 64^3 (block-Jacobi)
    scene = build_scene("twisting_bar_3d", device="cuda", res=64, ppc=8)
    sim = Simulation(scene["cfg"], scene["state"], scene["model"], scene["colliders"])
    fa.launches = fl.launches = sp.launches = 0
    with WindowStats() as ws:
        stats, seconds = run_steps(sim, 12, DT)
    launches = {"fused_apply": fa.launches, "fused_linearize": fl.launches,
                "bsr_spmv": sp.launches}
    emit("windows", path="main, 64^3 block-Jacobi", threads=fa.BLOCK_THREADS,
         window_nodes=fa.WINDOW_NODES, **ws.read())
    newton = [s.newton_iters for s in stats]
    cg = [s.cg_iters for s in stats]
    emit("main", particles=sim.state.n, steps=len(stats), seconds=seconds,
         steps_per_s=len(stats) / seconds, newton=newton, cg=cg,
         max_velocity=[s.max_velocity for s in stats], launches=launches,
         retries=sim.retry_count, step_s=sim.timer.snapshot())
    assert bool(torch.isfinite(sim.state.x).all() and torch.isfinite(sim.state.Ff).all())
    assert all(s.converged for s in stats) and sim.retry_count == 0, stats
    assert all(k > 0 for k in newton[6:]), newton
    assert launches["fused_apply"] > 0 and launches["fused_linearize"] > 0, launches
    assert launches["fused_linearize"] == sum(k + 1 for k in newton), (launches, newton)
    assert launches["fused_apply"] == sum(cg) + sum(newton), (launches, newton, cg)
    assert launches["bsr_spmv"] == 0, launches
    vmax = max(s.max_velocity for s in stats)
    assert 1.0 < vmax < 3.0, vmax   # clamps spin at 4 pi rad/s, 0.14 from the axis: ~1.76

    # ---- 5 the multigrid path at 64^3 (config 3, then the default MG)
    scene = build_scene("twisting_bar_3d", device="cuda", res=64, ppc=8)
    cfg3 = config3(scene["cfg"])
    mgc = cfg3.solver.multigrid
    sim = Simulation(cfg3, scene["state"], scene["model"], scene["colliders"])
    fa.launches = fl.launches = sp.launches = 0
    with BuildTimer(mg_mod) as bt:
        stats, seconds = run_steps(sim, 12, DT)
    mg_launches = {"fused_apply": fa.launches, "fused_linearize": fl.launches,
                   "bsr_spmv": sp.launches}
    newton = [s.newton_iters for s in stats]
    cg = [s.cg_iters for s in stats]
    # bsr_spmv launches, from solver/multigrid.py: every level is assembled,
    # so each SpMV is one launch. Per build (one per Newton iteration that
    # solves): power_iters for each Chebyshev level above the coarsest.
    # Per V-cycle (one per CG iteration plus one for the initial residual):
    # on each level above the coarsest, pre- and post-smoothing apply the
    # operator pre_smooth*order and post_smooth*order times, and the level
    # residual once; the coarsest level is a Cholesky solve.
    smoothed = mgc.levels - 1
    per_build = mgc.power_iters * smoothed
    per_vcycle = smoothed * ((mgc.pre_smooth + mgc.post_smooth) * mgc.chebyshev_order + 1)
    want_spmv = per_build * sum(newton) + per_vcycle * (sum(cg) + sum(newton))
    build_ms = bt.ms()
    emit("mg", config="config 3", particles=sim.state.n, steps=len(stats), seconds=seconds,
         steps_per_s=len(stats) / seconds, newton=newton, cg=cg,
         max_velocity=[s.max_velocity for s in stats], launches=mg_launches,
         bsr_spmv_expected=dict(per_build=per_build, per_vcycle=per_vcycle, total=want_spmv),
         builds=len(build_ms), build_ms_mean=float(np.mean(build_ms)) if build_ms else None,
         retries=sim.retry_count)
    assert bool(torch.isfinite(sim.state.x).all() and torch.isfinite(sim.state.Ff).all())
    assert all(s.converged for s in stats) and sim.retry_count == 0, stats
    assert all(k > 0 for k in newton[6:]), newton
    assert mg_launches["fused_linearize"] == sum(k + 1 for k in newton), (mg_launches, newton)
    assert mg_launches["fused_apply"] == sum(cg) + sum(newton), (mg_launches, newton, cg)
    assert mg_launches["bsr_spmv"] == want_spmv > 0, (mg_launches, want_spmv)
    assert len(build_ms) == sum(newton), (len(build_ms), newton)
    mg_counts = dict(mg_launches)

    for dtype in (torch.float32, torch.float64):
        scene = build_scene("twisting_bar_3d", device="cuda", res=64, ppc=8, dtype=dtype)
        cfg_mf = config_from_overrides(scene["cfg"], {"solver.preconditioner": "multigrid"})
        sim = Simulation(cfg_mf, scene["state"], scene["model"], scene["colliders"])
        stats, seconds = run_steps(sim, 3, DT)
        emit("mg", config="default multigrid (matrix-free levels)", dtype=str(dtype),
             steps=len(stats), seconds=seconds, newton=[s.newton_iters for s in stats],
             cg=[s.cg_iters for s in stats], converged=[s.converged for s in stats],
             retries=sim.retry_count)
        assert bool(torch.isfinite(sim.state.x).all()), stats
        assert all(math.isfinite(s.cn_residual) for s in stats), stats
        assert sum(s.cg_iters for s in stats) > 0, stats
        # This rediscretized (quadrature) hierarchy is not a convergent
        # iteration on the twisting bar (hot_tpu/solver/multigrid.py:676-680);
        # in fp32 it can stall Newton just above cn_eps, in hot_tpu as in the
        # port (ROADMAP.md, queue C). fp64 must converge.
        if dtype == torch.float64:
            assert all(s.converged for s in stats) and sim.retry_count == 0, stats
        del sim
    torch.cuda.empty_cache()

    # ---- 6 the card against the CPU (32^3, ppc 4, 3 steps)
    for label, levels in (("block_jacobi", None), ("config 3, 3 levels", 3)):
        base = build_scene("twisting_bar_3d", device="cpu", res=32, ppc=4, dtype=torch.float64)
        arrays = base["state"].to_numpy()
        sims = {}
        for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
            sc = build_scene("twisting_bar_3d", device=dev, res=32, ppc=4, dtype=dtype)
            cfg = sc["cfg"] if levels is None else config3(sc["cfg"], levels)
            sims[dev] = Simulation(cfg, state_from_numpy(arrays, dev, dtype), sc["model"],
                                   sc["colliders"])
        dx = base["cfg"].dx
        rows = []
        for _ in range(3):
            g, c = sims["cuda"].step(DT), sims["cpu"].step(DT)
            dxmax = float((sims["cuda"].state.x.double().cpu() - sims["cpu"].state.x).abs().max())
            rows.append(dict(newton=(g.newton_iters, c.newton_iters),
                             cg=(g.cg_iters, c.cg_iters), x_diff_over_dx=dxmax / dx))
        emit("cpu", preconditioner=label, particles=base["state"].n, steps=rows,
             limits=dict(newton="equal", cg_diff=2, x_diff_over_dx=X_TOL))
        for r in rows:
            # Newton stops on CN <= 1e-2, far above fp32 noise: counts agree.
            # CG stops on a relative residual of ~1e-3 whose crossing can move by
            # an iteration or two under fp32 rounding and atomic order.
            assert r["newton"][0] == r["newton"][1], rows
            assert abs(r["cg"][0] - r["cg"][1]) <= 2, rows
            assert r["x_diff_over_dx"] <= X_TOL, rows
        assert sum(r["newton"][1] for r in rows) > 0, rows
        del sims
    torch.cuda.empty_cache()

    # ---- 7 scale: 128^3, config 3 and block-Jacobi from one state, in turns
    scene = build_scene("twisting_bar_3d", device="cuda", res=128, ppc=8)
    sim = Simulation(scene["cfg"], scene["state"], scene["model"], scene["colliders"])
    run_steps(sim, 2, DT)                   # load the bar: the clamps start twisting
    start, t_start = sim.state, sim.t
    turns = []
    for label in ("config 3", "block_jacobi", "block_jacobi", "config 3"):
        cfg = config3(scene["cfg"]) if label == "config 3" else scene["cfg"]
        sim = Simulation(cfg, start, scene["model"], scene["colliders"])
        sim.t = t_start
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with BuildTimer(mg_mod) as bt:
            stats, seconds = run_steps(sim, 2, DT)
        build_ms = bt.ms()
        newton = [s.newton_iters for s in stats]
        turns.append(dict(preconditioner=label, steps=len(stats), seconds=seconds,
                          steps_per_s=len(stats) / seconds, newton=newton,
                          cg=[s.cg_iters for s in stats],
                          cg_per_newton=sum(s.cg_iters for s in stats) / max(sum(newton), 1),
                          mg_build_ms_per_newton=(float(np.mean(build_ms)) if build_ms
                                                  else None),
                          max_memory_allocated=torch.cuda.max_memory_allocated(),
                          retries=sim.retry_count))
        emit("scale", res=128, particles=sim.state.n, nodes=128 ** 3, **turns[-1])
        assert bool(torch.isfinite(sim.state.x).all()), turns[-1]
        assert all(s.converged for s in stats) and sim.retry_count == 0, turns[-1]
        del sim

    errs, t64 = summary["errs"], summary[64]
    spmv = summary["spmv"]

    def particle_row(name, err):
        row = t64[name]
        return {"name": name, "route": "cuda", "source": f"hot_tpu_torch/csrc/{name}.cu",
                "replaces": {"fused_linearize": "hot_tpu/ops/pallas_linearize.py:374",
                             "fused_apply": "hot_tpu/ops/pallas_apply.py:143"}[name],
                "launches": launches[name], "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None}

    print(json.dumps({"kernels": [
        particle_row("fused_linearize", errs["lin_f"][0]),
        particle_row("fused_apply", errs["apply_df"][0]),
        {"name": "bsr_spmv", "route": "cuda", "source": "hot_tpu_torch/csrc/bsr_spmv.cu",
         "replaces": "hot_tpu/ops/bsr_tiled.py:387",
         "launches": mg_counts["bsr_spmv"], "max_abs_err": spmv["max_abs_err"],
         "ms": spmv["ms"], "plain_ms": spmv["plain_ms"], "bound_ms": spmv["bound_ms"],
         "bound_by": spmv["bound_by"], "library_ms": spmv["library_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
