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
              global-atomic branch); on the 64^3 stacked boxes (mu and lam
              over four decades; A and b+- also per box, each against its own
              largest entry), on the bar without SPD projection (as MINRES
              runs it), and on the 64^2 sand column with F through
              Drucker-Prager's return map (StVK-Hencky); bsr_spmv on the four operators of the
              64^3 config-3 multigrid hierarchy (K = 125, 343, 729, 729), in
              fp32 and fp64, beside torch.sparse_bsr_tensor @ x; errors, each
              kernel's device time per launch (torch.profiler) and CUDA-event
              times of whole calls (the kernel's wrapper, its plain version,
              the library call)
  3b timing   the particle kernels at 64^3 and 128^3 (fp32, fixed-corotated;
              the linearize also under Neo-Hookean and linear corotated):
              device time, plain time, the bound from the run's inputs (x and
              the touched nodes) beside the stencil-table input set's; with
              --baseline DIR, the kernels built from DIR (an earlier csrc/)
              on the same particles, in turns; and a sweep of block size and
              window budget
  4 main      Simulation.step x12 at 64^3 (ppc 8, dt 2e-3, fp32, block-Jacobi):
              finite, converged, and the kernels' launch counters equal
              sum(newton + 1), sum(cg + newton) and, for the block
              diagonal, sum(newton); the particle kernels'
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
              under config 3 with 3 levels; and the same for the plastic
              scenes from stress_state: sand_column_2d and snowball_drop_2d
              at 32^2 (Jp too) and twisting_bar_vonmises_3d at 32^3 ppc 4
  7 scale     128^3 (ppc 8): config 3 and block-Jacobi as whole steps from
              one state, in alternating turns: steps/s, (newton, cg), MG
              build ms per Newton, peak device memory
  8 scenes    every scene of the registry at its default size, fp32, 3 steps
              at dt 2e-3 x 64 dx from stress_state: particles, nodes, steps/s,
              (newton, cg), peak memory, the share of particles the return
              map changed, Jp's range (snow), the mesh inside test's time;
              finite, converged, no dt retry, Newton in the first step,
              launch counters equal to the derived counts
  9 config4   stacked_boxes_3d at 64^3 (E 1e4..1e8): config 3 and
              block-Jacobi from one state, in turns: CG per Newton, MG build
              ms per Newton, steps/s, all three launch counters checked
  10 solver_options  the 64^3 twisting bar, 3 steps from stress_state, under
              MINRES without SPD projection and with Armijo line search:
              Newton, MINRES/CG, backtracks, launch counters checked
  11 cubic    12 steps of the 64^3 bar (ppc 8, dt 2e-3, fp32) with cubic
              transfers under block-Jacobi: finite, converged, no dt retry,
              launch counters equal sum(newton + 1) and sum(cg + newton);
              then 3 steps from rest in fp64 under the default (matrix-free)
              multigrid, every level's stencil cubic: finite, converged, no
              dt retry, every attempt's apply launches as derived
  12 models   the 64^3 bar under Neo-Hookean and under linear corotated, 3
              steps each from stress_state, launch counters checked
  13 baselines  the explicit integrator on block_drop_2d (32^2, E 1e4, dt
              5e-4, 200 steps from stress_state: finite, deformed, above
              the floor, no kernel launch) and L-BFGS on the 32^3 bar from
              stress_state (3 steps: converged, one linearize launch per
              gradient, no apply)
  14 io       the CLI on the card, block_drop_2d, 2 frames in bgeo with a
              checkpoint each; resumed from the first checkpoint, frame 1
              within 1e-5 dx of the uninterrupted run's; read_bgeo of a
              frame equal to its checkpoint's x bit for bit
  15 kernels_sparse  both particle kernels on the compact node ids of the
              128^3 bar's tile grid (F perturbed by 0.1), fp32 and fp64,
              against their plain versions on the same tile grid and against
              the dense instance on the same values (compact_to_dense); the
              dump row untouched; device ms per launch of the compact and the
              dense instance, window counters, the bound from the touched
              nodes and the tiles' lookup entries
  16 sparse   the 128^3 bar from one loaded state, dense against sparse
              backend, block-Jacobi and config 3, 6 steps each: converged,
              no dt retry, launch counters as derived; the dense run's
              state before each block-Jacobi step, cast to fp64, stepped
              once on each grid: equal Newton, CG within 2 and x within
              1e-4 dx; steps/s, peak memory, active tiles, compact against
              dense nodes, config 3's compact/dense levels
  17 composed the composed Galerkin level 1 against spgemm.rap of the
              assembled fine operator (64^3, fp64, within 1e-10); then the
              128^3 bar, config 3 against config 3 with
              assembled_from_level=1 (matrix-free finest level), 3 steps
              each (fp64): CG per Newton, build ms per Newton split into
              composed assembly, RAP and quadrature assembly, peak memory,
              launches as derived; then one fp32 step of the composed
              configuration, recorded (Newton, dt retries, convergence)
  18 scale256 the 256^3 bar (3.19 M particles) on the sparse grid
              (tile_capacity 16384): config 3 with the composed level 1
              below a matrix-free finest level, 2 steps, then 2 block-Jacobi
              steps: converged, no dt retry; Newton, CG, build ms per
              Newton, steps/s, peak memory and the hierarchy's compact and
              dense levels
  19 batch    both particle kernels on a batch of 8 members of the 64^3 bar
              (each its own E and F perturbation), quadratic and cubic, fp32
              and fp64: one launch per batched call, against the plain
              version per member and against the members' single launches;
              device ms of the batched launch against the 8 single launches,
              the bound of 8 members' bytes. Then the stiffness sweep: the
              64^3 bar (ppc 8) at E = 1e6 2^(k/2), k = -4..3, fp32,
              block-Jacobi, 6 steps from rest as one batch, then each member
              alone 4 times (fp32 runs part by the atomics' order): x within
              1e-4 dx of the nearest lone run or 10 times the lone runs'
              largest mutual difference, if larger (at most 1e-3 dx), and
              the steps whose counts no lone run took (Newton equal, CG
              within 2) recorded; launch counters equal to the derived
              counts, member-steps/s of both, peak memory; the same sweep in
              fp64 with each member alone once: Newton equal at every step,
              CG within 1, x within 1e-8 dx; and block_drop_2d at
              64^2, 16 members (E 1e4..1e7), fp64, 150 steps through impact,
              members 0, 5, 10, 15 alone, 3 times each (the same rule with
              CG within 1, x within 1e-8 dx, the spread at most 1e-4 dx)
  20 batch_solvers  (a) both particle kernels on a batch's tile grid: 8
              members of the 64^3 bar, each moved by a tile and 1.5 cells
              from the last (its own tile set), fp32 and fp64, against the
              plain version per member and each member's own single launch;
              one launch per call; device ms against the 8 single launches.
              (b) the 64^3 bar at the 8 stiffnesses of phase batch, fp64, 3
              steps from rest, under config 3 on the dense and the sparse
              grid and under the composed level (assembled_from_level=1),
              against members 0, 4 and 7 alone (Newton equal, CG within 1, x
              within 1e-8 dx); launch counters as derived (one bsr_spmv per
              batched SpMV); bsr_spmv over the 8 members' level-0 rows
              against its plain version and the 8 single SpMVs. (c) the
              128^3 bar at 4 stiffnesses, config 3 on the sparse grid, fp32,
              3 steps after phase sparse's 2 loading steps: converged, no
              retry, launches as derived; member-steps/s beside members 0
              and 3 alone (counts recorded), MG build ms per Newton, peak
              memory. (d) block_drop_2d at 64^2, 16 stiffnesses (E
              1e4..1e7), fp64, through impact: under MINRES and the explicit
              BSR 66 steps at dt 4e-3, members 0 and 15 alone twice each;
              under L-BFGS 127 steps at dt 2e-3, members 0 and 5 held and
              member 15 (whose lone runs part on the card) recorded (phase
              batch's fp64 rule)
  21 sharded  the slab decomposition (hot_tpu_torch/parallel): (a) both
              particle kernels on each of 4 slabs of the 64^3 bar (the
              rank's particles shifted into its extended slab), fp32 and
              fp64, against their plain versions (2e-5 / 1e-10), the
              ranks' outputs folded onto the grid against the dense launch,
              an interior slab's device ms beside the dense launch's; (b)
              config 4 (stacked_boxes_3d, 64^3, 3 steps from stress_state
              at mag 2) on 4 ranks sharing the card over a gloo group this
              script builds (every rank's kernels on the card, the halo,
              migration and reductions through host memory), block-Jacobi
              and config 3 (3 levels), fp64, against the one-grid step:
              Newton equal, CG equal (block-Jacobi) or within 2, x within
              1e-8 dx of the nearer of two one-grid runs (hold_to_lone; their
              own spread is recorded), each kernel's launches per rank (a
              rank with no particle launches none); the fp32 block-Jacobi run's counts and steps/s ("4
              ranks sharing one card, not a scaling number"); (c) the 64^2 drop with +x
              drift: particles migrated, a sharded checkpoint restored to
              the same state and stepped on; (d) the CLI under
              `python -m torch.distributed.run --standalone
              --nproc-per-node 1` with mesh.shape=(-1,) on NCCL: the
              one-grid CLI's counts; (e) 2 NCCL ranks on the card: refused,
              non-zero exit
  22 block_diag  the block-diagonal kernel (fused_block_diag) against its
              plain version on the same card tensors, each node's block
              within 2e-5 (fp32) / 1e-10 (fp64) of its largest entry, one
              launch counted per call: the 128^3 bar (F perturbed by 0.1)
              on the dense grid and on its tile grid (the benchmark's
              block-Jacobi cell), the 64^3 bar with the quadratic and the
              cubic stencil and the 64^2 drop with the cubic one, fp32 and
              fp64 (the cubic cases' scale floored at 1e-4 of the largest
              block's; their readings without the floor, and the plain
              version in fp32 against fp64, recorded); in fp32 at 128^3 and
              64^3 (3D) device ms through the window and with the global
              atomics alone, the plain version's ms, the bound from the
              run's bytes and operations
Where a phase checks the launch counters (main, mg, scenes, config4,
solver_options, cubic, models, baselines, sparse, composed, batch,
batch_solvers, sharded), it holds fused_block_diag's to the preconditioner
builds too: one per Newton iteration under block-Jacobi (per batched
iteration for a batch, on each sharded rank that holds particles), one per
matrix-free multigrid level and build, none under an assembled hierarchy,
L-BFGS or the explicit integrator.
Phase 3 also holds both particle kernels with the cubic stencil (4 nodes per
axis, every model) and the Neo-Hookean and linear-corotated linearize
against their plain versions, phase 3b times the cubic kernels at 64^3 and
128^3 beside the quadratic ones, and phase 6 adds the 32^3 bar with cubic
transfers, under Neo-Hookean and under L-BFGS (iterations within 2).
Then each phase's seconds, the kernels' summary and, last,
{"ok": true, "device": {...}}.
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
import os
import shutil
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
#   block_diag: stencil 60, node weights 2 x 108, G = F V 54, the pair
#     coefficients and the scale 20; per stencil node y = G^T gw 18, M in
#     U's frame 30, U M 54, the scaled upper triangle of U M U^T 42 and its
#     scatter 6: 150 a node, 4,050 over 27 nodes; about 4,400
# With the cubic stencil the per-node terms (node weights 8, gather 18,
# scatter 18 flops a node; the block diagonal's 158 a node) grow from 27 to
# 64 nodes: apply about 3,230, linearize about 4,690, block_diag about 10,250.
FLOPS_PER_PARTICLE = {("fused_apply", 3): 1600, ("fused_linearize", 3): 3030,
                      ("fused_apply", 4): 3230, ("fused_linearize", 4): 4690,
                      ("fused_block_diag", 3): 4400, ("fused_block_diag", 4): 10250}
CLAMP_FLOPS = 1290
# Neo-Hookean and linear corotated are the two models the linearize kernel
# gained with the cubic stencil; MODELS holds all four
NEW_MODELS = ("neo_hookean", "linear_corotated")
MODELS = ("fixed_corotated", "stvk_hencky") + NEW_MODELS
# the card's restart against the uninterrupted run (fp32, atomics reorder
# sums), in units of dx
RESUME_TOL = 1e-5
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
# the cubic stencil: the block size (64 is what fp64 fits) at the default window
SWEEP_CUBIC = {"threads": (64, 128, 256), "window_nodes": (1536,)}
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
    if name in ("fused_apply", "fused_block_diag"):   # F, U, V, A, b+, b-, V0
        return 4 * dd + 2 * pairs + 1
    return dd + 3 + 3 * dd + 2 * pairs  # in: F, mu, lam, V0; out: U, V, A, b+, b-


def particle_kernel_bytes(name, n, touched, d, itemsize):
    """Bytes each input read once and each output written once: x and the
    per-particle SoA arrays, and the grid vector read (w or v) and written
    (df or f) over the `touched` nodes, the unique stencil nodes."""
    return n * (d + _per_particle_values(name, d)) * itemsize + 2 * touched * d * itemsize


def block_diag_bytes(n, touched, d, itemsize, tiles=0):
    """Bytes of one block-diagonal launch, each input read once and each
    output written once: x and the per-particle SoA arrays, the upper
    triangle of K (d (d + 1) / 2 values) over the `touched` nodes, and the
    lookup entries of `tiles` tiles on the tile grid."""
    return (n * (d + _per_particle_values("fused_block_diag", d)) * itemsize
            + touched * d * (d + 1) // 2 * itemsize + 4 * tiles)


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


def kernel_inputs(scene_name, model_name, dtype, rng, res, permute=False, noise=0.1,
                  project=True, plastic=False, kernel="quadratic"):
    """One input set of the particle kernels: a scene's particles (F
    perturbed by seeded noise of scale `noise`, then passed through
    Drucker-Prager's return map if `plastic`; in a random order if
    `permute`), random grid vectors v and w, and the particles' stencil of
    the transfer kernel family on the grid. The linearize runs with SPD
    projection if `project`. For a scene of several bodies, `groups` holds
    each body's particle slice."""
    from hot_tpu_torch.models.constitutive import MODEL_REGISTRY
    from hot_tpu_torch.models.plasticity import DruckerPrager
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
    if plastic:
        alpha = DruckerPrager.alpha_from_friction_angle(30.0)
        F = DruckerPrager.project(F, mu, lam, alpha)
    # bodies of different material are contiguous (concatenate_states)
    cuts = [0] + (torch.nonzero(mu[1:] != mu[:-1]).flatten() + 1).tolist() + [n]
    groups = [(f"mu={float(mu[a]):.3g}", slice(a, b)) for a, b in zip(cuts[:-1], cuts[1:])]
    if permute:
        perm = torch.as_tensor(rng.permutation(n), device="cuda")
        x, F, mu, lam, V0 = (t[perm].contiguous() for t in (x, F, mu, lam, V0))
    grid = (res,) * d
    st = transfer.particle_stencil(x, 1.0 / res, grid, kernel=kernel)
    n_nodes = res ** d
    v = torch.as_tensor(rng.standard_normal((n_nodes, d)), dtype=dtype, device="cuda")
    w = torch.as_tensor(rng.standard_normal((n_nodes, d)), dtype=dtype, device="cuda")
    return dict(model=MODEL_REGISTRY[model_name], v=v, w=w, F=F, x_soa=soa(x), F_soa=soa(F),
                dx=1.0 / res, res=grid, mu=mu, lam=lam, V0=V0, st=st, n=n, d=d,
                project=project, groups=groups if len(groups) > 1 else [], kernel=kernel)


def lin_args(c):
    return (c["v"], c["x_soa"], c["dx"], c["res"], c["F_soa"], c["mu"], c["lam"], c["V0"], DT,
            c["model"], c["project"], c["kernel"])


def apply_args(c, ctx):
    return (c["w"], c["x_soa"], c["dx"], c["res"], c["F_soa"], *ctx, c["V0"], DT, c["kernel"])


class WindowStats:
    """The particle kernels' window counters over the calls inside."""

    def __enter__(self):
        from hot_tpu_torch.ops import fused_apply as fa
        from hot_tpu_torch.ops import fused_linearize as fl

        self.mods = {"fused_apply": fa, "fused_linearize": fl}
        self.bufs = {k: fa.new_window_stats("cuda") for k in self.mods}
        self.launches = launch_counts()
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
            launches = launch_counts()[k] - self.launches[k]
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
            # each body's per-particle outputs against its own largest entry,
            # so a soft body's error is not hidden under a stiff one's
            for label, sl in c["groups"] if name != "f" else ():
                out[f"lin_{name}[{label}]"] = rel_err(g[:, sl], w[:, sl])
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


def time_particle_kernels(res, rng, baseline_lib, sweep, kernel="quadratic",
                          model_name="fixed_corotated",
                          names=("fused_linearize", "fused_apply")):
    """fp32 3D twisting bar at res^3 with the stencil of the transfer kernel
    family and the model (its flops counted as fixed corotated's): each of
    the particle kernels `names`' device time per launch (profiler), its
    plain version's time, the bounds from this run's inputs; the baseline
    kernels (quadratic only) on the same particles in turns (baseline,
    current, current, baseline) when given; a sweep of block size and
    window budget when asked."""
    from hot_tpu_torch.ops import fused_apply as fa
    from hot_tpu_torch.ops import fused_linearize as fl
    from hot_tpu_torch.ops.bspline import kernel_width

    c = kernel_inputs("twisting_bar_3d", model_name, torch.float32, rng, res, kernel=kernel)
    n, d, width = c["n"], c["d"], kernel_width(kernel)
    if width != 3:
        baseline_lib = None
    ctx = fl.fused_linearize_plain(*lin_args(c))[1:]
    cur = {"fused_linearize": lambda **kw: fl.fused_linearize_cuda(*lin_args(c), **kw),
           "fused_apply": lambda **kw: fa.fused_apply_cuda(*apply_args(c, ctx), **kw)}
    plain = {"fused_linearize": lambda: fl.fused_linearize_plain(*lin_args(c)),
             "fused_apply": lambda: fa.fused_apply_plain(*apply_args(c, ctx))}
    old = baseline_calls(baseline_lib, c, ctx) if baseline_lib is not None else None
    touched = int(torch.unique(c["st"].node_ids).numel())
    clamped = clamp_share(c)
    out = dict(res=res, kernel=kernel, model=model_name, particles=n, touched_nodes=touched,
               clamp_share=clamped, launch_config=fa.launch_config(d, width, 4))
    for name in names:
        fn = cur[name]
        cuda_name = name + "_kernel"
        row = {}
        if old is not None:
            want = plain[name]()
            want = want[0] if isinstance(want, tuple) else want
            row["baseline_rel_err"] = rel_err(old[name](), want)[1]
            turns = [("baseline", old[name]), ("current", fn), ("current", fn),
                     ("baseline", old[name])]
            for who, f in turns:
                row.setdefault(who + "_ms", []).append(device_ms(f, 50, cuda_name)[0])
        row["ms"], row["ms_source"] = device_ms(fn, 50, cuda_name)
        row["plain_ms"] = cuda_time_ms(plain[name], 3 if res > 64 else 5)
        nbytes = particle_kernel_bytes(name, n, touched, d, 4)
        flops = FLOPS_PER_PARTICLE[name, width] + (
            CLAMP_FLOPS * clamped if name == "fused_linearize" else 0)
        row["bytes"], row["flops"] = nbytes, n * flops
        row["bound_ms"], row["bound_by"] = bound(nbytes, row["flops"])
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if width == 3:
            row["table_bytes"] = table_kernel_bytes(name, n, res ** d, d, 4)
            row["table_bound_ms"] = bound(row["table_bytes"], row["flops"])[0]
        if sweep:
            row["sweep"] = []
            grid = SWEEP if width == 3 else SWEEP_CUBIC
            for threads in grid["threads"]:
                for nodes in grid["window_nodes"]:
                    with WindowStats() as ws:
                        fn(threads=threads, window_nodes=nodes)
                        share = ws.read()[name]["overflow_share"]
                    ms = device_ms(lambda: fn(threads=threads, window_nodes=nodes), 20,
                                   cuda_name)[0]
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


class PlasticShare:
    """Per step, the share of particles whose F the plasticity return map
    changed by more than 1e-4 relative (fp32 rounding of the rebuilt F is
    ~1e-7); kept on the device and read after the steps."""

    def __enter__(self):
        from hot_tpu_torch.sim import simulation as sim_mod

        self.mod, self.orig, self.shares = sim_mod, sim_mod.return_map, []

        def recorded(plasticity, F, state):
            F_new, Jp = self.orig(plasticity, F, state)
            if plasticity is not None:
                changed = (F_new - F).abs().amax((1, 2)) > 1e-4 * F.abs().amax((1, 2))
                self.shares.append(changed.float().mean())
            return F_new, Jp

        self.mod.return_map = recorded
        return self

    def __exit__(self, *exc):
        self.mod.return_map = self.orig

    def read(self):
        return [float(t) for t in self.shares]


class InsideTimer:
    """Seconds, points and faces of each mesh inside test, and the points
    found inside."""

    def __enter__(self):
        from hot_tpu_torch.io import mesh

        self.mod, self.orig, self.calls = mesh, mesh.points_inside_mesh, []

        def timed(points, verts, faces):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(points, verts, faces)
            torch.cuda.synchronize()
            self.calls.append(dict(seconds=time.perf_counter() - t0, points=int(points.shape[0]),
                                   faces=len(faces), inside=int(out.sum())))
            return out

        self.mod.points_inside_mesh = timed
        return self

    def __exit__(self, *exc):
        self.mod.points_inside_mesh = self.orig


class Attempts:
    """Every attempt of Simulation.step (a dt retry repeats the step at half
    dt): its dt and StepStats, read after the steps."""

    def __enter__(self):
        from hot_tpu_torch.sim import simulation as sim_mod

        self.mod, self.orig, self.stats = sim_mod, sim_mod.advance_one_step, []

        def recorded(state, dt, t, **kw):
            new_state, stats = self.orig(state, dt, t, **kw)
            self.stats.append((dt, stats))
            return new_state, stats

        self.mod.advance_one_step = recorded
        return self

    def __exit__(self, *exc):
        self.mod.advance_one_step = self.orig

    def retried(self, accepted):
        """The attempts that were not accepted: (dt, newton, cg, converged,
        cn_residual)."""
        kept = {id(s) for s in accepted}
        return [(dt, s.newton_iters, s.cg_iters, s.converged, s.cn_residual)
                for dt, s in self.stats if id(s) not in kept]


def launch_counts():
    """Each kernel's launches so far (the tracer's counters)."""
    from hot_tpu_torch.utils.timing import TRACER

    return {k: TRACER.counts["launches." + k] for k in ("fused_apply", "fused_linearize",
                                                        "bsr_spmv", "fused_block_diag")}


def counted(fn):
    """(fn(), each kernel's launches during it)."""
    before = launch_counts()
    out = fn()
    return out, {k: v - before[k] for k, v in launch_counts().items()}


def mg_spmv_launches(mgc, newton, cg, first_assembled=0):
    """(per build, per V-cycle, total) bsr_spmv launches of config 3, from
    solver/multigrid.py: every level from first_assembled on is assembled,
    so each SpMV is one launch. Per build (one per Newton iteration that
    solves): power_iters for each assembled Chebyshev level above the
    coarsest. Per V-cycle (one per CG iteration plus one for the initial
    residual): on each assembled level above the coarsest, pre- and
    post-smoothing apply the operator pre_smooth*order and post_smooth*order
    times, and the level residual once; the coarsest level is a Cholesky
    solve. A matrix-free level above runs the same counts through
    fused_apply (composed_apply_launches)."""
    smoothed = mgc.levels - 1 - first_assembled
    per_build = mgc.power_iters * smoothed
    per_vcycle = smoothed * ((mgc.pre_smooth + mgc.post_smooth) * mgc.chebyshev_order + 1)
    return per_build, per_vcycle, per_build * sum(newton) + per_vcycle * (sum(cg) + sum(newton))


def composed_apply_launches(mgc, newton, cg):
    """fused_apply launches of config 3 with a matrix-free level 0 above the
    composed level 1: the outer CG's sum(cg) + sum(newton), and level 0's
    power_iters per build and (pre_smooth + post_smooth) * chebyshev_order
    smoother applications plus one residual per V-cycle."""
    solves = sum(cg) + sum(newton)
    per_vcycle = (mgc.pre_smooth + mgc.post_smooth) * mgc.chebyshev_order + 1
    return solves + mgc.power_iters * sum(newton) + per_vcycle * solves


def block_diag_launches(newton, mgc=None):
    """fused_block_diag launches for these Newton counts: one preconditioner
    build per Newton iteration that solves, which under block-Jacobi (mgc
    None) launches once, and under the multigrid once per matrix-free level
    (every level of the default multigrid; the levels above
    assembled_from_level of an assembled one)."""
    if mgc is None:
        return sum(newton)
    return (mgc.assembled_from_level if mgc.assembled else mgc.levels) * sum(newton)


def expected_launches(newton, cg, minres=False, mgc=None):
    """The launches the step's code implies for these Newton and inner
    iteration counts: one linearize per Newton iterate (and one at v0); one
    apply per inner iteration plus one per solve for the initial residual
    (MINRES: two, the second for the first preconditioned residual); the
    SpMVs of config 3 (mgc) or none; the block-diagonal launches of the
    preconditioner builds (block_diag_launches)."""
    return {"fused_apply": sum(cg) + (2 if minres else 1) * sum(newton),
            "fused_linearize": sum(k + 1 for k in newton),
            "bsr_spmv": 0 if mgc is None else mg_spmv_launches(mgc, newton, cg)[2],
            "fused_block_diag": block_diag_launches(newton, mgc)}


def step_record(sim, stats, seconds):
    newton = [s.newton_iters for s in stats]
    return dict(particles=sim.state.n, nodes=math.prod(sim.cfg.grid_res[:sim.cfg.dim]),
                steps=len(stats), seconds=seconds, steps_per_s=len(stats) / seconds,
                newton=newton, cg=[s.cg_iters for s in stats],
                cg_per_newton=sum(s.cg_iters for s in stats) / max(sum(newton), 1),
                converged=[s.converged for s in stats], retries=sim.retry_count,
                max_memory_allocated=torch.cuda.max_memory_allocated())


def assert_steps_ok(sim, stats, row, max_retries=0):
    """Finite state, every step converged with no dt retry (max_retries
    where a case is known to need one), and Newton at work from the first
    step (stress_state's velocities; a scene may relax to Newton 0 later, as
    the chain's stiff rings do by their third step)."""
    assert bool(torch.isfinite(sim.state.x).all() and torch.isfinite(sim.state.Ff).all()), row
    assert all(s.converged for s in stats) and sim.retry_count <= max_retries, row
    assert stats[0].newton_iters > 0, row


def mf_mg_apply_launches(mgc, newton, cg):
    """(per build, per V-cycle, total) fused_apply launches of the default
    multigrid, every level matrix-free, from solver/multigrid.py: per build
    (one per Newton iteration that solves), power_iters on every level (each
    needs Chebyshev's lambda_max when the coarse solve is the smoother); per
    V-cycle (one per CG iteration plus one for the initial residual), on
    each level above the coarsest (pre_smooth + post_smooth) x
    chebyshev_order smoother applications and one residual, and
    coarse_iters x chebyshev_order on the coarsest; plus the outer CG's
    sum(cg) + sum(newton)."""
    assert (mgc.smoother, mgc.coarse_solver, mgc.cycles, mgc.assembled) == (
        "chebyshev", "smoother", 1, False), mgc
    per_build = mgc.power_iters * mgc.levels
    per_vcycle = ((mgc.levels - 1) * ((mgc.pre_smooth + mgc.post_smooth) * mgc.chebyshev_order + 1)
                  + mgc.coarse_iters * mgc.chebyshev_order)
    solves = sum(cg) + sum(newton)
    return per_build, per_vcycle, solves + per_build * sum(newton) + per_vcycle * solves


def card_against_cpu(overrides, model_name=None):
    """3 steps at 32^3 (ppc 4) of the twisting bar with config overrides
    (and a model) on the card (fp32) and on the CPU (plain versions, fp64)
    from one state: per step the (newton, cg) pairs and max |x_card -
    x_cpu| / dx."""
    from hot_tpu_torch.models.constitutive import MODEL_REGISTRY
    from hot_tpu_torch.scenes import build_scene
    from hot_tpu_torch.sim import Simulation
    from hot_tpu_torch.sim.state import state_from_numpy
    from hot_tpu_torch.utils.config import config_from_overrides

    base = build_scene("twisting_bar_3d", device="cpu", res=32, ppc=4, dtype=torch.float64)
    arrays = base["state"].to_numpy()
    sims = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        sc = build_scene("twisting_bar_3d", device=dev, res=32, ppc=4, dtype=dtype)
        model = MODEL_REGISTRY[model_name] if model_name else sc["model"]
        sims[dev] = Simulation(config_from_overrides(sc["cfg"], overrides),
                               state_from_numpy(arrays, dev, dtype), model, sc["colliders"])
    rows = []
    for _ in range(3):
        g, c = sims["cuda"].step(DT), sims["cpu"].step(DT)
        dxmax = float((sims["cuda"].state.x.double().cpu() - sims["cpu"].state.x).abs().max())
        rows.append(dict(newton=(g.newton_iters, c.newton_iters), cg=(g.cg_iters, c.cg_iters),
                         converged=(g.converged, c.converged),
                         x_diff_over_dx=dxmax / base["cfg"].dx))
    return base["state"].n, rows


# ---- the sparse tile grid and the composed Galerkin level

SPARSE_RES = 128
SCALE_RES = 256
SCALE_TILES = 16384


def compact_inputs(c, rng):
    """Input set c with its grid vectors v and w on the compact nodes of its
    particles' tile grid; returns the grid."""
    from hot_tpu_torch.grid import sparse

    x = c["x_soa"].T.contiguous()
    tg = sparse.build_tile_grid(x, c["dx"], c["res"], capacity=10 ** 9)
    dtype = c["v"].dtype
    c["v"], c["w"] = (torch.as_tensor(rng.standard_normal((tg.n_cnodes, c["d"])), dtype=dtype,
                                      device="cuda") for _ in range(2))
    c["tgrid"] = tg
    c["st"] = sparse.sparse_stencil(x, c["dx"], tg)
    return tg


def check_sparse_kernels(c, timing):
    """Both particle kernels on compact node ids (input set c from
    compact_inputs) against their plain versions on the same tile grid, and
    against the dense instance on the same values scattered onto the dense
    grid (compact_to_dense); with `timing`, each compact and dense kernel's
    device ms per launch, the plain versions' ms, the window counters of
    the compact launches and the bounds from this run's inputs: the touched
    nodes, and for the compact kernels the lookup entries of their tiles."""
    from hot_tpu_torch.grid import sparse
    from hot_tpu_torch.ops import fused_apply as fa
    from hot_tpu_torch.ops import fused_linearize as fl

    tg, d, dtype = c["tgrid"], c["d"], c["v"].dtype
    lin = lin_args(c) + (tg,)
    dense_v = sparse.compact_to_dense(tg, c["v"])
    dense_lin = (dense_v,) + lin_args(c)[1:]
    with WindowStats() as ws:
        got = fl.fused_linearize_cuda(*lin)
        want = fl.fused_linearize_plain(*lin)
        apply = (c["w"],) + apply_args(c, want[1:])[1:] + (tg,)
        got_df = fa.fused_apply_cuda(*apply)
        windows = ws.read()
    want_df = fa.fused_apply_plain(*apply)
    dense_f = fl.fused_linearize_cuda(*dense_lin)[0]
    dense_apply = (sparse.compact_to_dense(tg, c["w"]),) + apply_args(c, want[1:])[1:]
    dense_df = fa.fused_apply_cuda(*dense_apply)
    errs = {"lin_f": rel_err(got[0], want[0]), "lin_A": rel_err(got[3], want[3]),
            "lin_b_plus": rel_err(got[4], want[4]), "lin_b_minus": rel_err(got[5], want[5]),
            "apply_df": rel_err(got_df, want_df),
            "lin_f_vs_dense": rel_err(sparse.compact_to_dense(tg, got[0]), dense_f),
            "apply_df_vs_dense": rel_err(sparse.compact_to_dense(tg, got_df), dense_df),
            "dump_row": (float(got[0][tg.dump].abs().max() + got_df[tg.dump].abs().max()),) * 2}
    tol = TOL[dtype]
    limits = {k: tol["apply"] if "apply" in k else tol["linearize"] for k in errs}
    limits["dump_row"] = 0.0
    bad = {k: v[1] for k, v in errs.items() if not v[1] <= limits[k]}
    out = dict(tiles=tg.n_active, compact_nodes=tg.n_cnodes,
               dense_nodes=math.prod(c["res"]), particles=c["n"], windows=windows,
               rel_err={k: v[1] for k, v in errs.items()},
               max_abs_err={k: v[0] for k, v in errs.items()}, limits=limits)
    if timing:
        touched = int(torch.unique(c["st"].node_ids).numel())
        calls = {("fused_linearize", "compact"): lambda: fl.fused_linearize_cuda(*lin),
                 ("fused_apply", "compact"): lambda: fa.fused_apply_cuda(*apply),
                 ("fused_linearize", "dense"): lambda: fl.fused_linearize_cuda(*dense_lin),
                 ("fused_apply", "dense"): lambda: fa.fused_apply_cuda(*dense_apply)}
        plain = {"fused_linearize": lambda: fl.fused_linearize_plain(*lin),
                 "fused_apply": lambda: fa.fused_apply_plain(*apply)}
        clamped = clamp_share(c)
        for (name, grid), fn in calls.items():
            nbytes = particle_kernel_bytes(name, c["n"], touched, d, 4)
            if grid == "compact":
                nbytes += 4 * tg.n_active
            flops = c["n"] * (FLOPS_PER_PARTICLE[name, 3]
                              + (CLAMP_FLOPS * clamped if name == "fused_linearize" else 0))
            row = dict(bytes=nbytes, flops=flops)
            row["ms"], row["ms_source"] = device_ms(fn, 50, name + "_kernel")
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
            if grid == "compact":
                row["plain_ms"] = cuda_time_ms(plain[name], 3)
            out[f"{name}_{grid}"] = row
    return out, bad


def sparse_run(scene, cfg, start, t_start, steps, record=False):
    """`steps` steps of one configuration from a saved state: (the
    Simulation, StepStats, seconds, launches, MG build ms per build, and with
    `record` the (state, t) before each step)."""
    from hot_tpu_torch.sim import Simulation
    from hot_tpu_torch.solver import multigrid as mg_mod

    sim = Simulation(cfg, start, scene["model"], scene["colliders"])
    sim.t = t_start
    before = []

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = []
        for _ in range(steps):
            if record:
                before.append((sim.state, sim.t))
            stats.append(sim.step(DT))
        torch.cuda.synchronize()
        return stats, time.perf_counter() - t0

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with BuildTimer(mg_mod) as bt:
        (stats, seconds), launches = counted(run)
    return sim, stats, seconds, launches, bt.ms(), before


class ComposedTimer:
    """CUDA-event ms of each composed Galerkin assembly, RAP and quadrature
    assembly inside the multigrid builds (read after the steps)."""

    def __enter__(self):
        from hot_tpu_torch.ops import bsr, composed, spgemm

        # multigrid calls these through its module references, so it calls
        # the patched attributes
        self.events = {"composed": [], "rap": [], "quadrature": []}
        self.patched = [(composed, "assemble_composed_galerkin", "composed"),
                        (spgemm, "rap", "rap"), (bsr, "assemble_hessian", "quadrature")]
        self.orig = []
        for mod, name, key in self.patched:
            fn = getattr(mod, name)
            self.orig.append(fn)
            setattr(mod, name, self._timed(fn, key))
        return self

    def _timed(self, fn, key):
        def timed(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events[key].append((start, end))
            return out
        return timed

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.patched, self.orig):
            setattr(mod, name, fn)

    def ms(self):
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.events.items()}


def hierarchy_split(sim):
    """Per level of the step's multigrid hierarchy: compact or dense, and its
    node count (compact nodes, or the dense grid's)."""
    from hot_tpu_torch.grid import sparse
    from hot_tpu_torch.solver import multigrid as mg_mod

    cfg = sim.cfg
    mgc = cfg.solver.multigrid
    res = tuple(cfg.grid_res[:3])
    tg = (sparse.build_tile_grid(sim.state.x, cfg.dx, res, cfg.tile_capacity)
          if cfg.grid_backend == "sparse" else None)
    mgs = mg_mod.build_static(sim.state.x, sim.state.m, res, cfg.dx, mgc.levels,
                              torch.zeros(tg.n_cnodes if tg else math.prod(res), dtype=torch.bool,
                                          device="cuda"), sim.state.x.dtype,
                              tgrid=tg, tile_capacity=cfg.tile_capacity,
                              dense_switch=mgc.sparse_dense_switch)
    return [dict(level=l, res=lv.res[0], compact=lv.tgrid is not None,
                 nodes=int(lv.grid_m.shape[0]), tiles=lv.tgrid.n_active if lv.tgrid else None,
                 active_nodes=int(lv.active.sum()))
            for l, lv in enumerate(mgs.levels)]


def composed_against_rap(rng):
    """On the 64^3 bar in fp64, at one Newton state (F perturbed by 0.1):
    the composed level-1 operator against spgemm.rap of the assembled fine
    operator, on the RAP operator's rows and columns (the composed level
    also has rows for the nodes of its active tiles that carry no mass);
    relative to the RAP operator's largest entry."""
    from hot_tpu_torch.ops import composed as comp_mod
    from hot_tpu_torch.ops import transfer
    from hot_tpu_torch.scenes import build_scene
    from hot_tpu_torch.sim import objective as obj_mod
    from hot_tpu_torch.solver import multigrid as mg_mod
    from hot_tpu_torch.utils.config import MultigridConfig

    dtype = torch.float64
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
    mcfg = MultigridConfig(levels=2, coarse_solver="cg", assembled=True)
    cons = torch.zeros(n_nodes, dtype=torch.bool, device="cuda")
    mats = {}
    seconds = {}
    for label, first in (("rap", 0), ("composed", 1)):
        mgs = mg_mod.build_static(state.x, state.m, res, cfg.dx, 2, cons, dtype,
                                  assembled_from=first, composed=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mats[label] = mg_mod.build_precond(mgs, F, hess, state.V0, DT, mcfg, 3).mats[1]
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
    rap, comp = mats["rap"], mats["composed"]
    rows = comp.row_of[rap.node_of]
    assert bool((rows >= 0).all()) and comp.half == rap.half == comp_mod.structure_half(1)
    ok = rap.col_row >= 0
    assert bool((comp.col_row[rows] >= 0)[ok].all())
    err, rel = rel_err(comp.vals[rows][ok], rap.vals[ok])
    return dict(scene="twisting_bar_3d", res=64, dtype=str(dtype), rows_rap=rap.n_rows,
                rows_composed=comp.n_rows, half=comp.half, max_abs_err=err, rel_err=rel,
                limit=1e-10, build_s=seconds)


# ---- the batched stiffness sweep

# E_k = 1e6 * 2^(k/2), k = -4..3: half-octaves around the bar's default E
SWEEP_E = [1e6 * 2.0 ** (k / 2) for k in range(-4, 4)]
SWEEP_RES = 64
SWEEP_STEPS = 6
# The fp32 bar's members against themselves alone. fp32 trajectories part
# from run to run by the order of the atomic adds: on an H100 two lone runs
# of member 2 parted by up to 1.35e-4 dx (36 roundings of x) by step 6, and
# member 7's sixth step took 6 or 7 Newton iterations, alone or in the
# batch, so a check against one lone run at X_TOL failed 6 of 12 sweeps on
# two checkouts (python -m hot_tpu_torch.ab_batch_sweep), and one against
# 4 lone runs' counts fails where the batch took 6 and all 4 lone runs 7.
# Each member runs alone SWEEP_RUNS times and is held to them by
# hold_to_lone: x within the larger of X_TOL and SWEEP_SPREAD times the
# lone runs' spread, which may not pass SWEEP_SPREAD_CAP; the steps whose
# counts no lone run took are recorded. The counts are held on the same
# sweep in fp64, where two runs part by ~1e-14 dx: every member alone
# once, Newton equal at every step, CG within 1, x within DROP_X_TOL
SWEEP_RUNS = 4
SWEEP_SPREAD = 10.0
SWEEP_SPREAD_CAP = 10 * X_TOL
# the 2D sweep: 16 members, E log-spaced over 1e4..1e7, fp64, through impact;
# these members also run alone
DROP_E = np.logspace(4.0, 7.0, 16).tolist()
DROP_STEPS = 150
DROP_ALONE = (0, 5, 10, 15)
# a member in the fp64 batch against itself alone, in units of dx; CG stops
# within 1. Both runs are on the card, where the atomics' order parts two
# runs of one member alone too, and the impact amplifies that (on an H100
# two lone runs of E = 1e6 parted by over 1e-6 dx by step 150). So each of
# these members runs alone DROP_RUNS times, and the batch is held to the
# larger of DROP_X_TOL and DROP_SPREAD times the lone runs' largest
# difference from one another; lone runs parting by more than
# DROP_SPREAD_CAP fail the check (a limit that grows with them would hold
# nothing)
DROP_X_TOL = 1e-8
DROP_SPREAD = 10.0
DROP_SPREAD_CAP = 1e-4
DROP_RUNS = 3


def batch_kernel_inputs(kernel, dtype, rng, res=SWEEP_RES):
    """The particle kernels' inputs for a batch of len(SWEEP_E) members of
    the res^3 bar: one particle set, each member with its own E, its own
    F perturbation (0.1, from its own seed) and its own grid vectors v, w.
    Returns the stacked input set and the members' own (single) sets."""
    from hot_tpu_torch.models.constitutive import MODEL_REGISTRY, lame_parameters
    from hot_tpu_torch.ops import transfer
    from hot_tpu_torch.ops.fused_apply import soa
    from hot_tpu_torch.scenes import build_scene

    state = build_scene("twisting_bar_3d", device="cuda", dtype=dtype, res=res, ppc=8)["state"]
    n, grid = state.n, (res,) * 3
    st = transfer.particle_stencil(state.x, 1.0 / res, grid, kernel=kernel)
    common = dict(model=MODEL_REGISTRY["fixed_corotated"], dx=1.0 / res, res=grid, n=n, d=3,
                  project=True, kernel=kernel, st=st, groups=[])
    members = []
    for k, E in enumerate(SWEEP_E):
        mrng = np.random.default_rng([int(rng.integers(2 ** 31)), k])
        mu, lam = lame_parameters(E, 0.3)
        F = state.F + torch.as_tensor(0.1 * mrng.standard_normal((n, 3, 3)), dtype=dtype,
                                      device="cuda")
        v, w = (torch.as_tensor(mrng.standard_normal((res ** 3, 3)), dtype=dtype, device="cuda")
                for _ in range(2))
        members.append(dict(common, F=F, F_soa=soa(F), x_soa=soa(state.x), v=v, w=w,
                            mu=torch.full_like(state.mu, mu), lam=torch.full_like(state.lam, lam),
                            V0=state.V0))
    stacked = dict(common, **{key: torch.stack([m[key] for m in members])
                              for key in ("F_soa", "x_soa", "v", "w", "mu", "lam", "V0")})
    return stacked, members


def check_batch_kernels(c, members, timing):
    """Both particle kernels on a batch (one launch each) against their plain
    versions on the same batch, per member (each against its own largest
    entry), and against one launch per member; the launch counters move by
    one per batched call. With `timing` (fp32): device ms of one batched
    launch and of the members' single launches together, the plain batched
    call's ms, and the bound of the batch's bytes and flops (B times one
    member's, from the touched nodes and each member's clamp share)."""
    from hot_tpu_torch.ops import fused_apply as fa
    from hot_tpu_torch.ops import fused_linearize as fl

    B, dtype = len(members), c["v"].dtype
    before = launch_counts()
    got = fl.fused_linearize_cuda(*lin_args(c))
    want = fl.fused_linearize_plain(*lin_args(c))
    apply = apply_args(c, want[1:])
    got_df = fa.fused_apply_cuda(*apply)
    launches = {k: launch_counts()[k] - before[k] for k in ("fused_linearize", "fused_apply")}
    want_df = fa.fused_apply_plain(*apply)
    alone = []
    for b, m in enumerate(members):
        out = fl.fused_linearize_cuda(*lin_args(m))
        alone.append(out + (fa.fused_apply_cuda(*apply_args(m, tuple(t[b] for t in want[1:]))),))
    errs = {}
    names = ("f", "U", "V", "A", "b_plus", "b_minus")
    for b in range(B):
        for name, g, w in zip(("f", "A", "b_plus", "b_minus"), (got[0], got[3], got[4], got[5]),
                              (want[0], want[3], want[4], want[5])):
            errs[f"lin_{name}[{b}]"] = rel_err(g[b], w[b])
        errs[f"apply_df[{b}]"] = rel_err(got_df[b], want_df[b])
        for name, g, a in zip(names + ("df",), got + (got_df,), alone[b]):
            errs[f"alone_{name}[{b}]"] = rel_err(g[b], a)
    tol = TOL[dtype]
    limits = {k: tol["apply"] if "df" in k else tol["linearize"] for k in errs}
    bad = {k: v[1] for k, v in errs.items() if not v[1] <= limits[k]}
    worst = {key: max(v[1] for k, v in errs.items() if k.startswith(key + "["))
             for key in ("lin_f", "lin_A", "lin_b_plus", "lin_b_minus", "apply_df")
             + tuple(f"alone_{n}" for n in names + ("df",))}
    out = dict(members=B, particles_per_member=c["n"], kernel=c["kernel"], dtype=str(dtype),
               launches_per_batched_call=launches, rel_err_worst_member=worst,
               max_abs_err=max(v[0] for k, v in errs.items() if k.startswith("lin_f[")),
               max_abs_err_apply=max(v[0] for k, v in errs.items() if k.startswith("apply_df[")),
               limits=TOL[dtype])
    if launches != {"fused_linearize": 1, "fused_apply": 1}:
        bad["launches"] = launches
    if timing:
        touched = int(torch.unique(c["st"].node_ids).numel())
        clamped = float(np.mean([clamp_share(m) for m in members]))
        width = 4 if c["kernel"] == "cubic" else 3
        calls = {"fused_linearize": lambda: fl.fused_linearize_cuda(*lin_args(c)),
                 "fused_apply": lambda: fa.fused_apply_cuda(*apply)}
        singles = {"fused_linearize": lambda: [fl.fused_linearize_cuda(*lin_args(m))
                                               for m in members],
                   "fused_apply": lambda: [
                       fa.fused_apply_cuda(*apply_args(m, tuple(t[b] for t in want[1:])))
                       for b, m in enumerate(members)]}
        plain = {"fused_linearize": lambda: fl.fused_linearize_plain(*lin_args(c)),
                 "fused_apply": lambda: fa.fused_apply_plain(*apply)}
        for name in calls:
            nbytes = B * particle_kernel_bytes(name, c["n"], touched, 3, 4)
            flops = B * c["n"] * (FLOPS_PER_PARTICLE[name, width]
                                  + (CLAMP_FLOPS * clamped if name == "fused_linearize" else 0))
            row = dict(bytes=nbytes, flops=flops)
            row["ms"], row["ms_source"] = device_ms(calls[name], 20, name + "_kernel")
            single_ms, _ = device_ms(singles[name], 10, name + "_kernel")
            row["singles_ms"] = B * single_ms
            row["plain_ms"] = cuda_time_ms(plain[name], 2)
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            out[name] = row
        out["clamp_share"] = clamped
    return out, bad


class CGCalls:
    """Each inner CG (or MINRES) solve of Newton inside: its iterations (per
    member for a batch), read after the steps."""

    def __enter__(self):
        from hot_tpu_torch.solver import newton

        self.mod, self.orig, self.iters = newton, dict(newton.SOLVERS), []

        def recorded(solve):
            def run(*args, **kw):
                res = solve(*args, **kw)
                self.iters.append(res.iters)
                return res
            return run

        for name, solve in self.orig.items():
            newton.SOLVERS[name] = recorded(solve)
        return self

    def __exit__(self, *exc):
        self.mod.SOLVERS.update(self.orig)


def sweep_run(scene, cfg, state, steps, dt, t_start=0.0):
    """`steps` Simulation steps at dt of one state or batch, from t_start:
    (Simulation, StepStats, seconds, launches, CG iterations per solve,
    peak device memory, the state after each step)."""
    from hot_tpu_torch.sim import Simulation

    sim = Simulation(cfg, state, scene["model"], scene["colliders"])
    sim.t = t_start
    states = []

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = []
        for _ in range(steps):
            stats.append(sim.step(dt))
            states.append(sim.state)
        torch.cuda.synchronize()
        return stats, time.perf_counter() - t0

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with CGCalls() as cg:
        (stats, seconds), launches = counted(run)
    return sim, stats, seconds, launches, cg.iters, torch.cuda.max_memory_allocated(), states


def with_E(state, E):
    """The state with every particle at Young's modulus E (nu 0.3)."""
    from hot_tpu_torch.models.constitutive import lame_parameters

    mu, lam = lame_parameters(E, 0.3)
    return state.replace(mu=torch.full_like(state.mu, mu), lam=torch.full_like(state.lam, lam))


def scene_members(name, kw, Es, dtype):
    """A scene (on the card) and its state at each stiffness of Es."""
    from hot_tpu_torch.scenes import build_scene

    scene = build_scene(name, device="cuda", dtype=dtype, **kw)
    return scene, [with_E(scene["state"], E) for E in Es]


def hold_to_lone(newton, cg, xs, lone, dx, cg_diff, x_tol, spread=None, cap=None,
                 counts=True):
    """Member b of a batch (its Newton and CG per step, its x per step)
    against its lone runs `lone` ((stats, x per step) each): at every step a
    lone run took the batch's Newton count with CG within cg_diff, and x is
    within the limit of the nearest lone run, the limit being the larger of
    x_tol and `spread` times the lone runs' largest mutual difference (in
    dx), which may not pass `cap`. With one lone run: Newton equal, CG
    within cg_diff, x within x_tol. With counts False the steps whose counts
    no lone run took are returned and not failed. Returns (nearest, limit,
    lone spread, the steps no lone run's counts matched, what failed)."""
    unmatched = [k for k, (n, c) in enumerate(zip(newton, cg))
                 if not any(s[k].newton_iters == n and abs(s[k].cg_iters - c) <= cg_diff
                            for s, _ in lone)]
    failed = [f"counts at step {k}" for k in unmatched] if counts else []
    nearest = min(max(float((xb - xa).abs().max()) for xb, xa in zip(xs, x)) / dx
                  for _, x in lone)
    lone_spread = max((max(float((xa - xc).abs().max()) for xa, xc in zip(a[1], c[1])) / dx
                       for i, a in enumerate(lone) for c in lone[i + 1:]), default=0.0)
    limit = max(x_tol, (spread or 0.0) * lone_spread)
    if cap is not None and lone_spread > cap:
        failed.append(f"lone runs part by {lone_spread} dx")
    if nearest > limit:
        failed.append(f"x {nearest} dx")
    return nearest, limit, lone_spread, unmatched, failed


def batch_phase(rng, card):
    """Phase 19: both particle kernels on a batch of 8 members of the 64^3
    bar (one launch per call) against their plain versions and the members'
    single launches; the stiffness sweep users run in place of 8 processes
    (the 64^3 bar at 8 stiffnesses, 6 steps, then each member alone, in
    fp32 and in fp64); the 2D sweep through impact (16 members, fp64, 150
    steps). Returns the fp32 kernel rows by stencil and the three sweeps'
    rows."""
    batch_summary = {}
    for kernel in ("quadratic", "cubic"):
        for dtype in (torch.float32, torch.float64):
            c, members = batch_kernel_inputs(kernel, dtype, rng)
            row, bad = check_batch_kernels(c, members, timing=dtype == torch.float32)
            emit("batch", card=card, case="kernels", **row)
            if bad:
                raise AssertionError(f"batched kernel disagrees: {bad}")
            if dtype == torch.float32:
                batch_summary[kernel] = row
            del c, members
            torch.cuda.empty_cache()
    sweeps = {}
    for label, name, kw, Es, dtype, steps, alone, limits in (
            ("bar", "twisting_bar_3d", dict(res=SWEEP_RES, ppc=8), SWEEP_E, torch.float32,
             SWEEP_STEPS, range(len(SWEEP_E)),
             dict(cg_diff=2, x_tol=X_TOL, spread=SWEEP_SPREAD, runs=SWEEP_RUNS,
                  cap=SWEEP_SPREAD_CAP, counts=False)),
            ("bar_fp64", "twisting_bar_3d", dict(res=SWEEP_RES, ppc=8), SWEEP_E,
             torch.float64, SWEEP_STEPS, range(len(SWEEP_E)),
             dict(cg_diff=1, x_tol=DROP_X_TOL)),
            ("drop", "block_drop_2d", dict(res=64), DROP_E, torch.float64, DROP_STEPS,
             DROP_ALONE, dict(cg_diff=1, x_tol=DROP_X_TOL, spread=DROP_SPREAD,
                              runs=DROP_RUNS, cap=DROP_SPREAD_CAP))):
        scene, members = scene_members(name, kw, Es, dtype)
        row, bad, _ = solver_sweep(label, "cg", scene, scene["cfg"], members, steps, DT, alone,
                                   **limits)
        emit("batch", card=card, case=f"sweep_{label}", scene=name, E=Es, **row)
        if bad:
            raise AssertionError(f"sweep {label}: {bad}; {row}")
        sweeps[label] = row
        torch.cuda.empty_cache()
    assert sum(sum(n) for n in sweeps["bar"]["newton"]) > 0, sweeps["bar"]
    assert sum(sum(n) for n in sweeps["bar_fp64"]["newton"]) > 0, sweeps["bar_fp64"]
    assert min(sum(n) for n in sweeps["drop"]["newton"]) > 0, sweeps["drop"]
    return batch_summary, sweeps


# ---- the batch under HOT's multigrid, the sparse grid and the other solvers

# (b): three members alone (the softest, a middle one, the stiffest); fp64
# multigrid runs on the card part by ~1e-14 dx, so one lone run each
SOLVER_STEPS = 3
SOLVER_ALONE = (0, 4, 7)
# (c): the 128^3 bar at the 4 stiffest of SWEEP_E (1e6 .. 2.83e6), 3 steps
# after phase sparse's 2 loading steps (at the scene's E 1e6); the softest
# and the stiffest member also alone
WIDE_E = SWEEP_E[4:]
WIDE_STEPS = 3
WIDE_ALONE = (0, 3)
# (d): the 64^2 drop at the 16 stiffnesses of DROP_E through impact (t =
# 0.244 s), members 0 and 15 alone twice each under MINRES and the explicit
# BSR (dt 4e-3). L-BFGS runs at dt 2e-3: at 4e-3 the stiff members exhaust
# max_cg iterations after impact and the shared dt is halved for the whole
# batch. Its lone runs reproduce on the card only for the softer members:
# two lone runs of a stiff member part in their iteration counts after
# impact, as L-BFGS's line search and CN test turn on the atomics' order.
# So members 0 and 5 are held and member 15 is a witness, recorded
DROP_SOLVER_DT = 4e-3
DROP_SOLVER_STEPS = 66
DROP_SOLVER_ALONE = (0, 15)
LBFGS_DT = 2e-3
LBFGS_STEPS = 127
LBFGS_ALONE = (0, 5)
LBFGS_WITNESS = (15,)


def shifted_member(state, cells, dx):
    """The state moved by `cells` cells along y: another tile set."""
    shift = torch.zeros(3, dtype=state.x.dtype, device=state.x.device)
    shift[1] = cells * dx
    return state.replace(x=state.x + shift)


def member_cells(b):
    """Member b's shift in cells: a whole tile and 1.5 cells per member,
    the batch centred on the scene (64^3 bar: y from 4 to 54 of 64)."""
    from hot_tpu_torch.grid import sparse

    return (b - len(SWEEP_E) // 2) * (sparse.TILE + 1.5)


def batch_tiled_inputs(dtype, rng, res=SWEEP_RES):
    """Phase 20a's inputs: len(SWEEP_E) members of the res^3 bar, each moved
    by member_cells(b) (its own tile set), with its own E, F perturbation
    (0.1) and grid vectors over the batch's compact nodes. Returns the
    stacked set (with the batch's tile grid) and the members' own sets (each
    on its own tile grid, its compact rows of the batch's vectors)."""
    from hot_tpu_torch.grid import sparse
    from hot_tpu_torch.models.constitutive import MODEL_REGISTRY, lame_parameters
    from hot_tpu_torch.ops.fused_apply import soa
    from hot_tpu_torch.scenes import build_scene

    state = build_scene("twisting_bar_3d", device="cuda", dtype=dtype, res=res, ppc=8)["state"]
    n, grid, dx = state.n, (res,) * 3, 1.0 / res
    xs = [shifted_member(state, member_cells(b), dx).x for b in range(len(SWEEP_E))]
    tg = sparse.build_tile_grid(torch.stack(xs), dx, grid, capacity=10 ** 9)
    common = dict(model=MODEL_REGISTRY["fixed_corotated"], dx=dx, res=grid, n=n, d=3,
                  project=True, kernel="quadratic", groups=[])
    Fs, mus, lams = [], [], []
    for k, E in enumerate(SWEEP_E):
        mrng = np.random.default_rng([int(rng.integers(2 ** 31)), k])
        mu, lam = lame_parameters(E, 0.3)
        Fs.append(state.F + torch.as_tensor(0.1 * mrng.standard_normal((n, 3, 3)), dtype=dtype,
                                            device="cuda"))
        mus.append(torch.full_like(state.mu, mu))
        lams.append(torch.full_like(state.lam, lam))
    B = len(SWEEP_E)
    v, w = (torch.as_tensor(rng.standard_normal((B, tg.n_cnodes, 3)), dtype=dtype,
                            device="cuda") for _ in range(2))
    stacked = dict(common, x_soa=soa(torch.stack(xs), 1), F_soa=soa(torch.stack(Fs), 1), v=v,
                   w=w, mu=torch.stack(mus), lam=torch.stack(lams),
                   V0=torch.stack([state.V0] * B), tgrid=tg,
                   st=sparse.sparse_stencil(torch.stack(xs), dx, tg))
    members = []
    for b in range(B):
        own = tg.member(b)

        def own_rows(t, b=b, rows=own.n_cnodes - 1):
            return torch.cat([t[b, :rows], t[b, -1:]])

        members.append(dict(common, x_soa=soa(xs[b]), F=Fs[b], F_soa=soa(Fs[b]), v=own_rows(v),
                            w=own_rows(w), mu=mus[b], lam=lams[b], V0=state.V0, tgrid=own,
                            own_rows=own_rows, st=sparse.sparse_stencil(xs[b], dx, own)))
    return stacked, members


def check_batch_tiled_kernels(c, members, timing):
    """Phase 20a: both particle kernels on a batch's tile grid (one launch
    each) against their plain versions on the same batch, per member (f, A,
    b+- and df; U and V may differ by paired column signs), and every output
    against the member's own single launch on its own tile grid; the
    counters move by one per batched call. With `timing` (fp32): device ms
    of one batched launch and of the members' single launches together,
    the plain batched call's ms, and the bound from the members' touched
    nodes and their tiles' lookup entries."""
    from hot_tpu_torch.ops import fused_apply as fa
    from hot_tpu_torch.ops import fused_linearize as fl

    B, dtype, tg = len(members), c["v"].dtype, c["tgrid"]
    lin = lin_args(c) + (tg,)
    before = launch_counts()
    got = fl.fused_linearize_cuda(*lin)
    want = fl.fused_linearize_plain(*lin)
    apply = (c["w"],) + apply_args(c, want[1:])[1:] + (tg,)
    got_df = fa.fused_apply_cuda(*apply)
    launches = {k: launch_counts()[k] - before[k] for k in ("fused_linearize", "fused_apply")}
    want_df = fa.fused_apply_plain(*apply)
    names = ("f", "U", "V", "A", "b_plus", "b_minus", "df")
    errs = {}
    single_calls = []
    for b, m in enumerate(members):
        own = m["own_rows"]
        m_lin = lin_args(m) + (m["tgrid"],)
        m_apply = (m["w"],) + apply_args(m, tuple(t[b] for t in want[1:]))[1:] + (m["tgrid"],)
        single_calls.append((m_lin, m_apply))
        alone = fl.fused_linearize_cuda(*m_lin) + (fa.fused_apply_cuda(*m_apply),)
        for name, i in (("f", 0), ("A", 3), ("b_plus", 4), ("b_minus", 5)):
            errs[f"lin_{name}[{b}]"] = rel_err(got[i][b], want[i][b])
        errs[f"apply_df[{b}]"] = rel_err(got_df[b], want_df[b])
        for name, g, a in zip(names, got + (got_df,), alone):
            # f and df over the member's own compact rows
            errs[f"alone_{name}[{b}]"] = rel_err(own(g) if name in ("f", "df") else g[b], a)
    tol = TOL[dtype]
    limits = {k: tol["apply"] if "df" in k else tol["linearize"] for k in errs}
    bad = {k: v[1] for k, v in errs.items() if not v[1] <= limits[k]}
    worst = {key: max(v[1] for k, v in errs.items() if k.startswith(key + "["))
             for key in ("lin_f", "lin_A", "lin_b_plus", "lin_b_minus", "apply_df")
             + tuple(f"alone_{n}" for n in names)}
    out = dict(members=B, particles_per_member=c["n"], tiles=tg.member_tiles,
               slots_per_member=tg.n_active, dtype=str(dtype),
               launches_per_batched_call=launches, rel_err_worst_member=worst,
               max_abs_err=max(v[0] for k, v in errs.items() if k.startswith("lin_f[")),
               max_abs_err_apply=max(v[0] for k, v in errs.items() if k.startswith("apply_df[")),
               limits=TOL[dtype])
    if launches != {"fused_linearize": 1, "fused_apply": 1}:
        bad["launches"] = launches
    if timing:
        touched = [int(torch.unique(m["st"].node_ids).numel()) for m in members]
        clamped = float(np.mean([clamp_share(m) for m in members]))
        calls = {"fused_linearize": lambda: fl.fused_linearize_cuda(*lin),
                 "fused_apply": lambda: fa.fused_apply_cuda(*apply)}
        singles = {"fused_linearize": lambda: [fl.fused_linearize_cuda(*a)
                                               for a, _ in single_calls],
                   "fused_apply": lambda: [fa.fused_apply_cuda(*a) for _, a in single_calls]}
        plain = {"fused_linearize": lambda: fl.fused_linearize_plain(*lin),
                 "fused_apply": lambda: fa.fused_apply_plain(*apply)}
        for name in calls:
            nbytes = sum(particle_kernel_bytes(name, c["n"], t, 3, 4) + 4 * k
                         for t, k in zip(touched, tg.member_tiles))
            flops = B * c["n"] * (FLOPS_PER_PARTICLE[name, 3]
                                  + (CLAMP_FLOPS * clamped if name == "fused_linearize" else 0))
            row = dict(bytes=nbytes, flops=flops)
            row["ms"], row["ms_source"] = device_ms(calls[name], 20, name + "_kernel")
            single_ms, _ = device_ms(singles[name], 10, name + "_kernel")
            row["singles_ms"] = B * single_ms
            row["plain_ms"] = cuda_time_ms(plain[name], 2)
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            out[name] = row
        out["clamp_share"] = clamped
    return out, bad


class LastPrecond:
    """The last multigrid preconditioner built inside (its operators)."""

    def __init__(self, mg_mod):
        self.mg_mod, self.orig, self.pre = mg_mod, mg_mod.build_precond, None

    def __enter__(self):
        def kept(*args, **kw):
            self.pre = self.orig(*args, **kw)
            return self.pre

        self.mg_mod.build_precond = kept
        return self

    def __exit__(self, *exc):
        self.mg_mod.build_precond = self.orig


def member_rows(mat, b):
    """Member b's own rows of a batch's BSR operator, as one operator's
    (vals, col_row): its active rows, columns into them."""
    R = mat.member_rows
    own = int((mat.node_of[b * R:(b + 1) * R] < mat.row_of.shape[0]).sum())
    rows = slice(b * R, b * R + own)
    col = mat.col_row[rows]
    return mat.vals[rows].contiguous(), torch.where(col >= 0, col - b * R, col).contiguous()


def check_batch_spmv(mat, rng):
    """Phase 20b: bsr_spmv over a batch's level-0 operator (all members'
    rows, one launch) against its plain version, and against one SpMV per
    member on its own rows; device ms of both, the plain version's and the
    library call's, the bound from the batch's blocks."""
    from hot_tpu_torch.ops import bsr_spmv as sp

    B, R, d, dtype = mat.batch, mat.n_rows, mat.dim, mat.vals.dtype
    x = torch.as_tensor(rng.standard_normal((R, d)), dtype=dtype, device="cuda")
    args = (mat.vals, mat.col_row, x)
    got, want = sp.bsr_spmv_cuda(*args), sp.bsr_spmv_plain(*args)
    err, rel = rel_err(got, want)
    singles = []
    for b in range(B):
        vals, col = member_rows(mat, b)
        xb = x[b * mat.member_rows:b * mat.member_rows + vals.shape[0]]
        singles.append((vals, col, xb))
        alone = rel_err(got[b * mat.member_rows:b * mat.member_rows + vals.shape[0]],
                        sp.bsr_spmv_cuda(*singles[-1]))
        rel = max(rel, alone[1])
    nnz = int((mat.col_row >= 0).sum())
    item = x.element_size()
    nbytes = nnz * d * d * item + R * mat.K * 4 + 2 * R * d * item
    flops = 2 * nnz * d * d * (1 if dtype == torch.float32 else 2)
    A = library_bsr(mat)
    lib = lambda: (A @ x.reshape(-1, 1)).reshape(R, d)  # noqa: E731
    row = dict(members=B, rows=R, rows_per_member=mat.member_rows, K=mat.K, nnz_blocks=nnz,
               bytes=nbytes, max_abs_err=err, rel_err=rel, limit=SPMV_TOL[dtype],
               dtype=str(dtype))
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    row["ms"], row["ms_source"] = device_ms(lambda: sp.bsr_spmv_cuda(*args), 50,
                                            "bsr_spmv_kernel")
    row["singles_ms"] = device_ms(lambda: [sp.bsr_spmv_cuda(*a) for a in singles], 20,
                                  "bsr_spmv_kernel")[0] * B
    row["plain_ms"] = cuda_time_ms(lambda: sp.bsr_spmv_plain(*args), 10)
    row["library_ms"] = cuda_time_ms(lib, 50)
    if not rel <= SPMV_TOL[dtype]:
        raise AssertionError(f"batched bsr_spmv disagrees: {row}")
    return row


def batched_launches(kind, mgc, stats, cg_calls):
    """The launches a batch's steps imply (each loop runs while any member
    is active; stats and the solves per member): one linearize at v0 and one
    per batched Newton iteration, or for L-BFGS one per batched iteration
    (the gradient); per inner solve one apply per batched iteration plus
    one for the initial residual (MINRES: two), through bsr_spmv for the
    explicit BSR; and the multigrid's SpMVs and matrix-free level applies
    (mg_spmv_launches, composed_apply_launches) over the batched Newton
    iterations and CG iterations; one block-diagonal launch per batched
    build and matrix-free level (block_diag_launches), none for L-BFGS."""
    newton = [max(s.newton_iters) for s in stats]
    cg = [max(i) for i in cg_calls]
    solves = len(cg_calls)
    out = {"fused_linearize": sum(k + 1 for k in newton), "fused_apply": sum(cg) + solves,
           "bsr_spmv": 0, "fused_block_diag": block_diag_launches(
               newton, mgc if kind in ("config3", "composed") else None)}
    if kind == "lbfgs":
        out["fused_apply"] = out["fused_block_diag"] = 0
    elif kind == "minres":
        out["fused_apply"] = sum(cg) + 2 * solves
    elif kind == "explicit_bsr":
        out["fused_apply"], out["bsr_spmv"] = 0, sum(cg) + solves
    elif kind in ("config3", "composed"):
        first = mgc.assembled_from_level
        out["bsr_spmv"] = mg_spmv_launches(mgc, newton, cg, first)[2]
        if first:
            out["fused_apply"] = composed_apply_launches(mgc, newton, cg)
    return out


def solver_sweep(label, kind, scene, cfg, members, steps, dt, alone, cg_diff=None, x_tol=None,
                 spread=None, runs=1, cap=None, t_start=0.0, witness=(), counts=True):
    """Phases 19 and 20: `members` (single states) stepped as one batch
    under cfg (`kind` names the solver for batched_launches), then the
    members `alone` and `witness` one at a time (`runs` times each), from
    t_start: the batch's and the lone runs' (newton, cg) per member and
    step, max |x_batch - x_alone| / dx, the launch counters against
    batched_launches, member-steps/s of both, MG build ms per Newton, peak
    memory. With cg_diff the lone runs hold the members `alone`
    (hold_to_lone with x_tol, spread, cap and counts); without, and for
    `witness`, the counts and differences are recorded. Returns the row, what failed
    and the operators of the last multigrid preconditioner built in the
    batch (None without)."""
    from hot_tpu_torch.sim.state import stack_states
    from hot_tpu_torch.solver import multigrid as mg_mod

    def run(state):
        with BuildTimer(mg_mod) as bt:
            *out, states = sweep_run(scene, cfg, state, steps, dt, t_start)
        return (*out, [st.x for st in states], bt.ms())

    with LastPrecond(mg_mod) as last:
        sim, stats, seconds, launches, cg_calls, peak, xs, build_ms = run(stack_states(members))
    mgc = cfg.solver.multigrid
    want = batched_launches(kind, mgc, stats, cg_calls)
    B = len(members)
    newton = [[s.newton_iters[b] for s in stats] for b in range(B)]
    cg = [[s.cg_iters[b] for s in stats] for b in range(B)]
    row = dict(label=label, kind=kind, res=cfg.grid_res[0], dtype=str(members[0].x.dtype),
               backend=cfg.grid_backend, members=B, particles_per_member=members[0].n,
               steps=steps, dt=dt, seconds=seconds, member_steps_per_s=B * steps / seconds,
               newton=newton, cg=cg, converged=all(all(s.converged) for s in stats),
               retries=sim.retry_count, active_tiles=[s.active_tiles for s in stats],
               batched_inner_per_solve=[max(i) for i in cg_calls], launches=launches,
               launches_expected=want, max_memory_allocated=peak,
               mg_build_ms_per_newton=float(np.mean(build_ms)) if build_ms else None)
    bad = []
    if (launches != want or sim.retry_count or not row["converged"]
            or not bool(torch.isfinite(sim.state.x).all())):
        bad.append("batch")
    # the derivation's inputs agree with the stats: one inner solve per
    # batched Newton iteration, each member's iterations summing to its counts
    if kind not in ("lbfgs",) and (
            len(cg_calls) != sum(max(s.newton_iters) for s in stats)
            or [sum(i[b] for i in cg_calls) for b in range(B)] != [sum(c) for c in cg]):
        bad.append("cg_calls")
    del sim
    mats = None if last.pre is None else last.pre.mats
    alone_rows, alone_seconds, alone_runs, alone_peak = [], 0.0, 0, 0
    for b in tuple(alone) + tuple(witness):
        lone = []
        for _ in range(runs):
            sim_b, stats_b, sec_b, launches_b, _, peak_b, xs_b, build_b = run(members[b])
            alone_seconds, alone_runs = alone_seconds + sec_b, alone_runs + 1
            alone_peak = max(alone_peak, peak_b)
            lone.append((stats_b, xs_b, sim_b.retry_count, build_b))
            del sim_b
        stats_b, xs_b, retries_b, build_b = lone[0]
        held = b in alone and cg_diff is not None
        nearest, limit, lone_spread, unmatched, failed = hold_to_lone(
            newton[b], cg[b], [x[b] for x in xs], [o[:2] for o in lone], cfg.dx,
            cg_diff or 0, x_tol or 0.0, spread, cap, counts)
        r = dict(member=b, held=held, newton_alone=[s.newton_iters for s in stats_b],
                 cg_alone=[s.cg_iters for s in stats_b],
                 x_diff_over_dx=[float((xb[b] - xa).abs().max()) / cfg.dx
                                 for xb, xa in zip(xs, xs_b)],
                 x_nearest_over_dx=nearest, retries=[o[2] for o in lone],
                 mg_build_ms_per_newton=float(np.mean(build_b)) if build_b else None)
        if runs > 1:
            r["alone_again_counts"] = [[s.newton_iters for s in o[0]] for o in lone[1:]]
            r["alone_again_cg"] = [[s.cg_iters for s in o[0]] for o in lone[1:]]
            r["alone_spread_over_dx"] = lone_spread
        if b in alone and any(r["retries"]):
            bad.append(f"member {b} retried alone")
        if held:
            # a step whose counts no lone run took: each run's Newton, CG and
            # final CN residual there (cn_eps is the Newton stop)
            r.update(x_limit=limit, failed=failed, cn_eps=cfg.solver.cn_eps, counts_unmatched=[
                dict(step=k, batch=[newton[b][k], cg[b][k], stats[k].cn_residual[b]],
                     alone=[[s[k].newton_iters, s[k].cg_iters, s[k].cn_residual]
                            for s, *_ in lone]) for k in unmatched])
            if failed:
                bad.append(f"member {b}")
        alone_rows.append(r)
        del lone
    row.update(alone=alone_rows, alone_seconds=alone_seconds,
               alone_member_steps_per_s=alone_runs * steps / max(alone_seconds, 1e-9),
               alone_max_memory_allocated=alone_peak,
               limits=None if cg_diff is None else dict(
                   newton="a lone run's" if counts else "recorded", cg_diff=cg_diff,
                   x_diff_over_dx=x_tol,
                   x_spread_factor=spread, spread_cap_over_dx=cap, runs=runs))
    return row, bad, mats


def batch_solvers_phase(rng, card):
    """Phase 20 (see the module doc): (a) the particle kernels on a batch's
    tile grid; (b) the 64^3 bar under config 3 dense and sparse and the
    composed level, fp64, and bsr_spmv over the batch's level-0 rows; (c)
    the 128^3 bar under config 3 on the sparse grid, fp32; (d) the 64^2
    drop under MINRES, L-BFGS and the explicit BSR, fp64. Returns the rows
    the kernels line reads."""
    from hot_tpu_torch.scenes import build_scene
    from hot_tpu_torch.sim import Simulation
    from hot_tpu_torch.utils.config import config_from_overrides

    out = {}
    # (a)
    for dtype in (torch.float32, torch.float64):
        c, members = batch_tiled_inputs(dtype, rng)
        row, bad = check_batch_tiled_kernels(c, members, timing=dtype == torch.float32)
        emit("batch_solvers", card=card, case="tiled_kernels", **row)
        if bad:
            raise AssertionError(f"batched tile-grid kernel disagrees: {bad}")
        if dtype == torch.float32:
            out["tiled"] = row
        del c, members
        torch.cuda.empty_cache()
    # (b)
    sparse_cfg = {"grid_backend": "sparse", "tile_capacity": 4096}
    scene, members = scene_members("twisting_bar_3d", dict(res=SWEEP_RES, ppc=8), SWEEP_E,
                                   torch.float64)
    mg_cases = (("config3_dense", "config3", config3(scene["cfg"])),
                ("config3_sparse", "config3",
                 config_from_overrides(config3(scene["cfg"]), sparse_cfg)),
                ("composed", "composed", config_from_overrides(
                    config3(scene["cfg"]), {"solver.multigrid.assembled_from_level": 1})))
    out["mg"] = {}
    for label, kind, cfg in mg_cases:
        row, bad, mats = solver_sweep(label, kind, scene, cfg, members, SOLVER_STEPS, DT,
                                      SOLVER_ALONE, 1, DROP_X_TOL)
        if label == "config3_dense":
            out["spmv"] = check_batch_spmv(mats[0], rng)
            row["spmv_level0"] = out["spmv"]
        emit("batch_solvers", card=card, case=label, **row)
        if bad:
            raise AssertionError(f"batch_solvers {label}: {bad}; {row}")
        assert sum(sum(n) for n in row["newton"]) > 0, row
        out["mg"][label] = row
        del mats
        torch.cuda.empty_cache()
    del scene, members
    # (c)
    scene = build_scene("twisting_bar_3d", device="cuda", res=SPARSE_RES, ppc=8)
    sim = Simulation(scene["cfg"], scene["state"], scene["model"], scene["colliders"])
    run_steps(sim, 2, DT)
    start, t_start = sim.state, sim.t
    del sim
    cfg = config_from_overrides(config3(scene["cfg"]), sparse_cfg)
    row, bad, _ = solver_sweep("wide", "config3", scene, cfg, [with_E(start, E) for E in WIDE_E],
                               WIDE_STEPS, DT, WIDE_ALONE, t_start=t_start)
    emit("batch_solvers", card=card, case="wide_128", E=WIDE_E, **row)
    if bad:
        raise AssertionError(f"batch_solvers wide: {bad}; {row}")
    out["wide"] = row
    del scene, start
    torch.cuda.empty_cache()
    # (d)
    out["drop"] = {}
    for kind, over, dt, steps, alone, witness in (
            ("minres", {"solver.linear_solver": "minres"}, DROP_SOLVER_DT, DROP_SOLVER_STEPS,
             DROP_SOLVER_ALONE, ()),
            ("lbfgs", {"solver.nonlinear": "lbfgs"}, LBFGS_DT, LBFGS_STEPS, LBFGS_ALONE,
             LBFGS_WITNESS),
            ("explicit_bsr", {"solver.matrix_free": False}, DROP_SOLVER_DT, DROP_SOLVER_STEPS,
             DROP_SOLVER_ALONE, ())):
        scene, members = scene_members("block_drop_2d", dict(res=64), DROP_E, torch.float64)
        cfg = config_from_overrides(scene["cfg"], over)
        row, bad, _ = solver_sweep(f"drop_{kind}", kind, scene, cfg, members, steps, dt, alone, 1,
                                   DROP_X_TOL, DROP_SPREAD, 2, DROP_SPREAD_CAP, witness=witness)
        emit("batch_solvers", card=card, case=f"drop_{kind}", E=DROP_E, **row)
        if bad:
            raise AssertionError(f"batch_solvers drop {kind}: {bad}; {row}")
        assert min(sum(n) for n in row["newton"]) > 0, row
        out["drop"][kind] = row
    return out


# ---- the sharded step on one card: D ranks share it over gloo

SHARDED_RANKS = 4
SHARDED_CONFIG3 = {"solver.preconditioner": "multigrid", "solver.multigrid.levels": 3,
                   "solver.multigrid.smoother": "chebyshev",
                   "solver.multigrid.coarse_solver": "direct",
                   "solver.multigrid.assembled": True}
SHARDED_DIR = Path("build") / "chip_smoke_sharded"


def slab_inputs(c, rank, ranks):
    """Rank `rank`'s part of a kernel input set on the slab decomposition:
    its particles (base plane in its slab), their SoA arrays in the slab's
    frame, and the grid vectors over its extended slab."""
    from hot_tpu_torch.ops.fused_apply import soa
    from hot_tpu_torch.parallel.sharded import make_slab, owner_of

    x = c["x_soa"].T
    slab = make_slab(c["res"], ranks, rank)
    mine = torch.nonzero(owner_of(x, c["dx"], c["res"], ranks) == rank).reshape(-1)
    planes = lambda g: g.reshape(c["res"][0], -1, c["d"])[slab.org:slab.org + slab.ext_planes]  # noqa: E731
    return slab, mine, dict(c, v=planes(c["v"]).reshape(-1, c["d"]).contiguous(),
                            w=planes(c["w"]).reshape(-1, c["d"]).contiguous(),
                            x_soa=soa(slab.local_x(x[mine], c["dx"])),
                            F_soa=c["F_soa"][:, mine].contiguous(), F=c["F"][mine],
                            mu=c["mu"][mine].contiguous(), lam=c["lam"][mine].contiguous(),
                            V0=c["V0"][mine].contiguous(), res=slab.ext_res, n=int(mine.numel()))


def check_slab_kernels(dtype, rng, timing):
    """Phase 21 (a): both particle kernels on each of SHARDED_RANKS slabs of
    the 64^3 twisting bar, against their plain versions on the same slab
    inputs, and the ranks' outputs folded onto the global grid against the
    dense launch; with `timing`, device ms per launch of an interior rank's
    slab beside the dense launch's, and the slab launch's bound."""
    from hot_tpu_torch.ops import fused_apply as fa
    from hot_tpu_torch.ops import fused_linearize as fl
    from hot_tpu_torch.ops import transfer

    c = kernel_inputs("twisting_bar_3d", "fixed_corotated", dtype, rng, 64)
    d, res = c["d"], c["res"]
    dense_f = fl.fused_linearize_cuda(*lin_args(c))
    dense_df = fa.fused_apply_cuda(*apply_args(c, dense_f[1:]))
    folded_f, folded_df = torch.zeros_like(dense_f[0]), torch.zeros_like(dense_df)
    errs, per_rank = {}, []
    for r in range(SHARDED_RANKS):
        slab, mine, s = slab_inputs(c, r, SHARDED_RANKS)
        got = fl.fused_linearize_cuda(*lin_args(s))
        want = fl.fused_linearize_plain(*lin_args(s))
        ctx = list(want[1:])
        df = fa.fused_apply_cuda(*apply_args(s, ctx))
        df_plain = fa.fused_apply_plain(*apply_args(s, ctx))
        e = {"lin_f": rel_err(got[0], want[0]), "lin_A": rel_err(got[3], want[3]),
             "apply_df": rel_err(df, df_plain)}
        for k, v in e.items():
            errs[k] = max(errs.get(k, (0.0, 0.0)), v, key=lambda t: t[1])
        lo = slab.org * slab.plane_nodes
        folded_f[lo:lo + slab.n_ext] += got[0]
        # the apply on the rank's part of the dense launch's Hessian context
        dctx = [t[:, mine].contiguous() for t in dense_f[1:]]
        folded_df[lo:lo + slab.n_ext] += fa.fused_apply_cuda(*apply_args(s, dctx))
        per_rank.append(dict(rank=r, particles=s["n"], ext_planes=slab.ext_planes,
                             rel_err={k: v[1] for k, v in e.items()}))
        if timing and r == 1:
            touched = int(torch.unique(transfer.particle_stencil(
                s["x_soa"].T, s["dx"], s["res"]).node_ids).numel())
            clamped = clamp_share(dict(s, st=transfer.particle_stencil(s["x_soa"].T, s["dx"],
                                                                        s["res"])))
            slab_timing = {}
            calls = {"fused_linearize": (lambda: fl.fused_linearize_cuda(*lin_args(s)),
                                         lambda: fl.fused_linearize_plain(*lin_args(s)),
                                         lambda: fl.fused_linearize_cuda(*lin_args(c))),
                     "fused_apply": (lambda: fa.fused_apply_cuda(*apply_args(s, ctx)),
                                     lambda: fa.fused_apply_plain(*apply_args(s, ctx)),
                                     lambda: fa.fused_apply_cuda(*apply_args(c, dense_f[1:])))}
            for name, (fn, plain, dense) in calls.items():
                row = {}
                row["ms"], row["ms_source"] = device_ms(fn, 50, name + "_kernel")
                row["dense_ms"] = device_ms(dense, 50, name + "_kernel")[0]
                row["plain_ms"] = cuda_time_ms(plain, 5)
                nbytes = particle_kernel_bytes(name, s["n"], touched, d, c["v"].element_size())
                flops = s["n"] * (FLOPS_PER_PARTICLE[name, 3] + (
                    CLAMP_FLOPS * clamped if name == "fused_linearize" else 0))
                row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
                row["share_of_bound"] = row["bound_ms"] / row["ms"]
                slab_timing[name] = row
            per_rank[-1]["timing"] = slab_timing
    errs["folded_f"] = rel_err(folded_f, dense_f[0])
    errs["folded_df"] = rel_err(folded_df, dense_df)
    return errs, per_rank


def _sharded_rank(rank, world, init, spec, out):
    """One rank of phase 21 (b) and (c), on the card over gloo."""
    import torch.distributed as dist

    from hot_tpu_torch.ops import cuda_lib
    from hot_tpu_torch.parallel.mesh import make_mesh
    from hot_tpu_torch.parallel.sharded_step import ShardedSimulation
    from hot_tpu_torch.scenes import build_scene, stress_state
    from hot_tpu_torch.utils.config import config_from_overrides

    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    cuda_lib.load()            # built by the parent
    mesh = make_mesh()
    results = {}
    for label, case in spec.items():
        scene = build_scene(case["scene"], device="cuda", dtype=case["dtype"], **case["kw"])
        cfg = config_from_overrides(scene["cfg"], case["over"])
        state = (stress_state(scene["state"], cfg, mag=case["stress"]) if case["stress"]
                 else scene["state"])
        if case.get("drift"):
            state = state.replace(v=state.v + torch.tensor(case["drift"], dtype=state.v.dtype,
                                                           device="cuda"))
        sim = ShardedSimulation(mesh, cfg, state, scene["model"], scene["colliders"])
        dist.barrier()
        torch.cuda.synchronize()
        (stats, seconds), launches = counted(lambda: run_steps(sim, case["steps"], case["dt"]))
        row = dict(newton=[s.newton_iters for s in stats], cg=[s.cg_iters for s in stats],
                   converged=[s.converged for s in stats], retries=sim.retry_count,
                   seconds=seconds, launches=launches, migrated=sim.migrated,
                   particles=sim.ps.n)
        row["x"] = sim.state.x.cpu().numpy() if case.get("keep_x") else None
        if case.get("checkpoint"):
            path = str(SHARDED_DIR / "ckpt")
            saved = sim.state
            sim.save_checkpoint(path)
            sim2 = ShardedSimulation(mesh, cfg, state, scene["model"], scene["colliders"])
            sim2.restore(path)
            back = sim2.state
            row["restore_equal"] = all(bool(torch.equal(getattr(saved, f), getattr(back, f)))
                                       for f in ("x", "v", "Cf", "Ff", "m", "Jp"))
            sim.step(case["dt"])
            sim2.step(case["dt"])
            row["resumed_x_diff_over_dx"] = float((sim.state.x - sim2.state.x).abs().max()) / cfg.dx
        all_rows = [None] * world
        dist.all_gather_object(all_rows, {k: v for k, v in row.items() if k != "x"})
        row["launches_all_ranks"] = {k: sum(r["launches"][k] for r in all_rows)
                                     for k in row["launches"]}
        row["launches_per_rank"] = [r["launches"] for r in all_rows]
        row["particles_per_rank"] = [r["particles"] for r in all_rows]
        results[label] = row
        del sim
        torch.cuda.empty_cache()
    if rank == 0:
        import pickle

        with open(out, "wb") as fh:
            pickle.dump(results, fh)
    dist.destroy_process_group()


def sharded_phase(rng, card):
    """Phase 21 sharded (see the module doc): (a) the particle kernels on
    each rank's slab; (b) config 4 at full size, SHARDED_RANKS ranks sharing
    the card over gloo, against the one-grid step; (c) migration and a
    sharded checkpoint; (d) the CLI on NCCL at world size 1; (e) the CLI's
    refusal of two NCCL ranks on one card. Returns the rows the kernels line
    reads."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    from hot_tpu_torch.scenes import build_scene, stress_state
    from hot_tpu_torch.sim import Simulation
    from hot_tpu_torch.utils.config import config_from_overrides

    out = {}
    shutil.rmtree(SHARDED_DIR, ignore_errors=True)
    SHARDED_DIR.mkdir(parents=True)
    # (a) the slab launches
    for dtype in (torch.float32, torch.float64):
        errs, per_rank = check_slab_kernels(dtype, rng, timing=dtype == torch.float32)
        tol = 2e-5 if dtype == torch.float32 else 1e-10
        emit("sharded", card=card, case="slab_kernels", dtype=str(dtype), ranks=SHARDED_RANKS,
             rel_err={k: v[1] for k, v in errs.items()},
             max_abs_err={k: v[0] for k, v in errs.items()}, limit=tol, per_rank=per_rank)
        bad = {k: v[1] for k, v in errs.items() if not v[1] <= tol}
        if bad:
            raise AssertionError(f"slab kernels disagree: {bad}")
        if dtype == torch.float32:
            out["slab"] = dict(max_abs_err=errs, timing=per_rank[1]["timing"])
        torch.cuda.empty_cache()

    # (b) config 4 at full size on SHARDED_RANKS ranks sharing the card over
    # gloo (halo, migration and reductions through host memory), against the
    # one-grid step from the same state; (c) the migrating 2D drop
    # from stress_state at a quarter of its default velocity (the boxes
    # compressed into each other from the first step): at the default,
    # config 3's first step stalls and is retried (phase config4), and two
    # one-grid runs then part in their counts; from rest no step needs Newton
    boxes = dict(scene="stacked_boxes_3d", kw=dict(res=64), stress=2.0, steps=3, dt=DT)
    spec = {
        "bj_fp64": dict(boxes, dtype=torch.float64, over={}, keep_x=True),
        "config3_fp64": dict(boxes, dtype=torch.float64, over=SHARDED_CONFIG3, keep_x=True),
        "bj_fp32": dict(boxes, dtype=torch.float32, over={}),
        "drift": dict(scene="block_drop_2d", kw=dict(res=64), stress=False, steps=6, dt=4e-3,
                      dtype=torch.float64, over={}, drift=[0.35, 0.0], checkpoint=True),
    }
    rendezvous = tempfile.mkdtemp(dir=SHARDED_DIR)
    t0 = time.perf_counter()
    mp.spawn(_sharded_rank, args=(SHARDED_RANKS, f"file://{rendezvous}/init", spec,
                                  str(SHARDED_DIR / "ranks.pkl")), nprocs=SHARDED_RANKS)
    spawn_seconds = time.perf_counter() - t0
    with open(SHARDED_DIR / "ranks.pkl", "rb") as fh:
        ranks = pickle.load(fh)
    for label in ("bj_fp64", "config3_fp64"):
        case = spec[label]
        scene = build_scene(case["scene"], device="cuda", dtype=case["dtype"], **case["kw"])
        cfg = config_from_overrides(scene["cfg"], case["over"])
        # the one-grid step twice: fp64 atomics' order makes two runs part
        lone = []
        for _ in range(2):
            sim = Simulation(cfg, stress_state(scene["state"], cfg, mag=case["stress"]),
                             scene["model"], scene["colliders"])
            stats, seconds = run_steps(sim, case["steps"], case["dt"])
            lone.append((stats, [sim.state.x], sim.retry_count, seconds))
        got = ranks[label]
        xs = [torch.as_tensor(got["x"], device="cuda")]
        nearest, limit, spread, _, failed = hold_to_lone(
            got["newton"], got["cg"], xs, [(st, x) for st, x, _, _ in lone],
            cfg.dx, 0 if label == "bj_fp64" else 2, 1e-8)
        row = {k: v for k, v in got.items() if k != "x"}
        row.update(one_grid_newton=[s.newton_iters for s in lone[0][0]],
                   one_grid_cg=[s.cg_iters for s in lone[0][0]], one_grid_seconds=lone[0][3],
                   one_grid_retries=lone[0][2], x_diff_over_dx=nearest, x_limit_over_dx=limit,
                   one_grid_spread_over_dx=spread)
        emit("sharded", card=card, case=label, scene="stacked_boxes_3d", res=64,
             ranks=SHARDED_RANKS, backend="gloo, 4 ranks sharing one card", **row)
        assert all(got["converged"]) and got["retries"] == lone[0][2], row
        assert not failed and sum(got["newton"]) > 0, (failed, row)
        assert got["launches_all_ranks"]["fused_apply"] > 0, row
        assert got["launches_all_ranks"]["fused_linearize"] > 0, row
        if label == "config3_fp64":
            assert got["launches_all_ranks"]["bsr_spmv"] > 0, row
        # block-Jacobi: one block-diagonal launch per build on each rank that
        # holds particles (a retried attempt's builds are not in the counts);
        # config 3 assembles every level and launches none
        if not got["retries"]:
            builds = sum(got["newton"]) if label == "bj_fp64" else 0
            assert [r["fused_block_diag"] for r in got["launches_per_rank"]] == [
                builds if p else 0 for p in got["particles_per_rank"]], row
        out[label] = row
        del sim, scene, lone
        torch.cuda.empty_cache()
    for label in ("bj_fp32",):
        got = ranks[label]
        emit("sharded", card=card, case=label, scene="stacked_boxes_3d", res=64,
             ranks=SHARDED_RANKS, note="4 ranks sharing one card, not a scaling number",
             steps_per_s=len(got["newton"]) / got["seconds"],
             **{k: v for k, v in got.items() if k != "x"})
        assert all(got["converged"]), got
    got = ranks["drift"]
    emit("sharded", card=card, case="migration", scene="block_drop_2d", res=64,
         ranks=SHARDED_RANKS, **{k: v for k, v in got.items() if k != "x"})
    assert got["migrated"] > 0 and got["restore_equal"], got
    assert got["resumed_x_diff_over_dx"] <= 1e-8, got

    # (d) the CLI on NCCL, one rank per GPU (world size 1 on this card),
    # against the one-grid CLI; (e) two NCCL ranks on one card are refused
    cli = ["-m", "hot_tpu_torch", "--scene", "twisting_bar_3d", "--frames", "1", "--quiet",
           "--f64", "--scene-arg", "res=32", "--scene-arg", "ppc=4", "--frame-format", "npz",
           "--checkpoint-every", "0", "--set", "frame_dt=0.006"]
    env = dict(os.environ, PYTHONPATH=str(Path.cwd()))
    runs = {}
    for label, launcher in (("one_grid", [sys.executable]),
                            ("nccl", [sys.executable, "-m", "torch.distributed.run",
                                      "--standalone", "--nproc-per-node", "1"])):
        extra = ["--set", "mesh.shape=(-1,)"] if label == "nccl" else []
        run = subprocess.run(launcher + cli + extra + ["-o", str(SHARDED_DIR / label)],
                             capture_output=True, text=True, env=env, timeout=300)
        if run.returncode != 0:
            raise AssertionError(f"CLI {label} failed ({run.returncode}): {run.stderr[-3000:]}")
        recs = [json.loads(line) for line in open(SHARDED_DIR / label / "metrics.jsonl")]
        runs[label] = [(r["newton_iters"], r["cg_iters"]) for r in recs if "newton_iters" in r]
    emit("sharded", card=card, case="cli_nccl", steps=len(runs["nccl"]), counts=runs["nccl"],
         one_grid_counts=runs["one_grid"])
    assert runs["nccl"] == runs["one_grid"] and sum(c[0] for c in runs["nccl"]) > 0, runs
    refuse = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2"]
        + cli + ["--set", "mesh.shape=(-1,)", "-o", str(SHARDED_DIR / "refused")],
        capture_output=True, text=True, env=env, timeout=300)
    said = "one rank per GPU" in refuse.stderr + refuse.stdout
    emit("sharded", card=card, case="cli_refuses_two_nccl_ranks", returncode=refuse.returncode,
         message_found=said, spawn_seconds=spawn_seconds)
    assert refuse.returncode != 0 and said, refuse.stderr[-3000:]
    out["launches"] = ranks["config3_fp64"]["launches_all_ranks"]
    out["bj_launches"] = ranks["bj_fp64"]["launches_all_ranks"]
    return out


# ---- the block-diagonal kernel on the main path's shape

# the cubic cases' floor on a block's scale, in units of the largest
# block's: a cubic fringe block comes out of the weights' cancelling tails,
# which nvcc's FMA contraction rounds differently from the plain version
# (tests/test_torch_kernels_card.py has the readings)
CUBIC_FLOOR = 1e-4


def block_errors(got, want, floor=0.0):
    """(worst, largest absolute): each node's (d, d) block's error over its
    largest entry, floored at `floor` times the largest block's; a block
    with no contribution must be exactly 0 (worst inf otherwise)."""
    err = (got - want).abs().amax((-1, -2)).double()
    scale = want.abs().amax((-1, -2)).double()
    scale = torch.where(scale > 0, scale.clamp(min=floor * float(scale.max())), scale)
    ratio = torch.where(scale > 0, err / scale.clamp(min=1e-300),
                        torch.where(err > 0, math.inf, 0.0))
    return float(ratio.max()), float(err.max())


def block_diag_args(c):
    """fused_block_diag's arguments on input set c (its tile grid if it has
    one): the Hessian context of the plain linearize at c's v."""
    from hot_tpu_torch.ops import fused_linearize as fl

    tg = c.get("tgrid")
    ctx = fl.fused_linearize_plain(*lin_args(c), tg)[1:]
    return (c["x_soa"], c["dx"], c["res"], c["F_soa"], *ctx, c["V0"], DT, c["kernel"], tg)


def check_block_diag(c, timing, floor=0.0):
    """fused_block_diag_cuda on input set c against fused_block_diag_plain
    on the same card tensors, each block within TOL of its largest entry
    (floored as block_errors); the launches of the checked call (counters
    read just before and after it) and its window counters. With `timing`,
    device ms per launch through the window and with the global atomics
    alone (window_nodes 0), the plain version's ms, and the bound from this
    run's bytes (block_diag_bytes over the touched nodes) and operations."""
    from hot_tpu_torch.ops import fused_apply as fa
    from hot_tpu_torch.ops import fused_block_diag as fbd
    from hot_tpu_torch.ops.bspline import kernel_width

    args = block_diag_args(c)
    tg, d, dtype = c.get("tgrid"), c["d"], c["v"].dtype
    want = fbd.fused_block_diag_plain(*args)
    fbd.window_stats = fa.new_window_stats("cuda")
    try:
        before = launch_counts()
        got = fbd.fused_block_diag_cuda(*args)
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        st = fa.read_window_stats(fbd.window_stats)
    finally:
        fbd.window_stats = None
    worst, abs_err = block_errors(got, want, floor)
    row = dict(grid="tile grid" if tg is not None else "dense", kernel=c["kernel"], d=d,
               dtype=str(dtype), particles=c["n"], nodes=fbd.nodes_of(c["res"], tg),
               rel_err=worst, rel_err_no_floor=block_errors(got, want)[0], floor=floor,
               max_abs_err=abs_err, limit=TOL[dtype]["apply"], launches=launches,
               overflow_share=st["overflow_blocks"] / max(st["blocks"], 1),
               global_atomics=st["global_atomics"])
    bad = not worst <= row["limit"] or launches != dict(
        {k: 0 for k in launches}, fused_block_diag=1)
    if timing:
        touched = int(torch.unique(c["st"].node_ids).numel())
        nbytes = block_diag_bytes(c["n"], touched, d, got.element_size(),
                                  0 if tg is None else tg.n_active)
        flops = c["n"] * FLOPS_PER_PARTICLE["fused_block_diag", kernel_width(c["kernel"])]
        row["ms"], row["ms_source"] = device_ms(lambda: fbd.fused_block_diag_cuda(*args), 50,
                                                "fused_block_diag_kernel")
        row["global_atomics_ms"] = device_ms(
            lambda: fbd.fused_block_diag_cuda(*args, window_nodes=0), 20,
            "fused_block_diag_kernel")[0]
        row["plain_ms"] = cuda_time_ms(lambda: fbd.fused_block_diag_plain(*args), 3)
        row.update(touched_nodes=touched, bytes=nbytes, flops=flops,
                   bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   flops_bound_ms=flops / FP32_FLOPS * 1e3,
                   launch_config=fa.launch_config(d, kernel_width(c["kernel"]),
                                                  got.element_size(), fbd.upper_values(d)))
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return row, bad


def cubic_witness(c64):
    """The cubic stencil's readings on one input set (fp64, and the same
    values in fp32): the kernel against the plain version in each
    precision, and the plain version in fp32 against its fp64 self, each
    without and with CUBIC_FLOOR (block_errors)."""
    from hot_tpu_torch.ops import fused_block_diag as fbd

    c32 = {k: v.float() if torch.is_tensor(v) and v.is_floating_point() else v
           for k, v in c64.items()}
    out = {}
    for label, c in (("fp64", c64), ("fp32", c32)):
        args = block_diag_args(c)
        out[label] = (fbd.fused_block_diag_cuda(*args), fbd.fused_block_diag_plain(*args))
    pairs = {"kernel_vs_plain_fp64": out["fp64"], "kernel_vs_plain_fp32": out["fp32"],
             "plain_fp32_vs_plain_fp64": (out["fp32"][1].double(), out["fp64"][1])}
    return {k: dict(no_floor=block_errors(g, w)[0], floor=block_errors(g, w, CUBIC_FLOOR)[0])
            for k, (g, w) in pairs.items()}


def block_diag_phase(rng, card):
    """Phase 22 (see the module doc): the block-diagonal kernel on the 128^3
    bar (the tile grid, as the benchmark's block-Jacobi cell runs it, and
    the dense grid) in fp32 and fp64, the 64^3 bar (quadratic and cubic) and
    the 64^2 drop (cubic), fp32 and fp64, against the plain version on the
    same card tensors; fp32 times at 128^3 and 64^3; the cubic cases'
    readings without and with their floor (cubic_witness). Returns the rows
    the kernels line reads."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        timing = dtype == torch.float32
        c = kernel_inputs("twisting_bar_3d", "fixed_corotated", dtype, rng, SPARSE_RES)
        row, bad = check_block_diag(c, timing)
        emit("block_diag", card=card, scene="twisting_bar_3d", res=SPARSE_RES, **row)
        if bad:
            raise AssertionError(f"block-diagonal kernel disagrees: {row}")
        out["dense_128", str(dtype)] = row
        compact_inputs(c, rng)
        row, bad = check_block_diag(c, timing)
        row.update(tiles=c["tgrid"].n_active)
        emit("block_diag", card=card, scene="twisting_bar_3d", res=SPARSE_RES, **row)
        if bad:
            raise AssertionError(f"block-diagonal kernel disagrees: {row}")
        out["compact_128", str(dtype)] = row
        del c
        torch.cuda.empty_cache()
    for scene_name, kernel in (("twisting_bar_3d", "quadratic"), ("twisting_bar_3d", "cubic"),
                               ("block_drop_2d", "cubic")):
        floor = CUBIC_FLOOR if kernel == "cubic" else 0.0
        c64 = kernel_inputs(scene_name, "fixed_corotated", torch.float64, rng, 64,
                            kernel=kernel)
        witness = cubic_witness(c64) if kernel == "cubic" else None
        for dtype in (torch.float32, torch.float64):
            c = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
                 for k, v in c64.items()}
            row, bad = check_block_diag(c, dtype == torch.float32 and c["d"] == 3, floor)
            emit("block_diag", card=card, scene=scene_name, res=64, **row,
                 **({"witness": witness} if witness and dtype == torch.float64 else {}))
            if bad:
                raise AssertionError(f"block-diagonal kernel disagrees: {row}")
            out[scene_name, kernel, str(dtype)] = row
        del c64, c
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", metavar="DIR",
                    help="an earlier csrc/ whose particle kernels are timed beside these")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from hot_tpu_torch.ops import cuda_lib
    from hot_tpu_torch.ops import fused_apply as fa
    from hot_tpu_torch.scenes import SCENES, build_scene, stress_state
    from hot_tpu_torch.sim import Simulation
    from hot_tpu_torch.sim.state import FIELDS, state_from_numpy
    from hot_tpu_torch.solver import multigrid as mg_mod
    from hot_tpu_torch.utils.config import config_from_overrides

    laps, t_lap = {}, [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        laps[phase], t_lap[0] = now - t_lap[0], now

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

    lap("env")
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

    lap("build")
    # ---- 3 kernels against their plain versions
    rng = np.random.default_rng(0)
    summary = {}
    for dtype in (torch.float32, torch.float64):
        models = ("fixed_corotated", "stvk_hencky")
        # (scene, res, model, random order, F noise, SPD projection, F through
        # Drucker-Prager's return map). With F perturbed by 0.5 a share of the
        # particles needs the clamp's eigensolve and the rest skip it;
        # StVK-Hencky is ill-conditioned there in fp32 (its plain version in
        # fp32 and fp64 differ by 1e-3), so it is held in fp64. The stacked
        # boxes' mu and lam span four decades (errors also per box); MINRES
        # runs the linearize without projection; the sand column's StVK-Hencky
        # sees plastically projected F. Then the two models added with the
        # cubic stencil, quadratic, and every model with the cubic stencil
        Q, C = "quadratic", "cubic"
        cases = [(scene_name, 64, m, False, 0.1, True, False, Q)
                 for scene_name in ("twisting_bar_3d", "block_drop_2d") for m in models]
        cases += [("twisting_bar_3d", 64, "fixed_corotated", True, 0.1, True, False, Q)]
        cases += [("twisting_bar_3d", 64, m, False, 0.5, True, False, Q) for m in models
                  if dtype == torch.float64 or m == "fixed_corotated"]
        cases += [("stacked_boxes_3d", 64, "fixed_corotated", False, 0.1, True, False, Q)]
        cases += [("twisting_bar_3d", 64, m, False, 0.1, False, False, Q) for m in models]
        cases += [("sand_column_2d", 64, "stvk_hencky", False, 0.1, True, True, Q)]
        cases += [(scene_name, 64, m, False, 0.1, True, False, kernel)
                  for kernel, names in ((Q, NEW_MODELS), (C, MODELS)) for m in names
                  for scene_name in ("twisting_bar_3d", "block_drop_2d")]
        for scene_name, res, model_name, permute, noise, project, plastic, kernel in cases:
            case = kernel_inputs(scene_name, model_name, dtype, rng, res, permute, noise,
                                 project, plastic, kernel)
            clamped = clamp_share(case)
            errs, limits, bad, windows = check_kernels(case)
            emit("kernels", scene=scene_name, res=res, n=case["n"], model=model_name,
                 kernel=kernel,
                 dtype=str(dtype), order="random" if permute else "lattice", F_noise=noise,
                 project=project, F_through_drucker_prager=plastic,
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
            if scene_name == "stacked_boxes_3d":
                assert len(case["groups"]) == 3, case["groups"]
            if (dtype == torch.float32 and scene_name == "twisting_bar_3d"
                    and model_name == "fixed_corotated" and not permute and noise == 0.1
                    and project):
                summary["errs" if kernel == Q else "errs_cubic"] = errs
            del case
    for res in (64, 128):
        for kernel in ("quadratic", "cubic"):
            timing = time_particle_kernels(res, rng, baseline_lib, sweep=True, kernel=kernel)
            emit("timing", card=card, **timing)
            summary[res if kernel == "quadratic" else (kernel, res)] = timing
            torch.cuda.empty_cache()
        # the linearize of the two models it gained (quadratic stencil)
        for model_name in NEW_MODELS:
            timing = time_particle_kernels(res, rng, None, sweep=False, model_name=model_name,
                                           names=("fused_linearize",))
            emit("timing", card=card, **timing)
            summary[model_name, res] = timing
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
        f"{name}_{res}{suffix}": dict(bound_ms=summary[key][name]["bound_ms"],
                                      bound_by=summary[key][name]["bound_by"],
                                      copy_bound_ms=summary[key][name]["bytes"]
                                      / copy_bytes_per_s * 1e3)
        for res in (64, 128) for suffix, key in (("", res), ("_cubic", ("cubic", res)))
        for name in ("fused_apply", "fused_linearize")})
    torch.cuda.empty_cache()

    lap("kernels")
    # ---- 4 the main path at 64^3 (block-Jacobi)
    scene = build_scene("twisting_bar_3d", device="cuda", res=64, ppc=8)
    sim = Simulation(scene["cfg"], scene["state"], scene["model"], scene["colliders"])
    with WindowStats() as ws:
        (stats, seconds), launches = counted(lambda: run_steps(sim, 12, DT))
    emit("windows", path="main, 64^3 block-Jacobi", threads=fa.BLOCK_THREADS,
         window_nodes=fa.WINDOW_NODES, **ws.read())
    newton = [s.newton_iters for s in stats]
    cg = [s.cg_iters for s in stats]
    emit("main", particles=sim.state.n, steps=len(stats), seconds=seconds,
         steps_per_s=len(stats) / seconds, newton=newton, cg=cg,
         max_velocity=[s.max_velocity for s in stats], launches=launches,
         retries=sim.retry_count)
    assert bool(torch.isfinite(sim.state.x).all() and torch.isfinite(sim.state.Ff).all())
    assert all(s.converged for s in stats) and sim.retry_count == 0, stats
    assert all(k > 0 for k in newton[6:]), newton
    assert launches["fused_apply"] > 0 and launches["fused_linearize"] > 0, launches
    assert launches["fused_linearize"] == sum(k + 1 for k in newton), (launches, newton)
    assert launches["fused_apply"] == sum(cg) + sum(newton), (launches, newton, cg)
    assert launches["bsr_spmv"] == 0, launches
    assert launches["fused_block_diag"] == sum(newton), (launches, newton)
    vmax = max(s.max_velocity for s in stats)
    assert 1.0 < vmax < 3.0, vmax   # clamps spin at 4 pi rad/s, 0.14 from the axis: ~1.76

    lap("main")
    # ---- 5 the multigrid path at 64^3 (config 3, then the default MG)
    scene = build_scene("twisting_bar_3d", device="cuda", res=64, ppc=8)
    cfg3 = config3(scene["cfg"])
    mgc = cfg3.solver.multigrid
    sim = Simulation(cfg3, scene["state"], scene["model"], scene["colliders"])
    with BuildTimer(mg_mod) as bt:
        (stats, seconds), mg_launches = counted(lambda: run_steps(sim, 12, DT))
    newton = [s.newton_iters for s in stats]
    cg = [s.cg_iters for s in stats]
    per_build, per_vcycle, want_spmv = mg_spmv_launches(mgc, newton, cg)
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
    assert mg_launches["fused_block_diag"] == 0, mg_launches
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

    lap("mg")
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
    # the plastic scenes from stress_state (the snow ball at twice the
    # default magnitude, which takes it past snow's critical compression)
    for name, kw, mag in (("sand_column_2d", dict(res=32), 8.0),
                          ("snowball_drop_2d", dict(res=32), 16.0),
                          ("twisting_bar_vonmises_3d", dict(res=32, ppc=4), 8.0)):
        base = build_scene(name, device="cpu", dtype=torch.float64, **kw)
        arrays = stress_state(base["state"], base["cfg"], mag).to_numpy()
        sims = {dev: Simulation(base["cfg"], state_from_numpy(arrays, dev, dtype), base["model"],
                                base["colliders"], plasticity=base["plasticity"])
                for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64))}
        dx = base["cfg"].dx
        rows = []
        for _ in range(3):
            g, c = sims["cuda"].step(DT), sims["cpu"].step(DT)
            gs, cs = sims["cuda"].state, sims["cpu"].state
            dxmax = float((gs.x.double().cpu() - cs.x).abs().max())
            jp = float((gs.Jp.double().cpu() - cs.Jp).abs().max() / cs.Jp.abs().max())
            rows.append(dict(newton=(g.newton_iters, c.newton_iters), cg=(g.cg_iters, c.cg_iters),
                             x_diff_over_dx=dxmax / dx, Jp_rel_diff=jp,
                             Jp_range=(float(cs.Jp.min()), float(cs.Jp.max()))))
        emit("cpu", scene=name, plasticity=base["plasticity"], particles=base["state"].n,
             steps=rows, retries=(sims["cuda"].retry_count, sims["cpu"].retry_count),
             limits=dict(newton="equal", cg_diff=2, x_diff_over_dx=X_TOL, Jp_rel_diff=X_TOL))
        for r in rows:
            assert r["newton"][0] == r["newton"][1], rows
            assert abs(r["cg"][0] - r["cg"][1]) <= 2, rows
            assert r["x_diff_over_dx"] <= X_TOL and r["Jp_rel_diff"] <= X_TOL, rows
        assert sum(r["newton"][1] for r in rows) > 0, rows
        if name == "snowball_drop_2d":
            assert rows[-1]["Jp_range"][0] < 1.0, rows
        del sims
    # the cubic stencil, Neo-Hookean and L-BFGS (whose iteration count, the
    # "newton" and "cg" pairs alike, may differ by 2)
    for label, overrides, model_name in (("cubic", {"transfer_kernel": "cubic"}, None),
                                         ("neo_hookean", {}, "neo_hookean"),
                                         ("lbfgs", {"solver.nonlinear": "lbfgs"}, None)):
        n, rows = card_against_cpu(overrides, model_name)
        iter_diff = 2 if label == "lbfgs" else 0
        emit("cpu", case=label, scene="twisting_bar_3d", particles=n, steps=rows,
             limits=dict(newton_diff=iter_diff, cg_diff=2, x_diff_over_dx=X_TOL))
        for r in rows:
            assert all(r["converged"]), rows
            assert abs(r["newton"][0] - r["newton"][1]) <= iter_diff, rows
            assert abs(r["cg"][0] - r["cg"][1]) <= 2, rows
            assert r["x_diff_over_dx"] <= X_TOL, rows
        assert sum(r["newton"][1] for r in rows) > 0, rows
    torch.cuda.empty_cache()

    lap("cpu")
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

    del start
    torch.cuda.empty_cache()
    lap("scale")

    # ---- 8 scenes: every scene of the registry at its default size, 3 steps
    # from stress_state (the snow ball at twice its magnitude, as in phase cpu)
    # at dt 2e-3 scaled by dx/(1/64), the protocol's cells per step: at 128^3
    # stress_state's velocities cross twice the cells of 64^3 per step, and
    # the faceless mesh (0.82 tall) then moves 0.9 dx per step at dt 2e-3 and
    # needed a dt retry there on an H100
    scene_launches = {}
    for name in SCENES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with InsideTimer() as inside:
            scene = build_scene(name, device="cuda")
        build_s = time.perf_counter() - t0
        state = stress_state(scene["state"], scene["cfg"], 16.0 if name == "snowball_drop_2d"
                             else 8.0)
        sim = Simulation(scene["cfg"], state, scene["model"], scene["colliders"],
                         plasticity=scene["plasticity"])
        dt = DT * 64 * scene["cfg"].dx
        with PlasticShare() as plastic:
            (stats, seconds), run_launches = counted(lambda: run_steps(sim, 3, dt))
        row = step_record(sim, stats, seconds)
        want = expected_launches(row["newton"], row["cg"])
        row.update(scene=name, res=scene["cfg"].grid_res[0], dt=dt, build_seconds=build_s,
                   model=scene["model"].name, plasticity=scene["plasticity"],
                   launches=run_launches, launches_expected=want)
        if scene["plasticity"] is not None:
            row["plastic_share"] = plastic.read()
        if scene["plasticity"] == "snow":
            row["Jp_range"] = (float(sim.state.Jp.min()), float(sim.state.Jp.max()))
        if inside.calls:
            row["inside_test"] = inside.calls
        emit("scenes", card=card, **row)
        assert_steps_ok(sim, stats, row)
        assert run_launches == want, row
        if scene["plasticity"] is not None:
            assert len(row["plastic_share"]) == 3 and max(row["plastic_share"]) > 0, row
        if name == "faceless_mesh_3d":
            assert len(inside.calls) == 1 and inside.calls[0]["inside"] == sim.state.n, row
        for k, v in run_launches.items():
            scene_launches[k] = scene_launches.get(k, 0) + v
        del scene, state, sim
    emit("scenes", scenes=len(SCENES), launches=scene_launches)
    lap("scenes")

    # ---- 9 config 4: the stacked boxes (E 1e4..1e8) at 64^3, config 3 and
    # block-Jacobi from one state (stress_state), in turns
    scene = build_scene("stacked_boxes_3d", device="cuda", res=64)
    start = stress_state(scene["state"], scene["cfg"])
    for label in ("config 3", "block_jacobi", "block_jacobi", "config 3"):
        cfg = config3(scene["cfg"]) if label == "config 3" else scene["cfg"]
        sim = Simulation(cfg, start, scene["model"], scene["colliders"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with BuildTimer(mg_mod) as bt, Attempts() as att:
            (stats, seconds), run_launches = counted(lambda: run_steps(sim, 3, DT))
        build_ms = bt.ms()
        row = step_record(sim, stats, seconds)
        mgc = cfg.solver.multigrid if label == "config 3" else None
        # the launches of every attempt, a retried one's too
        newton_all = [a.newton_iters for _, a in att.stats]
        want = expected_launches(newton_all, [a.cg_iters for _, a in att.stats], mgc=mgc)
        row.update(preconditioner=label, launches=run_launches, launches_expected=want,
                   retried_attempts=att.retried(stats),
                   mg_build_ms_per_newton=float(np.mean(build_ms)) if build_ms else None)
        emit("config4", card=card, scene="stacked_boxes_3d", res=64, **row)
        # config 3's first step from this state takes 10 Newton iterations
        # without reaching the CN tolerance and is retried at dt/2; hot_tpu
        # retries it too (compared on the CPU, fp32 and fp64). Reported, and
        # every attempt's launches counted
        assert_steps_ok(sim, stats, row, max_retries=1 if mgc else 0)
        assert run_launches == want, row
        assert len(build_ms) == (sum(newton_all) if mgc else 0), row
        del sim
    del scene, start
    lap("config4")

    # ---- 10 solver options: the 64^3 twisting bar, 3 steps from stress_state,
    # under MINRES without SPD projection and with Armijo line search
    scene = build_scene("twisting_bar_3d", device="cuda", res=64, ppc=8)
    start = stress_state(scene["state"], scene["cfg"])
    for label, overrides in (
            ("minres, no SPD projection", {"solver.linear_solver": "minres",
                                           "solver.project_hessian": False}),
            ("line search", {"solver.line_search": True})):
        cfg = config_from_overrides(scene["cfg"], overrides)
        sim = Simulation(cfg, start, scene["model"], scene["colliders"])
        torch.cuda.reset_peak_memory_stats()
        (stats, seconds), run_launches = counted(lambda: run_steps(sim, 3, DT))
        row = step_record(sim, stats, seconds)
        want = expected_launches(row["newton"], row["cg"],
                                 minres=cfg.solver.linear_solver == "minres")
        row.update(options=label, backtracks=[s.ls_backtracks for s in stats],
                   launches=run_launches, launches_expected=want)
        emit("solver_options", card=card, scene="twisting_bar_3d", res=64, **row)
        assert_steps_ok(sim, stats, row)
        assert run_launches == want, row
        del sim
    del scene, start
    lap("solver_options")

    # ---- 11 cubic transfers: the 64^3 bar under block-Jacobi, then the
    # default (matrix-free) multigrid, whose levels' stencils are cubic too
    scene = build_scene("twisting_bar_3d", device="cuda", res=64, ppc=8)
    cfg = config_from_overrides(scene["cfg"], {"transfer_kernel": "cubic"})
    sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
    torch.cuda.reset_peak_memory_stats()
    with WindowStats() as ws:
        (stats, seconds), cubic_launches = counted(lambda: run_steps(sim, 12, DT))
    emit("windows", path="cubic, 64^3 block-Jacobi",
         launch_config=fa.launch_config(3, 4, 4), **ws.read())
    row = step_record(sim, stats, seconds)
    want = expected_launches(row["newton"], row["cg"])
    row.update(preconditioner="block_jacobi", launches=cubic_launches, launches_expected=want,
               max_velocity=[s.max_velocity for s in stats])
    emit("cubic", card=card, scene="twisting_bar_3d", res=64, **row)
    assert bool(torch.isfinite(sim.state.x).all() and torch.isfinite(sim.state.Ff).all()), row
    assert all(s.converged for s in stats) and sim.retry_count == 0, row
    assert all(k > 0 for k in row["newton"][6:]), row
    assert cubic_launches == want and want["fused_apply"] > 0, row
    vmax = max(s.max_velocity for s in stats)
    assert 1.0 < vmax < 3.0, vmax
    # the default multigrid, every level's stencil cubic, 3 steps from rest
    # in fp64 (the fp64 cubic instances; in fp32 this hierarchy can stall
    # Newton just above cn_eps, as phase mg's quadratic one does)
    del sim
    scene = build_scene("twisting_bar_3d", device="cuda", res=64, ppc=8, dtype=torch.float64)
    cfg_mg = config_from_overrides(scene["cfg"], {"transfer_kernel": "cubic",
                                                  "solver.preconditioner": "multigrid"})
    sim = Simulation(cfg_mg, scene["state"], scene["model"], scene["colliders"])
    torch.cuda.reset_peak_memory_stats()
    with Attempts() as att:
        (stats, seconds), run_launches = counted(lambda: run_steps(sim, 3, DT))
    row = step_record(sim, stats, seconds)
    newton_all = [a.newton_iters for _, a in att.stats]
    cg_all = [a.cg_iters for _, a in att.stats]
    per_build, per_vcycle, want_apply = mf_mg_apply_launches(cfg_mg.solver.multigrid, newton_all,
                                                             cg_all)
    want = {"fused_apply": want_apply, "fused_linearize": sum(k + 1 for k in newton_all),
            "bsr_spmv": 0,
            "fused_block_diag": block_diag_launches(newton_all, cfg_mg.solver.multigrid)}
    row.update(preconditioner="default multigrid (matrix-free levels)", dtype=str(torch.float64),
               launches=run_launches, launches_expected=want, apply_per_build=per_build,
               apply_per_vcycle=per_vcycle, retried_attempts=att.retried(stats))
    emit("cubic", card=card, scene="twisting_bar_3d", res=64, **row)
    assert bool(torch.isfinite(sim.state.x).all() and torch.isfinite(sim.state.Ff).all()), row
    assert all(s.converged for s in stats) and sim.retry_count == 0, row
    assert sum(newton_all) > 0 and sum(cg_all) > 0 and run_launches == want, row
    del scene, sim
    torch.cuda.empty_cache()
    lap("cubic")

    # ---- 12 the two models the linearize kernel gained: the 64^3 bar, 3
    # steps from stress_state each
    from hot_tpu_torch.models.constitutive import MODEL_REGISTRY

    scene = build_scene("twisting_bar_3d", device="cuda", res=64, ppc=8)
    start = stress_state(scene["state"], scene["cfg"])
    for name in NEW_MODELS:
        sim = Simulation(scene["cfg"], start, MODEL_REGISTRY[name], scene["colliders"])
        torch.cuda.reset_peak_memory_stats()
        (stats, seconds), run_launches = counted(lambda: run_steps(sim, 3, DT))
        row = step_record(sim, stats, seconds)
        want = expected_launches(row["newton"], row["cg"])
        row.update(model=name, launches=run_launches, launches_expected=want)
        emit("models", card=card, scene="twisting_bar_3d", res=64, **row)
        assert_steps_ok(sim, stats, row)
        assert run_launches == want, row
        del sim
    del scene, start
    lap("models")

    # ---- 13 baselines: the explicit integrator (tests/test_baselines.py's
    # block drop at E 1e4 and dt 5e-4, from stress_state so that the
    # elastic forces act), then L-BFGS on the 32^3 bar from stress_state
    scene = build_scene("block_drop_2d", device="cuda", res=32, E=1e4)
    cfg = config_from_overrides(scene["cfg"], {"solver.integrator": "explicit"})
    sim = Simulation(cfg, stress_state(scene["state"], scene["cfg"]), scene["model"],
                     scene["colliders"])
    (stats, seconds), run_launches = counted(lambda: run_steps(sim, 200, 5e-4))
    eye = torch.eye(2, device="cuda").reshape(1, 4)
    row = dict(integrator="explicit", scene="block_drop_2d", res=32, steps=len(stats),
               seconds=seconds, steps_per_s=len(stats) / seconds, launches=run_launches,
               min_y=float(sim.state.x[:, 1].min()), floor_y=0.15, dx=cfg.dx,
               max_F_minus_I=float((sim.state.Ff - eye).abs().max()))
    emit("baselines", card=card, **row)
    assert bool(torch.isfinite(sim.state.x).all() and torch.isfinite(sim.state.Ff).all()), row
    assert row["min_y"] > 0.15 - 2 * cfg.dx and row["max_F_minus_I"] > 1e-3, row
    assert all(s.newton_iters == 0 and s.converged for s in stats), row
    assert all(v == 0 for v in run_launches.values()), row
    scene = build_scene("twisting_bar_3d", device="cuda", res=32, ppc=4)
    cfg = config_from_overrides(scene["cfg"], {"solver.nonlinear": "lbfgs"})
    sim = Simulation(cfg, stress_state(scene["state"], scene["cfg"]), scene["model"],
                     scene["colliders"])
    (stats, seconds), run_launches = counted(lambda: run_steps(sim, 3, DT))
    row = step_record(sim, stats, seconds)
    # one gradient (the linearize's residual) at v0 and one per iteration
    want = {"fused_apply": 0, "fused_linearize": sum(k + 1 for k in row["newton"]),
            "bsr_spmv": 0, "fused_block_diag": 0}
    row.update(nonlinear="lbfgs", scene="twisting_bar_3d", res=32, launches=run_launches,
               launches_expected=want, backtracks=[s.ls_backtracks for s in stats])
    emit("baselines", card=card, **row)
    assert_steps_ok(sim, stats, row)
    assert run_launches == want, row
    del scene, sim
    lap("baselines")

    # ---- 14 io: the CLI on the card, 2 frames of block_drop_2d in bgeo, and
    # the same run resumed from its first checkpoint
    from hot_tpu_torch import cli
    from hot_tpu_torch.io.checkpoint import load_checkpoint
    from hot_tpu_torch.io.frames import read_bgeo

    io_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_io"
    shutil.rmtree(io_dir, ignore_errors=True)
    cli_args = ["--scene", "block_drop_2d", "--device", "cuda", "--frames", "2",
                "--frame-format", "bgeo", "--quiet"]
    t0 = time.perf_counter()
    assert cli.main(cli_args + ["-o", str(io_dir / "full")]) == 0
    assert cli.main(cli_args + ["-o", str(io_dir / "resumed"), "--resume",
                                str(io_dir / "full" / "ckpt_00000.npz")]) == 0
    cli_seconds = time.perf_counter() - t0
    x_full, v_full = read_bgeo(str(io_dir / "full" / "frame_00001.bgeo"))
    x_resumed, _ = read_bgeo(str(io_dir / "resumed" / "frame_00001.bgeo"))
    state, t_end, steps = load_checkpoint(str(io_dir / "full" / "ckpt_00001.npz"),
                                          device="cpu")
    dx = json.loads((io_dir / "full" / "config.json").read_text())["dx"]
    row = dict(scene="block_drop_2d", frames=2, steps=steps, t=t_end, seconds=cli_seconds,
               particles=state.n, resume_x_diff_over_dx=float(np.abs(x_full - x_resumed).max())
               / dx, limit=RESUME_TOL,
               bgeo_equals_checkpoint_x=bool(np.array_equal(x_full[:, :2], state.x.numpy())),
               files=sorted(p.name for p in (io_dir / "full").iterdir()))
    emit("io", card=card, **row)
    assert not (io_dir / "resumed" / "frame_00000.bgeo").exists(), row
    assert state.x.dtype == torch.float32 and row["bgeo_equals_checkpoint_x"], row
    assert np.isfinite(x_full).all() and v_full is not None and steps > 0, row
    assert row["resume_x_diff_over_dx"] <= RESUME_TOL, row
    lap("io")

    # ---- 15 kernels_sparse: both particle kernels on the compact node ids of
    # the 128^3 bar's tile grid (F perturbed by 0.1), against their plain
    # versions and against the dense instance
    sparse_summary = {}
    for dtype in (torch.float32, torch.float64):
        case = kernel_inputs("twisting_bar_3d", "fixed_corotated", dtype, rng, SPARSE_RES)
        compact_inputs(case, rng)
        row, bad = check_sparse_kernels(case, timing=dtype == torch.float32)
        emit("kernels_sparse", card=card, scene="twisting_bar_3d", res=SPARSE_RES,
             dtype=str(dtype), **row)
        if bad:
            raise AssertionError(f"compact-id kernel disagrees: {bad}")
        if dtype == torch.float32:
            sparse_summary = row
        del case
    torch.cuda.empty_cache()
    lap("kernels_sparse")

    # ---- 16 sparse: the 128^3 bar, dense against sparse backend under
    # block-Jacobi and config 3, 6 steps each from one loaded state; then
    # each block-Jacobi step again from the dense run's state before it, cast
    # to fp64, once on each grid (6 fp32 steps apart, the two runs' atomics
    # orders alone part their trajectories, as two dense runs part; and in
    # fp32 a step on a Newton threshold takes one more or one fewer Newton
    # iteration by the order of the atomic adds, which once failed this
    # check on an honest tree, so the stepwise pairs run in fp64)
    scene = build_scene("twisting_bar_3d", device="cuda", res=SPARSE_RES, ppc=8)
    sim = Simulation(scene["cfg"], scene["state"], scene["model"], scene["colliders"])
    run_steps(sim, 2, DT)
    start, t_start = sim.state, sim.t
    del sim
    sparse_cfg = {"grid_backend": "sparse", "tile_capacity": 4096}
    sparse_launches = {}
    for label in ("block_jacobi", "config 3"):
        runs = {}
        for backend in ("dense", "sparse"):
            cfg = scene["cfg"] if label == "block_jacobi" else config3(scene["cfg"])
            if backend == "sparse":
                cfg = config_from_overrides(cfg, sparse_cfg)
            sim, stats, seconds, run_launches, build_ms, before = sparse_run(
                scene, cfg, start, t_start, 6, record=backend == "dense")
            row = step_record(sim, stats, seconds)
            mgc = cfg.solver.multigrid if label == "config 3" else None
            want = expected_launches(row["newton"], row["cg"], mgc=mgc)
            row.update(preconditioner=label, backend=backend, launches=run_launches,
                       launches_expected=want, active_tiles=[s.active_tiles for s in stats],
                       mg_build_ms_per_newton=float(np.mean(build_ms)) if build_ms else None)
            if backend == "sparse":
                row["compact_nodes"] = 64 * stats[-1].active_tiles + 1
                row["hierarchy"] = hierarchy_split(sim) if mgc else None
                sparse_launches[label] = run_launches
            row["dense_nodes"] = SPARSE_RES ** 3
            emit("sparse", card=card, scene="twisting_bar_3d", res=SPARSE_RES, **row)
            assert bool(torch.isfinite(sim.state.x).all()), row
            assert all(s.converged for s in stats) and sim.retry_count == 0, row
            assert run_launches == want, row
            runs[backend] = (sim.state.x, stats, before + [(sim.state, sim.t)])
            del sim
        (xd, sd, dense_states), (xs, ss, _) = runs["dense"], runs["sparse"]
        diff = float((xd - xs).abs().max()) / scene["cfg"].dx
        pairs = [((a.newton_iters, b.newton_iters), (a.cg_iters, b.cg_iters))
                 for a, b in zip(sd, ss)]
        # Block-Jacobi is the same operator on both grids. Config 3's coarse
        # levels are not: a coarse node is constrained when over 25% of its
        # restriction weight comes from constrained fine nodes, and the dense
        # grid counts the weight of inactive fine nodes (the clamps' empty
        # nodes) that the tile grid does not hold, as hot_tpu's two backends
        # do; so config 3 is held to convergence and its launches, and its
        # counts and x are recorded
        exact = label == "block_jacobi"
        stepwise = []
        if exact:
            for k, stats_k in enumerate(sd):
                state_k, t_k = dense_states[k]
                state_k = state_k.replace(**{f: getattr(state_k, f).double() for f in FIELDS})
                after = {}
                for backend, cfg in (("dense", scene["cfg"]),
                                     ("sparse", config_from_overrides(scene["cfg"], sparse_cfg))):
                    sim = Simulation(cfg, state_k, scene["model"], scene["colliders"])
                    sim.t = t_k
                    after[backend] = (sim.step(DT), sim.state.x)
                    del sim
                (dn, dx_), (sp_, sx) = after["dense"], after["sparse"]
                stepwise.append(dict(newton=(dn.newton_iters, sp_.newton_iters),
                                     cg=(dn.cg_iters, sp_.cg_iters),
                                     x_diff_over_dx=float((dx_ - sx).abs().max())
                                     / scene["cfg"].dx,
                                     fp32_dense=(stats_k.newton_iters, stats_k.cg_iters)))
        emit("sparse", preconditioner=label, trajectories=pairs, x_diff_over_dx=diff,
             dense_against_sparse_per_step_fp64=stepwise,
             limits=dict(newton="equal", cg_diff=2, x_diff_over_dx=X_TOL) if exact else None)
        for r in stepwise:
            assert r["newton"][0] == r["newton"][1], stepwise
            assert abs(r["cg"][0] - r["cg"][1]) <= 2 and r["x_diff_over_dx"] <= X_TOL, stepwise
        del runs
    del start
    torch.cuda.empty_cache()
    lap("sparse")

    # ---- 17 composed: the composed level-1 operator against the RAP of the
    # assembled fine operator (64^3, fp64); then 128^3 dense, config 3
    # against config 3 with assembled_from_level=1 (composed level 1 below a
    # matrix-free finest level), 3 steps each from one loaded state, in
    # fp64: in fp32 the matrix-free finest level's diagonal floor
    # (solver/multigrid.py:_floor_fp32_diag, hot_tpu's) stalls Newton on the
    # bar (ROADMAP queue C; PERF.md, PR 6)
    row = composed_against_rap(rng)
    emit("composed", card=card, **row)
    assert row["rel_err"] <= row["limit"], row
    torch.cuda.empty_cache()
    scene = build_scene("twisting_bar_3d", device="cuda", res=SPARSE_RES, ppc=8,
                        dtype=torch.float64)
    sim = Simulation(scene["cfg"], scene["state"], scene["model"], scene["colliders"])
    run_steps(sim, 2, DT)
    start, t_start = sim.state, sim.t
    del sim
    for label, extra in (("config 3", {}),
                         ("config 3, composed level 1", {
                             "solver.multigrid.assembled_from_level": 1})):
        cfg = config_from_overrides(config3(scene["cfg"]), extra)
        with ComposedTimer() as ct, Attempts() as att:
            sim, stats, seconds, run_launches, build_ms, _ = sparse_run(scene, cfg, start,
                                                                        t_start, 3)
        parts = ct.ms()
        row = step_record(sim, stats, seconds)
        mgc = cfg.solver.multigrid
        # every attempt's launches, a retried one's too
        newton_att = [a.newton_iters for _, a in att.stats]
        cg_att = [a.cg_iters for _, a in att.stats]
        want = expected_launches(newton_att, cg_att, mgc=mgc)
        if extra:
            want.update(fused_apply=composed_apply_launches(mgc, newton_att, cg_att),
                        bsr_spmv=mg_spmv_launches(mgc, newton_att, cg_att, 1)[2])
        newton_all = sum(newton_att)
        row.update(config=label, launches=run_launches, launches_expected=want,
                   mg_build_ms_per_newton=float(np.mean(build_ms)) if build_ms else None,
                   build_ms_split_per_newton={k: sum(v) / max(newton_all, 1)
                                              for k, v in parts.items()},
                   builds=dict((k, len(v)) for k, v in parts.items()))
        emit("composed", card=card, scene="twisting_bar_3d", res=SPARSE_RES,
             dtype=str(torch.float64), **row)
        assert bool(torch.isfinite(sim.state.x).all()), row
        assert all(s.converged for s in stats) and sim.retry_count == 0, row
        assert run_launches == want, row
        if extra:
            assert len(parts["composed"]) == newton_all and not parts["quadrature"], row
        del sim
    del start
    # the composed configuration in fp32, one step from the fp32 loaded
    # state: recorded (Newton, dt retries, convergence), held only to a finite
    # state, as phase mg's default multigrid in fp32
    scene = build_scene("twisting_bar_3d", device="cuda", res=SPARSE_RES, ppc=8)
    sim = Simulation(scene["cfg"], scene["state"], scene["model"], scene["colliders"])
    run_steps(sim, 2, DT)
    cfg = config_from_overrides(config3(scene["cfg"]), {"solver.multigrid.assembled_from_level": 1})
    with Attempts() as att:
        sim, stats, seconds, run_launches, _, _ = sparse_run(scene, cfg, sim.state, sim.t, 1)
    row = step_record(sim, stats, seconds)
    row.update(config="config 3, composed level 1", dtype=str(torch.float32),
               cn_residual=[s.cn_residual for s in stats], retried_attempts=att.retried(stats))
    emit("composed", card=card, scene="twisting_bar_3d", res=SPARSE_RES, **row)
    assert bool(torch.isfinite(sim.state.x).all()), row
    del sim, scene
    torch.cuda.empty_cache()
    lap("composed")

    # ---- 18 scale256: the 256^3 bar (3.19 M particles) on the sparse grid:
    # 4-level MG with the composed Galerkin level 1 below a matrix-free
    # finest level, Chebyshev, direct coarse solve, 2 steps; then 2
    # block-Jacobi steps on the same sparse grid; fp64, as phase composed
    scene = build_scene("twisting_bar_3d", device="cuda", res=SCALE_RES, ppc=8,
                        dtype=torch.float64)
    start, t_start = scene["state"], 0.0
    scale_cfg = {"grid_backend": "sparse", "tile_capacity": SCALE_TILES,
                 "solver.multigrid.assembled_from_level": 1}
    for label in ("config 3, composed level 1", "block_jacobi"):
        cfg = (config_from_overrides(config3(scene["cfg"]), scale_cfg) if label != "block_jacobi"
               else config_from_overrides(scene["cfg"], {
                   k: v for k, v in scale_cfg.items() if not k.startswith("solver")}))
        with ComposedTimer() as ct:
            sim, stats, seconds, run_launches, build_ms, _ = sparse_run(scene, cfg, start,
                                                                        t_start, 2)
        row = step_record(sim, stats, seconds)
        parts = ct.ms()
        row.update(config=label, launches=run_launches, active_tiles=[s.active_tiles
                                                                      for s in stats],
                   compact_nodes=64 * stats[-1].active_tiles + 1, dense_nodes=SCALE_RES ** 3,
                   mg_build_ms_per_newton=float(np.mean(build_ms)) if build_ms else None,
                   build_ms_split_per_newton={k: sum(v) / max(sum(row["newton"]), 1)
                                              for k, v in parts.items()})
        if label != "block_jacobi":
            row["hierarchy"] = hierarchy_split(sim)
            switch = 2 * SCALE_TILES * 4 ** 3
            # hot_tpu's rule: level 0 compact, a coarser level while its
            # dense node count is above the switch
            assert [h["compact"] for h in row["hierarchy"]] == [
                l == 0 or h["res"] ** 3 > switch for l, h in enumerate(row["hierarchy"])], row
        emit("scale256", card=card, scene="twisting_bar_3d", res=SCALE_RES,
             dtype=str(torch.float64), **row)
        assert bool(torch.isfinite(sim.state.x).all()), row
        assert all(s.converged for s in stats) and sim.retry_count == 0, row
        start, t_start = sim.state, sim.t
        del sim
    del scene, start
    torch.cuda.empty_cache()
    lap("scale256")

    # ---- 19 batch: the batched kernels and the two stiffness sweeps
    batch_summary, sweeps = batch_phase(rng, card)
    lap("batch")

    # ---- 20 batch_solvers: the batch on the tile grid, under HOT's
    # multigrid, MINRES, L-BFGS and the explicit BSR
    solvers = batch_solvers_phase(rng, card)
    lap("batch_solvers")

    # ---- 21 sharded: the slab decomposition, D ranks sharing the card
    sharded = sharded_phase(rng, card)
    lap("sharded")

    # ---- 22 block_diag: the block-diagonal kernel against its plain version
    block_diag = block_diag_phase(rng, card)
    lap("block_diag")
    emit("runtime", seconds=laps, total_seconds=sum(laps.values()))

    spmv = summary["spmv"]

    def particle_row(name, kernel):
        """The kernel's row: launches on its main path (block-Jacobi at 64^3,
        quadratic or cubic), its error and times at 64^3 (fp32)."""
        quadratic = kernel == "quadratic"
        row = summary[64] if quadratic else summary[kernel, 64]
        err = summary["errs" if quadratic else "errs_cubic"][
            "lin_f" if name == "fused_linearize" else "apply_df"][0]
        return {"name": name if quadratic else f"{name}_{kernel}", "route": "cuda",
                "source": f"hot_tpu_torch/csrc/{name}.cu",
                "replaces": {"fused_linearize": "hot_tpu/ops/pallas_linearize.py:374",
                             "fused_apply": "hot_tpu/ops/pallas_apply.py:143"}[name],
                "launches": (launches if quadratic else cubic_launches)[name],
                "max_abs_err": err, "ms": row[name]["ms"], "plain_ms": row[name]["plain_ms"],
                "bound_ms": row[name]["bound_ms"], "bound_by": row[name]["bound_by"],
                "library_ms": None}

    def compact_row(name):
        """The compact-id instance: launches on the sparse backend's
        block-Jacobi run (phase sparse), error and times at 128^3 (fp32)."""
        row = sparse_summary[f"{name}_compact"]
        err = sparse_summary["max_abs_err"]["lin_f" if name == "fused_linearize" else "apply_df"]
        return {"name": f"{name}_compact", "route": "cuda",
                "source": f"hot_tpu_torch/csrc/{name}.cu",
                "replaces": {"fused_linearize": "hot_tpu/ops/pallas_linearize.py:374",
                             "fused_apply": "hot_tpu/ops/pallas_apply.py:143"}[name],
                "launches": sparse_launches["block_jacobi"][name], "max_abs_err": err,
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None}

    def batch_row(name):
        """The batched launch: launches on the 64^3 bar sweep (8 members,
        phase batch), the worst member's error against the plain version
        and device ms of one launch of the 8 members (fp32, quadratic)."""
        row = batch_summary["quadratic"]
        return {"name": f"{name}_batched", "route": "cuda",
                "source": f"hot_tpu_torch/csrc/{name}.cu",
                "replaces": {"fused_linearize": "hot_tpu/ops/pallas_linearize.py:374",
                             "fused_apply": "hot_tpu/ops/pallas_apply.py:143"}[name],
                "launches": sweeps["bar"]["launches"][name],
                "max_abs_err": row["max_abs_err" if name == "fused_linearize"
                                   else "max_abs_err_apply"],
                "ms": row[name]["ms"], "plain_ms": row[name]["plain_ms"],
                "bound_ms": row[name]["bound_ms"], "bound_by": row[name]["bound_by"],
                "library_ms": None}

    def tiled_batch_row(name):
        """The batched launch on a batch's tile grid: launches on the 128^3
        sweep under config 3 on the sparse grid (4 members, phase
        batch_solvers (c)), the worst member's error against the plain
        version and device ms of one launch of 8 members of the 64^3 bar,
        each on its own tile set (fp32, (a))."""
        row = solvers["tiled"]
        return {"name": f"{name}_compact_batched", "route": "cuda",
                "source": f"hot_tpu_torch/csrc/{name}.cu",
                "replaces": {"fused_linearize": "hot_tpu/ops/pallas_linearize.py:374",
                             "fused_apply": "hot_tpu/ops/pallas_apply.py:143"}[name],
                "launches": solvers["wide"]["launches"][name],
                "max_abs_err": row["max_abs_err" if name == "fused_linearize"
                                   else "max_abs_err_apply"],
                "ms": row[name]["ms"], "plain_ms": row[name]["plain_ms"],
                "bound_ms": row[name]["bound_ms"], "bound_by": row[name]["bound_by"],
                "library_ms": None}

    batch_spmv = solvers["spmv"]

    def slab_row(name):
        """The slab launch: launches on config 4's sharded run under config 3
        (summed over the ranks, phase sharded (b), fp64; a rank holding no
        particle launches none), the worst rank's error against
        the plain version and device ms of an interior rank's launch at
        64^3 (fp32, (a))."""
        row = sharded["slab"]["timing"][name]
        err = sharded["slab"]["max_abs_err"]["lin_f" if name == "fused_linearize"
                                             else "apply_df"][0]
        return {"name": f"{name}_slab", "route": "cuda",
                "source": f"hot_tpu_torch/csrc/{name}.cu",
                "replaces": {"fused_linearize": "hot_tpu/ops/pallas_linearize.py:374",
                             "fused_apply": "hot_tpu/ops/pallas_apply.py:143"}[name],
                "launches": sharded["launches"][name], "max_abs_err": err,
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None}

    def block_diag_row(key, name, launches_on_path):
        """The block-diagonal kernel's row: launches on its main path
        (`launches_on_path`), its error and times (fp32) from phase
        block_diag."""
        row = block_diag[key]
        return {"name": name, "route": "cuda",
                "source": "hot_tpu_torch/csrc/fused_block_diag.cu", "replaces": None,
                "reference": "hot_tpu/sim/objective.py:elastic_block_diag (plain jnp)",
                "launches": launches_on_path, "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None}

    print(json.dumps({"kernels": [
        particle_row("fused_linearize", "quadratic"),
        particle_row("fused_apply", "quadratic"),
        particle_row("fused_linearize", "cubic"),
        particle_row("fused_apply", "cubic"),
        compact_row("fused_linearize"),
        compact_row("fused_apply"),
        batch_row("fused_linearize"),
        batch_row("fused_apply"),
        {"name": "bsr_spmv", "route": "cuda", "source": "hot_tpu_torch/csrc/bsr_spmv.cu",
         "replaces": "hot_tpu/ops/bsr_tiled.py:387",
         "launches": mg_counts["bsr_spmv"], "max_abs_err": spmv["max_abs_err"],
         "ms": spmv["ms"], "plain_ms": spmv["plain_ms"], "bound_ms": spmv["bound_ms"],
         "bound_by": spmv["bound_by"], "library_ms": spmv["library_ms"]},
        tiled_batch_row("fused_linearize"),
        tiled_batch_row("fused_apply"),
        # launches: the three multigrid sweeps of (b), 8 members each; times
        # of one SpMV over the 8 members' level-0 rows (fp64, config 3 dense)
        {"name": "bsr_spmv_batched", "route": "cuda", "source": "hot_tpu_torch/csrc/bsr_spmv.cu",
         "replaces": "hot_tpu/ops/bsr_tiled.py:387",
         "launches": sum(r["launches"]["bsr_spmv"] for r in solvers["mg"].values()),
         "max_abs_err": batch_spmv["max_abs_err"], "ms": batch_spmv["ms"],
         "plain_ms": batch_spmv["plain_ms"], "bound_ms": batch_spmv["bound_ms"],
         "bound_by": batch_spmv["bound_by"], "library_ms": batch_spmv["library_ms"]},
        slab_row("fused_linearize"),
        slab_row("fused_apply"),
        # launches: block-Jacobi at 64^3 (phase main), with the cubic stencil
        # (phase cubic) and on the 128^3 bar's tile grid (phase sparse)
        block_diag_row(("twisting_bar_3d", "quadratic", str(torch.float32)), "fused_block_diag",
                       launches["fused_block_diag"]),
        block_diag_row(("twisting_bar_3d", "cubic", str(torch.float32)),
                       "fused_block_diag_cubic", cubic_launches["fused_block_diag"]),
        block_diag_row(("compact_128", str(torch.float32)), "fused_block_diag_compact",
                       sparse_launches["block_jacobi"]["fused_block_diag"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
