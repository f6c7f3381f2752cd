"""Fused Newton linearization: elastic force and Hessian context at v.

Replaces the TPU kernel ``hot_tpu/ops/pallas_linearize.py:fused_linearize``
with the CUDA kernel ``hot_tpu_torch/csrc/fused_linearize.cu``. For a grid
velocity v it returns

    f (n_nodes, d): f_i = sum_p sum_k [node_k(p) = i] -V0_p (P_p F_p^T) gw_pk,
                    P_p = P(F_new_p), F_new_p = (I + dt grad_v_p) F_p;
    U, V, A (d*d, n) and b_plus, b_minus (n_pairs, n): the (SPD-projected)
                    diagonal-space Hessian context at F_new, per particle.

The stencil is that of the particle positions x (d, n) on the grid of
spacing dx and size res, computed in the kernel, as in ``ops.fused_apply``.
The context comes out in the structure-of-arrays layout that the apply
reads (see there), so one Newton iteration is one launch of this kernel
followed by one launch of the apply per CG iteration.

On the H100 the kernel is bound by bytes, with the two 6-sweep Jacobi
eigensolves per 3D particle close behind; it gathers and scatters through
the same shared-memory node window as the apply (see the source's note).
The kernel's SVD uses the algebraic Jacobi angle, so U and V may differ from
the plain version's by paired column signs; everything downstream is
invariant to that.

Dispatch is by device: CPU tensors take ``fused_linearize_plain``; CUDA
tensors launch the kernel or raise. ``launches`` counts kernel launches;
``window_stats`` works as in ``ops.fused_apply``.
"""

from __future__ import annotations

import torch

from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.ops import cuda_lib
from hot_tpu_torch.ops import transfer
from hot_tpu_torch.ops.fused_apply import aos_mat, launch_args, param_specs, soa

MODEL_CODES = {"fixed_corotated": 0, "stvk_hencky": 1}

launches = 0
window_stats = None


def fused_linearize_plain(v, x, dx, res, F, mu, lam, V0, dt, model, project: bool = True):
    """The unfused chain in plain PyTorch (the reference for the kernel)."""
    d = v.shape[-1]
    st = transfer.particle_stencil(x.T, dx, res)
    Fp = aos_mat(F, d)
    eye = torch.eye(d, dtype=v.dtype, device=v.device)
    F_new = (eye + dt * transfer.velocity_gradient(st, v)) @ Fp
    P, ctx = cm.stress_and_hessian(model, F_new, mu, lam, project=project)
    f = transfer.scatter_force(st, P @ Fp.transpose(-1, -2), V0, v.shape[0])
    return (f, soa(ctx.U), soa(ctx.V), soa(ctx.A), soa(ctx.b_plus), soa(ctx.b_minus))


def fused_linearize_cuda(v, x, dx, res, F, mu, lam, V0, dt, model, project: bool = True,
                         threads=None, window_nodes=None):
    """Launch the CUDA kernel (CUDA tensors only)."""
    global launches
    if model.name not in MODEL_CODES:
        raise NotImplementedError(f"no linearize kernel for model '{model.name}'")
    d = v.shape[-1]
    n = x.shape[1]
    cuda_lib.check_inputs(v, param_specs(v, x, res, F=F, mu=mu, lam=lam, V0=V0))
    lib = cuda_lib.load()
    n_pairs = 1 if d == 2 else 3
    f = torch.zeros_like(v)
    U, V, A = (torch.empty((d * d, n), dtype=v.dtype, device=v.device) for _ in range(3))
    bp, bm = (torch.empty((n_pairs, n), dtype=v.dtype, device=v.device) for _ in range(2))
    rc = lib.hot_fused_linearize(
        MODEL_CODES[model.name], cuda_lib.dtype_code(v), d, v.data_ptr(), x.data_ptr(),
        float(dx), cuda_lib.int_array(res), F.data_ptr(), mu.data_ptr(), lam.data_ptr(),
        V0.data_ptr(), float(dt), int(bool(project)), f.data_ptr(), U.data_ptr(),
        V.data_ptr(), A.data_ptr(), bp.data_ptr(), bm.data_ptr(), n,
        *launch_args(v, threads, window_nodes, window_stats), cuda_lib.stream_ptr(v.device))
    cuda_lib.check(rc, "fused_linearize")
    launches += 1
    return f, U, V, A, bp, bm


def fused_linearize(v, x, dx, res, F, mu, lam, V0, dt, model, project: bool = True):
    """(f, U, V, A, b_plus, b_minus) at grid velocity v (see the module doc)."""
    if v.device.type == "cpu":
        return fused_linearize_plain(v, x, dx, res, F, mu, lam, V0, dt, model, project)
    if v.device.type != "cuda":
        raise ValueError(f"fused_linearize runs on cpu or cuda tensors, not {v.device}")
    return fused_linearize_cuda(v, x, dx, res, F, mu, lam, V0, dt, model, project)
