"""Fused matrix-free Hessian apply: the per-CG-iteration force differential.

Replaces the TPU kernel ``hot_tpu/ops/pallas_apply.py:fused_contrib_cl``
with the CUDA kernel ``hot_tpu_torch/csrc/fused_apply.cu``. For a grid
direction w it returns

    df_i = sum_p sum_k [node_k(p) = i] -V0_p (dP_p F_p^T) gw_pk,
    dP_p = dP/dF(F_p) : (dt grad_w_p F_p),  grad_w_p = sum_k w_k gw_pk^T,

i.e. gather -> velocity gradient -> diagonal-space Hessian apply -> force
scatter, fused into one launch with atomic adds. The caller adds the mass
term and masks inactive nodes (``sim.objective.elastic_hessian_apply``).

Per-particle arguments are structure-of-arrays with the particle index
last: node_ids (s, n) int32, gwn (s*d, n), F/U/V/A (d*d, n) row-major per
particle, b_plus/b_minus (n_pairs, n), V0 (n,). This is the layout the
linearize kernel writes, so the per-Newton parameter block needs no
transposes.

On the H100 the kernel is bound by bytes (about 160 parameter values, 27
random grid reads and 81 atomics per 3D particle); see the source's note.

Dispatch is by device: CPU tensors take ``fused_apply_plain``; CUDA tensors
launch the kernel or raise. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from hot_tpu_torch.models import constitutive as cm
from hot_tpu_torch.ops import cuda_lib
from hot_tpu_torch.ops import transfer

launches = 0


def soa_stencil(node_ids, gwn, d: int) -> transfer.Stencil:
    """A particle-major Stencil view (no weights) of SoA node_ids and gwn."""
    s, n = node_ids.shape
    return transfer.Stencil(node_ids=node_ids.T.long(), wn=None,
                            gwn=gwn.T.reshape(n, s, d), rel=None)


def aos_mat(M, d: int):
    """(d*d, n) SoA -> (n, d, d) view."""
    return M.T.reshape(-1, d, d)


def soa(M):
    """(n, ...) particle-major -> contiguous (prod(...), n) SoA."""
    return M.reshape(M.shape[0], -1).T.contiguous()


def fused_apply_plain(w, node_ids, gwn, F, U, V, A, b_plus, b_minus, V0, dt):
    """The unfused chain in plain PyTorch (the reference for the kernel)."""
    d = w.shape[-1]
    st = soa_stencil(node_ids, gwn, d)
    Fp = aos_mat(F, d)
    ctx = cm.HessianContext(U=aos_mat(U, d), V=aos_mat(V, d), A=aos_mat(A, d),
                            b_plus=b_plus.T, b_minus=b_minus.T)
    grad_w = transfer.velocity_gradient(st, w)
    dP = cm.apply_hessian(ctx, dt * (grad_w @ Fp))
    return transfer.scatter_force(st, dP @ Fp.transpose(-1, -2), V0, w.shape[0])


def param_specs(w, node_ids, **params):
    """check_inputs specs for a quadratic-stencil kernel's arguments."""
    d = w.shape[-1]
    s, n = node_ids.shape
    if d not in (2, 3) or s != 3 ** d:
        raise ValueError(f"need a quadratic stencil in 2D or 3D, got d={d}, s={s}")
    rows = {"gwn": s * d, "F": d * d, "U": d * d, "V": d * d, "A": d * d,
            "b_plus": 1 if d == 2 else 3, "b_minus": 1 if d == 2 else 3}
    specs = [("node_ids", node_ids, (s, n), torch.int32)]
    for name, t in params.items():
        specs.append((name, t, (rows[name], n) if name in rows else (n,), w.dtype))
    return specs


def fused_apply_cuda(w, node_ids, gwn, F, U, V, A, b_plus, b_minus, V0, dt):
    """Launch the CUDA kernel (CUDA tensors only)."""
    global launches
    params = dict(gwn=gwn, F=F, U=U, V=V, A=A, b_plus=b_plus, b_minus=b_minus, V0=V0)
    cuda_lib.check_inputs(w, [("w", w, w.shape, w.dtype)]
                          + param_specs(w, node_ids, **params))
    lib = cuda_lib.load()
    df = torch.zeros_like(w)
    rc = lib.hot_fused_apply(
        cuda_lib.dtype_code(w), w.shape[-1], w.data_ptr(), node_ids.data_ptr(),
        *(t.data_ptr() for t in params.values()), float(dt), df.data_ptr(),
        node_ids.shape[1], cuda_lib.stream_ptr(w.device))
    cuda_lib.check(rc, "fused_apply")
    launches += 1
    return df


def fused_apply(w, node_ids, gwn, F, U, V, A, b_plus, b_minus, V0, dt):
    """df (n_nodes, d) for grid direction w (see the module doc)."""
    if w.device.type == "cpu":
        return fused_apply_plain(w, node_ids, gwn, F, U, V, A, b_plus, b_minus, V0, dt)
    if w.device.type != "cuda":
        raise ValueError(f"fused_apply runs on cpu or cuda tensors, not {w.device}")
    return fused_apply_cuda(w, node_ids, gwn, F, U, V, A, b_plus, b_minus, V0, dt)
