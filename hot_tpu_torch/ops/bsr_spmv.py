"""Block-sparse SpMV over the compressed-row BSR layout of ``ops.bsr``.

Replaces the TPU kernel ``hot_tpu/ops/bsr_tiled.py:spmv_T`` with the CUDA
kernel ``hot_tpu_torch/csrc/bsr_spmv.cu``:

    y[r, :] = sum_k vals[r, k] @ x[col_row[r, k], :]   (col_row < 0 skipped)

for vals (R, K, d, d), col_row (R, K) int32 and x (n_rows, d), d in {2, 3},
any K (25/125 for quadrature operators, 49/343 and 81/729 for Galerkin
levels). It is the one SpMV of every assembled operator: the outer
Hessian with ``matrix_free=False`` and the assembled multigrid levels'
smoothers, residuals, power iterations and coarse CG.

On the H100 the kernel is bound by bytes (vals and col_row, each read once;
see the source's note).

Dispatch is by device: CPU tensors take ``bsr_spmv_plain``; CUDA tensors
launch the kernel or raise. The tracer's counter ``launches.bsr_spmv``
(``utils.timing``) counts kernel launches (none for a matrix with no rows).
"""

from __future__ import annotations

import torch

from hot_tpu_torch.ops import cuda_lib
from hot_tpu_torch.utils.timing import count


def bsr_spmv_plain(vals, col_row, x):
    """Masked gather and einsum in plain PyTorch (the kernel's reference)."""
    ok = (col_row >= 0)[:, :, None]
    xg = torch.where(ok, x[col_row.clamp(min=0).long()], torch.zeros((), dtype=x.dtype,
                                                                     device=x.device))
    return torch.einsum("rkij,rkj->ri", vals, xg)


def bsr_spmv_cuda(vals, col_row, x):
    """Launch the CUDA kernel (CUDA tensors only)."""
    R, K, d = vals.shape[0], vals.shape[1], x.shape[-1]
    if d not in (2, 3):
        raise ValueError(f"bsr_spmv takes d in (2, 3), got {d}")
    cuda_lib.check_inputs(x, [("x", x, x.shape, x.dtype), ("vals", vals, (R, K, d, d), x.dtype),
                              ("col_row", col_row, (R, K), torch.int32)])
    lib = cuda_lib.load()
    y = torch.empty((R, d), dtype=x.dtype, device=x.device)
    rc = lib.hot_bsr_spmv(cuda_lib.dtype_code(x), d, vals.data_ptr(), col_row.data_ptr(),
                          x.data_ptr(), y.data_ptr(), R, K, cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "bsr_spmv")
    count("launches.bsr_spmv", int(R > 0))   # the C entry launches nothing for no rows
    return y


def bsr_spmv(vals, col_row, x):
    """y (n_rows, d) = A x (see the module doc)."""
    if x.device.type == "cpu":
        return bsr_spmv_plain(vals, col_row, x)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmv runs on cpu or cuda tensors, not {x.device}")
    return bsr_spmv_cuda(vals, col_row, x)
