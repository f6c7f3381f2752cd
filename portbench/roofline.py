"""The yardstick's arithmetic: published peaks, a kernel's least time, and
the operations and bytes of the port's three CUDA kernels.

Frozen copies of ``chip_smoke.py`` at commit a112837 (the port's bring-up
check), so that no later change to the program moves the yardstick:

* ``PEAKS``: ``chip_smoke.py:219-220`` (the H100 SXM data sheet, dense fp32
  outside the tensor cores, HBM3), stated for the card's full 700 W limit;
* ``bound``: ``chip_smoke.py:301``;
* ``particle_kernel_bytes`` and its per-particle value counts:
  ``chip_smoke.py:307-319``;
* ``FLOPS_PER_PARTICLE``: ``chip_smoke.py:234`` (the clamp's 1,290 extra
  operations per particle, ``chip_smoke.py:236``, are left out: they run
  only where sym(A) is not positive definite, which a launch does not
  report, and counting fewer operations can only lower a share);
* ``spmv_bytes``/``spmv_flops``: ``check_spmv``, ``chip_smoke.py:381-398``;
* the tile lookup's bytes on the sparse grid: ``chip_smoke.py:992-993``.

Each input byte is counted read once and each output byte written once,
whatever the kernel reads again.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S, "fp32_flops": FP32_FLOPS,
         "power_limit_w": 700.0}

FLOPS_PER_PARTICLE = {("fused_apply", 3): 1600, ("fused_linearize", 3): 3030,
                      ("fused_apply", 4): 3230, ("fused_linearize", 4): 4690}


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the fp32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _per_particle_values(name: str, d: int) -> int:
    dd, pairs = d * d, 1 if d == 2 else 3
    if name == "fused_apply":   # F, U, V, A, b+, b-, V0
        return 4 * dd + 2 * pairs + 1
    return dd + 3 + 3 * dd + 2 * pairs  # in: F, mu, lam, V0; out: U, V, A, b+, b-


def particle_kernel_bytes(name: str, n: int, touched: int, d: int, itemsize: int,
                          tiles: int = 0) -> int:
    """Bytes of one launch of a particle kernel (``fused_apply`` or
    ``fused_linearize``): x and the per-particle SoA arrays, the grid vector
    read (w or v) and written (df or f) over the `touched` nodes (the unique
    stencil nodes), and on the sparse grid the int32 lookup entry of each of
    the `tiles` active tiles."""
    return (n * (d + _per_particle_values(name, d)) * itemsize + 2 * touched * d * itemsize
            + 4 * tiles)


def particle_kernel_flops(name: str, n: int, width: int = 3) -> int:
    return n * FLOPS_PER_PARTICLE[name, width]


def spmv_bytes(nnz_blocks: int, rows: int, K: int, d: int, itemsize: int) -> int:
    """Bytes of one ``bsr_spmv`` launch: the stored blocks, the int32 column
    table (rows x K), x read and y written."""
    return nnz_blocks * d * d * itemsize + rows * K * 4 + 2 * rows * d * itemsize


def spmv_flops(nnz_blocks: int, d: int, itemsize: int) -> int:
    """Operations of one launch, an fp64 one counted twice against the fp32
    peak."""
    return 2 * nnz_blocks * d * d * (1 if itemsize == 4 else 2)
