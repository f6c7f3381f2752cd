"""Frozen configuration tree for scenes, solver, multigrid and device mesh.

Counterpart of ``hot_tpu.utils.config``: the same classes, field names and
defaults, less the knobs that only chose an XLA:TPU code path or a Pallas
kernel (``pallas_apply``, ``pallas_linearize``, ``slot_major``,
``transfer_impl``, ``bin_cells_capacity``, ``bin_cap``). In this package the
kernels are chosen by the device the tensors live on, not by a flag.

The CLI overrides fields with dotted paths (``config_from_overrides``) and
dumps the whole tree into the run directory.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MultigridConfig:
    """Node-embedding multigrid knobs (reference flags -mg_level, --mg_times,
    --smoother, --coarseSolver), read by ``solver.multigrid``.

    The port sizes every assembled level to its rows, so ``coarse_capacity``
    has nothing to bound and is not read. ``sparse_dense_switch`` is the
    dense node count at or below which a coarse level of the sparse grid
    backend is dense (None: 2 tile_capacity 4^dim, as in hot_tpu).
    ``assembled_from_level > 0`` with ``coarsening="galerkin"`` makes that
    level the composed Galerkin operator (``ops.composed``)."""

    levels: int = 3
    cycles: int = 1
    pre_smooth: int = 2
    post_smooth: int = 2
    smoother: str = "chebyshev"      # chebyshev | jacobi | colored_gs
    chebyshev_order: int = 2
    jacobi_omega: float = 2.0 / 3.0
    coarse_solver: str = "smoother"  # smoother | cg | direct
    coarse_iters: int = 20
    chebyshev_lo: float = 0.1
    chebyshev_hi: float = 1.05
    power_iters: int = 8
    assembled: bool = False
    coarsening: str = "galerkin"     # galerkin | quadrature
    assembled_from_level: int = 0
    coarse_capacity: Optional[int] = None
    rap_max_half: Optional[int] = None
    rap_refresh: str = "newton"      # newton | lagged
    sparse_dense_switch: Optional[int] = None


@dataclass(frozen=True)
class SolverConfig:
    """Newton + Krylov knobs (reference flags --usecn --cneps --lsolver
    --Ainv --matfree)."""

    integrator: str = "implicit"     # implicit | explicit
    nonlinear: str = "newton"        # newton | lbfgs
    lbfgs_history: int = 8
    max_newton: int = 10
    use_cn: bool = True              # characteristic-norm termination
    cn_eps: float = 1e-2             # --cneps
    abs_tol: float = 1e-9            # fallback absolute residual tolerance
    linear_solver: str = "cg"        # cg | minres
    # none | jacobi (mass) | block_jacobi (HOT's --Ainv) | multigrid
    preconditioner: str = "block_jacobi"
    max_cg: int = 200
    cg_tol: float = 1e-3             # relative tolerance (inexact Newton floor)
    # Eisenstat-Walker-style forcing: eta_k = clip(sqrt(cn_k / cn_0), cg_tol, 0.5)
    adaptive_forcing: bool = True
    matrix_free: bool = True         # finest-level Hessian: matrix-free vs BSR
    bsr_capacity: int = 0
    line_search: bool = False
    # "newton": rebuild the preconditioner at every Newton iterate (HOT);
    # "step": build it once at v0 and reuse it for the whole solve
    precond_refresh: str = "newton"
    # retry a non-converged or non-finite step at halved dt this many times
    dt_retries: int = 3
    project_hessian: bool = True     # SPD projection of per-particle dP/dF
    multigrid: MultigridConfig = field(default_factory=MultigridConfig)
    overlap_halo: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh partitioning of the grid: a shape other than (1,) runs the
    sharded step (``parallel.ShardedSimulation``; one axis "x" over grid
    axis 0, shape (-1,) spans the ranks)."""

    axes: Tuple[str, ...] = ("x",)
    shape: Tuple[int, ...] = (1,)
    partition_dims: Tuple[int, ...] = (0,)


@dataclass(frozen=True)
class SimConfig:
    """Scene-independent simulation parameters."""

    dim: int = 3
    dx: float = 1.0 / 64.0
    gravity: Tuple[float, ...] = (0.0, -9.81, 0.0)
    cfl: float = 0.6                 # max particle travel in cells per step
    frame_dt: float = 1.0 / 24.0
    max_dt: float = 1e-2
    min_dt: float = 1e-7
    dtype: str = "float32"           # float32 | float64
    flip_ratio: float = 0.95         # FLIP/APIC blend (1.0 = pure FLIP)
    transfer: str = "apic"           # apic | flip
    solver: SolverConfig = field(default_factory=SolverConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    grid_res: Tuple[int, ...] = (64, 64, 64)
    grid_backend: str = "dense"      # dense | sparse
    # the most active tiles (4^dim nodes each) a sparse-grid level may hold;
    # more raise RuntimeError (grid/sparse.py)
    tile_capacity: int = 4096
    compute_energy: bool = True      # potential-energy diagnostic per step
    transfer_kernel: str = "quadratic"  # quadratic | cubic

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def config_from_overrides(base: SimConfig, overrides: dict) -> SimConfig:
    """Apply dotted-path overrides, e.g. {"solver.cn_eps": 1e-4}."""
    cfg = base
    for key, value in overrides.items():
        cfg = _replace_path(cfg, key.split("."), value)
    return cfg


def _replace_path(obj, parts, value):
    if len(parts) == 1:
        return dataclasses.replace(obj, **{parts[0]: value})
    child = getattr(obj, parts[0])
    return dataclasses.replace(obj, **{parts[0]: _replace_path(child, parts[1:], value)})
