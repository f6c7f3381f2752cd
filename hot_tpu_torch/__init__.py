"""hot_tpu_torch: the implicit MPM solver of ``hot_tpu`` on PyTorch and CUDA.

A port of the JAX/Pallas package ``hot_tpu`` (which stays the reference) to
eager PyTorch on an NVIDIA Hopper GPU. The per-particle hot loops of the
implicit step run in hand-written CUDA kernels (``csrc/``), chosen by the
device the tensors live on; on CPU tensors the same functions run their
plain PyTorch versions. Module names follow ``hot_tpu`` so each function's
counterpart is easy to find:

  grid      the block-sparse tile grid and its compact node ids (sparse)
  ops       B-splines, SVD, transfers; fused_apply / fused_linearize /
            bsr_spmv (the CUDA kernels, counterparts of pallas_apply /
            pallas_linearize / bsr_tiled.spmv_T), on the dense grid or on
            compact node ids; BSR assembly, the Galerkin RAP and the composed
            Galerkin level (bsr, spgemm, composed)
  models    fixed-corotated, StVK-Hencky, Neo-Hookean and linear corotated
            in singular-value space; the von Mises, snow and Drucker-Prager
            return maps
  solver    projected CG and MINRES, inexact Newton with optional line
            search, L-BFGS, node-embedding multigrid on dense and compact
            levels
  parallel  the slab decomposition over torch.distributed (hot_tpu.parallel):
            halo exchange, the sharded step and multigrid, migration,
            sharded checkpoints
  sim       state, seeding, colliders, the objective, the time step,
            conservation queries and the finite-difference check
  io        checkpoints, render frames, OBJ meshes and sampling inside them
  scenes    hot_tpu's eleven scenes and their procedural mesh asset
  utils     config tree, metrics, the tracer (spans and counters)
"""

__version__ = "0.1.0"

from hot_tpu_torch.utils.config import (  # noqa: F401
    MeshConfig,
    MultigridConfig,
    SimConfig,
    SolverConfig,
)
