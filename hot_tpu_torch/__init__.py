"""hot_tpu_torch: the implicit MPM solver of ``hot_tpu`` on PyTorch and CUDA.

A port of the JAX/Pallas package ``hot_tpu`` (which stays the reference) to
eager PyTorch on an NVIDIA Hopper GPU. The per-particle hot loops of the
implicit step run in hand-written CUDA kernels (``csrc/``), chosen by the
device the tensors live on; on CPU tensors the same functions run their
plain PyTorch versions. Module names follow ``hot_tpu`` so each function's
counterpart is easy to find:

  ops       B-splines, SVD, transfers; fused_apply / fused_linearize (the
            CUDA kernels, counterparts of pallas_apply / pallas_linearize)
  models    fixed-corotated and StVK-Hencky in singular-value space
  solver    projected CG and inexact Newton
  sim       state, seeding, colliders, the objective and the time step
  scenes    block_drop_2d and twisting_bar_3d
  utils     config tree, metrics, timers
"""

__version__ = "0.1.0"

from hot_tpu_torch.utils.config import (  # noqa: F401
    MeshConfig,
    MultigridConfig,
    SimConfig,
    SolverConfig,
)
