"""Checkpoint and restart, and per-frame render output.

Counterpart of ``hot_tpu.io.checkpoint``. A checkpoint is one ``.npz`` with
every ParticleState field (``x``, ``v``, ``Cf``, ``Ff``, ``m``, ``V0``,
``mu``, ``lam``, ``yield_stress``, ``Jp``) and the clock (``__t``,
``__step_count``): the keys hot_tpu writes, so a checkpoint of either
package loads in the other. The grid is derived from the particles, so a
resumed run repeats the uninterrupted one bit for bit where the step is
deterministic (the CPU; on a GPU, atomic adds change fp32 rounding).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from hot_tpu_torch.io import frames
from hot_tpu_torch.sim.state import FIELDS, ParticleState

FRAME_WRITERS = {"bgeo": frames.write_bgeo, "ply": frames.write_ply, "vtk": frames.write_vtk}


def save_checkpoint(path: str, state: ParticleState, t: float, step_count: int):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, __t=t, __step_count=step_count, **state.to_numpy())


def load_checkpoint(path: str, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Tuple[ParticleState, float, int]:
    """(state on `device`, t, step_count); dtype None keeps the saved one."""
    with np.load(path) as data:
        fields = {f: torch.as_tensor(data[f], device=device) for f in FIELDS}
        t, step_count = float(data["__t"]), int(data["__step_count"])
    if dtype is not None:
        fields = {f: a.to(dtype) for f, a in fields.items()}
    return ParticleState(**fields), t, step_count


def save_frame(path: str, state: ParticleState):
    """The particles' positions and velocities for rendering, in the format
    of the file's extension: bgeo, ply, vtk (``io.frames``), else npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ext = os.path.splitext(path)[1].lstrip(".").lower()
    x = state.x.detach().cpu().numpy()
    v = state.v.detach().cpu().numpy()
    if ext in FRAME_WRITERS:
        FRAME_WRITERS[ext](path, x, v)
    else:
        np.savez_compressed(path, x=x, v=v)
