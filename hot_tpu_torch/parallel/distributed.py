"""Process-level wiring: torch.distributed from the launcher's environment,
and the mesh a MeshConfig asks for.

Counterpart of ``hot_tpu.parallel.distributed``. One process per rank, as
``torchrun`` starts them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``); a process started alone is a world of
one on an in-process store. The backend follows the device: NCCL,
one rank per GPU, for cuda; gloo for the CPU. NCCL refuses two ranks on
one device, so ``initialize`` refuses before any step when the local ranks
outnumber the visible GPUs: it does not switch backend.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from hot_tpu_torch.parallel.mesh import Mesh, make_mesh


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(device="cuda") -> Mesh:
    """init_process_group once per process from the environment (a no-op
    when already initialised); for cuda, set this process's GPU to
    LOCAL_RANK. Returns the mesh over the world."""
    import torch.distributed as dist

    device = torch.device(device)
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
        if device.type == "cuda":
            local, local_world = (int(os.environ.get("LOCAL_RANK", "0")),
                                  int(os.environ.get("LOCAL_WORLD_SIZE", str(world))))
            visible = torch.cuda.device_count()
            if local_world > visible:
                raise RuntimeError(
                    f"{local_world} ranks on this host but {visible} visible GPU(s): NCCL "
                    "takes one rank per GPU (it refuses two ranks on one device); start at "
                    "most one rank per GPU")
            torch.cuda.set_device(local)
        if "MASTER_ADDR" in os.environ:        # torchrun's rendezvous
            dist.init_process_group(backend_for(device), world_size=world, rank=rank)
        elif world == 1:
            # a process started alone: an in-process store, no port to share
            dist.init_process_group(backend_for(device), store=dist.HashStore(), world_size=1,
                                    rank=0)
        else:
            raise RuntimeError(f"WORLD_SIZE={world} without MASTER_ADDR: start the ranks "
                               "under torchrun")
    return make_mesh()


def mesh_shape(shape: Tuple[int, ...], world: int) -> Tuple[int, ...]:
    """MeshConfig.shape with -1 filled from the world size; one axis only
    (the slab axis)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != 1:
        raise NotImplementedError(f"the slab decomposition takes a 1-D mesh, got {shape}")
    if shape == (-1,):
        return (world,)
    if shape[0] != world:
        raise ValueError(f"mesh {shape} needs {shape[0]} ranks, the world has {world}")
    return shape


def mesh_from_config(mcfg, mesh: Mesh) -> Mesh:
    """The mesh of MeshConfig over `mesh`'s ranks: shape (-1,) spans them."""
    mesh_shape(mcfg.shape, mesh.size)
    if tuple(mcfg.axes) != ("x",) or tuple(mcfg.partition_dims) != (0,):
        raise NotImplementedError("the slab decomposition splits grid axis 0 over mesh axis 'x'")
    return mesh


def checkpoint_spec(mesh: Mesh):
    """(rows this process saves, rows in all): one row, the rank's slab."""
    return (mesh.rank,), mesh.size
