"""Ranks of the port's sharded tests: spawned by tests/test_torch_parallel.py
and tests/test_torch_sharded_step.py (torch.multiprocessing over gloo,
file:// rendezvous), one torch thread each. This module imports torch and
hot_tpu_torch only: neither jax nor hot_tpu.

``spawn(cases, world, tmp_path)`` runs every case on `world` ranks once
and returns rank 0's results; ``start`` starts the ranks and returns them
(`Ranks`) without waiting, so the caller can work while they run. A case
is (name, world size of its mesh, kwargs); the ranks beyond a case's world
size sit it out (its mesh is a subgroup of the first ranks). The ranks
have `DEADLINE` seconds: past it they are killed and `join` raises, so a
hung rank fails its test instead of holding the run to its clock.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

F64 = torch.float64
# seconds a spawn's ranks may take: several times the slowest file's
# (tests/test_torch_sharded_step.py's 15 cases, about 80 s on one core)
DEADLINE = 600.0


def _mesh(world: int, groups):
    from hot_tpu_torch.parallel.mesh import Mesh, make_mesh

    if world == 1:
        return Mesh(size=1, rank=0)
    return make_mesh(groups[world])


def _scene(name, fields=None, over=None, **kw):
    from hot_tpu_torch.scenes import build_scene
    from hot_tpu_torch.sim.state import state_from_numpy
    from hot_tpu_torch.utils.config import config_from_overrides

    scene = build_scene(name, device="cpu", dtype=F64, **kw)
    cfg = config_from_overrides(scene["cfg"], over or {})
    state = scene["state"] if fields is None else state_from_numpy(fields, "cpu", F64)
    return scene, cfg, state


def case_halo(mesh, a, b, width):
    """exchange_halo of this rank's planes of a and fold_halo of its
    extended block of b (a: (D, P, W), b: (D, P + 2 width, W), hot_tpu's
    blocks with zero ghosts beyond the grid)."""
    from hot_tpu_torch.parallel import halo

    r = mesh.rank
    lo = width if r > 0 else 0
    hi = width if r < mesh.size - 1 else 0
    P = a.shape[1]
    ext = halo.exchange_halo(torch.from_numpy(a[r]), mesh, lo, hi)
    ext = torch.cat([ext.new_zeros((width - lo,) + ext.shape[1:]), ext,
                     ext.new_zeros((width - hi,) + ext.shape[1:])])
    b_r = torch.from_numpy(b[r][width - lo:width + P + hi])
    folded = halo.fold_halo(b_r, mesh, lo, hi)
    lhs = halo.all_reduce_sum(torch.sum(ext * torch.from_numpy(b[r])), mesh)
    rhs = halo.all_reduce_sum(torch.sum(torch.from_numpy(a[r]) * folded), mesh)
    return dict(ext=halo.all_gather(ext, mesh).numpy(), fold=halo.all_gather(folded, mesh).numpy(),
                lhs=float(lhs), rhs=float(rhs))


def case_cg(mesh, sys_np, tol):
    """sharded_cg_solve of a global system given as numpy (hot_tpu's
    particles, Hessian context, grid arrays and right-hand side)."""
    from hot_tpu_torch.ops.fused_apply import soa
    from hot_tpu_torch.parallel import halo, sharded
    from hot_tpu_torch.sim.objective import HessianState

    t = {k: torch.from_numpy(v) for k, v in sys_np.items() if isinstance(v, np.ndarray)}
    hess = HessianState(U=soa(t["U"]), V=soa(t["V"]), A=soa(t["A"]),
                        b_plus=t["b_plus"].T.contiguous(), b_minus=t["b_minus"].T.contiguous())
    system = sharded.partition_system(t["x"], t["F"], hess, t["V0"], t["gm"], t["gm"] > 0,
                                      t["proj"], sys_np["dt"], sys_np["dx"], sys_np["res"], mesh)
    n = system.slab.n_owned
    b = t["b"][mesh.rank * n:(mesh.rank + 1) * n]
    res_cg = sharded.sharded_cg_solve(system, b, mesh, tol=tol)
    return dict(x=halo.all_gather(res_cg.x, mesh).reshape(-1, b.shape[-1]).numpy(),
                iters=res_cg.iters)


def case_steps(mesh, scene, fields=None, over=None, steps=3, dt=2e-3, drift=None, kw=None,
               checkpoint=None):
    """`steps` sharded steps (ShardedSimulation) from the scene's state or
    the given fields: per-step counts, the final state in id order, the
    particles migrated; with `checkpoint`, the state saved there after the
    steps (hot_tpu's layout) and one more step after a restore."""
    from hot_tpu_torch.parallel.sharded_step import ShardedSimulation

    sc, cfg, state = _scene(scene, fields, over, **(kw or {}))
    if drift is not None:
        state = state.replace(v=state.v + torch.tensor(drift, dtype=F64))
    sim = ShardedSimulation(mesh, cfg, state, sc["model"], sc["colliders"],
                            plasticity=sc["plasticity"])
    counts = []
    for _ in range(steps):
        s = sim.step(dt)
        counts.append((s.newton_iters, s.cg_iters))
    out = dict(counts=counts, migrated=sim.migrated, state=sim.state.to_numpy(), t=sim.t,
               ranks_particles=[int(c) for c in _counts(sim, mesh)])
    if checkpoint is not None:
        sim.save_checkpoint(checkpoint)
        sim.step(dt)
        after = sim.state.to_numpy()
        sim2 = ShardedSimulation(mesh, cfg, state, sc["model"], sc["colliders"],
                                 plasticity=sc["plasticity"])
        sim2.restore(checkpoint)
        sim2.step(dt)
        out.update(after=after, resumed=sim2.state.to_numpy())
    return out


def _counts(sim, mesh):
    from hot_tpu_torch.parallel import halo

    return halo.all_gather(torch.tensor([sim.ps.n]), mesh).reshape(-1).tolist()


def case_cli(mesh, argv):
    from hot_tpu_torch.cli import main

    return dict(rc=main(argv))


def case_sleep(mesh, seconds):
    """A rank that outlives the deadline (the test of spawn's deadline)."""
    time.sleep(seconds)
    return {}


CASES = {"halo": case_halo, "cg": case_cg, "steps": case_steps, "cli": case_cli,
         "sleep": case_sleep}


def _rank(rank, world, init, cases_path, out, deadline):
    torch.set_num_threads(1)
    with open(cases_path, "rb") as fh:
        cases = pickle.load(fh)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=deadline))
    sizes = sorted({w for _, w, _ in cases if w > 1})
    groups = {w: (dist.group.WORLD if w == world else dist.new_group(list(range(w))))
              for w in sizes}
    results = []
    for name, w, kw in cases:
        if rank < w:
            results.append(CASES[name](_mesh(w, groups), **kw))
        else:
            results.append(None)
        dist.barrier()
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump(results, fh)
    dist.destroy_process_group()


class Ranks:
    """Ranks started by `start`. `join` waits for them and returns rank 0's
    results in the cases' order (waiting once); `close` kills any rank still
    running."""

    def __init__(self, ctx, out: str, world: int, deadline: float):
        self._ctx, self._out, self._world, self._deadline = ctx, out, world, deadline
        self._end = time.monotonic() + deadline
        self._results = None

    def join(self):
        if self._results is None:
            self._results = self._wait()
        return self._results

    def _wait(self):
        ctx = self._ctx
        while not ctx.join(timeout=max(0.0, self._end - time.monotonic())):
            if time.monotonic() >= self._end:
                self.close()
                raise TimeoutError(f"{self._world} ranks still running after "
                                   f"{self._deadline} s, killed; exit codes "
                                   f"{[p.exitcode for p in ctx.processes]}")
        with open(self._out, "rb") as fh:
            return pickle.load(fh)

    def close(self):
        for p in self._ctx.processes:
            if p.is_alive():
                p.kill()
        for p in self._ctx.processes:
            p.join()


def start(cases, world: int, tmp_path, deadline: float = DEADLINE) -> Ranks:
    """Start `cases` on `world` gloo ranks and return them (see `Ranks`).

    The cases go to the ranks through a file: as a spawn argument they
    would fill the pipe to each new process, and the start would wait for
    each rank's interpreter in turn (seconds each) instead of starting all
    at once."""
    out = os.path.join(str(tmp_path), "results.pkl")
    cases_path = os.path.join(str(tmp_path), "cases.pkl")
    with open(cases_path, "wb") as fh:
        pickle.dump(cases, fh)
    init = f"file://{tmp_path}/rendezvous"
    ctx = mp.start_processes(_rank, args=(world, init, cases_path, out, deadline),
                             nprocs=world, join=False)
    return Ranks(ctx, out, world, deadline)


def spawn(cases, world: int, tmp_path, deadline: float = DEADLINE):
    """Run `cases` on `world` gloo ranks; rank 0's results, in order.

    A rank that fails fails the call (torch's ProcessContext.join stops the
    others). Ranks still running `deadline` seconds after the start are
    killed, and TimeoutError gives each rank's exit code."""
    return start(cases, world, tmp_path, deadline).join()
