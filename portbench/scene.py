"""A cell's inputs, made from the seed on the device, and the program's
objects built from them.

The scene recipe of a configuration file (``configs/<name>.json``, key
``scene``) gives a box of particles on a jittered lattice (a copy of the
port's sampler, ``hot_tpu_torch/sim/seeding.py:19``, with the scene's own
fixed jitter seed; the run's seed draws the particles' order, see
``particles``), one material and the colliders. The particles go to the program as
its ``ParticleState``; the colliders as its ``AxisBox`` objects; the
configuration as its ``SimConfig`` with the file's dotted overrides.
``particles`` needs nothing of the program (the control uses it alone).
"""

from __future__ import annotations

import numpy as np
import torch


def lattice(lo, hi, dx: float, ppc: int):
    """(sub-cell centres (n, d) float64, sub-cell sizes (d,)): each dx-cell
    of the box cut into per-axis sub-cells whose counts factor ppc
    greedily."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    dim = lo.shape[0]
    k_axes, rem = [], max(int(ppc), 1)
    for i in range(dim):
        k = int(np.ceil(rem ** (1.0 / (dim - i))))
        k_axes.append(k)
        rem = max(1, rem // k)
    sub_dx = dx / np.asarray(k_axes)
    counts = np.maximum(((hi - lo) / sub_dx).round().astype(int), 1)
    axes = [np.arange(c) * sub_dx[i] + lo[i] + 0.5 * sub_dx[i] for i, c in enumerate(counts)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=-1), sub_dx


def sample_box(seed: int, lo, hi, dx: float, ppc: int, dtype, device):
    """Jittered lattice samples of [lo, hi] (up to 0.45 sub-cell per axis),
    the jitter drawn from `seed` by a CPU generator, as the port's scene
    builders draw it: (x (n, d) on `device`, volume)."""
    centres, sub_dx = lattice(lo, hi, dx, ppc)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    u = torch.rand(centres.shape, generator=gen, dtype=torch.float32)
    jitter = (u * 0.9 - 0.45) * torch.as_tensor(sub_dx, dtype=torch.float32)
    x = torch.as_tensor(centres, dtype=dtype, device=device) + jitter.to(device, dtype)
    return x, float(np.prod(sub_dx))


def particles(config: dict, seed: int, device):
    """The cell's particles (x (n, d), volume): the scene's box at the
    configuration's fixed jitter seed, in an order drawn from the run's
    seed: shuffled within each run of ``order_group`` consecutive lattice
    samples (a row of sub-cells), so that every seed gives the same
    particles, the same work and the same memory locality, and only the
    order of the sums differs."""
    sc = config["scene"]
    dtype = getattr(torch, config["dtype"])
    x, vol = sample_box(sc["jitter_seed"], sc["lo"], sc["hi"], 1.0 / sc["res"], sc["ppc"],
                        dtype, device)
    n = x.shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    group = torch.arange(n, device=device, dtype=torch.float64) // sc["order_group"]
    keys = group * 2.0 + torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    return x[torch.argsort(keys)].contiguous(), vol


def lame(E: float, nu: float):
    """(mu, lambda) of Young's modulus E and Poisson's ratio nu."""
    return E / (2.0 * (1.0 + nu)), E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))


def _spin(axis: int, sign: float, omega: float, center):
    def motion(t):
        f64 = torch.float64
        w = torch.zeros(3, dtype=f64)
        w[axis] = sign * omega
        return torch.zeros(3, dtype=f64), w, torch.tensor(center, dtype=f64)

    return motion


def build(config: dict, traffic: dict, seed: int, device):
    """(cfg, state, model, colliders, material): the program's objects for
    one run, the state a batch when the mix has several members, and the
    material arrays (m, V0, mu, lam; a leading member dimension for a
    batch) the reference is handed."""
    from hot_tpu_torch.models.constitutive import MODEL_REGISTRY
    from hot_tpu_torch.sim.collision import AxisBox
    from hot_tpu_torch.sim.state import ParticleState, stack_states
    from hot_tpu_torch.utils.config import SimConfig, config_from_overrides

    sc = config["scene"]
    if sc["recipe"] != "box":
        raise ValueError(f"unknown scene recipe {sc['recipe']!r}")
    dtype = getattr(torch, config["dtype"])
    res = int(sc["res"])
    cfg = SimConfig(dim=3, dx=1.0 / res, grid_res=(res,) * 3, gravity=tuple(sc["gravity"]),
                    dtype=config["dtype"])
    cfg = config_from_overrides(cfg, config.get("overrides", {}))
    x, vol = particles(config, seed, device)
    n = x.shape[0]

    def member(E):
        mu, lam = lame(E, sc["nu"])
        full = lambda value: torch.full((n,), value, dtype=dtype, device=device)  # noqa: E731
        eye = torch.eye(3, dtype=dtype, device=device).reshape(1, 9)
        return ParticleState(x=x.clone(), v=torch.zeros_like(x),
                             Cf=torch.zeros((n, 9), dtype=dtype, device=device),
                             Ff=eye.expand(n, 9).clone(), m=full(sc["density"] * vol),
                             V0=full(vol), mu=full(mu), lam=full(lam),
                             yield_stress=full(float("inf")), Jp=full(1.0))

    members = [member(m.get("E", sc["E"])) for m in traffic["members"]]
    state = members[0] if len(members) == 1 else stack_states(members)
    colliders = tuple(
        AxisBox(kind=c["kind"], lo=tuple(c["lo"]), hi=tuple(c["hi"]),
                motion=_spin(c["spin_axis"], c["spin_sign"], sc["omega"], sc["center"]))
        for c in sc["colliders"])
    material = {k: getattr(state, k) for k in ("m", "V0", "mu", "lam")}
    return cfg, state, MODEL_REGISTRY[sc["model"]], colliders, material
