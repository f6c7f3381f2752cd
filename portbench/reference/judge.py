"""The comparison that decides a run's `correct`.

The program's answers are judged step by step from the state each step
started from, which for every step but the first is the program's own: the
reference cannot follow a trajectory of inexact Newton solves on its own,
since any two solvers that stop at HOT's tolerance part by up to that
tolerance. The first step starts from the inputs the benchmark made. Each
step's record holds what the timed path produced: the grid node positions
and velocities after P2G (v*, before the boundary conditions), the solved
grid velocities, and the particles after G2P. Three numbers are compared:

* ``p2g``: the largest gap between the program's v* and the reference's,
  at the program's nodes, in cells per step (|dv| dt / dx); infinite if a
  node with mass is missing from the program's grid;
* ``cn``: the largest characteristic norm, over the steps, of the
  reference's residual at the program's solved velocities; the
  configuration's Newton tolerance (``solver.cn_eps``) is its limit;
* ``g2p``: the largest gap between the program's particles and the
  reference's G2P of the program's solved velocities: positions in cells,
  velocities in cells per step, C and F as strains (|dC| dt, |dF|).

The reference runs in float64, one step at a time, over whole particle
arrays (a 400,554-particle step needs about 2 GB).
"""

from __future__ import annotations

import math

import torch

from portbench.reference import mpm

FIELDS = ("x", "v", "Cf", "Ff")


def _gap(a, b):
    d = (a - b).abs()
    d = torch.nan_to_num(d, nan=math.inf, posinf=math.inf)
    return float(d.max()) if d.numel() else 0.0


def _grid_ids(sc: mpm.Scene, node_pos):
    """Dense ids of the program's nodes inside the domain, and which of its
    rows they are (compact grids carry a dump row far outside)."""
    c = torch.round(node_pos / sc.dx)
    inside = torch.all((c >= 0) & (c <= sc.res - 1), dim=-1)
    c = c[inside].long()
    return (c[:, 0] * sc.res + c[:, 1]) * sc.res + c[:, 2], inside


def judge_step(sc: mpm.Scene, state: dict, rec: dict, device):
    """(p2g, cn, g2p) of one step from `state` (x, v, Cf, Ff) to rec's."""
    f64 = torch.float64
    ar = mpm.Arith(f64)
    dt = float(rec["dt"])
    s = {k: state[k].to(device=device, dtype=f64) for k in FIELDS}
    n = s["x"].shape[0]
    C, F = s["Cf"].reshape(n, 3, 3), s["Ff"].reshape(n, 3, 3)
    st = mpm.stencil(s["x"], sc.dx, sc.res)
    mass, v_star = mpm.p2g(sc, st, s["v"], C, dt, ar)

    ids, inside = _grid_ids(sc, rec["node_pos"].to(device=device, dtype=f64))
    have = torch.zeros(sc.n_nodes, dtype=torch.bool, device=device)
    have[ids] = True
    missing = int(((mass > 0) & ~have).sum())
    p2g = math.inf if missing else _gap(
        rec["v_star"].to(device=device, dtype=f64)[inside], v_star[ids]) * dt / sc.dx

    v_grid = torch.zeros((sc.n_nodes, 3), dtype=f64, device=device)
    v_grid[ids] = rec["v_new"].to(device=device, dtype=f64)[inside]
    act = torch.nonzero(mass > 0).squeeze(-1)
    fixed_a, v_bc_a = mpm.boundary(sc, mpm.node_positions(sc, act, f64))
    fixed = torch.zeros(sc.n_nodes, dtype=torch.bool, device=device)
    fixed[act] = fixed_a
    v_bc = torch.zeros((sc.n_nodes, 3), dtype=f64, device=device)
    v_bc[act] = v_bc_a
    r = mpm.residual(sc, st, F, mass, v_star, fixed, v_bc, v_grid, dt, ar)
    cn = float(mpm.cn_norm(r, mpm.cn_scale(sc, st, mass, dt), mass))
    if not math.isfinite(cn):
        cn = math.inf

    x, v, Cn, Fn = mpm.g2p(sc, st, s["x"], F, v_grid, dt, ar)
    out = {k: rec["out"][k].to(device=device, dtype=f64) for k in FIELDS}
    g2p = max(_gap(out["x"], x) / sc.dx, _gap(out["v"], v) * dt / sc.dx,
              _gap(out["Cf"].reshape(n, 3, 3), Cn) * dt, _gap(out["Ff"].reshape(n, 3, 3), Fn))
    return p2g, cn, g2p


def judge(sc: mpm.Scene, start: dict, records, expected: int, device) -> dict:
    """The numbers of a chain of steps from `start`: the largest of each
    over the steps, and the answers that never came."""
    worst = {"p2g": 0.0, "cn": 0.0, "g2p": 0.0}
    per_step = []
    state = start
    for rec in records:
        p2g, cn, g2p = judge_step(sc, state, rec, device)
        per_step.append({"p2g": p2g, "cn": cn, "g2p": g2p})
        for k, val in (("p2g", p2g), ("cn", cn), ("g2p", g2p)):
            worst[k] = max(worst[k], val) if math.isfinite(val) else math.inf
        state = rec["out"]
    worst["missing"] = expected - len(records)
    return {"numbers": worst, "per_step": per_step}


def verdict(numbers: dict, limits: dict) -> dict:
    """Each number beside its limit, and whether all hold (a NaN fails)."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": bool(ok), "checks": checks}
