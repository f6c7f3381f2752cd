"""The port's multigrid preconditioner (solver.multigrid) against
hot_tpu.solver.multigrid, on the same particles and the same per-particle
Hessian context (fp64, CPU: the plain kernel versions).

  * restriction and prolongation are adjoint;
  * one V-cycle (build_static -> build_precond -> mg_precondition) on a
    block_drop_2d 32^2 system with a constrained band, for assembled
    Galerkin levels (Chebyshev + direct, colored GS + CG), assembled
    quadrature levels (Jacobi + direct), and matrix-free quadrature levels
    (Chebyshev + smoother): output within 1e-9 of hot_tpu's, relative
    to its largest entry. hot_tpu's assembled levels are tile-row, the
    port's compressed rows: the operators are the same;
  * the fp32 fringe-node regression: a particle of mass 1e-20 at the
    fringe gives a finite, floored fp32 V-cycle, and fp64 MG-PCG on that
    system takes the same iterates with the floor as without it;
  * whole steps of the 16^3 twisting bar under config 3 (assembled Galerkin,
    Chebyshev, direct; levels=3) and under lagged RAP refresh: hot_tpu's
    Newton and CG counts per step, positions within 1e-9;
  * Newton's partial preconditioner refresh against hot_tpu's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.ops import transfer as jtr
from hot_tpu.scenes import build_scene as jbuild
from hot_tpu.sim import Simulation as JSimulation
from hot_tpu.sim import objective as jobj
from hot_tpu.solver import multigrid as jmg
from hot_tpu.solver.newton import newton_solve as j_newton
from hot_tpu.utils.config import MultigridConfig as JMGConfig
from hot_tpu.utils.config import config_from_overrides as j_overrides
from hot_tpu_torch.ops import transfer as ttr
from hot_tpu_torch.ops.fused_apply import soa
from hot_tpu_torch.scenes import build_scene as tbuild
from hot_tpu_torch.sim import Simulation as TSimulation
from hot_tpu_torch.sim import objective as tobj
from hot_tpu_torch.solver import multigrid as tmg
from hot_tpu_torch.solver.cg import cg_solve as t_cg
from hot_tpu_torch.solver.newton import newton_solve as t_newton
from hot_tpu_torch.utils.config import MultigridConfig as TMGConfig
from hot_tpu_torch.utils.config import config_from_overrides as t_overrides

from test_torch_ref import assert_close, carry_state, t2n
from test_torch_solver import _newton_problem

DT = 2e-3
LEVELS = 3
CONFIG3 = {"solver.preconditioner": "multigrid", "solver.multigrid.levels": LEVELS,
           "solver.multigrid.smoother": "chebyshev", "solver.multigrid.coarse_solver": "direct",
           "solver.multigrid.assembled": True}


def torch_hess(jctx):
    """hot_tpu's per-particle context as the port's SoA HessianState."""
    return tobj.HessianState(*(soa(torch.from_numpy(np.array(t))) for t in jctx))


def mg_system(fringe=False, seed=0):
    """A block_drop_2d 32^2 system (F perturbed, nodes of the lowest block
    rows constrained) as numpy arrays, and hot_tpu's Hessian context.
    fringe: add one particle of mass 1e-20 a cell and a half off the block."""
    scene = jbuild("block_drop_2d", res=32, E=1e6, dtype=jnp.float64)
    cfg, js, model = scene["cfg"], scene["state"], scene["model"]
    rng = np.random.default_rng(seed)
    arr = {f: np.asarray(getattr(js, f)) for f in ("x", "m", "V0", "mu", "lam", "F")}
    arr["F"] = arr["F"] + 0.02 * rng.standard_normal(arr["F"].shape)
    if fringe:
        i = int(np.argmax(arr["x"][:, 0]))
        new = {"x": arr["x"][i] + np.array([1.5 * cfg.dx, 0.0]), "m": 1e-20,
               "V0": 1e-20 * arr["V0"][i] / arr["m"][i], "mu": arr["mu"][i],
               "lam": arr["lam"][i], "F": np.eye(2)}
        arr = {f: np.concatenate([a, np.asarray(new[f])[None]]) for f, a in arr.items()}
    res = tuple(cfg.grid_res[:2])
    n_nodes = jtr.n_nodes_of(res)
    ymin = arr["x"][:, 1].min()
    node_y = np.asarray(jtr.node_positions(res, cfg.dx))[:, 1]
    cons = node_y < ymin + 2.0 * cfg.dx

    @jax.jit
    def linearize(x, m, V0, mu, lam, F):
        st = jtr.particle_stencil(x, cfg.dx, res)
        gm = jtr.scatter_sum(st.node_ids, st.wn * m[:, None], n_nodes)
        obj = jobj.make_objective(model, st, F, V0, mu, lam, gm, jnp.zeros((n_nodes, 2)),
                                  jnp.broadcast_to(jnp.eye(2), (n_nodes, 2, 2)), DT, cfg.dx)
        return jobj.build_hessian(model, obj, jnp.zeros((n_nodes, 2))).ctx, gm

    jctx, gm = linearize(*(jnp.asarray(arr[f]) for f in ("x", "m", "V0", "mu", "lam", "F")))
    free = (np.asarray(gm) > 0) & ~cons
    r = np.where(free[:, None], rng.standard_normal((n_nodes, 2)), 0.0)
    return dict(arr=arr, jctx=jctx, cons=cons, res=res, dx=cfg.dx, r=r, model=model,
                gm=np.asarray(gm), n_nodes=n_nodes)


def jax_vcycle(sys_, mcfg, assembled):
    arr, res, dx = sys_["arr"], sys_["res"], sys_["dx"]
    caps = dict(bin_caps=(2048, 16), mg_tile_caps=(96, 48, 24)) if assembled else {}

    @jax.jit
    def run(x, m, F, V0, jctx, cons, r):
        mgs = jmg.build_static(x, m, res, dx, LEVELS, cons, jnp.float64, **caps)
        pre = jmg.build_precond(mgs, F, jctx, V0, DT, mcfg, 2)
        overflow = mgs.overflow if mgs.overflow is not None else jnp.zeros((), bool)
        return jmg.mg_precondition(mgs, pre, F, V0, DT, mcfg, r), overflow

    z, overflow = run(*(jnp.asarray(arr[f]) for f in ("x", "m", "F", "V0")), sys_["jctx"],
                      jnp.asarray(sys_["cons"]), jnp.asarray(sys_["r"]))
    assert not bool(overflow)
    return np.asarray(z)


def torch_vcycle(sys_, mcfg, assembled_from, dtype=torch.float64):
    a = {f: torch.as_tensor(np.array(v), dtype=dtype) for f, v in sys_["arr"].items()}
    mgs = tmg.build_static(a["x"], a["m"], sys_["res"], sys_["dx"], LEVELS,
                           torch.from_numpy(sys_["cons"]), dtype, assembled_from=assembled_from)
    hess = tobj.HessianState(*(t.to(dtype) for t in torch_hess(sys_["jctx"])))
    pre = tmg.build_precond(mgs, a["F"], hess, a["V0"], DT, mcfg, 2)
    return tmg.mg_precondition(mgs, pre, DT, mcfg, torch.as_tensor(sys_["r"], dtype=dtype))


def test_restrict_prolong_are_adjoint(rng):
    x = torch.from_numpy(rng.uniform(0.3, 0.7, (200, 2)))
    mgs = tmg.build_static(x, torch.ones(200, dtype=torch.float64), (32, 32), 1 / 32, 2,
                           torch.zeros(1024, dtype=torch.bool), torch.float64)
    embed = mgs.embeds[0]
    r = torch.from_numpy(rng.standard_normal((1024, 2)))
    e = torch.from_numpy(rng.standard_normal((256, 2)))
    lhs = torch.sum(tmg.restrict(embed, r, 256) * e)
    rhs = torch.sum(r * tmg.prolong(embed, e))
    assert abs(float(lhs - rhs)) <= 1e-12 * float(torch.abs(r).sum() * torch.abs(e).max())
    # the embedding weights of every fine node sum to one inside the domain
    inside = embed.node_ids.min(1).values > 0
    np.testing.assert_allclose(t2n(embed.wn.sum(1)[inside]), 1.0, rtol=0, atol=1e-12)


VCYCLES = {
    "galerkin_chebyshev_direct": (dict(coarse_solver="direct", assembled=True), 0),
    "galerkin_coloredgs_cg": (dict(smoother="colored_gs", coarse_solver="cg",
                                   assembled=True), 0),
    "quadrature_assembled_jacobi_direct": (dict(smoother="jacobi", coarse_solver="direct",
                                                assembled=True, coarsening="quadrature"), 0),
    "matrixfree_chebyshev_smoother": (dict(coarse_solver="smoother"), None),
}


@pytest.mark.parametrize("case", sorted(VCYCLES))
def test_vcycle_matches_hot_tpu(case):
    kw, assembled_from = VCYCLES[case]
    sys_ = mg_system()
    want = jax_vcycle(sys_, JMGConfig(levels=LEVELS, **kw), assembled_from is not None)
    got = torch_vcycle(sys_, TMGConfig(levels=LEVELS, **kw), assembled_from)
    assert np.abs(want).max() > 0
    assert_close(got, want, 1e-9, scale=float(np.abs(want).max()))


@pytest.mark.parametrize("level", [1, 2])
def test_matrix_free_level_multiply_matches_hot_tpu(level):
    """The matrix-free coarse-level operator (the fused apply's plain
    version at the level's dx and res, built from x) == hot_tpu's
    level_multiply on its own coarse stencil."""
    sys_ = mg_system()
    arr, res, dx = sys_["arr"], sys_["res"], sys_["dx"]
    w_c = np.random.default_rng(1).standard_normal(
        (jtr.n_nodes_of(tmg.coarse_res(tmg.coarse_res(res)) if level == 2
                        else tmg.coarse_res(res)), 2))

    @jax.jit
    def run(x, m, F, V0, jctx, cons, w):
        mgs = jmg.build_static(x, m, res, dx, LEVELS, cons, jnp.float64)
        return jmg.level_multiply(mgs.levels[level], F, jctx, V0, DT, w)

    want = np.asarray(run(*(jnp.asarray(arr[f]) for f in ("x", "m", "F", "V0")),
                          sys_["jctx"], jnp.asarray(sys_["cons"]), jnp.asarray(w_c)))
    a = {f: torch.from_numpy(np.array(v)) for f, v in arr.items()}
    mgs = tmg.build_static(a["x"], a["m"], res, dx, LEVELS, torch.from_numpy(sys_["cons"]),
                           torch.float64)
    lv = mgs.levels[level]
    assert lv.x_soa is not None and lv.dx == dx * 2 ** level
    pre = tmg.MGPrecond(diag_inv=(), lmax=(), hess=torch_hess(sys_["jctx"]), F_soa=soa(a["F"]),
                        V0=a["V0"])
    got = tmg.level_multiply(lv, pre, DT, torch.from_numpy(w_c))
    assert_close(got, want, 1e-10, scale=float(np.abs(want).max()))


def test_fp32_fringe_node_vcycle_is_finite_and_f64_counts_hold(monkeypatch):
    sys_ = mg_system(fringe=True)
    assert sys_["gm"][sys_["gm"] > 0].min() < 1e-19
    mcfg = TMGConfig(levels=LEVELS)
    z32 = torch_vcycle(sys_, mcfg, None, dtype=torch.float32)
    assert bool(torch.isfinite(z32).all())
    # unfloored (fp64) the fringe rows of D^-1 reach ~1e21; the fp32 floor
    # bounds them at 1e10 / max diagonal
    assert float(torch_vcycle(sys_, mcfg, None).abs().max()) > 1e20
    assert float(z32.abs().max()) < 1e12

    # fp64 MG-PCG on H z = r to Newton's CG tolerance: the same iterates
    # with the floor as without it (it is fp32-only)
    arr, res, dx, n_nodes = sys_["arr"], sys_["res"], sys_["dx"], sys_["n_nodes"]
    a = {f: torch.from_numpy(np.array(v)) for f, v in arr.items()}
    st = ttr.particle_stencil(a["x"], dx, res)
    gm = ttr.scatter_sum(st.node_ids, st.wn * a["m"][:, None], n_nodes)
    cons = torch.from_numpy(sys_["cons"])
    proj = torch.where(cons[:, None, None], torch.zeros(()), torch.eye(2, dtype=torch.float64))
    obj = tobj.make_objective(sys_["model"], st, a["F"], a["V0"], a["mu"], a["lam"], gm,
                              torch.zeros((n_nodes, 2), dtype=torch.float64), proj, DT, dx,
                              a["x"], res)
    hess = torch_hess(sys_["jctx"])

    def solve():
        mgs = tmg.build_static(a["x"], a["m"], res, dx, LEVELS, cons, torch.float64)
        pre = tmg.build_precond(mgs, a["F"], hess, a["V0"], DT, mcfg, 2)
        return t_cg(lambda w: tobj.multiply(obj, hess, w), torch.from_numpy(sys_["r"]),
                    precondition=lambda q: tmg.mg_precondition(mgs, pre, DT, mcfg, q),
                    project=lambda q: tobj.project(obj, q), tol=1e-3, max_iters=100)

    floored = solve()
    monkeypatch.setattr(tmg, "_floor_fp32_diag", lambda D: D)
    plain = solve()
    assert floored.converged and floored.iters == plain.iters > 1
    assert torch.equal(floored.x, plain.x)


def _bar_steps(overrides, steps, dt=8e-3):
    scene = jbuild("twisting_bar_3d", res=16, ppc=2, dtype=jnp.float64)
    tscene = tbuild("twisting_bar_3d", device="cpu", res=16, ppc=2, dtype=torch.float64)
    jsim = JSimulation(j_overrides(scene["cfg"], overrides), scene["state"], scene["model"],
                       scene["colliders"])
    tsim = TSimulation(t_overrides(tscene["cfg"], overrides), carry_state(scene["state"]),
                       tscene["model"], tscene["colliders"])
    counts = []
    for _ in range(steps):
        js, ts = jsim.step(dt), tsim.step(dt)
        counts.append((ts.newton_iters, ts.cg_iters))
        assert counts[-1] == (int(js.newton_iters), int(js.cg_iters))
        assert ts.converged and tsim.retry_count == 0
        np.testing.assert_allclose(t2n(tsim.state.x), np.asarray(jsim.state.x), rtol=0,
                                   atol=1e-9)
    return counts


def test_config3_steps_match_hot_tpu():
    counts = _bar_steps(CONFIG3, 3)
    assert max(n for n, _ in counts) >= 2, counts


def test_lagged_rap_steps_match_hot_tpu():
    counts = _bar_steps(dict(CONFIG3, **{"solver.multigrid.rap_refresh": "lagged"}), 2)
    assert max(n for n, _ in counts) >= 2, counts


def test_newton_partial_refresh_matches_hot_tpu():
    kw = dict(max_newton=30, cn_eps=1e-9, cg_tol=1e-3, max_cg=50)
    jp = _newton_problem(np.random.default_rng(3), jnp, jnp.asarray)
    tp = _newton_problem(np.random.default_rng(3), torch, torch.from_numpy)
    jres = j_newton(**jp, refresh_preconditioner=lambda h, base: 0.5 * (h + base), **kw)
    tres = t_newton(**tp, refresh_preconditioner=lambda h, base: 0.5 * (h + base), **kw)
    assert (tres.iters, tres.cg_iters) == (int(jres.iters), int(jres.cg_iters))
    assert tres.iters > 3 and tres.converged
    assert_close(tres.v, jres.v, 1e-10)
