"""Cubic B-spline transfers (transfer_kernel="cubic", 4 nodes per axis) in
hot_tpu_torch against hot_tpu, on the same fp64 inputs (CPU: the plain
kernel versions).

  * the cubic weights, weight gradients, tensor weights and the clamped
    stencil: to 1e-14 (the same formulas in the same order);
  * the two kernel modules' plain versions with the cubic stencil: against
    hot_tpu's Pallas kernels in interpret mode (2D; the kernels take any
    stencil size s) and its XLA chains (3D, and the Neo-Hookean and
    linear-corotated linearize, which hot_tpu runs in XLA), to 1e-10;
  * the cubic golden step (tests/test_golden.py's cubic case): one step of
    block_drop_2d at 32^2 from hot_tpu's impact state, against
    tests/reference_mpm.py and hot_tpu: the same Newton count, CG within
    +-1, positions within 1e-10;
  * 3 cubic steps of the 16^3 twisting bar from a stressed state under
    block-Jacobi: hot_tpu's (newton, cg) per step, positions within 1e-9;
  * a cubic matrix-free V-cycle (Chebyshev, smoother coarse solve) within
    1e-9 of hot_tpu's;
  * the operators assembled into the 5-wide quadratic BSR refuse cubic.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.models import constitutive as jcm
from hot_tpu.ops import bspline as jbs
from hot_tpu.ops import pallas_apply, pallas_linearize
from hot_tpu.ops import transfer as jtr
from hot_tpu.sim import Simulation as JSimulation
from hot_tpu.sim import objective as jobj
from hot_tpu.sim.simulation import advance_one_step as j_advance
from hot_tpu.sim.state import ParticleState as JState
from hot_tpu.solver import multigrid as jmg
from hot_tpu.utils.config import MultigridConfig as JMGConfig
from hot_tpu.utils.config import config_from_overrides as j_overrides
from hot_tpu_torch.ops import bspline as tbs
from hot_tpu_torch.ops import fused_apply as tfa
from hot_tpu_torch.ops import fused_linearize as tfl
from hot_tpu_torch.ops import transfer as ttr
from hot_tpu_torch.scenes import build_scene as tbuild
from hot_tpu_torch.scenes import stress_state
from hot_tpu_torch.sim import Simulation as TSimulation
from hot_tpu_torch.sim import objective as tobj
from hot_tpu_torch.sim.simulation import advance_one_step as t_advance
from hot_tpu_torch.sim.state import FIELDS
from hot_tpu_torch.solver import multigrid as tmg
from hot_tpu_torch.utils.config import MultigridConfig as TMGConfig
from hot_tpu_torch.utils.config import config_from_overrides as t_overrides

from reference_mpm import advance_one_step_ref
from test_torch_multigrid import mg_system, torch_hess
from test_torch_ref import (DT, assert_close, carry_state, hot_tpu_scene,  # noqa: F401
                            objective_pair, one_torch_thread, t2n)
from test_torch_step import _impact_state

TOL = 1e-10
SCENES = {2: "block_drop_2d", 3: "twisting_bar_3d"}
CUBIC = {"transfer_kernel": "cubic"}


@pytest.mark.parametrize("d", [2, 3])
def test_cubic_weights_match_hot_tpu(rng, d):
    dx = 1.0 / 24
    x = rng.uniform(3 * dx, 20 * dx, (50, d))
    base, w, dw = jbs.bspline_weights(jnp.asarray(x), dx, "cubic")
    wn, gwn = jbs.tensor_weights(w, dw)
    tbase, tw, tdw = tbs.bspline_weights(torch.from_numpy(x), dx, "cubic")
    twn, tgwn = tbs.tensor_weights(tw, tdw)
    np.testing.assert_array_equal(tbase.numpy(), np.asarray(base))
    for got, want in ((tw, w), (tdw, dw), (twn, wn), (tgwn, gwn)):
        assert_close(got, want, 1e-14)
    u = torch.from_numpy(rng.uniform(1.0, 2.0, 64))
    assert_close(tbs.cubic_kernel_1d(u), jbs.cubic_kernel_1d(jnp.asarray(u.numpy())), 1e-14)
    assert_close(tbs.cubic_kernel_grad_1d(u),
                 jbs.cubic_kernel_grad_1d(jnp.asarray(u.numpy())), 1e-14)
    # partition of unity, and the derivative weights sum to zero
    np.testing.assert_allclose(t2n(tw.sum(-1)), 1.0, rtol=0, atol=1e-14)
    np.testing.assert_allclose(t2n(tdw.sum(-1)), 0.0, rtol=0, atol=1e-12)
    assert (tbs.kernel_width("cubic"), tbs.apic_d_inv_factor("cubic")) == (
        jbs.kernel_width("cubic"), jbs.apic_d_inv_factor("cubic")) == (4, 3.0)
    np.testing.assert_array_equal(tbs.stencil_offsets(d, 4).numpy(),
                                  np.asarray(jbs.stencil_offsets(d, 4)))
    with pytest.raises(ValueError):
        tbs.kernel_width("quartic")


@pytest.mark.parametrize("d", [2, 3])
def test_cubic_stencil_matches_hot_tpu(rng, d):
    """Including particles within a cell of both grid edges, whose cubic
    node coordinates clamp to [0, res - 1]."""
    res, dx = (12,) * d, 1.0 / 12
    x = np.concatenate([rng.uniform(0.2 * dx, 1.0, (60, d)), rng.uniform(0.0, 0.9 * dx, (5, d)),
                        rng.uniform(1.0 - 1.5 * dx, 1.0 - 0.1 * dx, (5, d))])
    jst = jtr.particle_stencil(jnp.asarray(x), dx, res, kernel="cubic")
    tst = ttr.particle_stencil(torch.from_numpy(x), dx, res, kernel="cubic")
    assert tst.node_ids.shape == (x.shape[0], 4 ** d)
    np.testing.assert_array_equal(t2n(tst.node_ids), np.asarray(jst.node_ids))
    for field in ("wn", "gwn", "rel"):
        assert_close(getattr(tst, field), getattr(jst, field), 1e-14)


def _jax_linearize(p, model, v, fused):
    """hot_tpu's objective.linearize: the Pallas kernel in interpret mode
    (fused) or the XLA chain; (f (n_nodes, d) of the residual, ctx)."""
    if fused:
        jo = p.jo
        vi = jtr.gather(jnp.asarray(v), jo.stencil.node_ids)
        contrib, U, V, A, bp, bm = pallas_linearize.fused_linearize(
            vi, jo.stencil.gwn, jo.F_n, jo.mu, jo.lam, jo.V0, DT, model_name=model.name,
            interpret=True)
        return jtr.scatter_sum(jo.stencil.node_ids, contrib, v.shape[0]), (A, bp, bm)
    r, hess = jax.jit(lambda vv: jobj.linearize(model, p.jo, vv))(jnp.asarray(v))
    return r, (hess.ctx.A, hess.ctx.b_plus, hess.ctx.b_minus)


@pytest.mark.parametrize("model_name,d", [("fixed_corotated", 2), ("stvk_hencky", 2),
                                          ("neo_hookean", 2), ("neo_hookean", 3),
                                          ("linear_corotated", 3)])
def test_cubic_fused_linearize_plain_matches_hot_tpu(rng, model_name, d):
    """The plain linearize with the cubic stencil: force against the Pallas
    kernel (2D, the two models it has) or the residual of the XLA chain,
    and A, b+- of the Hessian context."""
    p = objective_pair(SCENES[d], rng, model_name, kernel="cubic")
    to, v = p.to, p.v
    pallas = d == 2 and model_name in pallas_linearize._MODEL_DERIVS
    got = tfl.fused_linearize(torch.from_numpy(v), to.x_soa, to.dx, to.res, to.F_soa, to.mu,
                              to.lam, to.V0, DT, p.tmodel, kernel="cubic")
    want, (A, bp, bm) = _jax_linearize(p, p.jmodel, v, pallas)
    if pallas:
        assert_close(got[0], want, TOL)
    else:
        # the XLA chain returns the residual M (v - v*) - dt f, projected
        r = tobj.project(to, to.grid_m[:, None] * (torch.from_numpy(v) - to.v_star)
                         - to.dt * got[0])
        assert_close(r, want, TOL)
    assert_close(t2n(got[3]).T.reshape(-1, d, d), A, TOL)
    assert_close(t2n(got[4]).T, bp, TOL)
    assert_close(t2n(got[5]).T, bm, TOL)


@pytest.mark.parametrize("d", [2, 3])
def test_cubic_fused_apply_plain_matches_hot_tpu(rng, d):
    """The plain apply with the cubic stencil == Pallas fused_contrib +
    scatter in interpret mode (2D) or hot_tpu's XLA apply (3D)."""
    p = objective_pair(SCENES[d], rng, kernel="cubic")
    jo, to = p.jo, p.to
    _, th = tobj.linearize(p.tmodel, to, torch.from_numpy(p.v))
    jctx = jcm.HessianContext(*(jnp.asarray(t2n(t)) for t in th.context(d)))
    w = rng.standard_normal(p.v.shape)
    if d == 2:
        vi = jtr.gather(jnp.asarray(w), jo.stencil.node_ids)
        contrib = pallas_apply.fused_contrib(vi, jo.stencil.gwn, jo.F_n, jctx.U, jctx.V,
                                             jctx.A, jctx.b_plus, jctx.b_minus, jo.V0, DT,
                                             interpret=True)
        want = jtr.scatter_sum(jo.stencil.node_ids, contrib, w.shape[0])
        got = tfa.fused_apply(torch.from_numpy(w), to.x_soa, to.dx, to.res, to.F_soa, th.U,
                              th.V, th.A, th.b_plus, th.b_minus, to.V0, DT, kernel="cubic")
    else:
        want = jobj.elastic_hessian_apply(jo.stencil, jo.F_n, jctx, jo.V0, DT, jo.grid_m,
                                          jo.active, jnp.asarray(w))
        got = tobj.multiply(to, th, torch.from_numpy(w))
    assert_close(got, want, TOL)


def test_cubic_golden_block_drop_matches_hot_tpu_and_reference():
    res, dt = 32, 4e-3
    scene = hot_tpu_scene("block_drop_2d", res=res, dtype=jnp.float64)
    cfg = dataclasses.replace(scene["cfg"], transfer_kernel="cubic", solver=dataclasses.replace(
        scene["cfg"].solver, preconditioner="jacobi"))
    scene["cfg"] = cfg
    js = _impact_state(scene, dt)

    step = jax.jit(functools.partial(j_advance, cfg=cfg, model=scene["model"],
                                     colliders=scene["colliders"], plasticity=None))
    j_new, j_stats = step(js, jnp.float64(dt), jnp.float64(0.0))
    ref = advance_one_step_ref(
        np.asarray(js.x), np.asarray(js.v), np.asarray(js.C), np.asarray(js.F),
        np.asarray(js.m), np.asarray(js.V0), np.asarray(js.mu), np.asarray(js.lam),
        dx=cfg.dx, res=cfg.grid_res[:2], dt=dt, gravity=cfg.gravity[:2], floor_y=0.15,
        cn_eps=cfg.solver.cn_eps, cg_tol=cfg.solver.cg_tol,
        max_newton=cfg.solver.max_newton, max_cg=cfg.solver.max_cg, kernel="cubic")

    tscene = tbuild("block_drop_2d", device="cpu", res=res, dtype=torch.float64)
    t_new, t_stats = t_advance(carry_state(js), dt, 0.0, cfg=cfg, model=tscene["model"],
                               colliders=tscene["colliders"])

    assert t_stats.newton_iters == ref.newton_iters == int(j_stats.newton_iters) >= 2
    assert abs(t_stats.cg_iters - sum(ref.cg_iters)) <= 1
    assert abs(t_stats.cg_iters - int(j_stats.cg_iters)) <= 1
    np.testing.assert_allclose(t2n(t_new.x), ref.x, rtol=0, atol=1e-10)
    np.testing.assert_allclose(t2n(t_new.x), np.asarray(j_new.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(t2n(t_new.v), ref.v, rtol=0, atol=1e-8)
    np.testing.assert_allclose(t2n(t_new.F), ref.F, rtol=0, atol=1e-8)
    np.testing.assert_allclose(t2n(t_new.C), np.asarray(j_new.C), rtol=0, atol=1e-8)


def stressed_pair(name, overrides, jmodel=None, tmodel=None, **kw):
    """hot_tpu and port Simulations from one stressed fp64 state (the port's
    stress_state of hot_tpu's particles), with the same config overrides."""
    scene = hot_tpu_scene(name, dtype=jnp.float64, **kw)
    tscene = tbuild(name, device="cpu", dtype=torch.float64, **kw)
    ts = stress_state(carry_state(scene["state"]), tscene["cfg"])
    js = JState(**{f: jnp.asarray(t2n(getattr(ts, f))) for f in FIELDS})
    jsim = JSimulation(j_overrides(scene["cfg"], overrides), js, jmodel or scene["model"],
                       scene["colliders"])
    tsim = TSimulation(t_overrides(tscene["cfg"], overrides), ts, tmodel or tscene["model"],
                       tscene["colliders"])
    return jsim, tsim


def run_pair(jsim, tsim, steps, dt, atol):
    """Steps both; identical (newton, cg) per step, positions within atol."""
    counts = []
    for _ in range(steps):
        js, ts = jsim.step(dt), tsim.step(dt)
        counts.append((ts.newton_iters, ts.cg_iters))
        assert (ts.newton_iters, ts.cg_iters) == (int(js.newton_iters), int(js.cg_iters))
        assert ts.converged and bool(js.converged)
        np.testing.assert_allclose(t2n(tsim.state.x), np.asarray(jsim.state.x), rtol=0,
                                   atol=atol)
    return counts


def test_cubic_twisting_bar_three_steps_match_hot_tpu():
    jsim, tsim = stressed_pair("twisting_bar_3d", CUBIC, res=16, ppc=2)
    counts = run_pair(jsim, tsim, 3, 2e-3, 1e-9)
    assert min(c[0] for c in counts) > 0, counts


def test_cubic_matrix_free_vcycle_matches_hot_tpu():
    """One V-cycle of the matrix-free quadrature hierarchy with cubic
    particle stencils (the node-embedding transfers stay quadratic)."""
    sys_ = mg_system()
    arr, res, dx, levels = sys_["arr"], sys_["res"], sys_["dx"], 3
    kw = dict(smoother="chebyshev", coarse_solver="smoother", levels=levels)

    @jax.jit
    def run(x, m, F, V0, jctx, cons, r):
        mgs = jmg.build_static(x, m, res, dx, levels, cons, jnp.float64, kernel="cubic")
        pre = jmg.build_precond(mgs, F, jctx, V0, DT, JMGConfig(**kw), 2)
        return jmg.mg_precondition(mgs, pre, F, V0, DT, JMGConfig(**kw), r)

    want = run(*(jnp.asarray(arr[f]) for f in ("x", "m", "F", "V0")), sys_["jctx"],
               jnp.asarray(sys_["cons"]), jnp.asarray(sys_["r"]))
    a = {f: torch.as_tensor(np.array(v)) for f, v in arr.items()}
    mgs = tmg.build_static(a["x"], a["m"], res, dx, levels, torch.from_numpy(sys_["cons"]),
                           torch.float64, kernel="cubic")
    assert all(lv.stencil.wn.shape[1] == 16 and lv.kernel == "cubic" for lv in mgs.levels)
    assert all(e.wn.shape[1] == 9 for e in mgs.embeds)
    pre = tmg.build_precond(mgs, a["F"], torch_hess(sys_["jctx"]), a["V0"], DT,
                            TMGConfig(**kw), 2)
    got = tmg.mg_precondition(mgs, pre, DT, TMGConfig(**kw), torch.from_numpy(sys_["r"]))
    assert_close(got, np.asarray(want), 1e-9)


@pytest.mark.parametrize("overrides", [
    {"solver.matrix_free": False},
    {"solver.preconditioner": "multigrid", "solver.multigrid.assembled": True},
    {"solver.preconditioner": "multigrid", "solver.multigrid.coarse_solver": "direct"},
], ids=["explicit_bsr", "assembled_mg", "direct_coarse"])
def test_cubic_refuses_quadratic_bsr(overrides):
    scene = tbuild("block_drop_2d", device="cpu", res=16, dtype=torch.float64)
    cfg = t_overrides(scene["cfg"], dict(CUBIC, **overrides))
    with pytest.raises(NotImplementedError, match="5-wide quadratic"):
        TSimulation(cfg, scene["state"], scene["model"], scene["colliders"])
    with pytest.raises(NotImplementedError, match="5-wide quadratic"):
        tmg.build_static(scene["state"].x, scene["state"].m, (16, 16), 1 / 16, 2,
                         torch.zeros(256, dtype=torch.bool), torch.float64, assembled_from=0,
                         kernel="cubic")
