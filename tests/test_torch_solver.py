"""The port's CG and Newton loops, the step's solver and transfer options,
and the dt-halving retry, against hot_tpu on the same fp64 inputs; and the
options that are not ported yet, which must raise.

Tolerances: 1e-10 relative to the reference's largest entry for the solvers
(the same arithmetic, host loop against lax.while_loop); 1e-9 on positions
after the steps, as test_torch_step.py holds the default step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.scenes import build_scene as jbuild
from hot_tpu.sim import Simulation as JSimulation
from hot_tpu.solver.cg import cg_solve as j_cg
from hot_tpu.solver.newton import newton_solve as j_newton
from hot_tpu.utils.config import config_from_overrides as j_overrides
from hot_tpu_torch.scenes import build_scene as tbuild
from hot_tpu_torch.sim import Simulation as TSimulation
from hot_tpu_torch.solver.cg import cg_solve as t_cg
from hot_tpu_torch.solver.newton import newton_solve as t_newton
from hot_tpu_torch.utils.config import config_from_overrides as t_overrides

from test_torch_ref import SMALL, assert_close, carry_state, t2n

TOL = 1e-10


def _spd_system(rng, n=8, d=3):
    """A dense SPD operator on (n, d) unknowns, a right-hand side, and a
    projection that pins the first two rows."""
    M = rng.standard_normal((n * d, n * d))
    A = M @ M.T + n * d * np.eye(n * d)
    b = rng.standard_normal((n, d))
    keep = np.ones((n, 1))
    keep[:2] = 0.0
    return A, b, keep


@pytest.mark.parametrize("precondition,project", [(False, False), (True, False),
                                                  (True, True)])
def test_cg_matches_hot_tpu(rng, precondition, project):
    A, b, keep = _spd_system(rng)
    inv_diag = (1.0 / np.diag(A)).reshape(b.shape)

    def make(xp, asarray):
        A_, keep_, inv_ = asarray(A), asarray(keep), asarray(inv_diag)

        def mul(x):
            Ax = (A_ @ x.reshape(-1)).reshape(x.shape)
            return keep_ * Ax + (1.0 - keep_) * x if project else Ax

        return dict(multiply=mul,
                    precondition=(lambda r: inv_ * r) if precondition else None,
                    project=(lambda r: keep_ * r) if project else None)

    jres = j_cg(b=jnp.asarray(b), tol=1e-8, max_iters=100, **make(jnp, jnp.asarray))
    tres = t_cg(b=torch.from_numpy(b), tol=1e-8, max_iters=100,
                **make(torch, torch.from_numpy))
    assert tres.iters == int(jres.iters) > 3
    assert tres.converged and bool(jres.converged)
    assert_close(tres.x, jres.x, TOL)
    assert_close(tres.residual, jres.residual, TOL, scale=float(jres.residual0))


def _newton_problem(rng, xp, asarray):
    """A separable convex problem: r(v) = a v + b v^3 - c, Hessian
    diag(a + 3 b v^2), Jacobi-preconditioned, with a CN scale."""
    shape = (10, 3)
    a = asarray(rng.uniform(0.5, 2.0, shape))
    b = asarray(rng.uniform(0.0, 0.5, shape))
    c = asarray(rng.standard_normal(shape))
    scale = asarray(rng.uniform(0.5, 2.0, shape))

    def linearize(v):
        return a * v + b * v ** 3 - c, a + 3.0 * b * v ** 2

    return dict(
        linearize=linearize,
        multiply=lambda h, w: h * w,
        project=lambda r: r,
        precondition=lambda pstate, r: r / pstate,
        build_preconditioner=lambda h: h,
        cn_norm=lambda r: xp.sqrt(xp.mean((r / scale) ** 2)),
        v0=asarray(np.zeros(shape)),
    )


@pytest.mark.parametrize("adaptive_forcing", [True, False])
@pytest.mark.parametrize("precond_refresh", ["newton", "step"])
def test_newton_matches_hot_tpu(adaptive_forcing, precond_refresh):
    kw = dict(max_newton=30, cn_eps=1e-9, cg_tol=1e-3, max_cg=50,
              adaptive_forcing=adaptive_forcing, precond_refresh=precond_refresh)
    jres = j_newton(**_newton_problem(np.random.default_rng(3), jnp, jnp.asarray), **kw)
    tres = t_newton(**_newton_problem(np.random.default_rng(3), torch, torch.from_numpy),
                    **kw)
    assert (tres.iters, tres.cg_iters) == (int(jres.iters), int(jres.cg_iters))
    assert tres.iters > 3 and tres.converged and bool(jres.converged)
    assert_close(tres.v, jres.v, TOL)
    assert_close(np.asarray(tres.cn_history), np.asarray(jres.cn_history)[: tres.iters + 1],
                 TOL)


@pytest.mark.parametrize("option", [dict(linear_solver="minres"), dict(line_search=True),
                                    dict(refresh_preconditioner=lambda h, p: p),
                                    dict(axis_name="x")])
def test_unported_newton_options_raise(rng, option):
    with pytest.raises(NotImplementedError):
        t_newton(**_newton_problem(rng, torch, torch.from_numpy), **option)


@pytest.mark.parametrize("overrides", [
    {"grid_backend": "sparse"}, {"transfer_kernel": "cubic"},
    {"solver.integrator": "explicit"}, {"solver.nonlinear": "lbfgs"},
    {"solver.matrix_free": False}, {"solver.preconditioner": "multigrid"}])
def test_unported_configs_raise(overrides):
    scene = tbuild("block_drop_2d", device="cpu", res=16)
    cfg = t_overrides(scene["cfg"], overrides)
    with pytest.raises(NotImplementedError):
        TSimulation(cfg, scene["state"], scene["model"], scene["colliders"])


def test_plasticity_raises():
    scene = tbuild("block_drop_2d", device="cpu", res=16)
    with pytest.raises(NotImplementedError):
        TSimulation(scene["cfg"], scene["state"], scene["model"], scene["colliders"],
                    plasticity="von_mises")


def _bar_pair(overrides):
    """hot_tpu and port Simulations of the 16^3 twisting bar under the same
    config overrides, over the same particles."""
    scene = jbuild("twisting_bar_3d", dtype=jnp.float64, **SMALL["twisting_bar_3d"])
    tscene = tbuild("twisting_bar_3d", device="cpu", dtype=torch.float64,
                    **SMALL["twisting_bar_3d"])
    jsim = JSimulation(j_overrides(scene["cfg"], overrides), scene["state"], scene["model"],
                       scene["colliders"])
    tsim = TSimulation(t_overrides(tscene["cfg"], overrides), carry_state(scene["state"]),
                       tscene["model"], tscene["colliders"])
    return jsim, tsim


@pytest.mark.parametrize("overrides", [
    {"transfer": "flip", "solver.preconditioner": "none"},
    {"solver.preconditioner": "jacobi", "solver.precond_refresh": "step"}])
def test_step_options_match_hot_tpu(overrides):
    """FLIP transfers with unpreconditioned CG, and mass-Jacobi PCG with the
    preconditioner built once per step: the same counts and positions."""
    jsim, tsim = _bar_pair(overrides)
    newton = 0
    for _ in range(2):
        js, ts = jsim.step(2e-3), tsim.step(2e-3)
        assert (ts.newton_iters, ts.cg_iters) == (int(js.newton_iters), int(js.cg_iters))
        assert ts.converged
        newton += ts.newton_iters
        np.testing.assert_allclose(t2n(tsim.state.x), np.asarray(jsim.state.x), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(t2n(tsim.state.v), np.asarray(jsim.state.v), rtol=0,
                                   atol=1e-7)
    assert newton > 0


def test_dt_retry_matches_hot_tpu():
    """A step that cannot converge (one Newton iteration, a CN target far
    below reach) is retried at halved dt solver.dt_retries times and then
    accepted, in both packages."""
    jsim, tsim = _bar_pair({"solver.max_newton": 1, "solver.cn_eps": 1e-12})
    js, ts = jsim.step(2e-3), tsim.step(2e-3)
    assert not ts.converged and not bool(js.converged)
    assert tsim.retry_count == jsim.retry_count == tsim.cfg.solver.dt_retries == 3
    assert tsim.t == jsim.t == 2e-3 / 8
    retries = [r for r in tsim.metrics.records if r.get("event") == "dt_retry"]
    assert [r["dt"] for r in retries] == [1e-3, 5e-4, 2.5e-4]
    np.testing.assert_allclose(t2n(tsim.state.x), np.asarray(jsim.state.x), rtol=0, atol=1e-9)
    assert tsim.compute_dt() == pytest.approx(jsim.compute_dt(), rel=1e-12)
