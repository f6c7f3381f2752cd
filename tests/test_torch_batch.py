"""The port's batched step (a stiffness sweep of one scene, B members stepped
together) against hot_tpu's ``jax.vmap(advance_one_step)`` and against the
port's own single-member steps, on the CPU in fp64 (the kernels' plain
versions).

  * block_drop_2d at 24^2, E in {1e4, 1e5, 1e6, 1e7}, 75 steps at dt 4e-3
    through impact (tests/test_vmap_sweep.py's set-up): per step and member
    the same Newton and CG counts and convergence as hot_tpu's vmapped step,
    x within 1e-9 at the end, and hot_tpu's own asserts on the port's batch.
  * twisting_bar_3d at 16^3 (two stiffnesses, 3 steps, block-Jacobi with
    Armijo line search), the von Mises bar from stress_state and the bar
    with cubic transfers (2 steps each), the explicit integrator on the
    block drop: the batch against each member stepped alone, exact counts,
    x and F within 1e-12.
  * both kernels' plain versions on a batch against one call per member.
  * each configuration a batch once refused (multigrid, sparse,
    L-BFGS, MINRES, explicit BSR) stepping a batch; the device mesh it
    still refuses.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.models.constitutive import lame_parameters as j_lame
from hot_tpu.scenes import build_scene as jbuild
from hot_tpu.sim.simulation import advance_one_step as j_advance
from hot_tpu_torch.models.constitutive import lame_parameters, MODEL_REGISTRY
from hot_tpu_torch.ops import fused_apply as fa
from hot_tpu_torch.ops import fused_linearize as fl
from hot_tpu_torch.scenes import build_scene as tbuild
from hot_tpu_torch.scenes import stress_state
from hot_tpu_torch.sim import Simulation
from hot_tpu_torch.sim.simulation import advance_one_step as t_advance
from hot_tpu_torch.sim.state import FIELDS, stack_states, state_from_numpy, unstack_states
from hot_tpu_torch.utils.config import config_from_overrides

from test_torch_ref import one_torch_thread, t2n  # noqa: F401

SWEEP_E = [1e4, 1e5, 1e6, 1e7]


def _with_E(state, E):
    mu, lam = lame_parameters(E, 0.3)
    return state.replace(mu=torch.full_like(state.mu, mu), lam=torch.full_like(state.lam, lam))


def test_block_drop_sweep_matches_hot_tpu_vmap():
    """hot_tpu's batch (its with_E under jax.vmap) carried into the port and
    stepped side by side with jax.jit(jax.vmap(advance_one_step)) for 75
    steps: equal Newton and CG counts and convergence per step and member,
    x within 1e-9 after the last step (the single path's tolerance,
    tests/test_torch_step.py)."""
    scene = jbuild("block_drop_2d", res=24, dtype=jnp.float64)
    base = scene["state"]

    def with_E(E):
        mu, lam = j_lame(E, 0.3)
        return base.replace(mu=jnp.full((base.n,), mu, base.mu.dtype),
                            lam=jnp.full((base.n,), lam, base.lam.dtype))

    jstate = jax.vmap(with_E)(jnp.asarray(SWEEP_E))
    vstep = jax.jit(jax.vmap(functools.partial(
        j_advance, cfg=scene["cfg"], model=scene["model"], colliders=scene["colliders"],
        plasticity=None), in_axes=(0, None, None)))
    tscene = tbuild("block_drop_2d", device="cpu", res=24, dtype=torch.float64)
    tstate = state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in FIELDS}, "cpu",
                              torch.float64)
    assert tstate.batch == 4 and tstate.n == base.n
    dt, t, newton_total = 4e-3, 0.0, [0] * 4
    for k in range(75):
        jstate, js = vstep(jstate, jnp.float64(dt), jnp.float64(t))
        tstate, ts = t_advance(tstate, dt, t, cfg=tscene["cfg"], model=tscene["model"],
                               colliders=tscene["colliders"])
        t += dt
        want = [np.asarray(a).tolist() for a in (js.newton_iters, js.cg_iters, js.converged)]
        assert [ts.newton_iters, ts.cg_iters, ts.converged] == want, (k, want)
        newton_total = [a + b for a, b in zip(newton_total, ts.newton_iters)]
    assert min(newton_total) > 0, newton_total
    x = t2n(tstate.x)
    np.testing.assert_allclose(x, np.asarray(jstate.x), rtol=0, atol=1e-9)
    # hot_tpu's own asserts (tests/test_vmap_sweep.py) on the port's batch
    assert np.isfinite(x).all() and all(ts.converged)
    spread = x[:, :, 1].max(axis=1) - x[:, :, 1].min(axis=1)
    assert spread[0] < 0.7 * spread[-1], spread
    assert np.abs(x[0] - x[-1]).max() > 1e-3


def _batch_against_singles(scene, members, steps, dt, cfg=None, plasticity=None, f_tol=1e-12):
    """Step `members` (single states) as one batch and each alone: equal
    Newton, CG and line-search counts and convergence per step and member,
    x within 1e-12 and F within f_tol; returns the batch's per-step stats."""
    cfg = cfg or scene["cfg"]
    kw = dict(cfg=cfg, model=scene["model"], colliders=scene["colliders"],
              plasticity=plasticity)
    batch, records = stack_states(members), []
    for k in range(steps):
        t = k * dt
        batch, bs = t_advance(batch, dt, t, **kw)
        alone = [t_advance(m, dt, t, **kw) for m in members]
        members = [m for m, _ in alone]
        for field in ("newton_iters", "cg_iters", "ls_backtracks", "converged"):
            assert getattr(bs, field) == [getattr(s, field) for _, s in alone], (k, field)
        for got, want in zip(unstack_states(batch), members):
            np.testing.assert_allclose(t2n(got.x), t2n(want.x), rtol=0, atol=1e-12)
            np.testing.assert_allclose(t2n(got.Ff), t2n(want.Ff), rtol=0, atol=f_tol)
        records.append(bs)
    return records


def test_twisting_bar_batch_with_line_search_matches_singles():
    scene = tbuild("twisting_bar_3d", device="cpu", res=16, ppc=2, dtype=torch.float64)
    cfg = config_from_overrides(scene["cfg"], {"solver.line_search": True})
    assert cfg.solver.preconditioner == "block_jacobi"
    members = [_with_E(scene["state"], E) for E in (1e6, 4e6)]
    stats = _batch_against_singles(scene, members, 3, 2e-3, cfg)
    assert sum(sum(s.newton_iters) for s in stats) > 0


@pytest.mark.parametrize("case", ["von_mises", "cubic"])
def test_bar_batch_matches_singles(case):
    """The von Mises bar from stress_state (the return map at work) and the
    bar with cubic transfers, two stiffnesses, 2 steps."""
    name = "twisting_bar_vonmises_3d" if case == "von_mises" else "twisting_bar_3d"
    scene = tbuild(name, device="cpu", res=16, ppc=2, dtype=torch.float64)
    cfg = scene["cfg"]
    state = scene["state"]
    if case == "von_mises":
        state = stress_state(state, cfg)
    else:
        cfg = config_from_overrides(cfg, {"transfer_kernel": "cubic"})
    members = [_with_E(state, E) for E in (1e6, 3e6)]
    stats = _batch_against_singles(scene, members, 2, 2e-3, cfg, scene["plasticity"])
    assert sum(sum(s.newton_iters) for s in stats) > 0


def test_explicit_batch_matches_singles():
    """The explicit integrator (no kernel, no solve) on the block drop from
    stress_state, two stiffnesses, 3 steps; then the same batch through
    Simulation's step."""
    scene = tbuild("block_drop_2d", device="cpu", res=24, dtype=torch.float64)
    cfg = config_from_overrides(scene["cfg"], {"solver.integrator": "explicit"})
    members = [_with_E(stress_state(scene["state"], cfg), E) for E in (1e4, 3e4)]
    stats = _batch_against_singles(scene, members, 3, 5e-4, cfg)
    assert all(s.newton_iters == [0, 0] and s.converged == [True, True] for s in stats)
    sim = Simulation(cfg, stack_states(members), scene["model"], scene["colliders"])
    s = sim.step(5e-4)
    assert s.newton_iters == [0, 0] and sim.retry_count == 0 and sim.state.batch == 2


@pytest.mark.parametrize("case", ["sand_column_2d", "snowball_drop_2d", "neo_hookean",
                                  "linear_corotated", "stvk_hencky", "jacobi", "none"])
def test_2d_batch_matches_singles(case):
    """The 2D scenes' return maps (Drucker-Prager, snow with Jp) from
    stress_state, the block drop under the three other models and under the
    Jacobi and no preconditioner, two stiffnesses, 3 steps. Without a
    preconditioner only the first step converges (Newton 6 and 8, CG 57 and
    271); from the second on Newton stops at its cap of 10 unconverged,
    with up to 491 CG iterations a solve, and those runs amplify the
    rounding in which a batch's per-member sums (a reduction over each
    member's rows) differ from one state's whole-tensor sums (x parts by
    3.5e-9 after 2 steps), so that case takes the one step."""
    name = case if case.endswith("_2d") else "block_drop_2d"
    scene = tbuild(name, device="cpu", res=24, dtype=torch.float64)
    cfg = scene["cfg"]
    if case in MODEL_REGISTRY:
        scene["model"] = MODEL_REGISTRY[case]
    if case in ("jacobi", "none"):
        cfg = config_from_overrides(cfg, {"solver.preconditioner": case})
    state = stress_state(scene["state"], cfg)
    E = 2.0 * (1.0 + 0.3) * float(state.mu[0])    # the scene's own E
    members = [_with_E(state, E), _with_E(state, 4.0 * E)]
    stats = _batch_against_singles(scene, members, 1 if case == "none" else 3, 2e-3, cfg,
                                   scene["plasticity"])
    assert sum(sum(s.newton_iters) for s in stats) > 0


def _member_kernel_inputs(d, kernel, rng, members=3):
    """Per member: a small scene's particles jittered by up to 0.2 dx, F
    perturbed by 0.1, its own stiffness, and random grid vectors v, w."""
    name, kw = ("twisting_bar_3d", dict(res=16, ppc=2)) if d == 3 else ("block_drop_2d",
                                                                         dict(res=24))
    state = tbuild(name, device="cpu", dtype=torch.float64, **kw)["state"]
    dx, n, n_nodes = 1.0 / kw["res"], state.n, kw["res"] ** d
    out = []
    for k in range(members):
        x = state.x + torch.as_tensor(rng.uniform(-0.2, 0.2, state.x.shape)) * dx
        F = state.F + torch.as_tensor(0.1 * rng.standard_normal((n, d, d)))
        out.append(dict(x=fa.soa(x), F=fa.soa(F), mu=state.mu * 3.0 ** k,
                        lam=state.lam * 3.0 ** k, V0=state.V0,
                        v=torch.as_tensor(rng.standard_normal((n_nodes, d))),
                        w=torch.as_tensor(rng.standard_normal((n_nodes, d)))))
    return out, dx, (kw["res"],) * d


@pytest.mark.parametrize("kernel", ["quadratic", "cubic"])
@pytest.mark.parametrize("d", [2, 3])
def test_plain_kernels_take_a_batch(rng, d, kernel):
    """fused_linearize_plain and fused_apply_plain on a batch of three
    members (every argument with a leading member dimension) equal one call
    per member to 1e-13 of the largest entry."""
    members, dx, res = _member_kernel_inputs(d, kernel, rng)
    model = MODEL_REGISTRY["fixed_corotated"]
    stacked = {k: torch.stack([m[k] for m in members]) for k in members[0]}

    def lin(c):
        return fl.fused_linearize(c["v"], c["x"], dx, res, c["F"], c["mu"], c["lam"], c["V0"],
                                  2e-3, model, kernel=kernel)

    def apply(c, ctx):
        return fa.fused_apply(c["w"], c["x"], dx, res, c["F"], *ctx, c["V0"], 2e-3, kernel)

    got = lin(stacked)
    singles = [lin(m) for m in members]
    want = [torch.stack(t) for t in zip(*singles)]
    got_df = apply(stacked, got[1:])
    want_df = torch.stack([apply(m, s[1:]) for m, s in zip(members, singles)])
    for g, w in zip(got + (got_df,), want + [want_df]):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-13 * float(w.abs().max())


@pytest.mark.parametrize("override", [
    {"solver.preconditioner": "multigrid"},
    {"grid_backend": "sparse"},
    {"solver.nonlinear": "lbfgs"},
    {"solver.linear_solver": "minres"},
    {"solver.matrix_free": False},
], ids=["multigrid", "sparse", "lbfgs", "minres", "explicit_bsr"])
def test_batch_steps_each_configuration(override):
    """Each configuration that a batch refused before it took them steps a
    batch of two stiffnesses at 16^2 from stress_state, directly and
    through Simulation: finite and converged, a count per member."""
    scene = tbuild("block_drop_2d", device="cpu", res=16, dtype=torch.float64)
    cfg = config_from_overrides(scene["cfg"], override)
    base = stress_state(scene["state"], cfg)
    batch = stack_states([base, _with_E(base, 1e7)])
    new, stats = t_advance(batch, 1e-3, 0.0, cfg=cfg, model=scene["model"],
                           colliders=scene["colliders"])
    assert torch.isfinite(new.x).all() and stats.converged == [True, True]
    assert len(stats.newton_iters) == 2 and max(stats.newton_iters) > 0
    sim = Simulation(cfg, batch, scene["model"], scene["colliders"])
    s = sim.step(1e-3)
    assert s.converged == [True, True] and sim.retry_count == 0


def test_batch_refuses_a_device_mesh():
    """A batch refuses what one state refuses: a device mesh other than (1,)."""
    scene = tbuild("block_drop_2d", device="cpu", res=16, dtype=torch.float64)
    cfg = config_from_overrides(scene["cfg"], {"mesh.shape": (2,)})
    batch = stack_states([scene["state"]] * 2)
    with pytest.raises(NotImplementedError, match="mesh"):
        t_advance(batch, 1e-3, 0.0, cfg=cfg, model=scene["model"], colliders=scene["colliders"])
    with pytest.raises(NotImplementedError, match="mesh"):
        Simulation(cfg, batch, scene["model"], scene["colliders"])


def test_stack_unstack_and_launch_limits():
    """stack_states refuses unequal particle counts; unstack_states gives
    the members back; a launch takes 1 to 65535 members."""
    a = tbuild("block_drop_2d", device="cpu", res=16, dtype=torch.float64)["state"]
    b = tbuild("block_drop_2d", device="cpu", res=24, dtype=torch.float64)["state"]
    assert a.n != b.n
    with pytest.raises(ValueError):
        stack_states([a, b])
    batch = stack_states([a, _with_E(a, 2e5)])
    assert (batch.batch, batch.n, batch.dim, a.batch) == (2, a.n, 2, None)
    assert batch.F.shape == (2, a.n, 2, 2)
    back = unstack_states(batch)
    assert torch.equal(back[0].x, a.x) and torch.equal(back[1].mu, _with_E(a, 2e5).mu)
    with pytest.raises(ValueError):
        unstack_states(a)
    assert fa.batch_of(torch.zeros(4, 2)) == 1 and fa.batch_of(torch.zeros(3, 4, 2)) == 3
    with pytest.raises(ValueError, match="65535"):
        fa.batch_of(torch.zeros(fa.MAX_BATCH + 1, 1, 2))
