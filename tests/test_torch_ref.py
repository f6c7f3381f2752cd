"""Shared set-up for the hot_tpu_torch tests (builds hot_tpu scenes and
hands the same numbers, as numpy, to both packages), and the tests of that
carry-over: state_from_numpy and make_particle_state against hot_tpu."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.models import constitutive as jcm
from hot_tpu.ops import transfer as jtr
from hot_tpu.scenes import build_scene as jbuild
from hot_tpu.sim import objective as jobj
from hot_tpu_torch.models import constitutive as tcm
from hot_tpu_torch.ops import transfer as ttr
from hot_tpu_torch.sim import objective as tobj
from hot_tpu_torch.sim.state import FIELDS, state_from_numpy

SMALL = {"twisting_bar_3d": dict(res=16, ppc=2), "block_drop_2d": dict(res=24)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Each port test file runs on one torch thread (files that import this
    fixture use it too): the suite runs several files at once
    (pytest-xdist), and the default intra-op threads, one per core in every
    worker, made the small-tensor tests up to eight times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
DT = 2e-3


def carry_state(jstate, device="cpu", dtype=torch.float64):
    """The port's ParticleState holding hot_tpu's particles."""
    return state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in FIELDS}, device, dtype)


def t2n(t):
    return t.detach().cpu().numpy()


def objective_pair(scene_name, rng, model_name="fixed_corotated", kernel="quadratic"):
    """hot_tpu and port objectives over the same particles (F perturbed
    with seeded noise) and transfer kernel, plus a random grid velocity for
    both.

    Returns a namespace: jo, to (objectives), jmodel, tmodel, v (numpy grid
    velocity), x (numpy positions), res, dx."""
    scene = jbuild(scene_name, dtype=jnp.float64, **SMALL[scene_name])
    cfg = scene["cfg"]
    d = cfg.dim
    res = tuple(cfg.grid_res[:d])
    js = scene["state"]
    F = np.asarray(js.F) + 0.1 * rng.standard_normal(js.F.shape)
    js = js.replace(F=jnp.asarray(F))
    ts = carry_state(js)
    n_nodes = jtr.n_nodes_of(res)
    v_star = 0.3 * rng.standard_normal((n_nodes, d))
    v = v_star + 0.3 * rng.standard_normal((n_nodes, d))
    proj = np.broadcast_to(np.eye(d), (n_nodes, d, d))

    jst = jtr.particle_stencil(js.x, cfg.dx, res, kernel=kernel)
    jgm, _ = jtr.p2g_mass_momentum(jst, js.v, js.C, js.m, n_nodes)
    jo = jobj.make_objective(jcm.MODEL_REGISTRY[model_name], jst, js.F, js.V0, js.mu,
                             js.lam, jgm, jnp.asarray(v_star), jnp.asarray(proj), DT, cfg.dx)
    tst = ttr.particle_stencil(ts.x, cfg.dx, res, kernel=kernel)
    tgm, _ = ttr.p2g_mass_momentum(tst, ts.v, ts.C, ts.m, n_nodes)
    to = tobj.make_objective(tcm.MODEL_REGISTRY[model_name], tst, ts.F, ts.V0, ts.mu,
                             ts.lam, tgm, torch.from_numpy(v_star), torch.from_numpy(proj.copy()),
                             DT, cfg.dx, ts.x, res, kernel=kernel)
    return SimpleNamespace(jo=jo, to=to, jmodel=jcm.MODEL_REGISTRY[model_name],
                           tmodel=tcm.MODEL_REGISTRY[model_name], v=v,
                           x=np.asarray(js.x), res=res, dx=cfg.dx)


def assert_close(got, want, tol, scale=None):
    """max |got - want| <= tol * max(1, max |want|) (or tol * scale)."""
    got = t2n(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol:.1e} * {scale:.3e}"


def test_state_carry_over_is_exact():
    js = jbuild("twisting_bar_3d", dtype=jnp.float64, **SMALL["twisting_bar_3d"])["state"]
    ts = carry_state(js)
    for f in FIELDS:
        np.testing.assert_array_equal(t2n(getattr(ts, f)), np.asarray(getattr(js, f)))
    np.testing.assert_array_equal(t2n(ts.F), np.asarray(js.F))
    assert (ts.n, ts.dim) == (js.n, js.dim)


def test_make_particle_state_matches_hot_tpu():
    from hot_tpu.sim.state import make_particle_state as j_make
    from hot_tpu_torch.sim.state import make_particle_state as t_make

    x = np.random.default_rng(0).uniform(0.2, 0.8, (10, 3))
    js = j_make(jnp.asarray(x), particle_volume=2e-6, E=1e6, velocity=[0.0, 1.0, 0.0],
                dtype=jnp.float64)
    ts = t_make(torch.from_numpy(x), particle_volume=2e-6, E=1e6, velocity=[0.0, 1.0, 0.0],
                dtype=torch.float64, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(t2n(getattr(ts, f)), np.asarray(getattr(js, f)))
