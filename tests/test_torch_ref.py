"""Shared set-up for the hot_tpu_torch tests (builds hot_tpu scenes and
hands the same numbers, as numpy, to both packages), and the tests of that
carry-over: state_from_numpy and make_particle_state against hot_tpu.

`shared` runs a hot_tpu reference once per worker for each set of
arguments: the port's test files hold hundreds of cases, and most of their
time is jax tracing and compiling hot_tpu, so a scene, state or trajectory
that several cases build from the same arguments is built once."""

import functools
import importlib
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.models import constitutive as jcm
from hot_tpu.models import plasticity as jpl
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


def _copied(value):
    """value with every numpy array in its dicts, lists and tuples copied;
    the rest (jax arrays, hot_tpu's states and configs, numbers) is
    immutable and handed out as it is."""
    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, dict):
        return {k: _copied(v) for k, v in value.items()}
    if type(value) in (list, tuple):
        return type(value)(_copied(v) for v in value)
    return value


def shared(fn):
    """fn run once per worker for each set of (hashable) arguments.

    Every call returns its own copy of the numpy arrays in the result, so a
    case that writes into what it got cannot change what the next case
    gets. Results keep numpy in dicts, lists and tuples beside immutable
    values, never torch tensors: a case builds its port side from the numpy."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        return _copied(cached(*args, **kwargs))

    call.cache_info = cached.cache_info
    return call


@shared
def _scene(name, kw):
    return jbuild(name, **dict(kw))


def hot_tpu_scene(name, **kw):
    """hot_tpu.scenes.build_scene(name, **kw), built once per worker (a new
    dict each call, so a case may replace its entries)."""
    return dict(_scene(name, tuple(sorted(kw.items()))))


# hot_tpu's svd and eigh_sym, each under one jax.jit for the worker (the
# module by its path: hot_tpu.ops re-exports the function `svd` in its place)
jsvd = importlib.import_module("hot_tpu.ops.svd")
JIT_SVD = jax.jit(jsvd.svd)
JIT_EIGH_SYM = jax.jit(jsvd.eigh_sym)


@pytest.fixture
def jitted_hot_tpu_svd(monkeypatch):
    """hot_tpu's constitutive models, return maps and polar call its svd
    and eigh_sym jitted (JIT_SVD, JIT_EIGH_SYM), as they run inside hot_tpu's
    jitted step. Eagerly, their unrolled Jacobi sweeps are thousands of
    dispatched ops a call (about 11,000 in one 3D model case of
    tests/test_torch_numerics.py); jitted, each compiles once per worker and
    shape and every case reuses it."""
    for module in (jcm, jpl, jsvd):
        monkeypatch.setattr(module, "svd", JIT_SVD)
    monkeypatch.setattr(jcm, "eigh_sym", JIT_EIGH_SYM)


def carry_state(jstate, device="cpu", dtype=torch.float64):
    """The port's ParticleState holding hot_tpu's particles."""
    return state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in FIELDS}, device, dtype)


def t2n(t):
    return t.detach().cpu().numpy()


@shared
def _hot_tpu_objective(scene_name, rng_state, model_name, kernel):
    """hot_tpu's half of objective_pair, drawing from a generator in
    rng_state (JSON) as objective_pair draws; also returns the generator's
    state after the draws."""
    rng = np.random.default_rng()
    rng.bit_generator.state = json.loads(rng_state)
    scene = hot_tpu_scene(scene_name, dtype=jnp.float64, **SMALL[scene_name])
    cfg = scene["cfg"]
    d = cfg.dim
    res = tuple(cfg.grid_res[:d])
    js = scene["state"]
    F = np.asarray(js.F) + 0.1 * rng.standard_normal(js.F.shape)
    js = js.replace(F=jnp.asarray(F))
    n_nodes = jtr.n_nodes_of(res)
    v_star = 0.3 * rng.standard_normal((n_nodes, d))
    v = v_star + 0.3 * rng.standard_normal((n_nodes, d))
    proj = np.broadcast_to(np.eye(d), (n_nodes, d, d))
    jst = jtr.particle_stencil(js.x, cfg.dx, res, kernel=kernel)
    jgm, _ = jtr.p2g_mass_momentum(jst, js.v, js.C, js.m, n_nodes)
    jo = jobj.make_objective(jcm.MODEL_REGISTRY[model_name], jst, js.F, js.V0, js.mu,
                             js.lam, jgm, jnp.asarray(v_star), jnp.asarray(proj), DT, cfg.dx)
    return dict(js=js, jo=jo, v_star=v_star, v=v, proj=np.array(proj), res=res, dx=cfg.dx,
                rng_after=json.dumps(rng.bit_generator.state))


def objective_pair(scene_name, rng, model_name="fixed_corotated", kernel="quadratic"):
    """hot_tpu and port objectives over the same particles (F perturbed
    with seeded noise) and transfer kernel, plus a random grid velocity for
    both. hot_tpu's side is built once per worker for each generator state,
    and `rng` is left where the draws leave it.

    Returns a namespace: jo, to (objectives), jmodel, tmodel, v (numpy grid
    velocity), x (numpy positions), res, dx."""
    ref = _hot_tpu_objective(scene_name, json.dumps(rng.bit_generator.state), model_name,
                             kernel)
    rng.bit_generator.state = json.loads(ref["rng_after"])
    js, res, dx = ref["js"], ref["res"], ref["dx"]
    ts = carry_state(js)
    n_nodes = jtr.n_nodes_of(res)
    tst = ttr.particle_stencil(ts.x, dx, res, kernel=kernel)
    tgm, _ = ttr.p2g_mass_momentum(tst, ts.v, ts.C, ts.m, n_nodes)
    to = tobj.make_objective(tcm.MODEL_REGISTRY[model_name], tst, ts.F, ts.V0, ts.mu,
                             ts.lam, tgm, torch.from_numpy(ref["v_star"]),
                             torch.from_numpy(ref["proj"]), DT, dx, ts.x, res, kernel=kernel)
    return SimpleNamespace(jo=ref["jo"], to=to, jmodel=jcm.MODEL_REGISTRY[model_name],
                           tmodel=tcm.MODEL_REGISTRY[model_name], v=ref["v"],
                           x=np.asarray(js.x), res=res, dx=dx)


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


def test_shared_reference_runs_once_and_hands_out_copies():
    """A `shared` reference runs hot_tpu once for its arguments: the second
    call returns what the first computed, and what one caller writes into
    its arrays the next caller does not see. objective_pair's cached half
    leaves the generator where a fresh build leaves it."""
    runs = []

    @shared
    def reference(n):
        runs.append(n)
        x = jnp.linspace(0.2, 0.8, 2 * n).reshape(n, 2)
        st = jtr.particle_stencil(x, 1.0 / 16, (16, 16))
        return dict(wn=np.asarray(st.wn), ids=(np.asarray(st.node_ids), "ids"))

    first = reference(5)
    want = first["wn"].copy()
    first["wn"][:] = -1.0
    first["ids"][0][:] = -1
    second = reference(5)
    assert runs == [5] and reference.cache_info().hits == 1
    np.testing.assert_array_equal(second["wn"], want)
    assert (second["ids"][0] >= 0).all() and second["ids"][1] == "ids"

    rngs = [np.random.default_rng(11) for _ in range(2)]
    pairs = [objective_pair("block_drop_2d", r) for r in rngs]
    assert _hot_tpu_objective.cache_info().hits >= 1
    np.testing.assert_array_equal(pairs[0].v, pairs[1].v)
    pairs[0].v[:] = 0.0
    assert objective_pair("block_drop_2d", np.random.default_rng(11)).v.any()
    draws = [r.standard_normal(3) for r in rngs]
    fresh = np.random.default_rng(11)
    scene = jbuild("block_drop_2d", dtype=jnp.float64, **SMALL["block_drop_2d"])
    n_nodes = jtr.n_nodes_of(tuple(scene["cfg"].grid_res[:2]))
    fresh.standard_normal(scene["state"].F.shape)
    fresh.standard_normal((n_nodes, 2))
    fresh.standard_normal((n_nodes, 2))
    np.testing.assert_array_equal(draws[0], fresh.standard_normal(3))
    np.testing.assert_array_equal(draws[1], draws[0])
