"""The port's scene suite against hot_tpu's (fp64, CPU): the eleven
builders, their samplers, colliders and mesh pipeline, the analysis
queries and the CLI's scene list.

The builders draw their lattice jitter from a torch.Generator, so their
particles differ from hot_tpu's. To hold a builder against hot_tpu's, the
port's sample_box is replaced here by one that returns hot_tpu's lattice
for the same seed: every level-set and mesh mask is then applied by the
port to hot_tpu's candidate points, and the built states must agree
exactly in count and within 1e-12 in every field. Each port scene then
takes one step on the CPU from stress_state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.io import mesh as jmesh
from hot_tpu.scenes import SCENES as J_SCENES
from hot_tpu.scenes import assets as jassets
from hot_tpu.scenes import build_scene as jbuild
from hot_tpu.scenes import stress_state as j_stress
from hot_tpu.sim import analysis as janalysis
from hot_tpu.sim import collision as jcol
from hot_tpu.sim import seeding as jseed
from hot_tpu_torch import cli
from hot_tpu_torch.io import mesh as tmesh
from hot_tpu_torch.scenes import SCENES as T_SCENES
from hot_tpu_torch.scenes import assets as tassets
from hot_tpu_torch.scenes import build_scene as tbuild
from hot_tpu_torch.scenes import registry as treg
from hot_tpu_torch.scenes import stress_state as t_stress
from hot_tpu_torch.sim import Simulation
from hot_tpu_torch.sim import analysis as tanalysis
from hot_tpu_torch.sim import collision as tcol
from hot_tpu_torch.sim import seeding as tseed
from hot_tpu_torch.sim.state import FIELDS

from test_torch_config import TPU_ONLY
from test_torch_ref import assert_close, carry_state, one_torch_thread  # noqa: F401

TOL = 1e-12
SMALL = {
    "block_drop_2d": dict(res=16),
    "wheel_3d": dict(res=16, ppc=2),
    "twisting_bar_3d": dict(res=16, ppc=2),
    "twisting_bar_vonmises_3d": dict(res=16, ppc=2),
    "stacked_boxes_3d": dict(res=16, ppc=1),
    "boards_3d": dict(res=16, ppc=1),
    "chain_2d": dict(res=24),
    "faceless_3d": dict(res=32, ppc=1),
    "faceless_mesh_3d": dict(res=32, ppc=1),
    "sand_column_2d": dict(res=24),
    "snowball_drop_2d": dict(res=24),
}


def _hot_tpu_lattice(generator, lo, hi, dx, particles_per_cell, dtype=torch.float32,
                     device="cpu"):
    """hot_tpu's sample_box for the generator's seed, as the port's returns."""
    x, vol = jseed.sample_box(jax.random.PRNGKey(generator.initial_seed()), lo, hi, dx,
                              particles_per_cell, dtype=jnp.float64)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device), vol


@pytest.fixture
def hot_tpu_lattice(monkeypatch):
    monkeypatch.setattr(tseed, "sample_box", _hot_tpu_lattice)
    monkeypatch.setattr(treg, "sample_box", _hot_tpu_lattice)


@pytest.fixture(scope="module")
def obj_path(tmp_path_factory):
    """hot_tpu's generated OBJ, which the port's must equal byte for byte."""
    return jassets.write_faceless_obj(str(tmp_path_factory.mktemp("obj") / "faceless.obj"))


def _plain(cfg_dict):
    return {k: _plain(v) if isinstance(v, dict) else v for k, v in cfg_dict.items()
            if k not in TPU_ONLY}


def _same_collider(jc, tc):
    assert type(jc).__name__ == type(tc).__name__
    for f in dataclasses.fields(tc):
        if f.name != "motion":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert (jc.motion is None) == (tc.motion is None)
    if tc.motion is not None:
        for a, b in zip(tc.motion(0.37), jc.motion(0.37)):
            assert_close(a, b, TOL)


@pytest.mark.parametrize("name", sorted(J_SCENES))
def test_scene_matches_hot_tpu_and_steps(name, hot_tpu_lattice, obj_path):
    kw = dict(SMALL[name], **({"obj_path": obj_path} if name == "faceless_mesh_3d" else {}))
    js = jbuild(name, dtype=jnp.float64, **kw)
    ts = tbuild(name, device="cpu", dtype=torch.float64, **kw)
    assert _plain(dataclasses.asdict(ts["cfg"])) == _plain(dataclasses.asdict(js["cfg"]))
    assert ts["model"].name == js["model"].name
    assert ts["plasticity"] == js["plasticity"]
    assert len(ts["colliders"]) == len(js["colliders"])
    for jc, tc in zip(js["colliders"], ts["colliders"]):
        _same_collider(jc, tc)
    assert ts["state"].n == js["state"].n > 50
    for f in FIELDS:
        got, want = getattr(ts["state"], f).numpy(), np.asarray(getattr(js["state"], f))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))   # yield_stress
        finite = np.isfinite(want)
        if finite.any():
            assert_close(got[finite], want[finite], TOL)
    stressed = t_stress(ts["state"], ts["cfg"])
    assert_close(stressed.v, np.asarray(j_stress(js["state"], js["cfg"]).v), TOL)

    sim = Simulation(ts["cfg"], stressed, ts["model"], ts["colliders"],
                     plasticity=ts["plasticity"])
    stats = [sim.step(2e-3) for _ in range(2)]
    assert all(s.converged for s in stats) and sim.retry_count == 0
    assert sum(s.newton_iters for s in stats) > 0, stats
    assert bool(torch.isfinite(sim.state.x).all() and torch.isfinite(sim.state.Ff).all())


def test_scene_list_matches_hot_tpu(capsys):
    assert set(T_SCENES) == set(J_SCENES)
    assert cli.main(["--list-scenes"]) == 0
    assert capsys.readouterr().out.split() == sorted(J_SCENES)


@pytest.mark.parametrize("sampler", ["sphere", "cylinder"])
def test_samplers_keep_hot_tpu_points(sampler, hot_tpu_lattice):
    """The sphere and cylinder masks, applied to hot_tpu's candidates."""
    key, gen, dx = jax.random.PRNGKey(5), torch.Generator().manual_seed(5), 1.0 / 40
    if sampler == "sphere":
        args = ((0.5, 0.45, 0.55), 0.2, dx, 8)
        jx, jv = jseed.sample_sphere(key, *args, dtype=jnp.float64)
        tx, tv = tseed.sample_sphere(gen, *args, dtype=torch.float64, device="cpu")
    else:
        args = ((0.5, 0.42, 0.5), (0.3, 0.2, 1.0), 0.16, 0.05, dx, 8)
        jx, jv = jseed.sample_cylinder(key, *args, dtype=jnp.float64)
        tx, tv = tseed.sample_cylinder(gen, *args, dtype=torch.float64, device="cpu")
    assert tv == jv and tx.shape == jx.shape and jx.shape[0] > 100
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def _collider_points(rng, center, axis, radius, half_height):
    """Seeded points around a cylinder (or sphere, axis None): random ones,
    and, for the cylinder, points on its axis, on its mid-plane and on its
    curved surface."""
    c = np.asarray(center)
    pts = [c + 0.4 * rng.uniform(-1, 1, (300, 3))]
    if axis is not None:
        a = np.asarray(axis) / np.linalg.norm(axis)
        s = rng.uniform(-2, 2, (20, 1)) * half_height
        pts.append(c + s * a)                                   # on the axis
        perp = np.cross(a, rng.standard_normal((20, 3)))
        perp /= np.linalg.norm(perp, axis=1, keepdims=True)
        r = rng.uniform(0.0, 2.0, (20, 1)) * radius
        pts.append(c + r * perp)                                # on the mid-plane
        pts.append(c + radius * perp + 0.3 * s * a)             # on the curved face
    return np.concatenate(pts)


@pytest.mark.parametrize("shape", ["sphere", "sphere_inverted", "cylinder_z",
                                   "cylinder_tilted"])
def test_collider_phi_and_normal_match_hot_tpu(rng, shape):
    if shape.startswith("sphere"):
        kw = dict(center=(0.5, 0.4, 0.6), radius=0.2, inverted=shape.endswith("inverted"))
        jc, tc = jcol.Sphere(**kw), tcol.Sphere(**kw)
        x = _collider_points(rng, kw["center"], None, 0.2, None)
        x[0] = kw["center"]
    else:
        axis = (0.0, 0.0, 1.0) if shape == "cylinder_z" else (0.3, -1.0, 0.6)
        kw = dict(center=(0.5, 0.42, 0.5), axis=axis, radius=0.16, half_height=0.05)
        jc, tc = jcol.Cylinder(**kw), tcol.Cylinder(**kw)
        x = _collider_points(rng, kw["center"], axis, 0.16, 0.05)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert_close(tc.phi(tx, 0.0), jc.phi(jx, 0.0), TOL)
    n = tc.normal(tx, 0.0)
    assert_close(n, jc.normal(jx, 0.0), TOL)
    if shape.startswith("cylinder"):     # unit everywhere, degenerate points too
        assert_close(torch.linalg.norm(n, dim=-1), np.ones(len(x)), TOL)


def test_generated_obj_is_hot_tpu_s(tmp_path, monkeypatch, obj_path):
    want = open(obj_path, "rb").read()
    assert open(tassets.write_faceless_obj(str(tmp_path / "a.obj")), "rb").read() == want
    monkeypatch.setenv("HOT_TPU_ASSET_DIR", str(tmp_path))
    path = tassets.faceless_obj_path()
    assert path == str(tmp_path / "faceless_torch.obj")
    assert open(path, "rb").read() == want
    verts, faces = tmesh.load_obj(path)
    jverts, jfaces = jmesh.load_obj(obj_path)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    assert (len(verts), len(faces)) == (50, 96)


def test_points_inside_mesh_matches_hot_tpu(rng, obj_path, monkeypatch):
    """Random points over the mesh's box and points within 1e-9 of its
    faces (on both sides), with chunks smaller than the point count."""
    verts, faces = jmesh.load_obj(obj_path)
    lo, hi = verts.min(0) - 0.05, verts.max(0) + 0.05
    box = rng.uniform(lo, hi, (1500, 3))
    tri = verts[faces[rng.integers(0, len(faces), 500)]]
    w = rng.dirichlet(np.ones(3), 500)
    on_face = np.einsum("pk,pkj->pj", w, tri)
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    near = on_face + rng.uniform(-1e-9, 1e-9, (500, 1)) * nrm
    pts = np.concatenate([box, near])
    want = jmesh.points_inside_mesh(pts, verts, faces)
    assert 0.1 < want.mean() < 0.9
    monkeypatch.setattr(tmesh, "CHUNK_PAIRS", 96 * 300)
    got = tmesh.points_inside_mesh(torch.from_numpy(pts), verts, faces)
    np.testing.assert_array_equal(got.numpy(), want)
    got32 = tmesh.points_inside_mesh(torch.from_numpy(pts[:1500]).float(), verts, faces)
    np.testing.assert_array_equal(
        got32.numpy(), jmesh.points_inside_mesh(pts[:1500].astype(np.float32), verts, faces))


def test_analysis_matches_hot_tpu(rng):
    js = jbuild("chain_2d", dtype=jnp.float64, **SMALL["chain_2d"])
    state = js["state"]
    state = state.replace(v=jnp.asarray(rng.standard_normal(state.v.shape)),
                          F=state.F + 0.1 * jnp.asarray(rng.standard_normal(state.F.shape)))
    ts = carry_state(state)
    model_j, model_t = js["model"], T_SCENES["chain_2d"](device="cpu", res=24)["model"]
    g = js["cfg"].gravity
    pairs = [
        (tanalysis.total_momentum(ts), janalysis.total_momentum(state)),
        (tanalysis.total_mass(ts), janalysis.total_mass(state)),
        (tanalysis.kinetic_energy(ts), janalysis.kinetic_energy(state)),
        (tanalysis.potential_energy(ts, model_t),
         jax.jit(janalysis.potential_energy, static_argnums=1)(state, model_j)),
        (tanalysis.gravitational_energy(ts, g), janalysis.gravitational_energy(state, g)),
        (tanalysis.center_of_mass(ts), janalysis.center_of_mass(state)),
    ]
    for got, want in pairs:
        assert_close(got, np.asarray(want), TOL)
