"""The port's transfers, colliders and seeding against hot_tpu on a 16^3
ppc=2 twisting bar and a 24^2 block drop (fp64, the same particles carried
across as numpy).

Tolerance 1e-10 relative to the reference's largest entry (same formulas,
different summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.ops import transfer as jtr
from hot_tpu.scenes import build_scene as jbuild
from hot_tpu.sim import collision as jcol
from hot_tpu.sim.seeding import sample_box as j_sample_box
from hot_tpu_torch.ops import transfer as ttr
from hot_tpu_torch.scenes import build_scene as tbuild
from hot_tpu_torch.sim import collision as tcol
from hot_tpu_torch.sim.seeding import sample_box as t_sample_box

from test_torch_ref import SMALL, assert_close, carry_state, one_torch_thread, t2n  # noqa: F401

TOL = 1e-10
SCENES = ["twisting_bar_3d", "block_drop_2d"]


@pytest.fixture(params=SCENES)
def scene_pair(request, rng):
    name = request.param
    scene = jbuild(name, dtype=jnp.float64, **SMALL[name])
    js = scene["state"]
    d = js.dim
    # give the particles motion and an affine field so every term is exercised
    js = js.replace(v=jnp.asarray(rng.standard_normal(js.v.shape)),
                    C=jnp.asarray(rng.standard_normal(js.C.shape)))
    return name, scene, js, carry_state(js), tuple(scene["cfg"].grid_res[:d]), scene["cfg"].dx


def test_stencil_matches(scene_pair):
    _, _, js, ts, res, dx = scene_pair
    jst = jtr.particle_stencil(js.x, dx, res)
    tst = ttr.particle_stencil(ts.x, dx, res)
    np.testing.assert_array_equal(t2n(tst.node_ids), np.asarray(jst.node_ids))
    for field in ("wn", "gwn", "rel"):
        assert_close(getattr(tst, field), getattr(jst, field), TOL)
    assert ttr.n_nodes_of(res) == jtr.n_nodes_of(res)
    assert_close(ttr.node_positions(res, dx, torch.float64),
                 jtr.node_positions(res, dx, jnp.float64), TOL)


def test_p2g_g2p_and_forces_match(scene_pair, rng):
    _, _, js, ts, res, dx = scene_pair
    n_nodes = jtr.n_nodes_of(res)
    d = js.dim
    jst = jtr.particle_stencil(js.x, dx, res)
    tst = ttr.particle_stencil(ts.x, dx, res)
    jm, jmv = jtr.p2g_mass_momentum(jst, js.v, js.C, js.m, n_nodes)
    tm, tmv = ttr.p2g_mass_momentum(tst, ts.v, ts.C, ts.m, n_nodes)
    assert_close(tm, jm, TOL)
    assert_close(tmv, jmv, TOL)
    grid_v = rng.standard_normal((n_nodes, d))
    jv, jg, jC = jtr.g2p(jst, jnp.asarray(grid_v), dx)
    tv, tg, tC = ttr.g2p(tst, torch.from_numpy(grid_v), dx)
    for got, want in ((tv, jv), (tg, jg), (tC, jC)):
        assert_close(got, want, TOL)
    assert_close(ttr.velocity_gradient(tst, torch.from_numpy(grid_v)),
                 jtr.velocity_gradient(jst, jnp.asarray(grid_v)), TOL)
    PFt = rng.standard_normal((js.n, d, d))
    assert_close(ttr.scatter_force(tst, torch.from_numpy(PFt), ts.V0, n_nodes),
                 jtr.scatter_force(jst, jnp.asarray(PFt), js.V0, n_nodes), TOL)


@pytest.mark.parametrize("t", [0.0, 0.13])
def test_boundary_conditions_match(scene_pair, rng, t):
    """Scene colliders (scripted rotating clamps in 3D, a floor in 2D) plus
    a slip half-space with friction, at grid nodes."""
    name, scene, js, ts, res, dx = scene_pair
    d = js.dim
    tscene = tbuild(name, device="cpu", dtype=torch.float64, **SMALL[name])
    n_nodes = jtr.n_nodes_of(res)
    pos = jtr.node_positions(res, dx, jnp.float64)
    grid_v = rng.standard_normal((n_nodes, d))
    normal = (0.0, 1.0) if d == 2 else (0.0, 1.0, 0.0)
    origin = (0.0, 0.5) if d == 2 else (0.0, 0.5, 0.0)
    jslip = jcol.HalfSpace(kind=jcol.SLIP, friction=0.3, origin=origin, n=normal)
    tslip = tcol.HalfSpace(kind=tcol.SLIP, friction=0.3, origin=origin, n=normal)
    jout = jcol.grid_boundary_conditions(pos, t, scene["colliders"] + (jslip,),
                                         grid_v=jnp.asarray(grid_v), boundary_margin=2,
                                         res=res, dx=dx)
    tout = tcol.grid_boundary_conditions(torch.tensor(np.asarray(pos)), t,
                                         tscene["colliders"] + (tslip,),
                                         grid_v=torch.from_numpy(grid_v), boundary_margin=2,
                                         res=res, dx=dx)
    assert_close(tout[0], jout[0], TOL)
    assert_close(tout[1], jout[1], TOL)
    np.testing.assert_array_equal(t2n(tout[2]), np.asarray(jout[2]))
    assert_close(tcol.apply_bc_to_velocity(torch.from_numpy(grid_v), tout[0], tout[1]),
                 jcol.apply_bc_to_velocity(jnp.asarray(grid_v), jout[0], jout[1]), TOL)


@pytest.mark.parametrize("ppc", [2, 8])
def test_seeding_lattice_matches(ppc):
    """Same lattice and volume; the jitter (a different generator) stays
    within +-0.45 sub-cell of the same lattice points."""
    import jax

    lo, hi, dx = (0.2, 0.4, 0.4), (0.8, 0.6, 0.6), 1.0 / 16
    jx, jvol = j_sample_box(jax.random.PRNGKey(1), lo, hi, dx, ppc, dtype=jnp.float64)
    g = torch.Generator().manual_seed(1)
    tx, tvol = t_sample_box(g, lo, hi, dx, ppc, dtype=torch.float64, device="cpu")
    assert tvol == jvol and tx.shape == jx.shape
    sub = np.asarray([dx / k for k in ((2, 1, 1) if ppc == 2 else (2, 2, 2))])
    assert np.all(np.abs(t2n(tx) - np.asarray(jx)) <= 0.9 * sub + 1e-12)
