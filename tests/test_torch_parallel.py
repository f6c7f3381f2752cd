"""The port's halo exchange and sharded CG (hot_tpu_torch.parallel.halo,
parallel.sharded) on gloo ranks against hot_tpu's under shard_map, fp64.

The port's ranks are spawned once for the file (tests/torch_parallel_worker.py:
4 processes over gloo, a file:// rendezvous in tmp_path, one torch thread,
neither jax nor hot_tpu imported); every case runs there and the tests assert
on the numpy it hands back. hot_tpu runs here on 2 of the CPU devices of
tests/conftest.py (XLA:CPU aborts with more virtual devices than cores in a
collective loop, hot_tpu/parallel/mesh.py:32-51):

  * exchange_halo / fold_halo equal hot_tpu's at D = 2 (its edge devices'
    ghost planes are zeros; the port's edge slabs have none), and are
    adjoint, <exchange(a), b> = <a, fold(b)>, to 1e-12 at D = 2 and 4;
  * sharded_cg_solve of tests/test_sharded.py's impact system at D = 2:
    hot_tpu's iteration count, x within 3e-9 (the CG tolerance, not
    rounding: the ranks sum halo contributions in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from hot_tpu.parallel.halo import exchange_halo, fold_halo
from hot_tpu.parallel.mesh import make_mesh
from hot_tpu.parallel.sharded import partition_system, sharded_cg_solve

import torch_parallel_worker as worker
from test_sharded import _impact_system

P_, W, WIDTH = 4, 6, 2


def _halo_inputs(D):
    rng = np.random.default_rng(D)
    return rng.standard_normal((D, P_, W)), rng.standard_normal((D, P_ + 2 * WIDTH, W))


@pytest.fixture(scope="module")
def system():
    """tests/test_sharded.py's impact system (hot_tpu), and its particles,
    Hessian context, grid arrays and right-hand side as numpy."""
    parts = _impact_system()
    st, ctx = parts["state"], parts["hess"].ctx
    arrays = dict(x=st.x, F=st.F, V0=st.V0, gm=parts["gm"], proj=parts["proj"], b=parts["b"],
                  **{f: getattr(ctx, f) for f in ("U", "V", "A", "b_plus", "b_minus")})
    return parts, dict({k: np.asarray(v) for k, v in arrays.items()},
                       res=tuple(parts["grid_res"]), dx=1.0 / parts["grid_res"][0],
                       dt=float(parts["dt"]))


@pytest.fixture(scope="module")
def results(tmp_path_factory, system):
    cases = [("halo", D, dict(zip(("a", "b"), _halo_inputs(D)), width=WIDTH)) for D in (2, 4)]
    cases.append(("cg", 2, dict(sys_np=system[1], tol=1e-8)))
    return worker.spawn(cases, 4, tmp_path_factory.mktemp("ranks"))


def _hot_tpu_halo(a, b):
    mesh = make_mesh((2,), ("x",))

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("x"), P("x")),
                       out_specs=(P("x"), P("x")))
    def both(al, bl):
        return (exchange_halo(al[0], "x", 2, WIDTH)[None],
                fold_halo(bl[0], "x", 2, WIDTH)[None])

    ext, fold = both(jnp.asarray(a), jnp.asarray(b))
    return np.asarray(ext), np.asarray(fold)


def test_halo_matches_hot_tpu(results):
    a, b = _halo_inputs(2)
    ext, fold = _hot_tpu_halo(a, b)
    np.testing.assert_array_equal(results[0]["ext"], ext)
    np.testing.assert_allclose(results[0]["fold"], fold, rtol=0, atol=1e-15)


@pytest.mark.parametrize("case", [0, 1], ids=["D2", "D4"])
def test_fold_is_adjoint_of_exchange(results, case):
    r = results[case]
    assert abs(r["lhs"] - r["rhs"]) <= 1e-12 * max(1.0, abs(r["lhs"]))


def test_sharded_cg_matches_hot_tpu(results, system):
    parts, _ = system
    mesh = make_mesh((2,), ("x",))
    sys_j, geom, overflow = partition_system(
        parts["st"], parts["state"].F, parts["hess"].ctx, parts["state"].V0, parts["gm"],
        parts["active"], parts["proj"], parts["dt"], parts["grid_res"], 2)
    assert not overflow
    x, iters, _ = sharded_cg_solve(mesh, sys_j, geom, parts["b"], tol=1e-8, max_iters=1000)
    got = results[2]
    assert got["iters"] == int(iters) > 5
    np.testing.assert_allclose(got["x"], np.asarray(x), rtol=0, atol=3e-9)
