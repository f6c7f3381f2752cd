"""The port's objective (sim/objective.py, which drives both kernel
modules) against hot_tpu's unfused XLA objective, on the same fp64 inputs.

Tolerance 1e-10 relative to the reference's largest entry: both packages run
the same algorithms in fp64 (same SVD, so U and V match exactly) and differ
only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.sim import objective as jobj
from hot_tpu_torch.sim import objective as tobj

from test_torch_ref import DT, assert_close, objective_pair, one_torch_thread  # noqa: F401

TOL = 1e-10
SCENES = {2: "block_drop_2d", 3: "twisting_bar_3d"}


@pytest.mark.parametrize("model_name", ["fixed_corotated", "stvk_hencky"])
@pytest.mark.parametrize("d", [2, 3])
def test_linearize_and_multiply_match_xla_chain(rng, d, model_name):
    """linearize (residual + context) and multiply == hot_tpu's unfused XLA
    objective at 1e-10 (same SVD algorithm, so U and V match exactly)."""
    p = objective_pair(SCENES[d], rng, model_name)
    jo, to, jmodel, tmodel, v = p.jo, p.to, p.jmodel, p.tmodel, p.v
    jr, jh = jobj.linearize(jmodel, jo, jnp.asarray(v))
    tr, th = tobj.linearize(tmodel, to, torch.from_numpy(v))
    assert_close(tr, jr, TOL)
    ctx = th.context(d)
    for field in ("U", "V", "A", "b_plus", "b_minus"):
        assert_close(getattr(ctx, field), getattr(jh.ctx, field), TOL)
    w = rng.standard_normal(v.shape)
    assert_close(tobj.multiply(to, th, torch.from_numpy(w)),
                 jobj.multiply(jo, jh, jnp.asarray(w)), TOL)
    assert_close(tobj.residual(tmodel, to, torch.from_numpy(v)),
                 jobj.residual(jmodel, jo, jnp.asarray(v)), TOL)
    assert_close(tobj.energy(tmodel, to, torch.from_numpy(v)),
                 jobj.energy(jmodel, jo, jnp.asarray(v)), TOL)
    jb = jobj.build_hessian(jmodel, jo, jnp.asarray(v))
    assert_close(tobj.build_hessian(tmodel, to, torch.from_numpy(v)).context(d).A,
                 jb.ctx.A, TOL)


@pytest.mark.parametrize("d", [2, 3])
def test_block_jacobi_matches_hot_tpu(rng, d):
    """elastic_block_diag + sym_block_inv, and the CN norm / projection /
    mass preconditioner on the same residual."""
    p = objective_pair(SCENES[d], rng)
    jo, to = p.jo, p.to
    _, jh = jobj.linearize(p.jmodel, jo, jnp.asarray(p.v))
    _, th = tobj.linearize(p.tmodel, to, torch.from_numpy(p.v))
    active = jo.grid_m > 0
    jD = jobj.elastic_block_diag(jo.stencil, jo.F_n, jh.ctx, jo.V0, DT, jo.grid_m,
                                 active, d)
    tD = tobj.elastic_block_diag(to.stencil, to.F_n, th.context(d), to.V0, DT,
                                 to.grid_m, to.active, d)
    assert_close(tD, jD, TOL)
    assert_close(tobj.sym_block_inv(tD), jobj.sym_block_inv(jD), TOL)
    r = rng.standard_normal(p.v.shape)
    assert_close(tobj.project(to, torch.from_numpy(r)), jobj.project(jo, jnp.asarray(r)), TOL)
    assert_close(tobj.mass_precondition(to, torch.from_numpy(r)),
                 jobj.mass_precondition(jo, jnp.asarray(r)), TOL)
    assert_close(tobj.cn_norm(to, torch.from_numpy(r)), jobj.cn_norm(jo, jnp.asarray(r)), TOL)
    assert_close(to.cn_scale, jo.cn_scale, TOL)
