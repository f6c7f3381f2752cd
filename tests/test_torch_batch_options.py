"""The port's batched step under the solver options beside HOT's
multigrid, on the CPU in fp64 (the kernels' plain versions), one torch
thread; the multigrid cases are in tests/test_torch_batch_solvers.py,
whose set-up this file shares.

  * Against hot_tpu's jax.jit(jax.vmap(advance_one_step)) (the set-up of
    tests/test_torch_batch_solvers.py): the sparse grid under
    block-Jacobi, the explicit BSR, L-BFGS, and MINRES with no
    preconditioner (the only one under which hot_tpu's MINRES is right).
  * Against the port's own members stepped alone: the 24^2 block drop
    under the other smoothers and coarse solves (Jacobi with the coarse CG,
    colored Gauss-Seidel with the smoother), lagged rap_refresh,
    quadrature coarsening, the composed level on the sparse grid with the
    coarse CG, and MINRES under block-Jacobi, three stiffnesses, the
    stiffest on another tile set.
  * A batch of one member is bit for bit the single path, per configuration.
  * The plain kernels on a batch's tile grid against one call per member on
    the member's own tile grid.
"""

import pytest
import torch

from hot_tpu_torch.grid import sparse
from hot_tpu_torch.models.constitutive import MODEL_REGISTRY
from hot_tpu_torch.ops import fused_apply as fa
from hot_tpu_torch.ops import fused_linearize as fl
from hot_tpu_torch.scenes import build_scene as tbuild
from hot_tpu_torch.scenes import stress_state
from hot_tpu_torch.sim.simulation import advance_one_step as t_advance
from hot_tpu_torch.sim.state import stack_states
from hot_tpu_torch.utils.config import config_from_overrides as t_overrides

from test_torch_batch import _batch_against_singles, _with_E
from test_torch_batch_solvers import (COMPOSED, CONFIG3, DT, MG_CASES, SPARSE, VMAP_CASES,
                                      _shifted, check_against_hot_tpu_vmap)
from test_torch_ref import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", [c for c in VMAP_CASES if c not in MG_CASES])
def test_batch_matches_hot_tpu_vmap(case):
    check_against_hot_tpu_vmap(case)


DROP_OPTIONS = {
    "jacobi_cg": dict(CONFIG3, **{"solver.multigrid.smoother": "jacobi",
                                  "solver.multigrid.coarse_solver": "cg"}),
    "colored_gs_smoother": dict(CONFIG3, **{"solver.multigrid.smoother": "colored_gs",
                                            "solver.multigrid.coarse_solver": "smoother"}),
    "lagged": dict(CONFIG3, **{"solver.multigrid.rap_refresh": "lagged"}),
    "quadrature": dict(CONFIG3, **{"solver.multigrid.coarsening": "quadrature"}),
    "mf_colored_gs_cg": {"solver.preconditioner": "multigrid",
                         "solver.multigrid.smoother": "colored_gs",
                         "solver.multigrid.coarse_solver": "cg"},
    "sparse_composed_cg": dict(SPARSE, **dict(COMPOSED, **{
        "solver.multigrid.coarse_solver": "cg"})),
    "minres_block_jacobi": {"solver.linear_solver": "minres"},
}


@pytest.mark.parametrize("case", list(DROP_OPTIONS))
def test_drop_batch_options_match_singles(case):
    """The other smoothers and coarse solves, lagged rap_refresh, quadrature
    coarsening, and MINRES under block-Jacobi on the 24^2 block drop, three
    stiffnesses (the stiffest moved by a tile and a third of a cell, so its
    active nodes, rows and tiles differ and the others are padded), 2
    steps: exact counts, x within 1e-12 and F within 1e-12. The coarse CG
    (tol 1e-2) makes the V-cycle a nonlinear function of its input, and the
    padded members' row sums round differently from their lone runs' (the
    padding's zeros change the reduction's blocking): under Jacobi
    smoothing, with 12-20 coarse iterations, x stays within 6e-13 and F
    (dt grad v: 24 times x's sensitivity to v at 24^2) parts by up to
    7.3e-11, so that case holds F to 1e-10."""
    scene = tbuild("block_drop_2d", device="cpu", res=24, dtype=torch.float64)
    cfg = t_overrides(scene["cfg"], DROP_OPTIONS[case])
    base = stress_state(scene["state"], cfg)
    members = [_with_E(base, E) for E in (1e4, 1e6)]
    members.append(_shifted(_with_E(base, 1e7), -(sparse.TILE + 0.3), cfg.dx))
    stats = _batch_against_singles(scene, members, 2, 2e-3, cfg,
                                   f_tol=1e-10 if case == "jacobi_cg" else 1e-12)
    assert sum(sum(s.newton_iters) for s in stats) > 0


B1_CASES = dict({k: v[0] for k, v in VMAP_CASES.items()}, **DROP_OPTIONS)


@pytest.mark.parametrize("case", list(B1_CASES))
def test_batch_of_one_is_the_single_path(case):
    """A batch of one member steps bit for bit as the state alone (x, v, F,
    and every count), 2 steps."""
    scene = tbuild("block_drop_2d", device="cpu", res=24, dtype=torch.float64)
    cfg = t_overrides(scene["cfg"], B1_CASES[case])
    single = _with_E(stress_state(scene["state"], cfg), 1e6)
    batch = stack_states([single])
    kw = dict(cfg=cfg, model=scene["model"], colliders=scene["colliders"])
    for k in range(2):
        single, s = t_advance(single, DT, k * DT, **kw)
        batch, b = t_advance(batch, DT, k * DT, **kw)
        for field in s._fields:
            assert getattr(b, field) == [getattr(s, field)], field
        for f in ("x", "v", "Ff", "Cf"):
            assert torch.equal(getattr(batch, f)[0], getattr(single, f)), f


def test_plain_kernels_on_a_batch_tile_grid_match_singles(rng):
    """fused_linearize_plain and fused_apply_plain on a batch's tile grid
    (three members of the 16^3 bar, each on its own tile set) equal one call
    per member on the member's own tile grid, to 1e-13 of the largest entry."""
    state = tbuild("twisting_bar_3d", device="cpu", res=16, ppc=2, dtype=torch.float64)["state"]
    dx, res, n = 1.0 / 16, (16,) * 3, state.n
    xs = [_shifted(state, cells, dx).x for cells in (-(sparse.TILE + 0.3), 0.0, 2.6)]
    tg = sparse.build_tile_grid(torch.stack(xs), dx, res, capacity=512)
    assert len({tuple(t[:c].tolist()) for t, c in zip(tg.tile_ids, tg.counts)}) == 3
    model = MODEL_REGISTRY["fixed_corotated"]
    got_v = torch.as_tensor(rng.standard_normal((3, tg.n_cnodes, 3)))
    got_w = torch.as_tensor(rng.standard_normal((3, tg.n_cnodes, 3)))
    F = [state.F + torch.as_tensor(0.1 * rng.standard_normal((n, 3, 3))) for _ in xs]
    mus = [state.mu * 3.0 ** k for k in range(3)]
    lin = fl.fused_linearize(got_v, fa.soa(torch.stack(xs), 1), dx, res,
                             fa.soa(torch.stack(F), 1), torch.stack(mus),
                             torch.stack([state.lam] * 3), torch.stack([state.V0] * 3), 2e-3,
                             model, tgrid=tg)
    df = fa.fused_apply(got_w, fa.soa(torch.stack(xs), 1), dx, res, fa.soa(torch.stack(F), 1),
                        *lin[1:], torch.stack([state.V0] * 3), 2e-3, tgrid=tg)
    for b in range(3):
        own = tg.member(b)
        m = own.n_cnodes - 1

        def own_rows(t):
            return torch.cat([t[b, :m], t[b, -1:]])

        want = fl.fused_linearize(own_rows(got_v), fa.soa(xs[b]), dx, res, fa.soa(F[b]),
                                  mus[b], state.lam, state.V0, 2e-3, model, tgrid=own)
        want_df = fa.fused_apply(own_rows(got_w), fa.soa(xs[b]), dx, res, fa.soa(F[b]),
                                 *want[1:], state.V0, 2e-3, tgrid=own)
        for g, w in zip((own_rows(lin[0]),) + tuple(t[b] for t in lin[1:]) + (own_rows(df),),
                        want + (want_df,)):
            assert g.shape == w.shape
            assert float((g - w).abs().max()) <= 1e-13 * float(w.abs().max())
        # the padding slots hold nothing
        assert float(lin[0][b, m:-1].abs().sum()) == 0.0
