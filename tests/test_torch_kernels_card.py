"""The block-diagonal kernel (ops/fused_block_diag.py, csrc/fused_block_diag.cu)
against its plain version on the card, in every case its callers launch it:
fp32 and fp64, d = 2 and 3, the quadratic and cubic stencil, the dense grid
and the tile grid's compact nodes, a batch of members, a rank's slab, and an
unprojected Hessian context whose A has negative eigenvalues. Each case
runs both scatter paths: the shared-memory window and the global atomics
alone (window_nodes 0).

Run on a machine with a CUDA card and no jax (tests/conftest.py imports
jax, so leave it out):

    python -m pytest --noconftest -m cuda -q tests/test_torch_kernels_card.py

Without a card the tests skip. ``block_diag_inputs`` builds the cases for
the host-compiled kernel's tests too (tests/test_torch_csrc_host.py).

Tolerance, as fused_apply's card test has it: 2e-5 in fp32 (atomics in any
order, FMA contraction) and 1e-10 in fp64, relative to each node's block's
largest entry. The cubic cases floor that scale at CUBIC_FLOOR times the
largest block's. Their fringe nodes get only the far tails of the stencil's
weights, whose values come out of cancellation (-a^3/6 + a^2 - 2a + 4/3
near a = 2), so a fringe block is many roundings of its own size. The plain
version in fp32 differs from its fp64 self there by 2.1e-4 of such a block
(3d-cubic at 16^3; 6.1e-7 in the quadratic case). The same source compiled
for the host, without FMA, matches the plain version without the floor
(1.3e-15 in fp64, 8.7e-7 in fp32); compiled by nvcc, whose FMA contraction
rounds the cancelling sums differently, it does not (5.2e-2 in fp32 and
9.1e-9 in fp64 at 32^3 on an H100), and it does with the floor.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hot_tpu_torch.grid import sparse
from hot_tpu_torch.models.constitutive import MODEL_REGISTRY
from hot_tpu_torch.ops import fused_apply as fa
from hot_tpu_torch.ops import fused_block_diag as fbd
from hot_tpu_torch.ops import fused_linearize as fl
from hot_tpu_torch.parallel.sharded import make_slab, owner_of
from hot_tpu_torch.scenes import build_scene

DT = 2e-3
TOL = {torch.float32: 2e-5, torch.float64: 1e-10}
# the cubic cases' floor on a block's scale, in units of the largest block's
# (see the module doc)
CUBIC_FLOOR = 1e-4
SCENES = {3: "twisting_bar_3d", 2: "block_drop_2d"}
# name: (d, kernel, tile grid, members, what else)
CASES = {
    "3d": (3, "quadratic", False, 0, None),
    "2d": (2, "quadratic", False, 0, None),
    "3d-cubic": (3, "cubic", False, 0, None),
    "2d-cubic": (2, "cubic", False, 0, None),
    "3d-tiles": (3, "quadratic", True, 0, None),
    "2d-tiles": (2, "quadratic", True, 0, None),
    "3d-batch4": (3, "quadratic", False, 4, None),
    "3d-batch4-tiles": (3, "quadratic", True, 4, None),
    "3d-slab": (3, "quadratic", False, 0, "slab"),
    "3d-indefinite": (3, "quadratic", False, 0, "indefinite"),
    "2d-indefinite": (2, "quadratic", False, 0, "indefinite"),
    "3d-permuted": (3, "quadratic", False, 0, "permuted"),
}


def block_diag_inputs(case: str, rng, dtype, device="cpu", res=None):
    """Keyword arguments of fused_block_diag for the named case (CASES):
    the scene's particles (res per axis: 16 in 3D, 24 in 2D by default; 8 a
    cell in 3D), F perturbed by seeded noise, and the Hessian context of the
    plain linearize at a random grid velocity (projected to SPD unless the
    case is indefinite: then F is perturbed five times as much and A and
    b+- keep their negative eigenvalues)."""
    d, kernel, tiles, members, extra = CASES[case]
    res = res or {3: 16, 2: 24}[d]
    kw = dict(res=res, ppc=8) if d == 3 else dict(res=res)
    state = build_scene(SCENES[d], device="cpu", dtype=torch.float64, **kw)["state"]
    dx, grid = 1.0 / res, (res,) * d
    x, n = state.x, state.n
    noise = 0.5 if extra == "indefinite" else 0.1
    per = dict(F=state.F + torch.as_tensor(noise * rng.standard_normal((n, d, d))),
               mu=state.mu, lam=state.lam, V0=state.V0)
    if extra == "permuted":
        tail = torch.arange(n // 2, n)
        perm = torch.cat([torch.arange(n // 2),
                          tail[torch.from_numpy(rng.permutation(len(tail)))]])
        x, per = x[perm], {k: t[perm] for k, t in per.items()}
    if extra == "slab":
        slab = make_slab(grid, 4, 1)
        own = owner_of(x, dx, grid, 4) == 1
        x, per = slab.local_x(x[own], dx), {k: t[own] for k, t in per.items()}
        grid = slab.ext_res
    if members:
        shifts = torch.zeros((members, 1, d), dtype=x.dtype)
        shifts[:, 0, 1] = (torch.arange(members) - members // 2) * 0.55 * dx
        x = x + shifts
        per = {k: torch.stack([t * (1.0 + 0.5 * b) if k in ("mu", "lam") else t
                               for b in range(members)]) for k, t in per.items()}
    lead = 1 if members else 0
    tgrid = sparse.build_tile_grid(x, dx, grid, capacity=10 ** 6) if tiles else None
    nodes = fbd.nodes_of(grid, tgrid)
    v = torch.as_tensor(rng.standard_normal(tuple(x.shape[:-2]) + (nodes, d)))
    xs, F = fa.soa(x, lead), fa.soa(per["F"], lead)
    ctx = fl.fused_linearize_plain(v, xs, dx, grid, F, per["mu"], per["lam"], per["V0"], DT,
                                   MODEL_REGISTRY["fixed_corotated"],
                                   project=extra != "indefinite", kernel=kernel,
                                   tgrid=tgrid)[1:]
    on = lambda t: t.to(device, dtype)  # noqa: E731
    if tgrid is not None:
        tgrid = dataclasses.replace(tgrid, tile_ids=tgrid.tile_ids.to(device),
                                    lookup=tgrid.lookup.to(device))
    return dict(x=on(xs), dx=dx, res=grid, F=on(F),
                **{k: on(t) for k, t in zip(("U", "V", "A", "b_plus", "b_minus"), ctx)},
                V0=on(per["V0"]), dt=DT, kernel=kernel, tgrid=tgrid)


def assert_blocks_close(got, want, tol, floor=0.0):
    """Each node's (d, d) block within tol of its largest entry, or of
    `floor` times the largest block's where that is more (a block with no
    contribution exactly 0)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    err = (got - want).abs().amax((-1, -2)).double()
    scale = want.abs().amax((-1, -2)).double()
    scale = torch.where(scale > 0, scale.clamp(min=floor * float(scale.max())), scale)
    bad = (err > tol * scale) | ((scale == 0) & (err > 0))
    worst = float((err / scale.clamp(min=1e-300)).max())
    assert not bool(bad.any()), f"{int(bad.sum())} blocks off; worst {worst:.3e} > {tol:.1e}"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_block_diag_kernel_matches_plain(cuda_device, case, dtype):
    """The kernel's K == fused_block_diag_plain's on the same card tensors,
    through the window and through the global atomics alone."""
    rng = np.random.default_rng(7)
    kw = block_diag_inputs(case, rng, dtype, cuda_device, res={3: 32, 2: 64}[CASES[case][0]])
    want = fbd.fused_block_diag_plain(**kw)
    floor = CUBIC_FLOOR if kw["kernel"] == "cubic" else 0.0
    for window_nodes in (None, 0):
        got = fbd.fused_block_diag_cuda(**kw, window_nodes=window_nodes)
        assert_blocks_close(got, want, TOL[dtype], floor)
    assert bool(want.abs().amax((-1, -2)).gt(0).any())
