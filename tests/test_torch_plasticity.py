"""The port's plasticity return maps against hot_tpu's vmapped ones (fp64,
CPU), and the properties tests/test_models.py checks of hot_tpu's.

The inputs, made from seeded numpy, hold F near the identity, strained past
yield, inverted (det F < 0), expanded (tr eps > 0, the Drucker-Prager cone
tip) and compressed, with per-particle Lame parameters over two decades and
some yield stresses infinite. Projected F and the snow jp_ratio must agree
within 1e-12 relative to the largest entry (the same arithmetic; only the
summation order of three terms differs). hot_tpu's svd runs jitted
(test_torch_ref.jitted_hot_tpu_svd).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hot_tpu.models import plasticity as jpl
from hot_tpu_torch.models import plasticity as tpl
from hot_tpu_torch.models.constitutive import lame_parameters
from hot_tpu_torch.ops.svd import svd

from test_torch_ref import assert_close, jitted_hot_tpu_svd, one_torch_thread  # noqa: F401

TOL = 1e-12
pytestmark = pytest.mark.usefixtures("jitted_hot_tpu_svd")
MU, LAM = lame_parameters(1e4, 0.3)
ALPHA = tpl.DruckerPrager.alpha_from_friction_angle(30.0)


def _cases(rng, d, n=24):
    """F (5n, d, d) of the five kinds, and per-particle mu, lam and yield."""
    eye = np.eye(d)[None]
    noise = lambda s: s * rng.standard_normal((n, d, d))  # noqa: E731
    near = eye + noise(0.002)
    inverted = near.copy()
    inverted[:, :, 0] *= -1.0
    F = np.concatenate([near, eye + noise(0.5), inverted, 1.3 * eye + noise(0.05),
                        0.8 * eye + noise(0.05)])
    m = F.shape[0]
    E = 10.0 ** rng.uniform(4.0, 6.0, m)
    mu, lam = lame_parameters(E, 0.3)
    yield_stress = 10.0 ** rng.uniform(1.0, 3.0, m)
    yield_stress[::4] = np.inf
    return F, mu, lam, yield_stress


def _pair(name, F, mu, lam, ys):
    """(port, hot_tpu) results of return map `name` on the same inputs."""
    t = [torch.from_numpy(a) for a in (F, mu, lam, ys)]
    j = [jnp.asarray(a) for a in (F, mu, lam, ys)]
    if name == "von_mises":
        return (tpl.VonMisesHencky.project(*t),
                jax.vmap(jpl.VonMisesHencky.project)(*j))
    if name == "snow":
        return tpl.SnowPlasticity.project(t[0]), jax.vmap(jpl.SnowPlasticity.project)(j[0])
    alpha = jpl.DruckerPrager.alpha_from_friction_angle(30.0)
    return (tpl.DruckerPrager.project(t[0], t[1], t[2], ALPHA),
            jax.vmap(lambda f, m_, l_: jpl.DruckerPrager.project(f, m_, l_, alpha))(*j[:3]))


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("name", ["von_mises", "snow", "drucker_prager"])
def test_return_map_matches_hot_tpu(rng, name, d):
    F, mu, lam, ys = _cases(rng, d)
    assert (np.linalg.det(F) < 0).any()
    got, want = _pair(name, F, mu, lam, ys)
    if name == "snow":
        (got, got_jp), (want, want_jp) = got, want
        assert_close(got_jp, want_jp, TOL)
        assert bool(torch.isfinite(got_jp).all())
    assert bool(torch.isfinite(got).all())
    assert_close(got, want, TOL)
    # the inputs reach the yield branch and the elastic branch
    changed = (got - torch.from_numpy(F)).abs().amax((1, 2)) > 1e-6
    assert 0 < int(changed.sum()) < F.shape[0]


def test_alpha_matches_hot_tpu():
    assert ALPHA == pytest.approx(float(jpl.DruckerPrager.alpha_from_friction_angle(30.0)),
                                  rel=1e-15, abs=0.0)


def test_infinite_yield_stress_is_elastic(rng):
    """yield_stress = inf (make_particle_state's default): dg = -inf, and
    max(dg, 0) dev / |dev| must stay 0, not NaN. (An inverted F would come
    back with positive singular values, so det F > 0 here.)"""
    F, mu, lam, _ = _cases(rng, 3)
    F = F[F.shape[0] // 5: 2 * F.shape[0] // 5]     # strained past any finite yield
    F = F[np.linalg.det(F) > 0]
    ys = np.full(F.shape[0], np.inf)
    out = tpl.VonMisesHencky.project(torch.from_numpy(F), torch.from_numpy(mu[:len(F)]),
                                     torch.from_numpy(lam[:len(F)]), torch.from_numpy(ys))
    assert bool(torch.isfinite(out).all())
    assert_close(out, F, 1e-12)


def _random_F(rng, n, d, spread):
    return torch.eye(d, dtype=torch.float64)[None] + spread * torch.from_numpy(
        rng.standard_normal((n, d, d)))


def _hencky(F):
    _, s, _ = svd(F)
    eps = torch.log(torch.clamp(s.abs(), min=1e-9))
    tr = eps.sum(1)
    dev = eps - tr[:, None] / F.shape[-1]
    return tr, dev, torch.linalg.norm(dev, dim=1)


def test_von_mises_elastic_region_identity(rng):
    F = _random_F(rng, 20, 3, 1e-4)
    out = tpl.VonMisesHencky.project(F, MU, LAM, torch.full((20,), 1e9, dtype=F.dtype))
    assert_close(out, F.numpy(), 1e-9)


def test_von_mises_projects_to_yield_surface(rng):
    F = _random_F(rng, 20, 3, 0.4)
    tau_y = 100.0
    _, _, dev_norm = _hencky(tpl.VonMisesHencky.project(
        F, MU, LAM, torch.full((20,), tau_y, dtype=F.dtype)))
    assert bool((dev_norm <= tau_y / (2 * MU) + 1e-8).all())


def test_snow_clamps_singular_values(rng):
    out, jp = tpl.SnowPlasticity.project(_random_F(rng, 20, 3, 0.5))
    s = svd(out)[1].abs()
    assert bool((s <= 1.0 + 7.5e-3 + 1e-9).all() and (s >= 1.0 - 2.5e-2 - 1e-9).all())
    assert bool((jp > 0).all())


def test_drucker_prager_cone(rng):
    out = tpl.DruckerPrager.project(_random_F(rng, 30, 3, 0.4), MU, LAM, ALPHA)
    tr, _, dev_norm = _hencky(out)
    f_yield = dev_norm + ALPHA * tr * (3 * LAM + 2 * MU) / (2 * MU)
    assert bool(((f_yield <= 1e-6) | (dev_norm <= 1e-8)).all())
