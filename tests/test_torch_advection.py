"""The port's single-device transport operators against the JAX package's
``online/advection.py`` on the CPU: the flat FV step and its halo form,
semi-Lagrangian transport (scalar and per-row factors) and its halo
monitor, the omega diagnosis (flat and spherical) and the vertical
column transport."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.online import advection as jadv
from climsim_tpu_torch.online import advection as tadv

NLEV, NLAT, NLON = 4, 8, 12
NCOL = NLAT * NLON


def _winds(seed, su, sv):
    rng = np.random.default_rng(seed)
    q = np.abs(rng.normal(1, 0.3, (NLEV, NLAT, NLON))).astype(np.float32)
    u = rng.normal(0, su, (NLEV, NLAT, NLON)).astype(np.float32)
    v = rng.normal(0, sv, (NLEV, NLAT, NLON)).astype(np.float32)
    return q, u, v


def _per_level(fn, *arrays):
    """The JAX function vmapped over the level axis, as HybridLoop does."""
    return np.asarray(jax.vmap(fn)(*[jnp.asarray(a) for a in arrays]))


def test_fv_advect_2d_matches_jax():
    """The flat FV step on every level, float32 to 1e-6."""
    q, u, v = _winds(1, 1.0, 1.0)
    got = tadv.fv_advect_2d(*map(torch.as_tensor, (q, u, v)), 0.4, 0.3)
    want = _per_level(lambda a, b, c: jadv.fv_advect_2d(a, b, c, 0.4, 0.3),
                      q, u, v)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("edges", [(True, False), (False, True),
                                   (False, False)])
def test_fv_advect_2d_halo_matches_jax(edges):
    """The halo form on a band of 4 rows with its 2 ghost rows each side,
    as a latitude-sharded step calls it, with and without a pole edge."""
    q, u, v = _winds(2, 1.0, 1.0)
    sl = slice(1, 9)
    args = [a[0, sl] for a in (q, u, v)]
    got = tadv.fv_advect_2d_halo(*map(torch.as_tensor, args), 0.4, 0.3,
                                 *edges)
    want = jadv.fv_advect_2d_halo(*map(jnp.asarray, args), 0.4, 0.3,
                                  *edges)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_semi_lagrangian_scalar_matches_jax():
    """Flat raster: departures up to several cells in both directions,
    across the periodic seam and beyond the poles (clamped)."""
    q, u, v = _winds(3, 6.0, 3.0)
    got = tadv.semi_lagrangian_2d(*map(torch.as_tensor, (q, u, v)), 0.5,
                                  0.5)
    want = _per_level(
        lambda a, b, c: jadv.semi_lagrangian_2d(a, b, c, 0.5, 0.5), q, u, v)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_semi_lagrangian_per_row_matches_jax():
    """The sphere: per-row factors [nlat, 1] from the metric, winds in
    m/s; a long step (12,000 s) so that departures cross cells in both
    directions."""
    q, u, v = _winds(4, 60.0, 300.0)
    bands = np.linspace(-80.0, 80.0, NLAT)
    m = jadv.spherical_metric(bands, NLON, 12000.0)
    rows = tadv.metric_rows(tadv.spherical_metric(bands, NLON, 12000.0),
                            "cpu")
    got = tadv.semi_lagrangian_2d(*map(torch.as_tensor, (q, u, v)),
                                  rows.dtdx[:, None], rows.dtdy[:, None])
    want = _per_level(lambda a, b, c: jadv.semi_lagrangian_2d(
        a, b, c, m.dtdx[:, None], m.dtdy[:, None]), q, u, v)
    assert np.abs(u * m.dtdx[:, None]).max() > 1.0     # crosses cells
    assert np.abs(v * m.dtdy[:, None]).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_halo_clip_fraction_matches_jax():
    _, _, v = _winds(5, 1.0, 2.0)
    for dt_dy in (0.5, np.linspace(0.2, 0.9, NLAT)[:, None].astype(
            np.float32)):
        got = tadv.semi_lagrangian_halo_clip_fraction(
            torch.as_tensor(v), torch.as_tensor(dt_dy))
        want = jadv.semi_lagrangian_halo_clip_fraction(jnp.asarray(v),
                                                       jnp.asarray(dt_dy))
        assert 0.0 < float(got) < 1.0
        assert float(got) == pytest.approx(float(want), abs=1e-7)


def test_vertical_advect_column_matches_jax():
    rng = np.random.default_rng(6)
    q = np.abs(rng.normal(1e-3, 3e-4, (NCOL, NLEV))).astype(np.float32)
    w = rng.normal(0, 30, (NCOL, NLEV + 1)).astype(np.float32)
    dp = rng.uniform(500, 3000, (NCOL, NLEV)).astype(np.float32)
    got = tadv.vertical_advect_column(*map(torch.as_tensor, (q, w, dp)), 1.0)
    want = jadv.vertical_advect_column(*map(jnp.asarray, (q, w, dp)), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("geometry", ["flat", "sphere"])
def test_diagnose_omega_matches_jax(geometry):
    """Omega from the horizontal divergence: the flat branch on Courant
    winds, the spherical one on winds in m/s with the metric. The column
    integral is a cumulative sum over 4 levels (rtol 1e-5 of its scale)."""
    rng = np.random.default_rng(7)
    lat = rng.uniform(-85, 85, NCOL).astype(np.float32)
    lon = rng.uniform(0, 360, NCOL).astype(np.float32)
    gather, scatter = jadv.build_proxy_grid(lat, lon, NLAT, NLON)
    scale = 0.3 if geometry == "flat" else 20.0
    u = rng.normal(0, scale, (NCOL, NLEV)).astype(np.float32)
    v = rng.normal(0, scale, (NCOL, NLEV)).astype(np.float32)
    dp = rng.uniform(500, 3000, (NCOL, NLEV)).astype(np.float32)
    bands = np.sort(lat).reshape(NLAT, NLON).mean(1)
    jm = jadv.spherical_metric(bands, NLON, 1200.0) \
        if geometry == "sphere" else None
    tm = tadv.spherical_metric(bands, NLON, 1200.0) \
        if geometry == "sphere" else None
    got = tadv.diagnose_omega(torch.as_tensor(u), torch.as_tensor(v), 0.7,
                              0.6, torch.as_tensor(dp),
                              torch.as_tensor(gather),
                              torch.as_tensor(scatter), NLAT, NLON, tm)
    want = np.asarray(jadv.diagnose_omega(
        jnp.asarray(u), jnp.asarray(v), 0.7, 0.6, jnp.asarray(dp),
        jnp.asarray(gather), jnp.asarray(scatter), NLAT, NLON, jm))
    assert got.shape == (NCOL, NLEV + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
