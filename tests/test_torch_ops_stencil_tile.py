"""The band-tile designs of B2 (spherical multi-tracer FV step), B5 (flat
multi-tracer FV step) and B6 (one flat field), on the CPU: ``fv_design``'s choice and geometry from the
shape, and a torch emulation of ``csrc/fv_tile.cuh``'s order (the clipped
span copies into a NaN-filled stage, the clamped reads, the in-place
Courant numbers of the spherical form, then per column the zonal sweep of
each copied row and the meridional sweep streaming down the band) against
the plain version and the JAX package's Pallas kernels in interpret
mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.online import advection as jadv
from climsim_tpu.ops.pallas_stencil import (_fv_advect_tracers_fwd_impl,
                                            _fv_sphere_fwd_impl)
from climsim_tpu.ops.pallas_stencil import fv_advect_levels as jlevels
from climsim_tpu_torch.online import advection as tadv
from climsim_tpu_torch.online.advection import metric_rows
from climsim_tpu_torch.ops.pallas_stencil import (fv_design, fv_tile_smem,
                                                  fv_tracers_reference,
                                                  fv_tracers_sphere_reference)

DT = 1200.0
DT_DX, DT_DY = 0.4, 0.3
SMEM_MAX, SM_SMEM, SM_THREADS = 232448, 233472, 2048


# ------------------------------------------------------------ fv_design

# (kind, ntrac, L, nlat, nlon) -> fv_design on 132 SMs: the main path's B2,
# B5 (the v6_flat arm's: B2's geometry) and B6; B5 on the 384-column grid
# (bands of 8, a group a tracer); nlat 20, whose two bands even out to 10 rows; nlat 23, whose
# second band is one row short (a ragged last band); both pole clamps in
# one band (nlat 5 < R + 4); the 384-column grid (two bands of 8); a
# 0.25-degree grid's 1,440 columns (the most rows halved until the tile
# fits: B2 12 -> 1, B6 12 -> 6; two passes of 360 pairs); nlon 182 and 26
# (not a multiple of 4: the first design)
@pytest.mark.parametrize("shape,want", [
    (("b2", 6, 60, 120, 180), dict(design="tile", R=12, groups=3,
                                   threads=288, smem=90128, blocks=264)),
    (("b5", 6, 60, 120, 180), dict(design="tile", R=12, groups=3,
                                   threads=288, smem=90128, blocks=264)),
    (("b6", 1, 60, 120, 180), dict(design="tile", R=12, groups=1,
                                   threads=96, smem=32528, blocks=600)),
    (("b5", 6, 60, 16, 24), dict(design="tile", R=8, groups=6, threads=192,
                                 smem=9056, blocks=120)),
    (("b2", 6, 60, 20, 180), dict(design="tile", R=10, groups=3,
                                  threads=288, smem=78608, blocks=120)),
    (("b2", 6, 60, 23, 180), dict(design="tile", R=12, groups=3,
                                  threads=288, smem=90128, blocks=120)),
    (("b6", 1, 60, 5, 180), dict(design="tile", R=5, groups=1, threads=96,
                                 smem=17408, blocks=60)),
    (("b2", 6, 60, 16, 24), dict(design="tile", R=8, groups=6, threads=192,
                                 smem=9056, blocks=120)),
    (("b2", 6, 60, 120, 1440), dict(design="tile", R=1, groups=1,
                                    threads=384, smem=213248, blocks=132)),
    (("b6", 1, 60, 120, 1440), dict(design="tile", R=6, groups=1,
                                    threads=384, smem=155648, blocks=132)),
    (("b2", 6, 60, 120, 182), dict(design="first", R=8, groups=1,
                                   threads=256, smem=26208, blocks=900)),
    (("b6", 1, 60, 16, 26), dict(design="first", R=8, groups=1,
                                 threads=256, smem=3744, blocks=120)),
    (("b5", 6, 60, 120, 182), dict(design="first", R=8, groups=1,
                                   threads=256, smem=26208, blocks=900))])
def test_fv_design(shape, want):
    """The band tile where nlon % 4 == 0 and a tile fits 232,448 bytes
    (bands of at most 12 rows, the most halved until the tile fits, then
    evened out; a thread a pair of columns; tracer groups, the largest
    divisor of ntrac within 512 threads; as many CTAs a SM as its 233,472
    bytes and 2,048 threads hold, at most one a tile), else the first
    design."""
    assert fv_design(*shape) == want


@pytest.mark.parametrize("kind,ntrac", [("b2", 6), ("b2", 1), ("b6", 1),
                                        ("b5", 6)])
@pytest.mark.parametrize("nlat,nlon", [(120, 180), (20, 180), (5, 24),
                                       (16, 24), (120, 1440), (361, 720),
                                       (120, 4096)])
def test_fv_design_fits_the_card(kind, ntrac, nlat, nlon):
    """Every tile design fits a block's shared memory and the SMs: its
    shared memory is fv_tile_smem's at its R, at most 232,448 bytes; its
    bands hold at most 12 rows and differ by at most one row bar the last;
    its groups divide the tracers and each group's threads cover the
    column pairs in whole warps, at most 512 a block; its CTAs are at most
    one a tile and as many a SM as the SM's memory and threads hold."""
    d = fv_design(kind, ntrac, 60, nlat, nlon, sms=132)
    if d["design"] == "first":
        assert fv_tile_smem(ntrac, nlon, 1) > SMEM_MAX
        return
    R, groups = d["R"], d["groups"]
    assert d["smem"] == fv_tile_smem(ntrac, nlon, R) <= SMEM_MAX
    bands = -(-nlat // R)
    assert R <= 12 and R == -(-nlat // bands)
    assert ntrac % groups == 0 and d["threads"] % (32 * groups) == 0
    tpg = d["threads"] // groups
    assert d["threads"] <= 512 and tpg * -(-(nlon // 2) // tpg) >= nlon // 2
    per_sm = min(SM_SMEM // (d["smem"] + 1024), SM_THREADS // d["threads"])
    assert 1 <= d["blocks"] <= min(132 * per_sm, bands * 60)


def test_fv_design_refuses_what_the_tile_cannot_take():
    """Unaligned tensors run the first design; B6 takes one field and B5
    at least one; an unknown kernel raises; a tile that fits nowhere runs
    the first design."""
    for kind, ntrac in (("b2", 6), ("b5", 6), ("b6", 1)):
        assert fv_design(kind, ntrac, 60, 120, 180,
                         aligned=False)["design"] == "first"
    assert fv_design("b2", 60, 60, 120, 1440)["design"] == "first"
    assert fv_design("b5", 60, 60, 120, 1440)["design"] == "first"
    for bad in (("b6", 2), ("b5", 0), ("b1", 1)):
        with pytest.raises(ValueError):
            fv_design(bad[0], bad[1], 60, 120, 180)


# ------------------------------------------------------------ emulation


def _tile_emulation(qs, u, v, R, rows=None, dt=None):
    """csrc/fv_tile.cuh's kernel, tile by tile in torch, every column of a
    band at once (each column's operations are those the kernel's thread
    does for it, two columns a thread, with the limiter's copysign and
    the upwind face's operand selection): the stage filled as the bulk
    copies fill it (NaN where no copy lands, so a read of an uncopied row
    shows in the output); for the spherical form
    (``rows``: MetricRows) the zonal Courant numbers formed in place over
    u's rows and the faces' over v's rows in descending order; then per
    tracer and column the zonal sweep of each copied row (read through
    the clamped row index) feeding the meridional sweep down the band.
    The flat form takes ``dt`` = (dt_dx, dt_dy). qs [ntrac, L, nlat,
    nlon]."""
    ntrac, L, nlat, nlon = qs.shape
    sphere = rows is not None
    nan = float("nan")
    out = torch.full_like(qs, nan)
    i = torch.arange(nlon)
    im1, ip1 = (i - 1) % nlon, (i + 1) % nlon
    im2, ip2 = (im1 - 1) % nlon, (ip1 + 1) % nlon

    def slope(qm, q0, qp):
        dqc, dqp, dqm = 0.5 * (qp - qm), qp - q0, q0 - qm
        mag = torch.minimum(dqc.abs(), 2.0 * torch.minimum(dqp.abs(),
                                                           dqm.abs()))
        return torch.where(dqp * dqm > 0.0, torch.copysign(mag, dqc),
                           torch.zeros_like(mag))

    def upwind(w, c, qm, q0, sm, s0):
        pos = w >= 0.0
        k = 0.5 * (1.0 + torch.where(pos, -c, c))
        return w * (torch.where(pos, qm, q0) + k * torch.where(pos, sm, -s0))

    for lev in range(L):
        for r0 in range(0, nlat, R):
            nrow = min(R, nlat - r0)
            lo, hi = max(r0 - 2, 0), min(r0 + nrow + 1, nlat - 1)
            vhi = min(r0 + nrow, nlat - 1)
            su = torch.full((R + 4, nlon), nan)
            sv = torch.full((R + 1, nlon), nan)
            sq = torch.full((ntrac, R + 4, nlon), nan)
            su[lo - r0 + 2:hi - r0 + 3] = u[lev, lo:hi + 1]
            sv[:vhi - r0 + 1] = v[lev, r0:vhi + 1]
            sq[:, lo - r0 + 2:hi - r0 + 3] = qs[:, lev, lo:hi + 1]
            if sphere:
                for g in range(lo, hi + 1):
                    su[g - r0 + 2] = torch.clamp(su[g - r0 + 2]
                                                 * rows.dtdx[g],
                                                 -rows.cfl_max, rows.cfl_max)
                for s in range(nrow, -1, -1):
                    f = r0 + s
                    sv[s] = torch.clamp(sv[min(f, nlat - 1) - r0]
                                        * rows.cf_fac[f], -rows.cfl_max,
                                        rows.cfl_max)
            for t in range(ntrac):
                def zonal(g):
                    q, w = sq[t, g - r0 + 2], su[g - r0 + 2]
                    qmm, qm, q0, qp, qpp = q[im2], q[im1], q, q[ip1], q[ip2]
                    w0, w1 = w, w[ip1]
                    sl, s0, sr = (slope(qmm, qm, q0), slope(qm, q0, qp),
                                  slope(q0, qp, qpp))
                    if sphere:
                        f0, f1 = (upwind(w0, w0, qm, q0, sl, s0),
                                  upwind(w1, w1, q0, qp, s0, sr))
                        return q0 - ((f1 - f0) - q0 * (w1 - w0))
                    f0 = upwind(w0, w0 * dt[0], qm, q0, sl, s0)
                    f1 = upwind(w1, w1 * dt[0], q0, qp, s0, sr)
                    return q0 - dt[0] * ((f1 - f0) - q0 * (w1 - w0))

                def face(f, qm, q0, sm, s0):
                    if sphere:
                        c = sv[f - r0]
                        return (rows.wf[f] * upwind(c, c, qm, q0, sm, s0),
                                rows.wf[f] * c)
                    w = sv[min(f, nlat - 1) - r0]
                    if f in (0, nlat):
                        return torch.zeros(nlon), torch.zeros(nlon)
                    return upwind(w, w * dt[1], qm, q0, sm, s0), w

                zc = zonal(r0)
                zb = zonal(r0 - 1) if r0 >= 1 else zc
                za = zonal(r0 - 2) if r0 >= 2 else zb
                zd = zonal(r0 + 1) if r0 + 1 < nlat else zc
                sb, sc = slope(za, zb, zc), slope(zb, zc, zd)
                fa = face(r0, zb, zc, sb, sc)
                for j in range(r0, r0 + nrow):
                    ze = zonal(j + 2) if j + 2 < nlat else zd
                    sd = slope(zc, zd, ze)
                    fb = face(j + 1, zc, zd, sc, sd)
                    k = rows.wc[j] if sphere else dt[1]
                    out[t, lev, j] = zc - k * ((fb[0] - fa[0])
                                               - zc * (fb[1] - fa[1]))
                    zc, zd, sc, fa = zd, ze, sd, fb
    return out


def _sphere_case(ntrac, L, nlat, nlon, seed):
    """Winds strong enough that the Courant clip binds in both sweeps (as
    tests/test_torch_ops_stencil.py's on 16 x 24, scaled with the cell
    size)."""
    rng = np.random.default_rng(seed)
    lats = np.linspace(-85.0, 85.0, nlat)
    qs = rng.normal(1, 0.3, (ntrac, L, nlat, nlon)).astype(np.float32)
    u = rng.normal(0, 150 * 24 / nlon, (L, nlat, nlon)).astype(np.float32)
    v = rng.normal(0, 700 * 16 / nlat, (L, nlat, nlon)).astype(np.float32)
    return (qs, u, v, jadv.spherical_metric(lats, nlon, DT),
            tadv.spherical_metric(lats, nlon, DT))


# (L, nlat, nlon, R): a ragged last band of 4 rows (nlat 20, R 8), both
# pole clamps in one band (nlat 5 < R + 4), the 384-column grid at
# fv_design's R, bands of 3 (interior bands whose span starts past row 0),
# R 1 (the tile halved as far as it goes) and fv_design's ragged nlat 23
TILE_SHAPES = [(2, 20, 24, 8), (2, 5, 16, 8), (1, 16, 24, 8), (2, 20, 12, 3),
               (1, 9, 8, 1), (1, 23, 8, 12)]


@pytest.mark.parametrize("L,nlat,nlon,R", TILE_SHAPES)
@pytest.mark.parametrize("form", ["sphere", "flat", "flat_tracers"])
def test_tile_order_is_the_plain_step(form, L, nlat, nlon, R):
    """The band tile's copies, clamped reads and streamed sweeps compute
    the plain step and the JAX package's Pallas kernel in interpret mode
    (B2's _fv_sphere_fwd_impl, B6's fv_advect_levels, B5's
    _fv_advect_tracers_fwd_impl with 6 tracers) to 2e-6, as
    tests/test_torch_ops_stencil.py holds the plain version to them; no
    read lands outside the copied rows."""
    if form == "sphere":
        qs, u, v, jm, tm = _sphere_case(2, L, nlat, nlon, seed=nlat + R)
        rows = metric_rows(tm, "cpu")
        cz = np.abs(u * jm.dtdx[None, :, None]) > jm.cfl_max
        vf = np.concatenate([v, v[:, -1:]], axis=1)
        cm = np.abs(vf * jm.cf_fac[None, :, None]) > jm.cfl_max
        assert cz.any() and cm.any()
        got = _tile_emulation(*map(torch.as_tensor, (qs, u, v)), R,
                              rows=rows)
        plain = fv_tracers_sphere_reference(
            *map(torch.as_tensor, (qs, u, v)), tm)
        jax_out = np.asarray(_fv_sphere_fwd_impl(
            jnp.asarray(qs), jnp.asarray(u), jnp.asarray(v), jm,
            interpret=True))
    else:
        ntrac = 6 if form == "flat_tracers" else 1
        rng = np.random.default_rng(nlat + R)
        q = np.abs(rng.normal(1, 0.3, (ntrac, L, nlat, nlon))).astype(
            np.float32)
        u, v = (rng.normal(0, 1.0, (L, nlat, nlon)).astype(np.float32)
                for _ in range(2))
        got = _tile_emulation(*map(torch.as_tensor, (q, u, v)), R,
                              dt=(DT_DX, DT_DY))
        plain = fv_tracers_reference(*map(torch.as_tensor, (q, u, v)),
                                     DT_DX, DT_DY)
        if ntrac == 1:
            got, plain = got[0], plain[0]
            jax_out = np.asarray(jlevels(jnp.asarray(q[0]), jnp.asarray(u),
                                         jnp.asarray(v), DT_DX, DT_DY,
                                         interpret=True))
        else:
            jax_out = np.asarray(_fv_advect_tracers_fwd_impl(
                jnp.asarray(q), jnp.asarray(u), jnp.asarray(v), DT_DX,
                DT_DY, True))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=2e-6, atol=2e-6)
