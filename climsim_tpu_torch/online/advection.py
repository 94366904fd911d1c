"""Finite-volume and semi-Lagrangian tracer transport on the proxy grid.

Counterpart of ``climsim_tpu/online/advection.py``'s single-device
operators: the proxy-grid mapping (``build_proxy_grid``, ``to_grid``,
``to_columns``), the spherical metric, the MC-limited flux-form FV step on
the flat raster (``fv_advect_2d``, ``fv_advect_2d_halo``) and on the
sphere (``fv_advect_2d_sphere``, ``fv_advect_2d_sphere_halo``),
semi-Lagrangian transport (``semi_lagrangian_2d``, and
``semi_lagrangian_2d_halo`` with its monitor for the latitude-sharded
step), the omega-diagnosed vertical transport (``diagnose_omega``,
``vertical_advect_column``) and the multiplicative conservation fixer.

ClimSim's unstructured columns are mapped once to a structured
[nlat, nlon] proxy grid (latitude bands, then longitude within a band).
Transport then works on [..., nlat, nlon] fields: every function here
broadcasts over leading (tracer, level) axes, where JAX vmaps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..constants import EARTH_RADIUS


@dataclass(frozen=True)
class SphericalMetric:
    """Per-row metric factors for flux-form FV transport on the sphere.

    Arrays (numpy float32, static per loop):
      dtdx   [nlat]    dt / (a cos(phi_i) dlon)      (zonal courant / m/s)
      dtdy   [nlat]    dt / (a dphi_i)               (merid. courant / m/s)
      cf_fac [nlat+1]  dt / (a dphi_face)            (merid. courant / m/s)
      wf     [nlat+1]  cos(phi_face) * dphi_face     (face flux weight)
      wc     [nlat]    1 / (cos(phi_i) * dphi_i)     (cell update weight)
      cosc   [nlat]    cos(phi_i)                    (center cosine)
      cell_w [nlat]    cos(phi_i) * dphi_i * dlon    (relative cell area)

    Pole faces have cos(+-90 deg) = 0, so pole-crossing fluxes vanish.
    Courant numbers are clamped to +-cfl_max inside the sweeps.
    """
    dtdx: np.ndarray
    dtdy: np.ndarray
    cf_fac: np.ndarray
    wf: np.ndarray
    wc: np.ndarray
    cosc: np.ndarray
    cell_w: np.ndarray
    cfl_max: float = 0.9

    @property
    def nlat(self) -> int:
        return self.dtdx.shape[0]


def spherical_metric(band_lats_deg: np.ndarray, nlon: int, dt: float,
                     radius: float = EARTH_RADIUS,
                     cfl_max: float = 0.9) -> SphericalMetric:
    """Build the metric from the proxy grid's band-mean latitudes
    (ascending, degrees). Face latitudes are midpoints between band
    centers with the poles closing the ends."""
    lat = np.asarray(band_lats_deg, np.float64)
    if not np.all(np.diff(lat) > 0):
        raise ValueError("band latitudes must be ascending")
    phi = np.deg2rad(lat)
    phi_f = np.concatenate([[-np.pi / 2], 0.5 * (phi[:-1] + phi[1:]),
                            [np.pi / 2]])
    dphi = np.diff(phi_f)
    # face-local dphi for courant numbers (edge faces reuse the edge
    # cell's dphi; their flux is zeroed by cos(+-90) anyway)
    dphi_f = np.concatenate([[dphi[0]], np.diff(phi), [dphi[-1]]])
    dlon = 2.0 * np.pi / nlon
    cosc = np.cos(phi)
    cosf = np.cos(phi_f)
    cosf[0] = cosf[-1] = 0.0                            # exact pole closure
    f32 = lambda a: np.asarray(a, np.float32)
    return SphericalMetric(
        dtdx=f32(dt / (radius * cosc * dlon)),
        dtdy=f32(dt / (radius * dphi)),
        cf_fac=f32(dt / (radius * dphi_f)),
        wf=f32(cosf * dphi_f),
        wc=f32(1.0 / (cosc * dphi)),
        cosc=f32(cosc),
        cell_w=f32(cosc * dphi * dlon),
        cfl_max=cfl_max)


def build_proxy_grid(lat: np.ndarray, lon: np.ndarray, nlat: int,
                     nlon: int):
    """Assign each unstructured column to a [nlat, nlon] cell.

    Returns numpy (gather_idx [nlat*nlon] column index per cell,
    scatter_idx [ncol] cell index per column). Columns are sorted into
    nlat latitude bands of equal count, then by longitude within each
    band; requires ncol == nlat*nlon.
    """
    lat = np.asarray(lat)
    lon = np.asarray(lon)
    ncol = lat.shape[0]
    if ncol != nlat * nlon:
        raise ValueError(f"ncol {ncol} != nlat*nlon {nlat}*{nlon}")
    order = np.argsort(lat, kind="stable")
    gather = np.empty(ncol, np.int64)
    for b in range(nlat):
        band = order[b * nlon:(b + 1) * nlon]
        band = band[np.argsort(lon[band], kind="stable")]
        gather[b * nlon:(b + 1) * nlon] = band
    scatter = np.empty(ncol, np.int64)
    scatter[gather] = np.arange(ncol)
    return gather, scatter


def to_grid(x_col: torch.Tensor, gather_idx: torch.Tensor, nlat: int,
            nlon: int) -> torch.Tensor:
    """[ncol, ...] -> [nlat, nlon, ...]."""
    return x_col[gather_idx].reshape((nlat, nlon) + tuple(x_col.shape[1:]))


def to_columns(x_grid: torch.Tensor,
               scatter_idx: torch.Tensor) -> torch.Tensor:
    """[nlat, nlon, ...] -> [ncol, ...]."""
    flat = x_grid.reshape((-1,) + tuple(x_grid.shape[2:]))
    return flat[scatter_idx]


def _mc_limited_slope(qm, q0, qp):
    """Monotonized-central (van Leer) slope limiter."""
    dqc = 0.5 * (qp - qm)
    dqp = qp - q0
    dqm = q0 - qm
    mag = torch.minimum(dqc.abs(),
                        2.0 * torch.minimum(dqp.abs(), dqm.abs()))
    return torch.where(dqp * dqm > 0.0, torch.sign(dqc) * mag,
                       torch.zeros_like(mag))


def _courant_flux_1d(q, c):
    """Periodic van-Leer interface fluxes in Courant units along the last
    axis: c[..., i] is the (clamped) Courant number at the left face of
    cell i; returns Fc[..., i] = c * q_face."""
    qm = torch.roll(q, 1, -1)
    qmm = torch.roll(q, 2, -1)
    qp = torch.roll(q, -1, -1)
    slope_m = _mc_limited_slope(qmm, qm, q)
    slope_0 = _mc_limited_slope(qm, q, qp)
    q_face_pos = qm + 0.5 * (1.0 - c) * slope_m
    q_face_neg = q - 0.5 * (1.0 + c) * slope_0
    return torch.where(c >= 0.0, c * q_face_pos, c * q_face_neg)


def _flux_1d(q, u, dt_dx):
    """Upwind van-Leer flux at the interfaces of a periodic last axis:
    u[..., i] is the velocity at the left face of cell i; returns F[..., i]
    = u * q_face across that face."""
    qm = torch.roll(q, 1, -1)
    qmm = torch.roll(q, 2, -1)
    qp = torch.roll(q, -1, -1)
    slope_m = _mc_limited_slope(qmm, qm, q)
    slope_0 = _mc_limited_slope(qm, q, qp)
    c = u * dt_dx
    q_face_pos = qm + 0.5 * (1.0 - c) * slope_m
    q_face_neg = q - 0.5 * (1.0 + c) * slope_0
    return torch.where(u >= 0.0, u * q_face_pos, u * q_face_neg)


def fv_advect_2d_halo(q_ext: torch.Tensor, u_ext: torch.Tensor,
                      v_ext: torch.Tensor, dt_dx: float, dt_dy: float,
                      is_south, is_north, halo: int = 2) -> torch.Tensor:
    """Halo-aware flat-raster FV step on [..., nlat_local + 2*halo, nlon]
    fields; returns the interior rows. ``dt_dx``/``dt_dy`` are the
    constant Courant numbers at unit speed; ``is_south``/``is_north`` mark
    a domain that owns a pole edge, where the meridional flux is zeroed."""
    # zonal sweep on every row incl. ghosts; advective form: subtract q
    # times the constant-field flux divergence
    F = _flux_1d(q_ext, u_ext, dt_dx)
    q_ext = q_ext - dt_dx * ((torch.roll(F, -1, -1) - F)
                             - q_ext * (torch.roll(u_ext, -1, -1) - u_ext))

    # meridional faces j = 0..n between interior rows j-1 and j; the face
    # velocity comes from the cell below
    n = q_ext.shape[-2] - 2 * halo
    qmm = q_ext[..., halo - 2:halo + n - 1, :]
    qm = q_ext[..., halo - 1:halo + n, :]
    q0 = q_ext[..., halo:halo + n + 1, :]
    qp = q_ext[..., halo + 1:halo + n + 2, :]
    v = v_ext[..., halo:halo + n + 1, :]
    slope_m = _mc_limited_slope(qmm, qm, q0)
    slope_0 = _mc_limited_slope(qm, q0, qp)
    c = v * dt_dy
    q_face_pos = qm + 0.5 * (1.0 - c) * slope_m
    q_face_neg = q0 - 0.5 * (1.0 + c) * slope_0
    faces = torch.where(v >= 0.0, v * q_face_pos, v * q_face_neg)
    # zero pole-crossing fluxes on edge domains (the constant-field flux,
    # the face velocity itself, carries the same closure)
    smask, nmask = (0.0 if is_south else 1.0), (0.0 if is_north else 1.0)
    edges = lambda a: torch.cat([a[..., :1, :] * smask, a[..., 1:-1, :],
                                 a[..., -1:, :] * nmask], dim=-2)
    faces, vmasked = edges(faces), edges(v)
    interior = q_ext[..., halo:halo + n, :]
    return interior - dt_dy * ((faces[..., 1:, :] - faces[..., :-1, :])
                               - interior * (vmasked[..., 1:, :]
                                             - vmasked[..., :-1, :]))


def fv_advect_2d(q: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 dt_dx: float, dt_dy: float) -> torch.Tensor:
    """One dimensionally-split FV step on [..., nlat, nlon] (u zonal,
    periodic; v meridional, zero flux at the poles): the halo path with
    clamped ghost rows."""
    return fv_advect_2d_halo(_clamped_ghosts(q), _clamped_ghosts(u),
                             _clamped_ghosts(v), dt_dx, dt_dy,
                             is_south=True, is_north=True)


def semi_lagrangian_2d(q: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       dt_dx, dt_dy) -> torch.Tensor:
    """Semi-Lagrangian transport on [..., nlat, nlon]: back-trajectory
    departure points and bilinear interpolation, periodic in longitude and
    clamped in latitude. ``dt_dx``/``dt_dy`` are scalars (flat raster) or
    per-row factors [nlat, 1] (the sphere)."""
    nlat, nlon = q.shape[-2:]
    f32 = torch.float32
    i = torch.arange(nlat, dtype=f32, device=q.device)[:, None]
    j = torch.arange(nlon, dtype=f32, device=q.device)
    dep_i = i - v * dt_dy
    dep_j = j - u * dt_dx
    i0f = torch.clamp(torch.floor(dep_i), 0, nlat - 1)
    fi = torch.clamp(dep_i - i0f, 0.0, 1.0)
    j0f = torch.floor(dep_j)
    fj = dep_j - j0f
    i0 = i0f.to(torch.int64)
    i1 = torch.clamp(i0 + 1, 0, nlat - 1)
    j0 = torch.remainder(j0f.to(torch.int64), nlon)     # floor-mod
    j1 = torch.remainder(j0 + 1, nlon)
    flat = q.reshape(q.shape[:-2] + (nlat * nlon,))

    def at(ii, jj):
        idx = (ii * nlon + jj).expand(q.shape).reshape(flat.shape)
        return torch.gather(flat, -1, idx).reshape(q.shape)

    return ((1 - fi) * ((1 - fj) * at(i0, j0) + fj * at(i0, j1))
            + fi * ((1 - fj) * at(i1, j0) + fj * at(i1, j1)))


def semi_lagrangian_2d_halo(q_ext: torch.Tensor, u_ext: torch.Tensor,
                            v_ext: torch.Tensor, dt_dx_rows: torch.Tensor,
                            dt_dy_rows: torch.Tensor, row0: int,
                            nlat_total: int, halo: int = 2) -> torch.Tensor:
    """Semi-Lagrangian transport of a latitude band on [..., nlat_local +
    2*halo, nlon] fields extended by ``halo`` ghost rows; returns the
    interior rows. ``dt_dx_rows``/``dt_dy_rows`` are per-extended-row
    factors [n_ext, 1] (constant on the flat raster, the metric's rows,
    edge-padded, on the sphere); ``row0`` is the global index of the first
    interior row and ``nlat_total`` the global row count.

    Equal to :func:`semi_lagrangian_2d` on the whole grid where the
    meridional displacement stays within the halo (|v|*dt_dy <= halo - 1,
    one more row for the interpolation); beyond it the trajectory clamps to
    the outermost ghost row, silently:
    :func:`semi_lagrangian_halo_clip_fraction` measures how often."""
    n_ext, nlon = q_ext.shape[-2:]
    n = n_ext - 2 * halo
    f32, dev = torch.float32, q_ext.device
    u = u_ext[..., halo:halo + n, :]
    v = v_ext[..., halo:halo + n, :]
    # global fractional row indices of the interior rows, in float32 as JAX
    ig = torch.arange(n, dtype=f32, device=dev)[:, None] + row0
    j = torch.arange(nlon, dtype=f32, device=dev)
    dep_i = ig - v * dt_dy_rows[halo:halo + n]
    dep_j = j - u * dt_dx_rows[halo:halo + n]
    i0g = torch.clamp(torch.floor(dep_i), 0, nlat_total - 1)
    fi = torch.clamp(dep_i - i0g, 0.0, 1.0)
    i1g = torch.clamp(i0g + 1, 0, nlat_total - 1)
    # global rows -> rows of the extended window, clamped to its ghosts
    loc = lambda a: torch.clamp(a.to(torch.int64) - row0 + halo, 0, n_ext - 1)
    i0, i1 = loc(i0g), loc(i1g)
    j0f = torch.floor(dep_j)
    fj = dep_j - j0f
    j0 = torch.remainder(j0f.to(torch.int64), nlon)     # floor-mod
    j1 = torch.remainder(j0 + 1, nlon)
    lead = torch.broadcast_shapes(q_ext.shape[:-2], i0.shape[:-2])
    flat = q_ext.expand(lead + (n_ext, nlon)).reshape(lead + (n_ext * nlon,))

    def at(ii, jj):
        idx = (ii * nlon + jj).expand(lead + (n, nlon))
        return torch.gather(flat, -1, idx.reshape(lead + (n * nlon,))
                            ).reshape(lead + (n, nlon))

    return ((1 - fi) * ((1 - fj) * at(i0, j0) + fj * at(i0, j1))
            + fi * ((1 - fj) * at(i1, j0) + fj * at(i1, j1)))


def semi_lagrangian_halo_clip_fraction(v, dt_dy, halo: int = 2):
    """Fraction of points whose meridional back-trajectory leaves the
    halo-parity window (|v|*dt_dy > halo - 1), where a latitude-sharded
    semi-Lagrangian step would clamp to its outermost ghost row. ``dt_dy``
    is a scalar or per-row factors broadcastable against ``v``."""
    disp = torch.abs(v * dt_dy)
    return torch.mean((disp > (halo - 1)).to(torch.float32))


def vertical_advect_column(q: torch.Tensor, w: torch.Tensor,
                           dp: torch.Tensor, dt: float) -> torch.Tensor:
    """Conservative first-order upwind vertical transport per column, in
    the advective form, with zero flux at TOA and surface: q [B, L], w
    [B, L+1] pressure velocity at the interfaces (positive downward), dp
    [B, L] layer thickness."""
    w_in = w[:, 1:-1]                     # interior interfaces [B, L-1]
    flux = torch.where(w_in >= 0.0, w_in * q[:, :-1], w_in * q[:, 1:])
    zero = torch.zeros_like(flux[:, :1])
    flux_full = torch.cat([zero, flux, zero], dim=1)     # [B, L+1]
    w_full = torch.cat([zero, w_in, zero], dim=1)
    return q - dt * ((flux_full[:, 1:] - flux_full[:, :-1])
                     - q * (w_full[:, 1:] - w_full[:, :-1])) / dp


def diagnose_omega(u, v, dt_dx, dt_dy, dp, gather_idx, scatter_idx,
                   nlat: int, nlon: int, metric=None) -> torch.Tensor:
    """Diagnostic pressure velocity from the horizontal divergence:
    omega(l+1/2) = -sum_{k<=l} div_k dp_k. u/v [ncol, L]; with
    ``metric=None`` they are in Courant units per step and dt_dx/dt_dy the
    flat raster's constant factors; with a :class:`SphericalMetric` (or
    its MetricRows) they are in m/s and the divergence carries the
    spherical terms. Returns omega at the interfaces [ncol, L+1] in Pa per
    step, for :func:`vertical_advect_column` at dt = 1."""
    ug = to_grid(u, gather_idx, nlat, nlon)               # [nlat, nlon, L]
    vg = to_grid(v, gather_idx, nlat, nlon)
    clampdiff = lambda a: (torch.cat([a[1:], a[-1:]], dim=0)
                           - torch.cat([a[:1], a[:-1]], dim=0)) * 0.5
    zonal = torch.roll(ug, -1, 1) - torch.roll(ug, 1, 1)
    if metric is not None:
        rows = metric_rows(metric, u.device)
        ex = lambda a: a[:, None, None]
        dudx = zonal * 0.5 * ex(rows.dtdx)
        # (1/cos phi) d(v cos phi)/dphi, one-sided at the pole rows
        dvdy = clampdiff(vg * ex(rows.cosc)) * ex(rows.dtdy) \
            / ex(rows.cosc)
    else:
        # centered divergence on the flat raster (periodic lon, clamped)
        dudx = zonal * 0.5 * dt_dx
        dvdy = clampdiff(vg) * dt_dy
    div = to_columns(dudx + dvdy, scatter_idx)            # [ncol, L]
    col_int = torch.cumsum(div * dp, dim=1)
    zero = torch.zeros_like(col_int[:, :1])
    return -torch.cat([zero, col_int], dim=1)             # [ncol, L+1]


class MetricRows(NamedTuple):
    """The per-row metric factors the transport reads, as float32 tensors
    on one device (dtdx/wc/dtdy/cosc [nlat], cf_fac/wf [nlat+1]): the FV
    step's first, then those of the semi-Lagrangian step and of
    ``diagnose_omega``. Built once per loop so that a step copies nothing
    from the host."""
    dtdx: torch.Tensor
    cf_fac: torch.Tensor
    wf: torch.Tensor
    wc: torch.Tensor
    cfl_max: float
    dtdy: torch.Tensor | None = None
    cosc: torch.Tensor | None = None


def metric_rows(m, device) -> MetricRows:
    """``m`` (a :class:`SphericalMetric`, or MetricRows already) as
    MetricRows on ``device``."""
    if isinstance(m, MetricRows):
        return m
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=device)
    return MetricRows(t(m.dtdx), t(m.cf_fac), t(m.wf), t(m.wc),
                      float(m.cfl_max), t(m.dtdy), t(m.cosc))


def fv_advect_2d_sphere_halo(q_ext: torch.Tensor, u_ext: torch.Tensor,
                             v_ext: torch.Tensor, m, row0: int = 0,
                             halo: int = 2) -> torch.Tensor:
    """Halo-aware spherical flux-form FV step on [..., nlat_local + 2*halo,
    nlon] fields (winds in m/s); returns the interior rows. ``row0`` is
    the global index of the first interior row; ``m`` is a
    :class:`SphericalMetric` or its :class:`MetricRows`."""
    rows = metric_rows(m, q_ext.device)
    n_ext = q_ext.shape[-2]
    n = n_ext - 2 * halo
    cfl = rows.cfl_max
    nlat = rows.dtdx.shape[0]
    # extended local row r is global row row0 - halo + r, edge-clamped
    ext_idx = (torch.arange(n_ext, device=q_ext.device) + row0
               - halo).clamp(0, nlat - 1)
    dtdx_ext = rows.dtdx[ext_idx][:, None]
    cf_fac = rows.cf_fac[row0:row0 + n + 1][:, None]
    wf = rows.wf[row0:row0 + n + 1][:, None]
    wc = rows.wc[row0:row0 + n][:, None]

    # zonal sweep on every row incl. ghosts, per-row courant; advective
    # form: the constant-field flux is c itself
    c = torch.clamp(u_ext * dtdx_ext, -cfl, cfl)
    Fc = _courant_flux_1d(q_ext, c)
    q_ext = q_ext - ((torch.roll(Fc, -1, -1) - Fc)
                     - q_ext * (torch.roll(c, -1, -1) - c))

    # meridional faces j = 0..n between interior rows j-1 and j
    qmm = q_ext[..., halo - 2:halo + n - 1, :]
    qm = q_ext[..., halo - 1:halo + n, :]
    q0 = q_ext[..., halo:halo + n + 1, :]
    qp = q_ext[..., halo + 1:halo + n + 2, :]
    vf = v_ext[..., halo:halo + n + 1, :]
    slope_m = _mc_limited_slope(qmm, qm, q0)
    slope_0 = _mc_limited_slope(qm, q0, qp)
    c = torch.clamp(vf * cf_fac, -cfl, cfl)
    q_face_pos = qm + 0.5 * (1.0 - c) * slope_m
    q_face_neg = q0 - 0.5 * (1.0 + c) * slope_0
    faces = torch.where(c >= 0.0, c * q_face_pos, c * q_face_neg)
    flux = wf * faces
    fluxc = wf * c
    interior = q_ext[..., halo:halo + n, :]
    return interior - wc * ((flux[..., 1:, :] - flux[..., :-1, :])
                            - interior * (fluxc[..., 1:, :]
                                          - fluxc[..., :-1, :]))


def _clamped_ghosts(a: torch.Tensor) -> torch.Tensor:
    """Two copies of the edge row on each side of the row axis (-2)."""
    return torch.cat([a[..., :1, :], a[..., :1, :], a, a[..., -1:, :],
                      a[..., -1:, :]], dim=-2)


def fv_advect_2d_sphere(q: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                        m) -> torch.Tensor:
    """Single-device spherical FV step on [..., nlat, nlon]: the halo path
    with clamped ghost rows."""
    return fv_advect_2d_sphere_halo(_clamped_ghosts(q), _clamped_ghosts(u),
                                    _clamped_ghosts(v), m, 0)


def conservation_fixer(q_new: torch.Tensor, q_old: torch.Tensor,
                       weights: torch.Tensor | None = None,
                       eps: float = 1e-30) -> torch.Tensor:
    """Multiplicative global fixer: rescale the (non-negative) field so its
    weighted integral matches the pre-step integral."""
    w = torch.ones_like(q_new) if weights is None else weights
    q_new = torch.clamp(q_new, min=0.0)
    tot_old = torch.sum(q_old * w)
    tot_new = torch.sum(q_new * w)
    return q_new * (tot_old / torch.clamp(tot_new, min=eps))
