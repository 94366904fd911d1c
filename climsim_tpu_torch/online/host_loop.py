"""The online hybrid host loop: emulator + horizontal transport + fixers.

Counterpart of ``climsim_tpu/online/host_loop.py``. Per coupled 20-minute
step the column emulator produces physics tendencies, the state advances
``X[t+1] = X[t] + dt * ptend_phys``, optionally an omega-diagnosed
vertical transport moves the thermodynamic fields, the six prognostic
fields are transported by the updated winds on the latitude-band proxy
grid, and the water and energy fixers restore the global integrals. JAX
runs the step under ``jit`` and the rollout as ``lax.scan``; here the step
runs eagerly and the rollout is a Python loop.

Ported: every single-device configuration of ``HostLoopConfig``: the
spherical or flat geometry, finite-volume (``scheme="fv"``, per field or
through the fused multi-tracer kernel with ``use_pallas``),
semi-Lagrangian or no transport (``"none"``), vertical advection, both
fixers, the channel-major and the batch-major emulator contracts and a
caller's ``feature_builder``; and ``sharded_hybrid_step``, the same step
on latitude bands over the ranks of a ``torch.distributed`` mesh axis
(halo exchange, ghost-row emulator, all-reduced fixers).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from ..ops import (fv_advect_levels, fv_advect_tracers,
                   fv_advect_tracers_sphere, resolve_device)
from . import advection as adv


def _energy_integral(T, qc, qi, w):
    """Global moist-energy integral sum(w * (cp*T - Lv*qc - Ls*qi)), with
    w = dp/g x area weight."""
    return torch.sum(w * (C.CP * T - C.LV * qc - C.LSUB * qi))


@dataclass(frozen=True)
class HostLoopConfig:
    nlat: int = 16
    nlon: int = 24
    dt: float = C.DT_STEP
    scheme: str = "fv"          # fv | semi_lagrangian | none
    # 'sphere': real-geography metric terms from the grid's latitudes
    # (advection.SphericalMetric); 'flat': a uniform raster with the
    # constant cell sizes dx/dy below
    geometry: str = "sphere"
    # with scheme "fv": all prognostic fields through the fused
    # multi-tracer stencil in one launch (u/v loaded once); otherwise one
    # field at a time
    use_pallas: bool = False
    vertical_advection: bool = False  # omega-diagnosed vertical transport
    fix_water: bool = True      # multiplicative tracer mass fixer
    # additive uniform temperature shift restoring the global moist-energy
    # integral across the transport step
    fix_energy: bool = False
    # channel-major emulator contract: x_main [L, nx, B], mem [L, nm, B],
    # ptend [L, 6, B] (x_sfc/fluxes stay batch-major); False is the
    # batch-major contract: x_main [B, L, nx], ptend [B, L, 6]
    emulator_level_major: bool = False
    # flat geometry: proxy-grid cell sizes (m) for the winds -> Courant
    # conversion
    dx: float = 1.2e6
    dy: float = 1.2e6

    @property
    def dt_dx(self):
        return self.dt / self.dx

    @property
    def dt_dy(self):
        return self.dt / self.dy


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class HybridLoop:
    """Couples a raw-units emulator step with the transport host dynamics.

    ``emulator_step(x_main_raw, x_sfc_raw, mem) -> (ptend, sfc_fluxes,
    mem)``: x_main_raw and ptend are ``[L, 6, B]`` with
    ``cfg.emulator_level_major``, else ``[B, L, 6]``. State: prognostic
    fields ``[ncol, nlev]`` for T, qv, qc, qi, u, v on ``device``. ``grid``
    needs ``lat``/``lon``, ``mass_weights`` and, for vertical advection,
    ``layer_thickness``; ``area_wgt`` is optional.
    ``feature_builder(state, x_sfc_raw) -> (x_main_raw, x_sfc)`` replaces
    the default features (the six prognostic fields); with the
    channel-major contract it must return x_main_raw ``[L, nx, B]``.

    ``device=None`` means ``"cuda"`` and raises without a CUDA device.
    """

    def __init__(self, emulator_step, grid,
                 cfg: HostLoopConfig = HostLoopConfig(),
                 feature_builder=None, device=None):
        if cfg.geometry not in ("sphere", "flat"):
            raise ValueError(f"geometry={cfg.geometry!r}: 'sphere' or "
                             "'flat'")
        if cfg.scheme not in ("fv", "semi_lagrangian", "none"):
            raise ValueError(f"scheme={cfg.scheme!r}: 'fv', "
                             "'semi_lagrangian' or 'none'")
        self.device = resolve_device(device)
        self.emulator = emulator_step
        self.grid = grid
        self.cfg = cfg
        self.feature_builder = feature_builder
        lat, lon = _numpy(grid.lat), _numpy(grid.lon)
        gather_np, scatter_np = adv.build_proxy_grid(lat, lon, cfg.nlat,
                                                     cfg.nlon)
        self.gather_idx = torch.as_tensor(gather_np, device=self.device)
        self.scatter_idx = torch.as_tensor(scatter_np, device=self.device)
        # spherical metric from the column latitudes: band-mean latitude
        # per proxy row (the bands are built latitude-sorted)
        self.metric = self.metric_rows = None
        if cfg.geometry == "sphere":
            band_lats = lat[gather_np].reshape(cfg.nlat, cfg.nlon).mean(1)
            self.metric = adv.spherical_metric(band_lats, cfg.nlon, cfg.dt)
            self.metric_rows = adv.metric_rows(self.metric, self.device)
        self.area_wgt = getattr(grid, "area_wgt", None)

    # -------------------------------------------------------------- dynamics

    def _to_levels(self, field: torch.Tensor) -> torch.Tensor:
        """[ncol, nlev] -> contiguous [nlev, nlat, nlon]."""
        cfg = self.cfg
        return adv.to_grid(field, self.gather_idx, cfg.nlat,
                           cfg.nlon).permute(2, 0, 1).contiguous()

    def _to_columns(self, levels: torch.Tensor) -> torch.Tensor:
        """[nlev, nlat, nlon] -> [ncol, nlev]."""
        return adv.to_columns(levels.permute(1, 2, 0), self.scatter_idx)

    def _advect_levels(self, q, u, v) -> torch.Tensor:
        """One field [nlev, nlat, nlon] transported by the winds of the
        same layout: the spherical FV step (plain), the flat FV step
        (kernel B6 on the card), or semi-Lagrangian transport (scalar
        factors on the flat raster, per-row factors on the sphere)."""
        cfg, rows = self.cfg, self.metric_rows
        if cfg.scheme == "fv":
            if rows is not None:
                return adv.fv_advect_2d_sphere(q, u, v, rows)
            return fv_advect_levels(q, u, v, cfg.dt_dx, cfg.dt_dy)
        if rows is not None:
            return adv.semi_lagrangian_2d(q, u, v, rows.dtdx[:, None],
                                          rows.dtdy[:, None])
        return adv.semi_lagrangian_2d(q, u, v, cfg.dt_dx, cfg.dt_dy)

    def advect(self, field: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        """Transport one [ncol, nlev] field with column winds [ncol, nlev]."""
        if self.cfg.scheme == "none":
            return field
        out = self._advect_levels(self._to_levels(field), self._to_levels(u),
                                  self._to_levels(v))
        return self._to_columns(out)

    def advect_all(self, fields: dict, u: torch.Tensor, v: torch.Tensor):
        """Transport every [ncol, nlev] field in ``fields`` with the same
        winds. With ``cfg.use_pallas`` and the FV scheme the fused
        multi-tracer stencil runs once for all fields (B2 on the sphere, B5
        on the flat raster); otherwise each field is transported alone."""
        cfg = self.cfg
        if cfg.scheme == "none":
            return dict(fields)
        ul, vl = self._to_levels(u), self._to_levels(v)
        if not (cfg.use_pallas and cfg.scheme == "fv"):
            return {k: self._to_columns(self._advect_levels(
                self._to_levels(f), ul, vl)) for k, f in fields.items()}
        names = list(fields)
        qs = torch.stack([self._to_levels(fields[k]) for k in names])
        if self.metric_rows is not None:
            out = fv_advect_tracers_sphere(qs, ul, vl, self.metric_rows)
        else:
            out = fv_advect_tracers(qs, ul, vl, cfg.dt_dx, cfg.dt_dy)
        return {k: self._to_columns(out[i]) for i, k in enumerate(names)}

    # ---------------------------------------------------------------- step

    def coupled_step(self, state: dict, mem, x_sfc_raw):
        """One 20-minute hybrid step. state: dict of [ncol, nlev] prognostic
        fields {T, qv, qc, qi, u, v}; returns (new_state, mem, diagnostics).
        """
        cfg = self.cfg
        lm = cfg.emulator_level_major
        if self.feature_builder is not None:
            x_main_raw, x_sfc = self.feature_builder(state, x_sfc_raw)
        else:
            fields = (state["T"], state["qv"], state["qc"], state["qi"],
                      state["u"], state["v"])
            if lm:
                x_main_raw = torch.stack([f.T for f in fields], dim=1)
            else:
                x_main_raw = torch.stack(fields, dim=-1)
            x_sfc = x_sfc_raw

        ptend, sfc_fluxes, mem = self.emulator(x_main_raw, x_sfc, mem)

        # channel j of the physics tendencies as [ncol, nlev]
        pt = (lambda j: ptend[:, j, :].T) if lm else \
            (lambda j: ptend[:, :, j])

        dt = cfg.dt
        T = state["T"] + dt * pt(0)
        qv = torch.clamp(state["qv"] + dt * pt(1), min=0.0)
        qc = torch.clamp(state["qc"] + dt * pt(2), min=0.0)
        qi = torch.clamp(state["qi"] + dt * pt(3), min=0.0)
        u = state["u"] + dt * pt(4)
        v = state["v"] + dt * pt(5)

        transport = cfg.scheme != "none"
        if cfg.vertical_advection and transport:
            # continuity-diagnosed omega -> conservative vertical transport
            dp = self.grid.layer_thickness(x_sfc[:, 0])
            if self.metric_rows is not None:
                omega = adv.diagnose_omega(
                    u, v, 1.0, 1.0, dp, self.gather_idx, self.scatter_idx,
                    cfg.nlat, cfg.nlon, metric=self.metric_rows)
            else:
                omega = adv.diagnose_omega(
                    u * (dt / cfg.dx), v * (dt / cfg.dy), 1.0, 1.0, dp,
                    self.gather_idx, self.scatter_idx, cfg.nlat, cfg.nlon)
            T = adv.vertical_advect_column(T, omega, dp, 1.0)
            qv = adv.vertical_advect_column(qv, omega, dp, 1.0)
            qc = adv.vertical_advect_column(qc, omega, dp, 1.0)
            qi = adv.vertical_advect_column(qi, omega, dp, 1.0)

        # horizontal transport by the updated winds
        adv_out = self.advect_all(
            {"T": T, "qv": qv, "qc": qc, "qi": qi, "u": u, "v": v}, u, v)
        T_a, qv_a, qc_a = adv_out["T"], adv_out["qv"], adv_out["qc"]
        qi_a, u_a, v_a = adv_out["qi"], adv_out["u"], adv_out["v"]

        w = None
        if (cfg.fix_water or cfg.fix_energy) and transport:
            # physical-units column mass: dp/g x per-column area weight
            w = self.grid.mass_weights(x_sfc[:, 0])
            if self.area_wgt is not None:
                w = w * self.area_wgt[:, None]

        if cfg.fix_water and transport:
            qv_a = adv.conservation_fixer(qv_a, qv, w)
            qc_a = adv.conservation_fixer(qc_a, qc, w)
            qi_a = adv.conservation_fixer(qi_a, qi, w)

        if cfg.fix_energy and transport:
            e_pre = _energy_integral(T, qc, qi, w)
            e_post = _energy_integral(T_a, qc_a, qi_a, w)
            T_a = T_a + (e_pre - e_post) / (C.CP * torch.sum(w))

        new_state = {"T": T_a, "qv": qv_a, "qc": qc_a, "qi": qi_a,
                     "u": u_a, "v": v_a}
        diags = {"sfc_fluxes": sfc_fluxes,
                 "precc": sfc_fluxes[:, 3],
                 "mean_T": torch.mean(T_a)}
        if w is not None:
            # physics energy residual of this step's emulator tendencies
            # (area-mass weighted mean) and the state's global moist-energy
            # integral
            snow = 1000.0 * sfc_fluxes[:, 2]
            rain = 1000.0 * sfc_fluxes[:, 3] - snow
            col = torch.sum(w * (C.CP * pt(0) - C.LV * pt(2)
                                 - C.LSUB * pt(3)), dim=1)
            diags["energy_resid"] = torch.mean(col - C.LV * rain
                                               - C.LSUB * snow)
            diags["energy_int"] = _energy_integral(T_a, qc_a, qi_a, w)
        return new_state, mem, diags

    def rollout(self, state: dict, mem, x_sfc_raw, n_steps: int):
        """N coupled steps; returns the final state, mem and the stacked
        diagnostics. x_sfc_raw may be [ncol, ns] (held fixed) or
        [n_steps, ncol, ns]."""
        time_varying = x_sfc_raw.ndim == 3
        if time_varying and x_sfc_raw.shape[0] != n_steps:
            raise ValueError(f"x_sfc_raw has {x_sfc_raw.shape[0]} steps, "
                             f"n_steps is {n_steps}")
        history = []
        for t in range(n_steps):
            sfc = x_sfc_raw[t] if time_varying else x_sfc_raw
            state, mem, diags = self.coupled_step(state, mem, sfc)
            history.append(diags)
        stacked = {k: torch.stack([d[k] for d in history])
                   for k in history[0]} if history else {}
        return state, mem, stacked


FIELDS = ("T", "qv", "qc", "qi", "u", "v")


def _updates(s, ptend, dt):
    """The six fields stacked on the last axis, advanced by the physics
    tendencies of the same layout; the three water species clamped at 0."""
    upd = s + dt * ptend
    upd[..., 1:4].clamp_(min=0.0)
    return upd


def sharded_hybrid_step(loop: HybridLoop, mesh, axis: str = "col",
                        overlap: bool = True):
    """The coupled step of ``loop`` on latitude bands over the ranks of the
    mesh axis ``axis``, equal to :meth:`HybridLoop.coupled_step` on the
    whole grid: the emulator runs on each rank's columns; the transport
    (FV or semi-Lagrangian, flat or spherical) takes its 2 ghost rows a
    side from the neighbours (``parallel.halo``); vertical advection
    diagnoses omega from halo-1 updated winds; the water and energy
    fixers and the diagnostics close their global sums with all-reduces.

    Returns ``step(state, mem, x_sfc) -> (state, mem, diagnostics)``, which
    every rank calls on its own rows: fields ``[nlat/n, nlon, nlev]`` (proxy
    grid layout), ``x_sfc [nlat/n, nlon, ns]``, ``mem [nlat/n * nlon, L,
    nm]`` (the batch-major emulator contract, the band's columns in grid
    order); the rows of rank i are rows i nlat/n to (i + 1) nlat/n - 1. It
    returns the rank's rows and diagnostics (``mean_T``, and with a fixer
    ``energy_resid`` and ``energy_int``) equal on every rank. JAX takes and
    returns the global arrays, being one controller over every device.

    ``overlap=True`` starts the exchange of the inputs' ghost rows (state,
    x_sfc, memory; width 2) before the emulator and waits for it after,
    then runs the emulator again on the 4 x nlon ghost columns, so that no
    exchange follows the emulator; with vertical advection the step runs
    without it, as JAX's. The transport is the plain per-field operator
    whatever ``cfg.use_pallas`` says, as in JAX. Only the batch-major
    contract without a feature builder is taken, as JAX's sharded step
    takes only that: the others raise."""
    from ..parallel import axis_rank, exchange_halo

    cfg = loop.cfg
    if cfg.emulator_level_major:
        raise ValueError("sharded_hybrid_step takes the batch-major emulator "
                         "contract only (emulator_level_major=False)")
    if loop.feature_builder is not None:
        raise ValueError("sharded_hybrid_step feeds the six prognostic "
                         "fields: a feature_builder is not taken")
    idx, nsh = axis_rank(mesh, axis)
    if cfg.nlat % nsh:
        raise ValueError(f"nlat {cfg.nlat} does not divide over {nsh} ranks")
    nlat_l, nlon = cfg.nlat // nsh, cfg.nlon
    halo = 2
    if nlat_l < halo:
        raise ValueError(f"{nlat_l} rows a rank, fewer than the halo {halo}")
    group = mesh.get_group(axis)
    row0 = idx * nlat_l
    dev = loop.device
    transport = cfg.scheme != "none"
    use_overlap = overlap and transport and not cfg.vertical_advection
    fixing = (cfg.fix_water or cfg.fix_energy) and transport
    rows = loop.metric_rows

    def ext_rows(a, pad):
        """A per-row metric tensor [nlat] at this band's rows with ``pad``
        edge-clamped rows a side."""
        i = torch.arange(-pad, nlat_l + pad, device=dev) + row0
        return a[i.clamp(0, cfg.nlat - 1)]

    # this band's per-cell area weights [nlat_l, nlon, 1]
    aw = torch.ones((nlat_l, nlon, 1), dtype=torch.float32, device=dev)
    if loop.area_wgt is not None:
        band = loop.gather_idx.reshape(cfg.nlat, nlon)[row0:row0 + nlat_l]
        aw = torch.as_tensor(loop.area_wgt, device=dev)[band][..., None]
    if cfg.scheme == "semi_lagrangian":
        if rows is not None:
            sl_dx = ext_rows(rows.dtdx, halo)[:, None]
            sl_dy = ext_rows(rows.dtdy, halo)[:, None]
        else:
            sl_dx = torch.full((nlat_l + 2 * halo, 1), cfg.dt_dx,
                               device=dev)
            sl_dy = torch.full((nlat_l + 2 * halo, 1), cfg.dt_dy,
                               device=dev)

    def psum(*scalars):
        """The sums over the axis of local scalars, in one all-reduce."""
        v = torch.stack(scalars)
        dist.all_reduce(v, group=group)
        return v.unbind()

    def advect(x):
        """x [6, nlev, nlat_l + 4, nlon] -> the interior rows transported
        by the winds x[4], x[5]."""
        u, v = x[4], x[5]
        if cfg.scheme == "semi_lagrangian":
            return adv.semi_lagrangian_2d_halo(x, u, v, sl_dx, sl_dy, row0,
                                               cfg.nlat, halo)
        if rows is not None:
            return adv.fv_advect_2d_sphere_halo(x, u, v, rows, row0, halo)
        return adv.fv_advect_2d_halo(x, u, v, cfg.dt_dx, cfg.dt_dy,
                                     idx == 0, idx == nsh - 1, halo)

    def vertical_advect(upd, dp):
        """Omega-diagnosed vertical transport of T, qv, qc, qi in ``upd``
        [nlat_l, nlon, nlev, 6]: diagnose_omega's divergence from the
        updated winds with one ghost row a side (the global edges clamped,
        as its one-sided difference)."""
        uv = upd[..., 4:6]
        if rows is not None:
            e = exchange_halo(uv, mesh, axis, 1)
            u_e, v_e = e[..., 0], e[..., 1]
            col = lambda a: a[:, None, None]
            cosc = col(ext_rows(rows.cosc, 1))
            dudx = (torch.roll(u_e[1:-1], -1, 1)
                    - torch.roll(u_e[1:-1], 1, 1)) * 0.5 \
                * col(ext_rows(rows.dtdx, 0))
            vcos = v_e * cosc
            dvdy = (vcos[2:] - vcos[:-2]) * 0.5 \
                * col(ext_rows(rows.dtdy, 0)) / cosc[1:-1]
        else:
            e = exchange_halo(uv * torch.tensor([cfg.dt_dx, cfg.dt_dy],
                                                device=dev), mesh, axis, 1)
            u_e, v_e = e[..., 0], e[..., 1]
            dudx = (torch.roll(u_e[1:-1], -1, 1)
                    - torch.roll(u_e[1:-1], 1, 1)) * 0.5
            dvdy = (v_e[2:] - v_e[:-2]) * 0.5
        col_int = torch.cumsum((dudx + dvdy) * dp, dim=-1)
        omega = -torch.cat([torch.zeros_like(col_int[..., :1]), col_int],
                           dim=-1)
        flat = lambda a: a.reshape(nlat_l * nlon, a.shape[-1])
        out = upd.clone()
        for i in range(4):
            out[..., i] = adv.vertical_advect_column(
                flat(upd[..., i]), flat(omega), flat(dp), 1.0
            ).reshape(nlat_l, nlon, -1)
        return out

    def step(state: dict, mem, x_sfc):
        if state["T"].shape[:2] != (nlat_l, nlon):
            raise ValueError(f"state rows {tuple(state['T'].shape[:2])}: "
                             f"this rank holds ({nlat_l}, {nlon})")
        s = torch.stack([state[k] for k in FIELDS], dim=-1)
        nlev = s.shape[2]
        flat = lambda a: a.reshape((nlat_l * nlon,) + tuple(a.shape[2:]))
        if use_overlap:
            # 1. start the exchange of the inputs' ghost rows: it does not
            # depend on the emulator, so it runs beside step 2
            edge = lambda a: torch.cat([a[:halo], a[-halo:]])
            mem_rows = mem.reshape((nlat_l, nlon) + tuple(mem.shape[1:]))
            pending = [exchange_halo(edge(a), mesh, axis, halo,
                                     async_op=True)
                       for a in (s, x_sfc, mem_rows)]

        # 2. the emulator on this band's columns
        ptend, sfc_fluxes, mem_new = loop.emulator(flat(s), flat(x_sfc), mem)
        ptend = ptend.reshape(nlat_l, nlon, nlev, 6)
        upd = _updates(s, ptend, cfg.dt)

        ps = flat(x_sfc)[:, 0]
        w = None
        if fixing:
            w = loop.grid.mass_weights(ps).reshape(nlat_l, nlon, nlev) * aw
        if cfg.vertical_advection and transport:
            dp = loop.grid.layer_thickness(ps).reshape(nlat_l, nlon, nlev)
            upd = vertical_advect(upd, dp)

        if transport:
            if use_overlap:
                # 3. the emulator on the 4 ghost rows: the neighbours'
                # updated boundary rows, computed here rather than sent
                # after their emulator
                ghost = [torch.cat([e[:halo], e[-halo:]])
                         for e in (p.wait() for p in pending)]
                g = lambda a: a.reshape((2 * halo * nlon,)
                                        + tuple(a.shape[2:]))
                pt_g, _, _ = loop.emulator(*(g(a) for a in ghost))
                gupd = _updates(ghost[0], pt_g.reshape(ghost[0].shape),
                                cfg.dt)
                upd_ext = torch.cat([gupd[:halo], upd, gupd[halo:]])
            else:
                upd_ext = exchange_halo(upd, mesh, axis, halo)
            x = upd_ext.permute(3, 2, 0, 1).contiguous()
            out = advect(x).permute(2, 3, 1, 0)     # [nlat_l, nlon, nlev, 6]
        else:
            out = upd
        o = dict(zip(FIELDS, out.unbind(-1)))
        before = dict(zip(FIELDS, upd.unbind(-1)))

        if fixing:
            water = ("qv", "qc", "qi") if cfg.fix_water else ()
            qn = {k: torch.clamp(o[k], min=0.0) for k in water}
            sums = psum(*[torch.sum(before[k] * w) for k in water],
                        *[torch.sum(qn[k] * w) for k in water],
                        _energy_integral(before["T"], before["qc"],
                                         before["qi"], w),
                        torch.sum(w))
            nw = len(water)
            for i, k in enumerate(water):
                o[k] = qn[k] * (sums[i] / torch.clamp(sums[nw + i],
                                                      min=1e-30))
            if cfg.fix_energy:
                e_pre, w_sum = sums[2 * nw], sums[2 * nw + 1]
                (e_post,) = psum(_energy_integral(o["T"], o["qc"], o["qi"],
                                                  w))
                o["T"] = o["T"] + (e_pre - e_post) / (C.CP * w_sum)

        local = [torch.mean(o["T"])]
        if w is not None:
            snow = 1000.0 * sfc_fluxes[:, 2]
            rain = 1000.0 * sfc_fluxes[:, 3] - snow
            pt = flat(ptend)
            col = torch.sum(flat(w) * (C.CP * pt[:, :, 0] - C.LV * pt[:, :, 2]
                                       - C.LSUB * pt[:, :, 3]), dim=1)
            local += [torch.mean(col - C.LV * rain - C.LSUB * snow),
                      _energy_integral(o["T"], o["qc"], o["qi"], w)]
        tot = psum(*local)
        diags = {"mean_T": tot[0] / nsh}
        if w is not None:
            diags["energy_resid"] = tot[1] / nsh
            diags["energy_int"] = tot[2]
        return ({k: o[k].contiguous() for k in FIELDS}, mem_new, diags)

    return step
