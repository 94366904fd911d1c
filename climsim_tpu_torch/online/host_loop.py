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
caller's ``feature_builder``. ``sharded_hybrid_step`` waits for the
multi-device slice (ROADMAP A.10).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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
