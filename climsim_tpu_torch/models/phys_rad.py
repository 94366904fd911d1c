"""Physical radiation layer: gas-optics MLPs, cloud optics and the
radiative-transfer solvers (counterpart of
``climsim_tpu/models/phys_rad.py``).

Per-g-point optical depths come from a softsign MLP with the RRTMGP-style
eighth-power output transform tau = col_dry * (sigma*y + mu)^8, a
Planck-fraction softmax distributes the LW source, E3SM cloud optics add
the cloud, the LW no-scattering and SW two-stream adding solvers (kernels
B12 and B11 on the card) give the fluxes, and flux divergence the heating;
the 6 radiative surface scalars are predicted physically.

Ported: the E3SM-table SW cloud optics, the grid-mean and McICA
(per-g-point water path) cloud paths and the two-pass water-vapor
variability. ``learned_cloud_optics``, ``map_bands`` and ``use_tc`` raise
``NotImplementedError`` naming ROADMAP A.11.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .. import constants as C
from ..ops import adding_sw_fast, lw_solver_noscat_fast
from ..physics import cloud_optics as CO
from ..physics import radiation as R
from .rnn import Dense


def _const_param(shape, value: float) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=torch.float32))


class GasOpticsMLP(nn.Module):
    """Per-g-point optical depth (and LW Planck fractions) from the layer
    state (rnn/layers.py:170-281): 3 softsign hidden layers ``h0..h2``, the
    softsign ``out`` layer, learnable scalars ``sigma``/``mu``, and for LW a
    ``planck`` softmax head."""

    def __init__(self, nf: int, ng: int, hidden: Sequence[int] = (64, 64, 64),
                 lw: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        f32 = torch.float32
        self.n_hidden = len(hidden)
        for i, (a, b) in enumerate(zip((nf,) + tuple(hidden), hidden)):
            setattr(self, f"h{i}", Dense(a, b, f32, generator))
        self.out = Dense(hidden[-1], ng, f32, generator)
        if lw:
            self.planck = Dense(hidden[-1], ng, f32, generator)
        self.lw = lw
        self.sigma = _const_param((), 0.3)
        self.mu = _const_param((), 0.4)

    def forward(self, x, col_dry):
        """x [B, L, nf] normalized layer features; col_dry [B, L] dry-air
        column density proxy -> od [B, L, ng] (and pfrac if lw)."""
        h = x
        for i in range(self.n_hidden):
            h = F.softsign(getattr(self, f"h{i}")(h))
        y = F.softsign(self.out(h))
        # the eighth power as three squarings, as XLA evaluates it
        a4 = R.pow4(torch.clamp(self.sigma * y + self.mu, min=0.0))
        od = col_dry[..., None] * (a4 * a4)
        if self.lw:
            return od, torch.softmax(self.planck(h), dim=-1)
        return od


class RadiationModule(nn.Module):
    """Full differentiable radiation: heating rates and the radiative
    surface scalars from raw physical fields (output heating in K/s).
    The gas optics read 6 features per layer, water vapor among them."""

    def __init__(self, ng_lw: int = 16, ng_sw: int = 16,
                 hidden: Sequence[int] = (64, 64, 64),
                 learned_cloud_optics: bool = False, map_bands: bool = False,
                 use_tc: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        for flag, on in (("learned_cloud_optics", learned_cloud_optics),
                         ("map_bands", map_bands), ("use_tc", use_tc)):
            if on:
                raise NotImplementedError(
                    f"RadiationModule {flag} is not ported yet "
                    f"(ROADMAP A.11)")
        self.ng_lw, self.ng_sw = ng_lw, ng_sw
        self.gas_lw = GasOpticsMLP(6, ng_lw, hidden, lw=True,
                                   generator=generator)
        self.gas_sw = GasOpticsMLP(6, ng_sw, hidden, generator=generator)
        self.ssa_gas = _const_param((ng_sw,), 2.0)
        self.solar_w = _const_param((ng_sw,), 0.0)
        self.vis_w = _const_param((ng_sw,), 0.0)

    def forward(self, T_lay, play, plev, gases, cloud_fields, sfc,
                generator: torch.Generator | None = None):
        """T_lay [B, L] K; play [B, L], plev [B, L+1] Pa.
        gases: 'o3', 'ch4', 'n2o', 'h2o' [B, L] mixing ratios (and
          optionally 'h2o_a'/'h2o_b', the two subgrid vapor states).
        cloud_fields: 'lwp', 'iwp' [B, L] (g/m2); 'landfrac', 'icefrac',
          'snowh' [B]; optional McICA per-g-point paths 'lwp_sw_g'/'iwp_sw_g'
          [B, L, ng_sw] and 'lwp_lw_g'/'iwp_lw_g' [B, L, ng_lw].
        sfc: 'coszrs', 'solin', 'lwup', 'aldif', 'aldir', 'asdif', 'asdir'
          [B].
        generator: with 'h2o_a', each SW g-point takes one of the two
          passes at random (a ``torch.Generator`` on the tensors' device);
          without one the passes are averaged, as JAX does without a
          'qvvar' rng.
        Returns (heating [B, L] K/s, scalars dict)."""
        dp = plev[:, 1:] - plev[:, :-1]
        col_dry = dp / (C.GRAV * 0.02896) / 6.02214e26 * 1e26  # ~mol/cm2

        def gas_feats(h2o):
            # quarter-root compression of the vmr, as the RRTMGP-NN inputs
            # (models_phys.py:961,965)
            return torch.stack(
                [T_lay / 300.0, torch.log(torch.clamp(play, min=1.0)) / 12.0,
                 torch.sqrt(torch.sqrt(torch.clamp(h2o, min=0.0))),
                 gases["o3"] * 1e6, gases["ch4"] * 1e6, gases["n2o"] * 1e6],
                dim=-1)

        feats = gas_feats(gases["h2o"])

        # ---------------- longwave
        od_lw, pfrac = self.gas_lw(feats, col_dry)
        if "lwp_lw_g" in cloud_fields:
            # McICA: each g-point absorbs its sampled region's full cloud
            od_cld_lw = 0.07 * (cloud_fields["lwp_lw_g"]
                                + cloud_fields["iwp_lw_g"])
        else:
            od_cld_lw = (0.07 * cloud_fields["lwp"]
                         + 0.07 * cloud_fields["iwp"])[..., None] \
                / self.ng_lw
        od_lw = od_lw + od_cld_lw
        tlev = R.interpolate_tlev(T_lay, play, plev)
        b_lay_top = R.outgoing_lw(tlev[:, :-1])[..., None] * pfrac
        b_lay_bot = R.outgoing_lw(tlev[:, 1:])[..., None] * pfrac
        sup, sdn, trans = R.reftrans_lw(b_lay_top, b_lay_bot, od_lw)
        # surface source: LWUP distributed with the lowest layer's fractions
        src_sfc = sfc["lwup"][:, None] * pfrac[:, -1, :]
        emis = torch.ones_like(src_sfc)
        fdn_lw, fup_lw = lw_solver_noscat_fast(trans, sdn, sup, src_sfc,
                                               emis)
        fdn_lw_tot = fdn_lw.sum(-1)
        fup_lw_tot = fup_lw.sum(-1)
        net_lw = fdn_lw_tot - fup_lw_tot                 # down positive

        # ---------------- shortwave
        mu0 = torch.clamp(sfc["coszrs"], 1e-3, 1.0)[:, None, None]
        if "h2o_a" in gases:
            # sub-grid water-vapor variability: two SW gas-optics passes on
            # the two most likely subgrid vapor states, merged per g-point
            # (models_phys.py:943-983)
            od_a = self.gas_sw(gas_feats(gases["h2o_a"]), col_dry * 0.2)
            od_b = self.gas_sw(gas_feats(gases["h2o_b"]), col_dry * 0.2)
            if generator is not None:
                mask = torch.rand(od_a.shape, generator=generator,
                                  device=od_a.device) < 0.5
                od_sw = torch.where(mask, od_a, od_b)
            else:
                od_sw = 0.5 * (od_a + od_b)
        else:
            od_sw = self.gas_sw(feats, col_dry * 0.2)
        ssa_gas = torch.sigmoid(self.ssa_gas)
        if "lwp_sw_g" in cloud_fields:
            tau_c, ssa_c, g_c = CO.cloud_optics_sw_mcica(
                cloud_fields["lwp_sw_g"], cloud_fields["iwp_sw_g"], T_lay,
                cloud_fields["landfrac"][:, None],
                cloud_fields["icefrac"][:, None],
                cloud_fields["snowh"][:, None])
        else:
            tau_c, ssa_c, g_c = CO.cloud_optics_sw(
                cloud_fields["lwp"], cloud_fields["iwp"], T_lay,
                cloud_fields["landfrac"][:, None],
                cloud_fields["icefrac"][:, None],
                cloud_fields["snowh"][:, None], self.ng_sw)
        tau, ssa, g = CO.combine_optics(
            od_sw, ssa_gas.expand(od_sw.shape), torch.zeros_like(od_sw),
            tau_c, ssa_c, g_c)
        ssa = torch.clamp(ssa, 1e-6, 0.999999)

        # spectral solar weights (learnable softmax ~ solar source fn)
        w_solar = torch.softmax(self.solar_w, dim=0)
        toa = sfc["solin"][:, None] * w_solar[None, :]
        ones = torch.ones((1, self.ng_sw), dtype=toa.dtype, device=toa.device)
        alb_diff = 0.5 * (sfc["aldif"] + sfc["asdif"])[:, None] * ones
        alb_dir = 0.5 * (sfc["aldir"] + sfc["asdir"])[:, None] * ones
        rd, td, rdir, tdd, tdir = R.calc_ref_trans_sw(mu0, tau, ssa, g)
        fup_sw, fdiff_sw, fdir_sw = adding_sw_fast(
            toa, alb_diff, alb_dir, rd, td, rdir, tdd, tdir)

        # visible/near-IR split weights (make_sw_visible_weights analog)
        vis_w = torch.sigmoid(self.vis_w)
        sfc_dir = fdir_sw[:, -1, :]
        sfc_diff = fdiff_sw[:, -1, :]
        sols = torch.sum(sfc_dir * vis_w, -1)           # visible direct
        soll = torch.sum(sfc_dir * (1 - vis_w), -1)     # near-IR direct
        solsd = torch.sum(sfc_diff * vis_w, -1)
        solld = torch.sum(sfc_diff * (1 - vis_w), -1)

        fdn_sw_tot = (fdir_sw + fdiff_sw).sum(-1)
        fup_sw_tot = fup_sw.sum(-1)
        net_sw = fdn_sw_tot - fup_sw_tot

        heating = R.heating_rate(net_lw + net_sw, dp)
        scalars = {"NETSW": net_sw[:, -1], "FLWDS": fdn_lw_tot[:, -1],
                   "SOLS": sols, "SOLL": soll, "SOLSD": solsd,
                   "SOLLD": solld, "OLR": fup_lw_tot[:, 0]}
        return heating, scalars
