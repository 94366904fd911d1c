"""Physical radiation layer: gas-optics MLPs, cloud optics and the
radiative-transfer solvers (counterpart of
``climsim_tpu/models/phys_rad.py``).

Per-g-point optical depths come from a softsign MLP with the RRTMGP-style
eighth-power output transform tau = col_dry * (sigma*y + mu)^8, a
Planck-fraction softmax distributes the LW source, E3SM cloud optics add
the cloud, the LW no-scattering and SW two-stream adding solvers (kernels
B12 and B11 on the card) give the fluxes, and flux divergence the heating;
the 6 radiative surface scalars are predicted physically.

Cloud optics: the E3SM tables (grid-mean or McICA per-g-point water
paths), learned optics (``learned_cloud_optics``: small Dense layers on
the temperature, the effective radii and the latent memory), the tables
expanded to the g-points by a trainable non-negative map (``map_bands``),
or TripleClouds (``use_tc``: region-resolved optics mixed between
regions by overlap matrices in the SW, ``physics/radiation.py::
adding_sw_tc``, plain torch as in JAX; the SW kernel B11 does not run
then). The SW gas optics takes one pass, or two on the two likeliest
sub-grid vapor states.
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
from .common import positive_linear, weak
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
    The gas optics read 6 features per layer, water vapor among them.

    ``learned_cloud_optics``: ``cld_lw`` (LW absorption) and, but with
    ``use_tc``, ``cld_sw1``/``cld_sw2`` (SW tau, ssa, g) map the features
    (T, ice and liquid radii, and the ``n_latent`` channels of
    ``cloud_fields['latent']`` where the caller passes them) to per-g-point
    optics scaled by the water path (models_phys.py:296-319,1095-1107).
    ``map_bands``: the 4-band table optics go to the ng_sw g-points through
    ``positive_linear`` with ``band_expand_kernel`` (initialised to the
    static band repeat) and ``band_expand_bias`` (models_phys.py:285,
    1018-1030); it takes the grid-mean paths (without 'lwp_sw_g').
    ``use_tc``: TripleClouds SW, needing ``cloud_fields`` 'region_frac'
    [B, L, nreg], 'overlap_param' [B, L-1] and 'lwp_r'/'iwp_r'
    [B, L, nreg]."""

    def __init__(self, ng_lw: int = 16, ng_sw: int = 16,
                 hidden: Sequence[int] = (64, 64, 64),
                 learned_cloud_optics: bool = False, map_bands: bool = False,
                 use_tc: bool = False, n_latent: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        f32 = torch.float32
        self.ng_lw, self.ng_sw = ng_lw, ng_sw
        self.learned_cloud_optics = learned_cloud_optics
        self.map_bands, self.use_tc = map_bands, use_tc
        self.gas_lw = GasOpticsMLP(6, ng_lw, hidden, lw=True,
                                   generator=generator)
        if learned_cloud_optics:
            self.cld_lw = Dense(3 + n_latent, ng_lw, f32, generator)
        self.gas_sw = GasOpticsMLP(6, ng_sw, hidden, generator=generator)
        self.ssa_gas = _const_param((ng_sw,), 2.0)
        if learned_cloud_optics and not use_tc:
            self.cld_sw1 = Dense(3 + n_latent, 2 * ng_sw, f32, generator)
            self.cld_sw2 = Dense(2 * ng_sw, 3 * ng_sw, f32, generator)
        elif map_bands and not use_tc:
            # the static band repeat (cloud_optics.py::_band_expand)
            rep = torch.zeros((4, ng_sw), dtype=f32)
            i4, i3, i2 = (round(f / 112 * ng_sw) for f in (29, 71, 80))
            rep[3, :i4] = 1.0
            rep[2, i4:i3] = 1.0
            rep[1, i3:i2] = 1.0
            rep[0, i2:] = 1.0
            self.band_expand_kernel = nn.Parameter(rep)
            self.band_expand_bias = _const_param((ng_sw,), 0.0)
        self.solar_w = _const_param((ng_sw,), 0.0)
        self.vis_w = _const_param((ng_sw,), 0.0)

    def forward(self, T_lay, play, plev, gases, cloud_fields, sfc,
                generator: torch.Generator | None = None):
        """T_lay [B, L] K; play [B, L], plev [B, L+1] Pa.
        gases: 'o3', 'ch4', 'n2o', 'h2o' [B, L] mixing ratios (and
          optionally 'h2o_a'/'h2o_b', the two subgrid vapor states).
        cloud_fields: 'lwp', 'iwp' [B, L] (g/m2); 'landfrac', 'icefrac',
          'snowh' [B]; optional McICA per-g-point paths 'lwp_sw_g'/'iwp_sw_g'
          [B, L, ng_sw] and 'lwp_lw_g'/'iwp_lw_g' [B, L, ng_lw]; 'latent'
          [B, L, n_latent] for learned optics; the TripleClouds fields.
        sfc: 'coszrs', 'solin', 'lwup', 'aldif', 'aldir', 'asdif', 'asdir'
          [B].
        generator: with 'h2o_a', each SW g-point takes one of the two
          passes at random (a ``torch.Generator`` on the tensors' device);
          without one the passes are averaged, as JAX does without a
          'qvvar' rng.
        Returns (heating [B, L] K/s, scalars dict)."""
        B, L = T_lay.shape
        cf = cloud_fields
        dp = plev[:, 1:] - plev[:, :-1]
        # Python scalars on the pressures and the policy's inputs round to
        # their dtype first, as in JAX (bf16 under the BF16 policy)
        w = lambda v, a: weak(v, a.dtype)
        col_dry = dp / w(C.GRAV * 0.02896, dp) / w(6.02214e26, dp) \
            * w(1e26, dp)                                  # ~mol/cm2

        def gas_feats(h2o):
            # quarter-root compression of the vmr, as the RRTMGP-NN inputs
            # (models_phys.py:961,965)
            return torch.stack(
                [T_lay / 300.0, torch.log(torch.clamp(play, min=1.0)) / 12.0,
                 torch.sqrt(torch.sqrt(torch.clamp(h2o, min=0.0))),
                 *(gases[k] * w(1e6, gases[k]) for k in ("o3", "ch4", "n2o"))],
                dim=-1)

        feats = gas_feats(gases["h2o"])
        # the per-column surface fields with n trailing unit axes
        sfc_cols = lambda n: [cf[k][(slice(None),) + (None,) * n]
                              for k in ("landfrac", "icefrac", "snowh")]
        if self.learned_cloud_optics:
            # T and the table radii (and the latent memory), the
            # reference's x_cld (models_phys.py:1095-1099)
            rel = CO.reltab(T_lay, *sfc_cols(1))
            rei = CO.reitab(T_lay)
            x_cld = torch.stack([(T_lay - 160.0) / 180.0, rei / 125.0,
                                 rel / 13.5], dim=-1)
            if "latent" in cf:
                x_cld = torch.cat([x_cld, cf["latent"]], dim=-1)

        # ---------------- longwave
        od_lw, pfrac = self.gas_lw(feats, col_dry)
        if self.learned_cloud_optics:
            k_lw = F.relu(self.cld_lw(x_cld))
            path = cf["lwp_lw_g"] + cf["iwp_lw_g"] if "lwp_lw_g" in cf \
                else (cf["lwp"] + cf["iwp"])[..., None]
            od_cld_lw = path * k_lw
        elif "lwp_lw_g" in cf:
            # McICA: each g-point absorbs its sampled region's full cloud
            path = cf["lwp_lw_g"] + cf["iwp_lw_g"]
            od_cld_lw = w(0.07, path) * path
        else:
            od_cld_lw = (w(0.07, cf["lwp"]) * cf["lwp"]
                         + w(0.07, cf["iwp"]) * cf["iwp"])[..., None] \
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
        mu0 = torch.clamp(sfc["coszrs"], w(1e-3, sfc["coszrs"]),
                          1.0)[:, None, None]
        if "h2o_a" in gases:
            # sub-grid water-vapor variability: two SW gas-optics passes on
            # the two most likely subgrid vapor states, merged per g-point
            # (models_phys.py:943-983)
            od_a = self.gas_sw(gas_feats(gases["h2o_a"]), col_dry * w(0.2, col_dry))
            od_b = self.gas_sw(gas_feats(gases["h2o_b"]), col_dry * w(0.2, col_dry))
            if generator is not None:
                mask = torch.rand(od_a.shape, generator=generator,
                                  device=od_a.device) < 0.5
                od_sw = torch.where(mask, od_a, od_b)
            else:
                od_sw = 0.5 * (od_a + od_b)
        else:
            od_sw = self.gas_sw(feats, col_dry * w(0.2, col_dry))
        ssa_gas = torch.sigmoid(self.ssa_gas)
        od_g = od_sw
        if self.learned_cloud_optics and not self.use_tc:
            # two stacked linears -> (tau_k, ssa, g) per g-point
            # (models_phys.py:1101-1107)
            k_c, s_c, a_c = self.cld_sw2(self.cld_sw1(x_cld)).chunk(3, dim=-1)
            path = cf["lwp_sw_g"] + cf["iwp_sw_g"] if "lwp_sw_g" in cf \
                else (cf["lwp"] + cf["iwp"])[..., None]
            tau_c, ssa_c, g_c = path * F.relu(k_c), torch.sigmoid(s_c), \
                torch.sigmoid(a_c)
        elif self.use_tc:
            # region-resolved optics [B, L, nreg, ng]: the region axis
            # rides the batch axes of the band coefficients
            tau_c, ssa_c, g_c = CO.cloud_optics_sw(
                cf["lwp_r"], cf["iwp_r"], T_lay[..., None], *sfc_cols(2),
                self.ng_sw)
            od_g = od_sw[:, :, None, :]            # the gas in every region
        elif "lwp_sw_g" in cf:
            tau_c, ssa_c, g_c = CO.cloud_optics_sw_mcica(
                cf["lwp_sw_g"], cf["iwp_sw_g"], T_lay, *sfc_cols(1))
        elif self.map_bands:
            # the 4-band tables through the trainable non-negative
            # expansion, shared by the six optical quantities
            rel = CO.reltab(T_lay, *sfc_cols(1))
            rei = CO.reitab(T_lay)
            k_l, s_l, a_l = CO.slingo_liq_optics_sw(rel, 4)
            k_i, s_i, a_i = CO.ec_ice_optics_sw(rei, 4)
            exp_ = lambda a: positive_linear(
                self.band_expand_kernel, self.band_expand_bias, a)
            lwp_, iwp_ = cf["lwp"][..., None], cf["iwp"][..., None]
            tau_c = lwp_ * exp_(k_l) + iwp_ * exp_(k_i)
            ts = lwp_ * exp_(k_l * s_l) + iwp_ * exp_(k_i * s_i)
            gt = lwp_ * exp_(k_l * s_l * a_l) + iwp_ * exp_(k_i * s_i * a_i)
            ssa_c = ts / torch.clamp(tau_c, min=1e-12)
            g_c = gt / torch.clamp(ts, min=1e-12)
        else:
            tau_c, ssa_c, g_c = CO.cloud_optics_sw(
                cf["lwp"], cf["iwp"], T_lay, *sfc_cols(1), self.ng_sw)
        tau, ssa, g = CO.combine_optics(
            od_g, ssa_gas.expand(od_g.shape), torch.zeros_like(od_g),
            tau_c, ssa_c, g_c)
        ssa = torch.clamp(ssa, 1e-6, 0.999999)

        # spectral solar weights (learnable softmax ~ solar source fn)
        w_solar = torch.softmax(self.solar_w, dim=0)
        toa = sfc["solin"][:, None] * w_solar[None, :]
        ones = torch.ones((1, self.ng_sw), dtype=toa.dtype, device=toa.device)
        alb_diff = 0.5 * (sfc["aldif"] + sfc["asdif"])[:, None] * ones
        alb_dir = 0.5 * (sfc["aldir"] + sfc["asdir"])[:, None] * ones
        if self.use_tc:
            rd, td, rdir, tdd, tdir = R.calc_ref_trans_sw(
                mu0[..., None], tau, ssa, g)        # [B, L, nreg, ng]
            nreg, ng = tau.shape[2], self.ng_sw

            def fold(a):   # [B, L, nreg, ng] -> [B*ng, L, nreg]
                return a.permute(0, 3, 1, 2).reshape(B * ng, L, nreg)

            V = R.calc_overlap_matrices(cf["region_frac"],
                                        cf["overlap_param"])
            V_g = V.repeat_interleave(ng, dim=0)     # [B*ng, L+1, r, r]
            # all TOA flux enters the (clear) region 0, whose top fraction
            # is 1; the per-region fluxes are area-integrated W/m2
            toa_r = torch.cat([toa.reshape(-1, 1), toa.new_zeros(
                (B * ng, nreg - 1))], dim=1)
            ad_r = alb_diff.reshape(-1, 1).expand(B * ng, nreg)
            adir_r = alb_dir.reshape(-1, 1).expand(B * ng, nreg)
            fluxes = R.adding_sw_tc(toa_r, ad_r, adir_r, fold(rd), fold(td),
                                    fold(rdir), fold(tdd), fold(tdir), V_g)
            # the regions summed -> [B, L+1, ng]
            fup_sw, fdiff_sw, fdir_sw = (
                f.sum(-1).reshape(B, ng, L + 1).transpose(1, 2)
                for f in fluxes)
        else:
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
