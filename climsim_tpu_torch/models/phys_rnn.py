"""Physics-constrained RNN emulator: flux and process-rate microphysics
with differentiable radiation (counterpart of
``climsim_tpu/models/phys_rnn.py::PhysicalRNNAutoreg``, the reference's
``physical_RNN_autoreg``, rnn/models/models_phys.py:25-706).

The decoder predicts per-sub-grid-region state decompositions,
mass-flux/eddy-diffusive vertical fluxes with zero boundary conditions and
microphysical process rates, clamped for positivity in the reference's
order (models_phys.py:535-559); tendencies follow from conservation
equations with the model's own latent heats, and precipitation is
semi-prognostic (a stored pool in the last memory slot). With
``use_physrad`` the ``RadiationModule`` computes heating on all 60 levels
and the radiative surface scalars from the updated state and the sub-grid
condensate (McICA-sampled when ``use_mcica``, region-resolved with
overlap when ``use_tc``, with learned optics when
``learned_cloud_optics``). Without it, heads on the trunk emulate the
radiation: the trunk then runs on all levels with the memory zero-padded
above the CRM, or, with ``separate_radiation``, a second GRU pair
(``rnn1_rad``/``rnn2_rad``, width ``nh_rad``) on all levels takes the
gas channels and the padded latent memory (models_phys.py:1585-1690).

Layout is batch-first [B, L, ...]; the CRM occupies the bottom
``L - ilev_crm`` levels. The trunk is either two ``RNNLayer`` GRU sweeps
(``use_pallas=False``, the default and what ``conf/autoreg_physrnn.yaml``
builds: the JAX CLI reads ``use_pallas`` from the yaml, which sets none;
parameters ``rnn_up``/``rnn_down``; ``nneur`` may be unequal) or the v2
fused BiGRU (``use_pallas=True``, kernel B7 on the card; parameters
``bigru_fused``; equal ``nneur``). The radiation solvers are kernels B11
and B12.

Policies: under ``BF16`` the inputs are cast to bfloat16 and, as in
JAX, every array the model builds in the input's dtype is bfloat16 too
(the hybrid coefficients and so the pressures, the yscales, the output
buffer, the cloud paths and the constant gases); the Dense layers
promote to the float32 parameters, so the trunk (B7 with the fused one)
and the radiation solvers (B11, B12) run in float32.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .. import constants as C
from ..ops import resolve_device
from ..physics import radiation as RAD
from ..physics import thermo
from .cells import FusedBiGRULayer, RNNLayer
from .common import F32, Policy, weak
from .phys_rad import RadiationModule
from .rnn import Dense, temperature_scaling, temperature_scaling_precip

DT = 1200.0
_VMR = 1.608079364     # water vapor mass -> volume mixing ratio


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _pad_top(x: torch.Tensor, ic: int, dtype: torch.dtype) -> torch.Tensor:
    """[B, Lc, ...] -> [B, ic + Lc, ...] in ``dtype`` with zeros above the
    CRM (JAX's ``zeros(..., dtype).at[:, ic:].set(x)``)."""
    z = torch.zeros((x.shape[0], ic) + tuple(x.shape[2:]), dtype=dtype,
                    device=x.device)
    return torch.cat([z, x.to(dtype)], dim=1)


def largest_regions(area_frac: torch.Tensor) -> torch.Tensor:
    """The indices of the two largest subgrid regions [..., 2], the lower
    index first among equal fractions (jax.lax.top_k's order): a stable
    descending sort."""
    return torch.argsort(-area_frac, dim=-1, stable=True)[..., :2]


class PhysicalRNNAutoreg(nn.Module):
    """Flux-predicting physical emulator. Keyword names and defaults follow
    the flax module; ``device=None`` means ``"cuda"`` (and raises without a
    CUDA device); parameters get flax's init (lecun-normal kernels, zero
    biases, the radiation's constants) from a ``torch.Generator`` seeded
    with ``seed``.

    ``separate_radiation`` only matters without ``use_physrad``, as in
    JAX.

    Call: (x_main [B, L, nx] normalized, x_sfc [B, nx_sfc] normalized,
           mem [B, L - ilev_crm, nh_mem + 1] with the stored precip in the
           last slot, x_denorm [B, L, >=4] RAW state with T at 0, qliq 2,
           qice 3 and qv at ``qv_channel``, y_true [B, L, ny] optional)
      -> (out [B, L, ny] scaled, out_sfc [B, ny_sfc] scaled, new_mem, aux)
    """

    def __init__(self, nx: int, nx_sfc: int, ny: int = 5, ny_sfc: int = 8,
                 nneur: Sequence[int] = (128, 128), nh_mem: int = 16,
                 nreg: int = 8, use_clear_sky_region: bool = True,
                 pred_subgrid_temp: bool = True,
                 pred_subgrid_liq_frac: bool = False,
                 ice_sedimentation: bool = True, store_precip: bool = True,
                 allow_extra_heating: bool = False,
                 condense_supersaturated: bool = False,
                 use_physrad: bool = False, separate_radiation: bool = False,
                 gas_channels: tuple = (12, 13, 14), nh_rad: int = 96,
                 update_states_for_rad: bool = True, use_mcica: bool = False,
                 use_tc: bool = False, use_qv_variability: bool = False,
                 learned_cloud_optics: bool = False, ng_lw: int = 8,
                 ng_sw: int = 8, ilev_crm: int = 10, qv_channel: int = -1,
                 add_pres: bool = False, grav: float = 9.8066500,
                 lv: float = 2.5104e6, ls: float = 2.8440e6,
                 hyai: Sequence[float] = (), hybi: Sequence[float] = (),
                 hyam: Sequence[float] = (), hybm: Sequence[float] = (),
                 sp_mean: float = 0.0, sp_div: float = 1.0,
                 yscale_t=1.0, yscale_qv=1.0, yscale_qn=1.0,
                 yscale_precc: float = 1.0, use_pallas: bool = False,
                 pallas_acc32: bool = True, policy: Policy = F32,
                 device=None, seed: int = 0):
        super().__init__()
        nh1, nh2 = nneur[0], nneur[1]
        if use_pallas and nh1 != nh2:
            # the fused kernel requires nh1 == nh2 and owns a different
            # parameter tree (bigru_fused vs rnn_up/rnn_down)
            raise ValueError(
                f"use_pallas=True requires nneur[0] == nneur[1]; got "
                f"({nh1}, {nh2}). Set use_pallas=False for unequal sweeps.")
        self.device = resolve_device(device)
        self.use_pallas = use_pallas
        self.ny, self.ny_sfc, self.nh_mem, self.nreg = ny, ny_sfc, nh_mem, nreg
        self.ilev_crm, self.qv_channel = ilev_crm, qv_channel
        self.gas_channels = tuple(gas_channels)
        self.use_physrad = use_physrad
        # separate radiation only without physical radiation, as in JAX
        self.separate_radiation = separate_radiation and not use_physrad
        self.use_clear_sky_region = use_clear_sky_region
        self.pred_subgrid_temp = pred_subgrid_temp
        self.pred_subgrid_liq_frac = pred_subgrid_liq_frac
        self.ice_sedimentation = ice_sedimentation
        self.store_precip = store_precip
        self.allow_extra_heating = allow_extra_heating
        self.condense_supersaturated = condense_supersaturated
        self.update_states_for_rad = update_states_for_rad
        self.use_mcica, self.use_qv_variability = use_mcica, use_qv_variability
        self.use_tc, self.learned_cloud_optics = use_tc, learned_cloud_optics
        self.ng_lw, self.ng_sw = ng_lw, ng_sw
        self.add_pres = add_pres
        self.grav, self.lv, self.ls = grav, lv, ls
        self.sp_mean, self.sp_div = sp_mean, sp_div
        self.yscale_precc = yscale_precc
        self.policy = policy
        f32 = torch.float32
        t = lambda a: torch.as_tensor(a, dtype=f32)
        # static coefficients: buffers outside the state_dict, so the flax
        # parameter tree maps one to one
        for name, v in (("hyai", hyai), ("hybi", hybi), ("hyam", hyam),
                        ("hybm", hybm), ("yscale_t", yscale_t),
                        ("yscale_qv", yscale_qv), ("yscale_qn", yscale_qn)):
            self.register_buffer(name, t(v), persistent=False)

        g = torch.Generator().manual_seed(seed)
        d = lambda a, b: Dense(a, b, f32, g)
        # creation order = flax's module order
        crm_trunk = use_physrad or self.separate_radiation
        nx_in = nx + (1 if add_pres else 0)
        n_keep = len([c for c in range(nx_in)
                      if not (crm_trunk and c in self.gas_channels)])
        nreg_q = nreg - 1 if use_clear_sky_region else nreg
        self.mlp_initial = d(n_keep, nh1)
        self.mlp_surface1 = d(nx_sfc - 5 if crm_trunk else nx_sfc, nh1)
        self.mlp_toa1 = d(2, nh2)
        if use_pallas:
            self.bigru_fused = FusedBiGRULayer(nh1 + nh_mem, nh1,
                                               acc32=pallas_acc32,
                                               generator=g)
        else:
            self.rnn_up = RNNLayer(nh1 + nh_mem, nh1, reverse=True,
                                   dtype=f32, generator=g)
            self.rnn_down = RNNLayer(nh1, nh2, dtype=f32, generator=g)
        self.mlp_latent = d(nh2, nh_mem)
        if self.separate_radiation:
            self.mlp_surface_init_rad = d(5, nh_rad)
            self.rnn1_rad = RNNLayer(len(self.gas_channels) + nh_mem, nh_rad,
                                     reverse=True, dtype=f32, generator=g)
            self.mlp_toa_rad = d(2, nh_rad)
            self.rnn2_rad = RNNLayer(nh_rad, nh_rad, dtype=f32, generator=g)
            self.mlp_output_rad = d(nh_rad, 1)
            self.mlp_surface_output_rad = d(nh_rad, ny_sfc - 2)
        elif not use_physrad:
            self.mlp_output_rad = d(nh2, 1)
            self.mlp_surface_output_rad = d(nh2, ny_sfc - 2)
        self.mlp_output = d(nh_mem, ny)
        self.mlp_qv_crm = d(nh2, nreg)
        self.mlp_qn_crm = d(nh2, nreg_q)
        self.mlp_subgrid_area_frac = d(nh2, nreg)
        if pred_subgrid_temp:
            self.mlp_t_crm = d(nh2, nreg)
        self.mlp_massflux = d(nh2, nreg)
        self.mlp_eddy_diff = d(nh2, nreg if pred_subgrid_temp else 1)
        if ice_sedimentation:
            self.mlp_qice_crm = d(nh2, nreg)
            self.mlp_sed_qn_crm = d(nh2, nreg)
        self.mlp_evap_prec_crm = d(nh2, nreg)
        self.mlp_evap_cond_vapor_crm = d(nh2, nreg_q)
        self.mlp_mp_aa_crm = d(nh2, nreg)
        if pred_subgrid_liq_frac:
            self.mlp_liq_frac_crm = d(nh2, nreg)
        if store_precip:
            self.mlp_precip_release = d(nh2, 1)
        if use_physrad:
            self.mlp_surface_output = d(nh2, ny_sfc)
            if use_tc:
                self.mlp_overlap = d(nh_mem, 1)
            self.radiation = RadiationModule(
                ng_lw=ng_lw, ng_sw=ng_sw, use_tc=use_tc,
                learned_cloud_optics=learned_cloud_optics,
                n_latent=nh_mem if learned_cloud_optics else 0, generator=g)
        self.to(self.device)

    def forward(self, x_main, x_sfc, mem, x_denorm, y_true=None,
                generator: torch.Generator | None = None):
        """``y_true`` (optional, [B, L, ny] normalized): with
        ``update_states_for_rad`` the radiation sees the state updated by
        the TRUE tendencies instead of the model's own, the reference's
        training-mode teacher forcing (models_phys.py:1722-1741).
        ``generator`` draws the per-g-point choice between the two vapor
        passes of ``use_qv_variability``; without one they are averaged."""
        B, L, _ = x_main.shape
        pol = self.policy
        ic = self.ilev_crm
        Lc = L - ic
        nreg = self.nreg
        dev = x_main.device

        x_main = pol.cast_in(x_main)
        x_sfc = pol.cast_in(x_sfc)
        mem_lat = pol.cast_in(mem[..., :self.nh_mem])
        P_old = mem[:, -1, -1]                       # stored precip pool
        # the arrays JAX builds in the input's dtype (bf16 under BF16)
        dt = x_main.dtype

        # ---- pressure geometry from raw ps, in the input's dtype
        sp = x_sfc[:, 0] * weak(self.sp_div, dt) + weak(self.sp_mean, dt)
        p0 = weak(1e5, dt)
        plev = p0 * self.hyai.to(dt) + sp[:, None] * self.hybi.to(dt)
        play = p0 * self.hyam.to(dt) + sp[:, None] * self.hybm.to(dt)
        if self.add_pres:
            # sqrt(p)/314 appended as the LAST input channel
            # (rnn/layers.py:101-121); the gas channels keep their places
            x_main = torch.cat(
                [x_main, (torch.sqrt(play) / 314.0)[..., None]], dim=-1)

        # ---- bi-RNN trunk. With physical or separate radiation it sees
        # the CRM levels without the gas channels and the radiation
        # surface inputs (models_phys.py:1581-1584,1607-1610); otherwise
        # every level, the memory zero-padded above the CRM (:1585-1599)
        sep = self.separate_radiation
        if self.use_physrad or sep:
            keep = [c for c in range(x_main.shape[-1])
                    if c not in self.gas_channels]
            trunk_in = x_main[:, ic:, keep]
            x_sfc_crm = torch.cat([x_sfc[:, 0:6], x_sfc[:, 11:]], dim=1)
            mem_in = mem_lat
        else:
            trunk_in, x_sfc_crm = x_main, x_sfc
            mem_in = _pad_top(mem_lat, ic, mem_lat.dtype)
        h = torch.tanh(self.mlp_initial(trunk_in))
        h = torch.cat([h, mem_in], dim=-1)
        hx1 = torch.tanh(self.mlp_surface1(x_sfc_crm))
        x_toa = torch.cat([x_sfc[:, 1:2], x_sfc[:, 6:7]], dim=1)
        hx2 = self.mlp_toa1(x_toa)
        if self.use_pallas:
            rnn2out_full, last_h = self.bigru_fused(h, hx1, hx2)
        else:
            up, _ = self.rnn_up(h, hx1)
            rnn2out_full, last_h = self.rnn_down(up, hx2)
        new_mem_full = self.mlp_latent(rnn2out_full)
        if self.use_physrad:
            rnn2out, new_mem_lat = rnn2out_full, new_mem_full
        elif sep:
            # the radiation BiGRU on every level: the gas channels and
            # the zero-padded latent
            rnn2out, new_mem_lat = rnn2out_full, new_mem_full
            gases_in = torch.stack([x_main[:, :, c]
                                    for c in self.gas_channels], dim=-1)
            x_rad = torch.cat([gases_in, _pad_top(new_mem_lat, ic,
                                                  new_mem_lat.dtype)], dim=-1)
            upr, _ = self.rnn1_rad(x_rad,
                                   self.mlp_surface_init_rad(x_sfc[:, 6:11]))
            rad_out, last_h_rad = self.rnn2_rad(upr, self.mlp_toa_rad(x_toa))
            dT_rad_ml = self.mlp_output_rad(rad_out)
            sfc_rad_ml = F.relu(self.mlp_surface_output_rad(last_h_rad))
        else:
            rnn2out = rnn2out_full[:, ic:]
            new_mem_lat = new_mem_full[:, ic:]
            dT_rad_ml = self.mlp_output_rad(rnn2out_full)
            sfc_rad_ml = F.relu(self.mlp_surface_output_rad(last_h))
        out_raw = self.mlp_output(new_mem_lat)

        dp = (plev[:, 1:] - plev[:, :-1])[:, ic:]    # [B, Lc]
        inv_dp = 1.0 / dp[..., None]

        # ---- raw GCM state on the CRM levels
        T_gcm = x_denorm[:, ic:, 0:1]
        qliq_gcm = x_denorm[:, ic:, 2:3]
        qice_gcm = x_denorm[:, ic:, 3:4]
        qn_gcm = qliq_gcm + qice_gcm
        qc = self.qv_channel
        qv_gcm = x_denorm[:, ic:, qc:qc + 1] if qc >= 0 \
            else x_denorm[:, ic:, -1:]

        # ---- 1. sub-grid decomposition (mean-preserving rescale)
        latent = rnn2out
        qv_crm = _softplus(self.mlp_qv_crm(latent))
        qn_crm = _softplus(self.mlp_qn_crm(latent))
        zreg = torch.zeros((B, Lc, 1), dtype=qn_crm.dtype, device=dev)
        if self.use_clear_sky_region:
            qn_crm = torch.cat([zreg, qn_crm], dim=-1)
        area_frac = torch.softmax(self.mlp_subgrid_area_frac(latent), dim=-1)

        def rescale(q_crm, q_gcm):
            mean = torch.sum(q_crm * area_frac, -1, keepdim=True)
            scale = torch.where(mean == 0, 1.0,
                                q_gcm / torch.clamp(mean, min=1e-30))
            return q_crm * scale

        qv_crm = rescale(qv_crm, qv_gcm)
        qn_crm = rescale(qn_crm, qn_gcm)
        if self.pred_subgrid_temp:
            dT_sub = self.mlp_t_crm(latent)
            dT_sub = dT_sub - torch.sum(dT_sub * area_frac, -1, keepdim=True)
            T_crm = T_gcm + dT_sub
        else:
            T_crm = T_gcm

        # ---- 2. vertical fluxes (zero BCs at CRM top and surface); the
        # model's own gravity 9.80665 (models_phys.py:199-200)
        g = self.grav
        sf = -g                                      # -g d(flux)/dp
        flux1 = self.mlp_massflux(rnn2out)
        eddy = self.mlp_eddy_diff(rnn2out)

        play_crm = play[:, ic:]
        pd0 = (play_crm - play[:, ic - 1:-1])[..., None]
        flux_H = eddy * (C.CP / g) * T_crm * pd0
        zer1 = torch.zeros((B, 1, nreg), dtype=flux_H.dtype, device=dev)
        zerH = torch.zeros((B, 1, flux_H.shape[-1]), dtype=flux_H.dtype,
                           device=dev)
        flux_H = torch.cat([zerH, flux_H[:, :-1], zerH], dim=1)
        flux_t_dp = (sf / C.CP) * (flux_H[:, 1:] - flux_H[:, :-1]) * inv_dp

        fm = 3.0e5
        fqv = fm * flux1 * qv_crm
        fqn = fm * flux1 * qn_crm
        fqv = torch.cat([zer1, fqv[:, :-1], zer1], dim=1)
        fqn = torch.cat([zer1, fqn[:, :-1], zer1], dim=1)
        flux_qv_dp = sf * (fqv[:, 1:] - fqv[:, :-1]) * inv_dp
        flux_qn_dp = sf * (fqn[:, 1:] - fqn[:, :-1]) * inv_dp

        # yscales in the input's dtype: scalars or per-level columns of
        # length L, sliced to the CRM levels for [B, Lc, nreg] and [B, Lc]
        ys_t_full, ys_qv_full, ys_qn_full = (
            self.yscale_t.to(dt), self.yscale_qv.to(dt),
            self.yscale_qn.to(dt))
        crm3 = lambda a: a if a.ndim == 0 else a[ic:].reshape(1, -1, 1)
        crm2 = lambda a: a if a.ndim == 0 else a[ic:].reshape(1, -1)
        ys_t, ys_qv, ys_qn = crm3(ys_t_full), crm3(ys_qv_full), \
            crm3(ys_qn_full)
        ys_t2, ys_qv2 = crm2(ys_t_full), crm2(ys_qv_full)
        if self.ice_sedimentation:
            qice_crm = _softplus(self.mlp_qice_crm(latent))
            qice_crm = rescale(qice_crm, qice_gcm)
            sed = F.relu(self.mlp_sed_qn_crm(rnn2out))
            sed = sed * g * qice_crm * ys_qn
            sedimentation = torch.sum(area_frac[:, -1] * sed[:, -1], -1)
            sed = torch.cat([zer1, sed], dim=1)
            sed_qn_dp = sf * (sed[:, 1:] - sed[:, :-1]) * inv_dp
        else:
            sedimentation = torch.zeros((B,), dtype=dt, device=dev)
            sed_qn_dp = 0.0

        # ---- 3. process rates + ORDERED positivity clamps (:535-559)
        dqv_evap_prec = F.relu(self.mlp_evap_prec_crm(rnn2out)) + 1.0e-6
        dq_cond = self.mlp_evap_cond_vapor_crm(rnn2out)
        if self.use_clear_sky_region:
            dq_cond = torch.cat([torch.zeros((B, Lc, 1), dtype=dq_cond.dtype,
                                             device=dev), dq_cond], dim=-1)
        if self.store_precip:
            # distribute the stored pool over levels, weight evaporation
            P_vert = torch.softmax(out_raw[:, :, 2], dim=1) * P_old[:, None]
            dqv_evap_prec = dqv_evap_prec * P_vert[..., None]

        alpha = F.relu(self.mlp_mp_aa_crm(rnn2out))
        dqn_aa = alpha * qn_crm * ys_qn

        ice_term = sed_qn_dp
        minval = -(ys_qn * qn_crm / DT) - flux_qn_dp + dqn_aa - ice_term
        dq_cond = torch.maximum(dq_cond, minval)
        minval = -(ys_qv * qv_crm / DT) - flux_qv_dp + dq_cond
        dqv_evap_prec = torch.maximum(dqv_evap_prec, minval)
        qn_max = 0.0006
        minval = flux_qn_dp + dq_cond + ice_term \
            - ys_qn * (qn_max - qn_crm) / DT
        dqn_aa = torch.maximum(dqn_aa, minval)

        # ---- 4. conservation equations
        dqv_crm = flux_qv_dp - dq_cond + dqv_evap_prec
        dqn_crm = flux_qn_dp + dq_cond - dqn_aa
        if self.ice_sedimentation:
            dqn_crm = dqn_crm + sed_qn_dp
        dT_crm = flux_t_dp
        # latent-heat branches as the reference (models_phys.py:573-598)
        if self.pred_subgrid_liq_frac or self.pred_subgrid_temp:
            if self.pred_subgrid_liq_frac:
                liq_frac_crm = torch.sigmoid(self.mlp_liq_frac_crm(rnn2out))
            else:
                temp = T_crm + dT_crm / ys_t * DT
                liq_frac_crm = temperature_scaling(temp)
            net_cond = (1.0 / C.CP) * (
                (liq_frac_crm * self.lv + (1 - liq_frac_crm) * self.ls)
                * dq_cond - self.lv * dqv_evap_prec)
        else:
            temp = T_gcm[..., 0] \
                + torch.sum(area_frac * dT_crm, 2) / ys_t2 * DT
            liq_frac = temperature_scaling(temp)[..., None]
            dq_cond_s = torch.sum(area_frac * dq_cond, 2, keepdim=True)
            dqv_ep_s = torch.sum(area_frac * dqv_evap_prec, 2, keepdim=True)
            net_cond = (1.0 / C.CP) * (
                (liq_frac * self.lv + (1 - liq_frac) * self.ls) * dq_cond_s
                - self.lv * dqv_ep_s)
            liq_frac_crm = liq_frac
        net_cond = (net_cond / ys_qv) * ys_t
        dT_crm = dT_crm + net_cond

        dT = torch.sum(area_frac * dT_crm, 2, keepdim=True)
        dqv = torch.sum(area_frac * dqv_crm, 2, keepdim=True)
        dqn = torch.sum(area_frac * dqn_crm, 2, keepdim=True)
        d_prec = torch.sum(area_frac * (dqn_aa - dqv_evap_prec), 2)

        if self.condense_supersaturated:
            qv_new = F.relu(qv_gcm + DT * dqv / ys_qv)
            temp2 = F.relu(T_gcm + DT * dT / ys_t)
            qsat = thermo.qsat(temp2[..., 0], play_crm)[..., None]
            qv_excess = torch.clamp(qv_new - qsat, min=0.0) / DT
            dqv = dqv - qv_excess * ys_qv
            dqn = dqn + qv_excess * ys_qn
            lf = temperature_scaling(temp2)
            dT = dT + (1.0 / C.CP) * (lf * self.lv + (1 - lf) * self.ls) \
                * qv_excess * ys_t

        # ---- 5. semi-prognostic precipitation (:647-677)
        one_over_g = weak(1.0 / g, dt)
        water_new = torch.sum(one_over_g * dp * d_prec, dim=1)
        if self.store_precip:
            water_new = P_old + water_new
            prec_negative = F.relu(-water_new)
            water_new = F.relu(water_new)
            release = torch.sigmoid(self.mlp_precip_release(last_h))[:, 0]
            water_released = release * water_new
            water_stored = water_new * (1.0 - release)
            Tsfc = x_denorm[:, -1, 0]
            Pmax = 1000.0 * self.yscale_precc * 5.58e-18 \
                * torch.exp(0.077 * Tsfc)
            water_excess = F.relu(water_stored - Pmax)
            water_stored = water_stored - water_excess
            precip = sedimentation + water_released + water_excess
        else:
            prec_negative = F.relu(-water_new)
            water_new = F.relu(water_new)
            water_stored = torch.zeros_like(water_new)
            precip = sedimentation + water_new

        precc = precip / 1000.0
        snowfrac = temperature_scaling_precip(x_denorm[:, -1, 0])
        precsc = snowfrac * precc

        # ---- assemble outputs (winds stay pure-ML) in the input's dtype,
        # as JAX's buffer; precc/precsc enter raw (models_phys.py:678,1758)
        out = torch.zeros((B, L, self.ny), dtype=dt, device=dev)
        out[:, ic + 2:, -2:] = out_raw[:, 2:, -2:]
        out[:, ic:, 0:1] = out_raw[:, :, 0:1] + dT \
            if self.allow_extra_heating else dT
        out[:, ic:, 1:2] = dqv
        out[:, ic:, 2:3] = dqn
        if not self.use_physrad:
            # ML radiation (models_phys.py:1688-1690,1758): heating on
            # every level, ReLU'd scalars around the diagnosed precip
            # pair; JAX's .at[].add casts the addend to the buffer's dtype
            out[:, :, 0:1] = out[:, :, 0:1] + dT_rad_ml.to(dt)
            out_sfc = torch.cat([sfc_rad_ml[:, 0:2], precsc[:, None],
                                 precc[:, None], sfc_rad_ml[:, 2:]], dim=1)
            return self._finish(out, out_sfc, new_mem_lat, water_stored,
                                prec_negative, area_frac, liq_frac_crm,
                                qv_crm, qn_crm, T_crm)
        out_sfc = self.mlp_surface_output(last_h).clone()
        out_sfc[:, 2] = precsc
        out_sfc[:, 3] = precc

        # ---- radiation on the CRM-updated state (models_phys.py:
        # 1717-1741): tendencies from y_true when teacher-forced
        qv_col = x_denorm[:, :, qc] if qc >= 0 else x_denorm[:, :, -1]
        if self.update_states_for_rad:
            if y_true is not None:
                dT_src, dqv_src = y_true[:, ic:, 0], y_true[:, ic:, 1]
            else:
                dT_src, dqv_src = dT[..., 0], dqv[..., 0]
            T_new_crm = F.relu(T_gcm[..., 0] + DT * (dT_src / ys_t2))
            T_full = torch.cat([x_denorm[:, :ic, 0], T_new_crm], dim=1)
            # subgrid water updated by the per-region tendencies
            # (models_phys.py:679-683), and qv like T (:1733-1737)
            qv_crm = F.relu(qv_crm + DT * dqv_crm / ys_qv)
            qn_crm = F.relu(qn_crm + DT * dqn_crm / ys_qn)
            qv_col = torch.cat([qv_col[:, :ic], F.relu(
                qv_col[:, ic:] + DT * (dqv_src / ys_qv2))], dim=1)
        else:
            T_full = x_denorm[:, :, 0]
        # sub-grid condensate -> grid-mean water paths [g/m2] with the
        # area-weighted liquid fraction split, in the input's dtype
        lf_r = liq_frac_crm * torch.ones_like(qn_crm)
        qn_mean = torch.sum(area_frac * qn_crm, -1)           # [B, Lc]
        lf_mean = torch.sum(area_frac * lf_r, -1) \
            / torch.clamp(torch.sum(area_frac, -1), min=1e-9)
        clouds = {
            "lwp": _pad_top(1000.0 * qn_mean * lf_mean * dp / C.GRAV, ic,
                            dt),
            "iwp": _pad_top(1000.0 * qn_mean * (1.0 - lf_mean) * dp
                            / C.GRAV, ic, dt)}
        if self.use_tc:
            # per-region paths; above the CRM everything is the clear
            # region 0; the overlap parameter of each interior interface
            # from the latent memory (op 1 above the CRM, irrelevant there)
            path_r = 1000.0 * qn_crm * dp[..., None] / C.GRAV
            clouds["lwp_r"] = _pad_top(path_r * lf_r, ic, dt)
            clouds["iwp_r"] = _pad_top(path_r * (1.0 - lf_r), ic, dt)
            top = torch.zeros((B, ic, nreg), dtype=dt, device=dev)
            top[:, :, 0] = 1.0
            clouds["region_frac"] = torch.cat([top, area_frac.to(dt)], dim=1)
            op_crm = torch.sigmoid(self.mlp_overlap(new_mem_lat[:, :-1, :]))
            clouds["overlap_param"] = torch.cat(
                [torch.ones((B, ic), dtype=dt, device=dev),
                 op_crm[..., 0].to(dt)], dim=1)
        if self.use_mcica:
            # stratified sampling of g-points among the subgrid regions by
            # area (models_phys.py:862-886)
            p_flat = area_frac.reshape(B * Lc, nreg)
            for tag, ng in (("sw", self.ng_sw), ("lw", self.ng_lw)):
                idx = RAD.stratified_sample(p_flat, ng).reshape(B, Lc, ng)
                qn_g = RAD.take_small_axis(qn_crm, idx)
                lf_g = RAD.take_small_axis(lf_r, idx)
                path_g = 1000.0 * qn_g * dp[..., None] / C.GRAV
                clouds[f"lwp_{tag}_g"] = _pad_top(path_g * lf_g, ic, dt)
                clouds[f"iwp_{tag}_g"] = _pad_top(path_g * (1.0 - lf_g), ic,
                                                  dt)
        # grid-mean water vapor as vmr (models_phys.py:946)
        qv_col = torch.clamp(qv_col, 0.0, 0.05)
        vmr_col = qv_col / (1.0 - qv_col) * _VMR
        full = lambda v: torch.full((B, L), v, dtype=dt, device=dev)
        gases = {"o3": full(2e-6), "ch4": full(9.7e-7), "n2o": full(4.8e-7),
                 "h2o": vmr_col}
        if self.use_qv_variability:
            top2 = largest_regions(area_frac)
            qv2 = torch.clamp(RAD.take_small_axis(qv_crm, top2), 0.0, 0.05)
            vmr2 = qv2 / (1.0 - qv2) * _VMR
            for key, i in (("h2o_a", 0), ("h2o_b", 1)):
                gases[key] = torch.cat([vmr_col[:, :ic], vmr2[..., i]],
                                       dim=1)
        clouds.update({"landfrac": x_sfc[:, 13], "icefrac": x_sfc[:, 12],
                       "snowh": F.relu(x_sfc[:, 16])})
        if self.learned_cloud_optics:
            clouds["latent"] = _pad_top(new_mem_lat, ic, dt)
        sfc_rad = {"coszrs": F.relu(x_sfc[:, 6]),
                   "solin": F.relu(x_sfc[:, 1]) * 1360.0,
                   "lwup": 5.67e-8 * RAD.pow4(torch.clamp(
                       x_denorm[:, -1, 0], 150.0, 350.0)),
                   "aldif": torch.sigmoid(x_sfc[:, 7]),
                   "aldir": torch.sigmoid(x_sfc[:, 8]),
                   "asdif": torch.sigmoid(x_sfc[:, 9]),
                   "asdir": torch.sigmoid(x_sfc[:, 10])}
        heating, scalars = self.radiation(T_full, play, plev, gases, clouds,
                                          sfc_rad, generator)
        ys_line = ys_t_full if ys_t_full.ndim == 0 \
            else ys_t_full.reshape(1, -1)
        out[:, :, 0] = out[:, :, 0] + (heating * ys_line).to(dt)
        for i, k in ((0, "NETSW"), (1, "FLWDS"), (4, "SOLS"), (5, "SOLL"),
                     (6, "SOLSD"), (7, "SOLLD")):
            out_sfc[:, i] = scalars[k]
        return self._finish(out, out_sfc, new_mem_lat, water_stored,
                            prec_negative, area_frac, liq_frac_crm, qv_crm,
                            qn_crm, T_crm)

    def _finish(self, out, out_sfc, new_mem_lat, water_stored,
                prec_negative, area_frac, liq_frac_crm, qv_crm, qn_crm,
                T_crm):
        """(out, out_sfc, new memory with the stored pool, aux) in the
        policy's output dtype."""
        B, Lc = new_mem_lat.shape[:2]
        pol = self.policy
        new_mem = torch.cat(
            [new_mem_lat, water_stored[:, None, None].expand(B, Lc, 1)],
            dim=-1)
        aux = {"prec_negative": prec_negative, "area_frac": area_frac,
               "liq_frac_crm": liq_frac_crm, "qv_crm": qv_crm,
               "qn_crm": qn_crm, "T_crm": T_crm,
               "water_stored": water_stored}
        return (pol.cast_out(out), pol.cast_out(out_sfc),
                pol.cast_out(new_mem), aux)
