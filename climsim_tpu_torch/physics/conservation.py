"""Column energy and water conservation residuals (counterpart of
``climsim_tpu/physics/conservation.py``), the physics terms of the
rollout loss.

The reference's energy and water functions use constants that differ
slightly from ``constants.py`` (1/g = 1/9.8 for energy, 1/9.806 for
water); they are kept here as they are, so loss curves stay comparable.

Output-channel layout of the keeplev v4 target tensor:
  lev channels  [dT, dqv, dql, dqi, du, dv]
  sfc channels  [NETSW, FLWDS, PRECSC, PRECC, SOLS, SOLL, SOLSD, SOLLD]
"""
from __future__ import annotations

import torch

_CP_E = 1004.0
_LV_E = 2.5104e6
_LS_E = 2.8440e6
_ONE_OVER_G_ENERGY = 0.1020408163   # 1/9.8
_ONE_OVER_G_WATER = 0.1019716213    # 1/9.806


def layer_thickness(sp: torch.Tensor, hyai: torch.Tensor,
                    hybi: torch.Tensor, one_over_g: float) -> torch.Tensor:
    """dp/g per layer from surface pressure [B] -> [B, nlev]."""
    dhyb = hybi[1:] - hybi[:-1]
    dhya = hyai[1:] - hyai[:-1]
    return one_over_g * (sp[:, None] * dhyb + 1.0e5 * dhya)


def energy_residual(y_lev, y_sfc, sp, hyai, hybi) -> torch.Tensor:
    """Column energy residual [W m-2] per sample: y_lev [B, nlev, >=4]
    tendencies (dT, dqv, dql, dqi, ...), y_sfc [B, >=4] with PRECSC at 2
    and PRECC at 3."""
    thick = layer_thickness(sp, hyai, hybi, _ONE_OVER_G_ENERGY)
    dT, dql, dqi = y_lev[:, :, 0], y_lev[:, :, 2], y_lev[:, :, 3]
    snow = 1000.0 * y_sfc[:, 2]
    prec = 1000.0 * y_sfc[:, 3]
    rain = prec - snow
    col = torch.sum(thick * (dT * _CP_E - dql * _LV_E - dqi * _LS_E), dim=1)
    return col - rain * _LV_E - snow * _LS_E


def energy_conservation_mse(y_true_lev, y_true_sfc, y_pred_lev, y_pred_sfc,
                            sp, hyai, hybi,
                            timesteps: int = 1) -> torch.Tensor:
    """MSE between predicted and true column-energy residuals, each
    averaged over the rollout window first."""
    e_t = energy_residual(y_true_lev, y_true_sfc, sp, hyai, hybi)
    e_p = energy_residual(y_pred_lev, y_pred_sfc, sp, hyai, hybi)
    e_t = e_t.reshape(timesteps, -1).mean(dim=0)
    e_p = e_p.reshape(timesteps, -1).mean(dim=0)
    return torch.mean(torch.square(e_p - e_t))


def water_residual(y_lev, y_sfc, sp, hyai, hybi) -> torch.Tensor:
    """Column water residual [kg m-2 s-1] per sample: the vertically
    integrated total-water tendency plus surface precipitation."""
    thick = layer_thickness(sp, hyai, hybi, _ONE_OVER_G_WATER)
    dq_tot = torch.sum(y_lev[:, :, 1:4], dim=2)
    lhs = torch.sum(thick * dq_tot, dim=1)
    return lhs + 1000.0 * y_sfc[:, 3]


def water_conservation_mse(y_pred_lev, y_pred_sfc, sp, hyai, hybi,
                           timesteps: int = 1) -> torch.Tensor:
    r = water_residual(y_pred_lev, y_pred_sfc, sp, hyai, hybi)
    r = r.reshape(timesteps, -1).mean(dim=0)
    return torch.mean(torch.square(r))


def cloud_water_path(y_lev, sp, hyai, hybi) -> torch.Tensor:
    """Vertically integrated condensate tendency per sample."""
    thick = layer_thickness(sp, hyai, hybi, _ONE_OVER_G_WATER)
    return torch.sum(thick * torch.sum(y_lev[:, :, 2:4], dim=2), dim=1)
