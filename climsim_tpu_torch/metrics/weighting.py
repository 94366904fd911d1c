"""The standardized output weighting, unscale -> dp/g -> area -> energy
units (counterpart of ``climsim_tpu/metrics/weighting.py``), as one
elementwise pass over the flat output tensor:

  [0] undo the output scaling   y / scale   (if the data was normalized)
  [1] x dp/g                    level variables only; dp from the hybrid
                                interface pressures of each sample's ps
  [2] x area_wgt                area / mean(area) per column
  [3] x energy conversion       cp (dT), Lv (dq-like), Lv rho_h2o
                                (precipitation); winds (conversion None)
                                are weighted by 1
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from .. import variables as V
from ..grid import Grid


def static_feature_weights(vset: V.VariableSet,
                           dtype=np.float64) -> np.ndarray:
    """Per-feature energy-conversion multiplier [ny] (chain step [3])."""
    out = np.ones(vset.outputs.total, dtype)
    for name in vset.outputs.names:
        conv = V.ENERGY_CONV.get(name, 1.0)
        out[vset.outputs.slices[name]] = 1.0 if conv is None else conv
    return out


def lev_feature_mask(vset: V.VariableSet, dtype=np.float64) -> np.ndarray:
    """1.0 for the features of level variables [ny]."""
    out = np.zeros(vset.outputs.total, dtype)
    for name in vset.outputs.names:
        if V.var_len(name) == V.NLEV:
            out[vset.outputs.slices[name]] = 1.0
    return out


def weight_outputs(y: torch.Tensor, ps_raw: torch.Tensor,
                   vset: V.VariableSet, grid: Grid,
                   scale: torch.Tensor | None = None) -> torch.Tensor:
    """The full weighting chain: y [T, ncol, ny] scaled (normalized) or
    raw flat outputs, ps_raw [T, ncol] raw surface pressure [Pa], scale
    [ny] the output scaling to undo (None: y is raw). Returns [T, ncol,
    ny] in common energy units (W/m^2 for the energy variables), on y's
    device and in its dtype."""
    dev, dt = y.device, y.dtype
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    if scale is not None:
        y = y / t(scale)
    dp_over_g = grid.layer_thickness(t(ps_raw)) / C.GRAV   # [T, ncol, nlev]
    # feature j of a level variable at level l takes dp[..., l]; scalars
    # take 1
    lev_index = np.zeros(vset.outputs.total, np.int64)
    for name in vset.outputs.lev_names:
        lev_index[vset.outputs.slices[name]] = np.arange(V.NLEV)
    dp_feat = dp_over_g[..., torch.as_tensor(lev_index, device=dev)]
    mask = torch.as_tensor(lev_feature_mask(vset) > 0, device=dev)
    y = y * torch.where(mask, dp_feat.to(dt), torch.ones((), dtype=dt,
                                                         device=dev))
    y = y * grid.area_wgt.to(device=dev, dtype=dt)[None, :, None]
    return y * t(static_feature_weights(vset))


def recover_ps(x: torch.Tensor, vset: V.VariableSet, mean_ps: float,
               div_ps: float, normalized: bool = True) -> torch.Tensor:
    """Raw surface pressure from the flat input tensor."""
    ps = x[..., vset.ps_index]
    if normalized:
        ps = ps * div_ps + mean_ps
    return ps


def split_variables(y: torch.Tensor,
                    vset: V.VariableSet) -> dict[str, torch.Tensor]:
    """A flat [..., ny] tensor split per output variable ([..., nlev] for
    level variables, [...] for scalars)."""
    out = {}
    for name in vset.outputs.names:
        sl = vset.outputs.slices[name]
        arr = y[..., sl]
        out[name] = arr[..., 0] if sl.stop - sl.start == 1 else arr
    return out
