"""Training losses (counterpart of ``climsim_tpu/train/losses.py``): the
huber/mse/mae menu, the per-feature weighted loss, the Clausius-Clapeyron
RH-consistency term on the raw state, the GEL loss on window-accumulated
precipitation, the absolute batch-mean bias, the per-variable weight
vector ``block_weights`` and the GEL loss ``gel_loss``."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import variables as V
from ..physics import thermo


def huber(pred, target, delta: float = 1.0):
    a = torch.abs(pred - target)
    quad = torch.clamp(a, max=delta)
    return torch.mean(0.5 * quad ** 2 + delta * (a - quad))


def mse(pred, target):
    return torch.mean(torch.square(pred - target))


def mae(pred, target):
    return torch.mean(torch.abs(pred - target))


LOSS_FNS = {"huber": huber, "mse": mse, "mae": mae}


def block_weights(vset: V.VariableSet, weights: dict[str, float],
                  default: float = 1.0, dtype=np.float32) -> np.ndarray:
    """Per-feature weight vector [ny] from per-variable weights: every
    feature of output variable ``name`` gets ``weights[name]``, the rest
    ``default``."""
    w = np.full(vset.outputs.total, default, dtype)
    for name, val in weights.items():
        w[vset.outputs.slices[name]] = val
    return w


def weighted_loss(pred, target, feature_w, kind: str = "huber",
                  delta: float = 1.0):
    """Mean of the per-element loss times ``feature_w`` (broadcast
    against the trailing axes)."""
    err = pred - target
    if kind == "mse":
        per = torch.square(err)
    elif kind == "mae":
        per = torch.abs(err)
    else:
        a = torch.abs(err)
        quad = torch.clamp(a, max=delta)
        per = 0.5 * quad ** 2 + delta * (a - quad)
    return torch.mean(per * feature_w)


def rh_consistency_loss(dqv_raw, dT_raw, qv_old, T_old, pmid,
                        dt: float = 1200.0, rh_max: float = 1.05):
    """Penalty on predicted states that become supersaturated: the mean
    square of RH above ``rh_max`` after one step of ``dt`` seconds
    (rnn/metrics.py:318-476). All arguments in raw units: tendencies,
    state and pmid [Pa] of one shape, e.g. [B, L]."""
    qv_new = torch.clamp(qv_old + dt * dqv_raw, min=0.0)
    T_new = torch.clamp(T_old + dt * dT_raw, min=100.0)
    rh = thermo.specific_to_relative_humidity_cc(qv_new, T_new, pmid)
    return torch.mean(torch.square(torch.clamp(rh - rh_max, min=0.0)))


def gel_loss(pred, target, lam: float = 1.0, fac: float = 1e-5):
    """Gamma-exponentiated loss (rnn/metrics.py:1068-1105 ``get_GEL``):
    |2^(1/lam) - min(2^E, 100)| with E = sum(beta - alpha log beta) /
    (lam n) over the eps-shifted, fac-scaled values, alpha = p/t, beta =
    max(p^2/t, eps). NaN terms are left out of the sum but count in n,
    as the reference's nansum / numel."""
    eps = torch.finfo(torch.float32).eps
    p = fac * pred + eps
    t = fac * target + eps
    beta = torch.clamp(torch.square(p) / t, min=eps)
    alpha = p / t
    diff = beta - alpha * torch.log(beta)
    expterm = torch.nansum(diff) / (lam * diff.numel())
    loss = torch.clamp(torch.pow(2.0, expterm), max=100.0)
    return torch.abs(2.0 ** (1.0 / lam) - loss)


def gel_precip_loss(true_sfc, pred_sfc, timesteps: int, lam: float = 1.0,
                    precc_index: int = 3, fac: float = 10000.0,
                    batch_mean=None):
    """GEL on window-accumulated precipitation: average the PRECC channel
    over the rollout window per column, then the ratio form 2^E. Args are
    [T*B, ny_sfc] stacked over the window. Above E = 30 the penalty grows
    linearly, so early garbage predictions give a large finite loss that
    still carries a gradient. ``batch_mean`` (default ``torch.mean``)
    takes E's mean over the columns (a sharded epoch's is global)."""
    eps = torch.finfo(torch.float32).eps
    pt = true_sfc[:, precc_index].reshape(timesteps, -1).mean(dim=0)
    pp = pred_sfc[:, precc_index].reshape(timesteps, -1).mean(dim=0)
    beta = torch.clamp(torch.square(fac * pp + eps) / (fac * pt + eps),
                       min=eps)
    alpha = (fac * pp + eps) / (fac * pt + eps)
    terms = beta - alpha * torch.log(beta)
    expterm = (torch.mean(terms) if batch_mean is None
               else batch_mean(terms)) / lam
    expterm = torch.clamp(expterm, max=1e6)
    return torch.exp2(torch.clamp(expterm, max=30.0)) \
        * (1.0 + F.relu(expterm - 30.0))


def absolute_bias_loss(pred_lev, true_lev, pred_sfc, true_sfc,
                       skip_top: int = 12, batch_nanmean=None):
    """Mean absolute batch-mean bias over level (below ``skip_top``) and
    surface outputs: pred/true_lev [N, L, ny], pred/true_sfc [N, ny_sfc];
    N may stack the rollout window. ``batch_nanmean`` (default
    ``torch.nanmean`` over dim 0) takes the batch means (a sharded
    epoch's are global)."""
    m = batch_nanmean or (lambda a: torch.nanmean(a, dim=0))
    d_lev = torch.abs(m(true_lev[:, skip_top:]) - m(pred_lev[:, skip_top:]))
    d_sfc = torch.abs(m(true_sfc) - m(pred_sfc))
    return torch.nanmean(torch.cat([torch.nanmean(d_lev, dim=0), d_sfc]))
