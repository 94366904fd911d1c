"""Standardized metric estimators: MAE, RMSE, R2, bias, CRPS (counterpart
of ``climsim_tpu/metrics/metrics.py``), with the reference's conventions:

* every metric reduces over time (axis 0) first, then with ``avg_grid``
  averages over the columns (axis 0 of what is left);
* R2 uses the time-dimension total sum of squares;
* CRPS is the sorted-sample estimator with the pairwise-count spread term.

Shapes: level variables [time, ncol, nlev], scalars [time, ncol]; CRPS
samples stacked on a trailing axis.
"""
from __future__ import annotations

import torch


def mae(pred: torch.Tensor, target: torch.Tensor, avg_grid: bool = True):
    m = torch.abs(pred - target).mean(dim=0)
    return m.mean(dim=0) if avg_grid else m


def rmse(pred: torch.Tensor, target: torch.Tensor, avg_grid: bool = True):
    r = torch.sqrt(torch.square(pred - target).mean(dim=0))
    return r.mean(dim=0) if avg_grid else r


def r2(pred: torch.Tensor, target: torch.Tensor, avg_grid: bool = True):
    sq_diff = torch.square(pred - target)
    tss = torch.square(target - target.mean(dim=0, keepdim=True))
    out = 1.0 - sq_diff.sum(dim=0) / tss.sum(dim=0)
    return out.mean(dim=0) if avg_grid else out


def bias(pred: torch.Tensor, target: torch.Tensor, avg_grid: bool = True):
    b = pred.mean(dim=0) - target.mean(dim=0)
    return b.mean(dim=0) if avg_grid else b


def crps(samplepreds: torch.Tensor, target: torch.Tensor,
         avg_grid: bool = True):
    """Sorted-sample CRPS estimator: samplepreds [..., num_samples] with
    leading dims [time, ncol(, lev)], target without the sample axis."""
    num = samplepreds.shape[-1]
    mae_term = torch.mean(torch.abs(samplepreds - target[..., None]),
                          dim=(0, -1))
    s = torch.sort(samplepreds, dim=-1).values
    diff = s[..., 1:] - s[..., :-1]
    count = torch.arange(1, num, device=s.device) \
        * torch.arange(num - 1, 0, -1, device=s.device)
    spread = (diff * count).sum(dim=-1).mean(dim=0)
    out = mae_term - spread / (num * (num - 1))
    return out.mean(dim=0) if avg_grid else out


METRIC_FNS = {"MAE": mae, "RMSE": rmse, "R2": r2, "bias": bias}
