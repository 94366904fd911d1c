"""Probabilistic losses and ensemble diagnostics for stochastic and
ensemble training (counterpart of ``climsim_tpu/train/probabilistic.py``):
sample-sorted CRPS, L1-kernel CRPS, almost-fair CRPS, the spread-skill
ratio, the variogram score, the energy score and the Dawid-Sebastiani
score. Ensemble members ride on a leading axis [M, B, ...]. Plain
functions on tensors; autograd gives their gradients."""
from __future__ import annotations

import math

import torch

__all__ = ["crps_sample_sorted", "crps_kernel", "crps_almost_fair",
           "spread_skill_ratio", "variogram_score", "energy_score",
           "dawid_sebastiani"]


def crps_sample_sorted(ens: torch.Tensor, obs: torch.Tensor,
                       beta: float = 1.0) -> torch.Tensor:
    """Sorted-sample CRPS, mean over batch and features. ens [M, ...],
    obs [...]; ``beta`` scales the skill term."""
    M = ens.shape[0]
    mae = beta * torch.mean(torch.abs(ens - obs[None]), dim=0)
    s = torch.sort(ens, dim=0).values
    diff = s[1:] - s[:-1]
    count = torch.arange(1, M, device=ens.device) \
        * torch.arange(M - 1, 0, -1, device=ens.device)
    count = count.reshape((-1,) + (1,) * obs.dim()).to(ens.dtype)
    spread = torch.sum(diff * count, dim=0) / (M * (M - 1))
    return torch.mean(mae - spread)


def _pair_spread(ens: torch.Tensor) -> torch.Tensor:
    """sum over member pairs of |X_i - X_j| [...]."""
    return torch.sum(torch.abs(ens[:, None] - ens[None, :]), dim=(0, 1))


def crps_kernel(ens: torch.Tensor, obs: torch.Tensor, fair: bool = True,
                beta: float = 1.0) -> torch.Tensor:
    """L1-kernel CRPS: beta E|X - y| - 0.5 E|X - X'|; the fair form
    divides the spread term by M (M - 1)."""
    M = ens.shape[0]
    term1 = beta * torch.mean(torch.abs(ens - obs[None]), dim=0)
    denom = M * (M - 1) if fair else M * M
    term2 = 0.5 * _pair_spread(ens) / denom
    return torch.mean(term1 - term2)


def crps_almost_fair(ens: torch.Tensor, obs: torch.Tensor,
                     alpha: float = 0.95,
                     beta: float = 1.0) -> torch.Tensor:
    """Almost-fair CRPS: the spread term interpolates the fair
    (1 / (M (M - 1))) and biased (1 / M^2) estimators by ``alpha``."""
    M = ens.shape[0]
    term1 = beta * torch.mean(torch.abs(ens - obs[None]), dim=0)
    e_spread = _pair_spread(ens)
    fair = e_spread / (M * (M - 1))
    biased = e_spread / (M * M)
    term2 = 0.5 * (alpha * fair + (1.0 - alpha) * biased)
    return torch.mean(term1 - term2)


def spread_skill_ratio(ens: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Ensemble spread over the RMSE of the ensemble mean, with the
    (M + 1) / M inflation; about 1 for a reliable ensemble."""
    M = ens.shape[0]
    mean = torch.mean(ens, dim=0)
    skill = torch.sqrt(torch.mean(torch.square(mean - obs)))
    spread = torch.sqrt(torch.mean(torch.var(ens, dim=0, correction=1)))
    return math.sqrt((M + 1) / M) * spread / torch.clamp(skill, min=1e-30)


def variogram_score(ens: torch.Tensor, obs: torch.Tensor, p: float = 0.5,
                    max_pairs: int = 64) -> torch.Tensor:
    """Variogram score of order p over the trailing feature axis, on a
    strided subset of neighbouring feature pairs. ens [M, B, D], obs
    [B, D]."""
    D = obs.shape[-1]
    stride = max(1, D // max_pairs)
    # features 0, stride, ... below D - 1 and each one's right neighbour
    lo, hi = slice(0, D - 1, stride), slice(1, D, stride)
    o_d = torch.abs(obs[..., lo] - obs[..., hi]) ** p
    e_d = torch.mean(torch.abs(ens[..., lo] - ens[..., hi]) ** p, dim=0)
    return torch.mean(torch.square(o_d - e_d))


def energy_score(ens: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Multivariate energy score E||X - y|| - 0.5 E||X - X'||. ens
    [M, B, D], obs [B, D]; the norm carries 1e-24 under its root so the
    gradient at the pair diagonal stays finite."""
    M = ens.shape[0]

    def safe_norm(x):
        return torch.sqrt(torch.sum(torch.square(x), dim=-1) + 1e-24)

    t1 = torch.mean(safe_norm(ens - obs[None]), dim=0)
    pair = safe_norm(ens[:, None] - ens[None, :])
    t2 = 0.5 * torch.sum(pair, dim=(0, 1)) / (M * (M - 1))
    return torch.mean(t1 - t2)


def dawid_sebastiani(ens: torch.Tensor, obs: torch.Tensor,
                     eps: float = 1e-12) -> torch.Tensor:
    """Dawid-Sebastiani score from the ensemble mean and variance."""
    mean = torch.mean(ens, dim=0)
    var = torch.var(ens, dim=0, correction=1) + eps
    return torch.mean(torch.log(var) + torch.square(obs - mean) / var)
