"""Cloud-condensate feature transforms (counterpart of
``climsim_tpu/physics/transforms.py``): the exponential cloud transform
``q -> 1 - exp(-q * lambda)``, its inverse, the fourth-root transform and
the v4 -> v5 input conversion (qc + qi merged to qn, and a liquid-fraction
channel). All are elementwise tensor operations on any device.
"""
from __future__ import annotations

import torch

from . import thermo

__all__ = ["cloud_exp_transform", "cloud_exp_inverse",
           "cloud_sqrt_transform", "signed_sqrt_scale", "v4_to_v5_inputs"]


def cloud_exp_transform(q: torch.Tensor, lbd: torch.Tensor) -> torch.Tensor:
    """q -> 1 - exp(-q*lambda); lambda broadcasts over levels
    (rnn/utils.py:1809-1815)."""
    return 1.0 - torch.exp(-q * lbd)


def cloud_exp_inverse(y: torch.Tensor, lbd: torch.Tensor,
                      eps: float = 1e-12) -> torch.Tensor:
    """Inverse of the exponential transform: -log(1-y)/lambda, with y
    clipped to [0, 1 - eps] for numerical safety at y -> 1."""
    y = torch.clamp(y, 0.0, 1.0 - eps)
    return -torch.log1p(-y) / lbd


def cloud_sqrt_transform(q: torch.Tensor) -> torch.Tensor:
    """Fourth-root transform q -> q**0.25 (rnn/utils.py:1817-1823)."""
    return torch.sqrt(torch.sqrt(q))


def signed_sqrt_scale(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """sign(y) * sqrt(sqrt(|y|)) * scale, the transform of
    apply_output_norm_numba_sqrt (rnn/utils.py:1856-1865)."""
    return torch.sign(y) * torch.sqrt(torch.sqrt(torch.abs(y))) * scale


def v4_to_v5_inputs(x_lev: torch.Tensor, T: torch.Tensor,
                    lbd_qn: torch.Tensor) -> torch.Tensor:
    """Convert v4 level-input channels to v5: channel 2 (qc) and 3 (qi)
    become the exp-transformed qn and the temperature-diagnosed liquid
    fraction (rnn/utils.py:1799-1807). Returns a new tensor.

    x_lev: [..., nlev, nx] with qc at channel 2, qi at channel 3.
    T:     [..., nlev] air temperature for the liquid-fraction ramp.
    """
    qn = x_lev[..., 2] + x_lev[..., 3]
    out = x_lev.clone()
    out[..., 2] = cloud_exp_transform(qn, lbd_qn)
    out[..., 3] = thermo.liquid_fraction(T)
    return out
