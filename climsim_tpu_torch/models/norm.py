"""flax's ``nn.LayerNorm`` and ``nn.GroupNorm`` (flax 0.12), written to
flax's formula where it differs from torch's ``layer_norm`` and
``group_norm``:

* the statistics are taken in float32 as Var = E[x²] − E[x]², clipped
  at 0 (flax's ``use_fast_variance=True``), not by a two-pass or Welford
  reduction;
* the input is normalized as (x − mean) · (rsqrt(var + eps) · scale) +
  bias, the scale folded into the reciprocal first;
* the result takes the promoted type of the input and the float32
  parameters (float32 for a bfloat16 input), as flax's does.

Parameters keep flax's names: ``scale`` (ones) and ``bias`` (zeros).
LayerNorm's epsilon defaults to flax's 1e-6 (torch's is 1e-5).
"""
from __future__ import annotations

import torch
from torch import nn


def _normalize(x, mean, var, scale, bias, eps):
    mul = torch.rsqrt(var + eps) * scale
    return (x - mean) * mul + bias


def _stats(xf: torch.Tensor, dims):
    mean = xf.mean(dims, keepdim=True)
    mean2 = (xf * xf).mean(dims, keepdim=True)
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()`` over the last axis of ``features``; with a
    tuple of sizes, over that many trailing axes together, its scale and
    bias of that shape (flax's ``reduction_axes=feature_axes=(-2, -1)``
    for two)."""

    def __init__(self, features: int | tuple, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        shape = tuple(features) if isinstance(features, tuple) \
            else (features,)
        self.dims = tuple(range(-len(shape), 0))
        self.scale = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x):
        dt = torch.promote_types(x.dtype, torch.float32)
        mean, var = _stats(x.to(torch.float32), self.dims)
        return _normalize(x.to(dt), mean, var, self.scale, self.bias,
                          self.epsilon)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, epsilon)`` on channels-last
    [B, ..., C]: the statistics of each group of C / num_groups channels
    over every axis but the batch's."""

    def __init__(self, num_groups: int, channels: int,
                 epsilon: float = 1e-6):
        super().__init__()
        if num_groups <= 0 or channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {channels} "
                             "channels")
        self.num_groups, self.epsilon = num_groups, epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        B, C = x.shape[0], x.shape[-1]
        G = self.num_groups
        dt = torch.promote_types(x.dtype, torch.float32)
        xg = x.to(torch.float32).reshape(B, -1, G, C // G)
        mean, var = _stats(xg, (1, 3))                # [B, 1, G, 1]
        shape = (B,) + (1,) * (x.dim() - 2) + (C,)
        expand = lambda s: s.expand(B, 1, G, C // G).reshape(shape)
        return _normalize(x.to(dt), expand(mean), expand(var), self.scale,
                          self.bias, self.epsilon)
