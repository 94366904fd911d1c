"""Heteroskedastic regression (HSR) baseline (counterpart of
``climsim_tpu/models/hsr.py``): two independent towers predict the mean
and the log-precision; the NLL loss ``prec (y - mu)² - logprec`` follows
an MSE-only warm phase; ``hsr_sample`` draws ``mu + eps prec^-1/2`` for
CRPS scoring.

Each tower is Dense -> LayerNorm -> ReLU, ``layers`` times, then a Dense
head. Parameters keep flax's names: ``mean.hidden_{i}``, ``mean.ln_{i}``,
``mean.out`` and the same under ``logprec``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import resolve_device
from .cells import Dense
from .common import F32, Policy
from .norm import LayerNorm


class _Tower(nn.Module):
    def __init__(self, nin: int, out_dim: int, hidden: int, layers: int,
                 policy: Policy, generator: torch.Generator):
        super().__init__()
        self.layers, self.policy = layers, policy
        dt = policy.compute_dtype
        for i in range(layers):
            setattr(self, f"hidden_{i}", Dense(nin if i == 0 else hidden,
                                               hidden, dt, generator))
            setattr(self, f"ln_{i}", LayerNorm(hidden))
        self.out = Dense(hidden if layers else nin, out_dim, dt, generator)

    def forward(self, x):
        h = self.policy.cast_in(x)
        for i in range(self.layers):
            h = getattr(self, f"hidden_{i}")(h)
            h = torch.relu(getattr(self, f"ln_{i}")(h))
        return self.policy.cast_out(self.out(h))


class HSR(nn.Module):
    """``forward(x) -> (mean, logprec)``, each [..., out_dim].
    ``device=None`` means ``"cuda"``; weights from ``seed``."""

    def __init__(self, in_dim: int, out_dim: int = 128, hidden: int = 512,
                 layers: int = 1, policy: Policy = F32, device=None,
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.mean = _Tower(in_dim, out_dim, hidden, layers, policy, g)
        self.logprec = _Tower(in_dim, out_dim, hidden, layers, policy, g)
        self.to(resolve_device(device))

    def forward(self, x):
        return self.mean(x), self.logprec(x)


def hsr_nll(mean, logprec, y, warm: bool = False):
    """The MLE loss, plain MSE while ``warm``."""
    if warm:
        return torch.mean(torch.square(y - mean))
    return torch.mean(torch.exp(logprec) * torch.square(y - mean) - logprec)


def hsr_sample(model: HSR, x, num_samples: int = 1, *, noise):
    """Samples mu + eps prec^-1/2, [..., out_dim, num_samples]. ``noise``
    is the standard-normal draw eps, shaped as the result."""
    mean, logprec = model(x)
    std = torch.exp(-0.5 * logprec)
    return mean[..., None] + noise * std[..., None]
