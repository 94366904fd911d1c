"""Conditional VAE baseline (counterpart of ``climsim_tpu/models/cvae.py``):
encoder [y, x] -> (mu, log sigma) -> reparameterized z; decoder [z, x] ->
(y mean, y std); training loss ``mean(0.5 (y - mean)² / std + log std) +
beta KL``; sampling draws z from the prior and adds output noise
``mean + eps std`` for CRPS scoring.

The reference's forms stay as JAX writes them: sigma = exp(linear
log-STD) (not a log-variance), std = exp(final log-STD), and KL =
mean(sigma² + mu² − log sigma − 1/2).

Every draw comes in from the caller (``noise``): the reparameterization's
eps at each update, z and eps at sampling. Parameters keep flax's names:
``enc.h{i}``, ``enc.ln{i}``, ``enc_mu``, ``enc_logstd``, ``dec.h{i}``,
``dec.ln{i}``, ``dec_mean``, ``dec_logstd``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import resolve_device
from .cells import Dense
from .common import F32, Policy
from .norm import LayerNorm


class _MLPStack(nn.Module):
    """Dense -> LayerNorm -> ReLU for each width."""

    def __init__(self, nin: int, widths, policy: Policy,
                 generator: torch.Generator):
        super().__init__()
        self.n, self.policy = len(widths), policy
        for i, w in enumerate(widths):
            setattr(self, f"h{i}", Dense(nin, w, policy.compute_dtype,
                                         generator))
            setattr(self, f"ln{i}", LayerNorm(w))
            nin = w

    def forward(self, x):
        h = self.policy.cast_in(x)
        for i in range(self.n):
            h = torch.relu(getattr(self, f"ln{i}")(getattr(self, f"h{i}")(h)))
        return h


class CVAE(nn.Module):
    """``in_dim`` conditioning inputs x, ``out_dim`` targets y.
    ``device=None`` means ``"cuda"``; weights from ``seed``. The four
    linear maps around the latent run in float32 (flax's default dtype),
    whatever the policy."""

    def __init__(self, in_dim: int, out_dim: int = 128, latent_dim: int = 5,
                 hidden: int = 512, layers: int = 2, policy: Policy = F32,
                 device=None, seed: int = 0):
        super().__init__()
        self.latent_dim = latent_dim
        g = torch.Generator().manual_seed(seed)
        widths = (hidden,) * layers
        f32 = torch.float32
        self.enc = _MLPStack(out_dim + in_dim, widths, policy, g)
        self.enc_mu = Dense(hidden, latent_dim, f32, g)
        self.enc_logstd = Dense(hidden, latent_dim, f32, g)
        self.dec = _MLPStack(latent_dim + in_dim, widths, policy, g)
        self.dec_mean = Dense(hidden, out_dim, f32, g)
        self.dec_logstd = Dense(hidden, out_dim, f32, g)
        self.to(resolve_device(device))

    def encode(self, y, x):
        h = self.enc(torch.cat([y, x], dim=-1))
        return self.enc_mu(h), self.enc_logstd(h)

    def decode(self, z, x):
        h = self.dec(torch.cat([z, x], dim=-1))
        return self.dec_mean(h), torch.exp(self.dec_logstd(h))

    def forward(self, y, x, eps):
        """(mean, std, kl) with z = mu + eps sigma; ``eps`` [..., latent]
        standard normal."""
        mu, logstd = self.encode(y, x)
        sigma = torch.exp(logstd)
        mean, std = self.decode(mu + eps * sigma, x)
        kl = torch.mean(sigma ** 2 + mu ** 2 - logstd - 0.5)
        return mean, std, kl

    def sample(self, x, noise=None, random: bool = True):
        """A conditional sample of y [..., out_dim]: z from the prior and
        mean + eps std, ``noise`` the draws (z [..., latent], eps
        [..., out_dim]); with ``random=False`` the decoder's mean at
        z = 0."""
        if not random:
            return self.decode(x.new_zeros(x.shape[:-1] + (self.latent_dim,)),
                               x)[0]
        z, eps = noise
        mean, std = self.decode(z, x)
        return mean + eps * std


def cvae_loss(model: CVAE, y, x, eps, beta: float = 1.0):
    mean, std, kl = model(y, x, eps)
    nll = torch.mean(0.5 * torch.square(y - mean) / std + torch.log(std))
    return nll + beta * kl


def cvae_samples(model: CVAE, x, num_samples: int = 32, *, noise):
    """[B, out_dim, S] conditional samples for CRPS, the S samples decoded
    as one batch of S x B rows. ``noise``: the draws (z [S, B, latent],
    eps [S, B, out_dim])."""
    z, eps = noise
    mean, std = model.decode(z, x.expand((num_samples,) + x.shape))
    return torch.movedim(mean + eps * std, 0, -1)
