"""The encoder-decoder (ED) baseline, a bottleneck MLP after Behrens 2022
(counterpart of ``climsim_tpu/models/ed.py``): encoder in -> d -> d ->
d/2 -> d/4 -> d/8 -> d/16 -> latent, decoder d/16 -> ... -> d -> d, all
ReLU, then a Dense to the outputs through ELU. Parameters keep flax's
names (``enc_{i}``, ``dec_{i}``, ``out``) and ``[in, out]`` kernels."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import resolve_device
from .cells import Dense
from .common import F32, Policy


class ED(nn.Module):
    """``device=None`` means ``"cuda"``; weights from ``seed`` as in
    ``models.mlp.MLP``."""

    def __init__(self, in_dim: int, out_dim: int = 128, latent_dim: int = 5,
                 intermediate_dim: int = 463, policy: Policy = F32,
                 device=None, seed: int = 0):
        super().__init__()
        self.policy = policy
        d = intermediate_dim
        enc = [d, d, d // 2, d // 4, d // 8, d // 16, latent_dim]
        dec = [d // 16, d // 8, d // 4, d // 2, d, d]
        self.n_enc, self.n_dec = len(enc), len(dec)
        g = torch.Generator().manual_seed(seed)
        dt = policy.compute_dtype
        nin = in_dim
        for i, w in enumerate(enc):
            setattr(self, f"enc_{i}", Dense(nin, w, dt, g))
            nin = w
        for i, w in enumerate(dec):
            setattr(self, f"dec_{i}", Dense(nin, w, dt, g))
            nin = w
        self.out = Dense(nin, out_dim, dt, g)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.policy.cast_in(x)
        for i in range(self.n_enc):
            h = F.relu(getattr(self, f"enc_{i}")(h))
        for i in range(self.n_dec):
            h = F.relu(getattr(self, f"dec_{i}")(h))
        return self.policy.cast_out(F.elu(self.out(h)))
