"""The ResNet-style 1-D CNN baseline over the vertical column
(counterpart of ``climsim_tpu/models/cnn.py``): ``depth`` residual blocks
of two same-padded convolutions (k 3) with ReLU and dropout and a 1x1
residual projection, an ELU 1x1 convolution to 10 channels, then a
per-level linear head for the 2 tendency channels and a ReLU head for the
8 scalar channels; with ``flat_io`` the v1 flat vectors go in and out
(scalars broadcast to every level on input, level-averaged on output).

Parameters keep flax's names and layout: ``block_{i}.Conv_{0,1,2}``
(flax's auto-names: the two convolutions, then the projection),
``pre_out``, each a ``kernel`` [k, in, out] and a ``bias``, and the Dense
heads ``head_lin``, ``head_relu`` ([in, out]). Activations stay
channels-last [B, L, C], as flax's, and flax's ``nn.Conv(padding="SAME")``
is one GEMM: the k level-shifted copies of the zero-padded input side by
side [B, L, k C] times the kernel as [k C, out]. On an H100 in float32
without TF32, cuDNN's ``conv1d`` runs these shapes through FFT kernels,
13x slower a training update (chip_smoke.py phase 12 times both).

Dropout acts only in a call with ``deterministic=False``, as in flax,
whatever ``module.training`` says: the offline trainer calls the model
as JAX's does (``apply_fn(p, x)``, deterministic), so it trains without
dropout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import constants as C
from ..ops import resolve_device
from .cells import Dense, lecun_normal_
from .common import F32, Policy

NLEV = C.NLEV


def reshape_input_for_cnn(x: torch.Tensor) -> torch.Tensor:
    """v1 flat [B, 124] -> [B, 60, 6]: (T, q, 4 broadcast scalars)."""
    lev = torch.stack([x[:, 0:60], x[:, 60:120]], dim=-1)
    sca = x[:, None, 120:124].expand(-1, NLEV, -1)
    return torch.cat([lev, sca], dim=-1)


def reshape_target_from_cnn(y_img: torch.Tensor) -> torch.Tensor:
    """[B, 60, 10] -> v1 flat [B, 128]: level channels flattened, scalar
    channels level-averaged."""
    lev = torch.cat([y_img[:, :, 0], y_img[:, :, 1]], dim=1)
    sca = y_img[:, :, 2:].mean(dim=1)
    return torch.cat([lev, sca], dim=1)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k,), padding="SAME")`` on [B, L, C]:
    ``kernel`` [k, in, out] (lecun-normal over fan-in k x in), ``bias``
    [out] (zeros), computed in ``dtype``."""

    def __init__(self, nin: int, nout: int, k: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        kernel = torch.zeros((k, nin, nout))
        if generator is not None:
            lecun_normal_(kernel, k * nin, generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(nout))

    def forward(self, x):
        dt = self.dtype
        k, nin, nout = self.kernel.shape
        x = x.to(dt)
        if k > 1:
            # SAME: (k - 1) // 2 zero levels above, the rest below
            lo = (k - 1) // 2
            xp = F.pad(x, (0, 0, lo, k - 1 - lo))
            L = x.shape[1]
            x = torch.cat([xp[:, j:j + L] for j in range(k)], dim=-1)
        return x @ self.kernel.to(dt).reshape(k * nin, nout) \
            + self.bias.to(dt)


class ResBlock1D(nn.Module):
    """Two k-convolutions with ReLU and dropout plus the 1x1 projection
    of the block's input, on [B, L, C]."""

    def __init__(self, nin: int, channels: int, kernel: int = 3,
                 dropout: float = 0.175, policy: Policy = F32,
                 generator: torch.Generator | None = None):
        super().__init__()
        dt = policy.compute_dtype
        self.dropout = dropout
        self.Conv_0 = Conv(nin, channels, kernel, dt, generator)
        self.Conv_1 = Conv(channels, channels, kernel, dt, generator)
        self.Conv_2 = Conv(nin, channels, 1, dt, generator)

    def forward(self, x, deterministic: bool = True):
        drop = lambda h: h if deterministic else F.dropout(h, self.dropout,
                                                           training=True)
        h = drop(F.relu(self.Conv_0(x)))
        h = drop(F.relu(self.Conv_1(h)))
        return h + self.Conv_2(x)


class CNN(nn.Module):
    """1-D residual CNN emulator: input [B, nlev, in_channels] (with
    ``flat_io`` the v1 flat [B, 124]), output [B, nlev, out_channels] (or
    the v1 flat [B, 128]). ``device=None`` means ``"cuda"``; weights from
    ``seed`` as in ``models.mlp.MLP``."""

    def __init__(self, depth: int = 12, channels: int = 406, kernel: int = 3,
                 dropout: float = 0.175, out_channels: int = 10,
                 n_lin: int = 2, policy: Policy = F32, flat_io: bool = True,
                 in_channels: int = 6, device=None, seed: int = 0):
        super().__init__()
        self.depth, self.policy, self.flat_io = depth, policy, flat_io
        g = torch.Generator().manual_seed(seed)
        dt = policy.compute_dtype
        nin = in_channels
        for i in range(depth):
            setattr(self, f"block_{i}", ResBlock1D(nin, channels, kernel,
                                                   dropout, policy, g))
            nin = channels
        self.pre_out = Conv(nin, out_channels, 1, dt, g)
        self.head_lin = Dense(out_channels, n_lin, dt, g)
        self.head_relu = Dense(out_channels, out_channels - n_lin, dt, g)
        self.to(resolve_device(device))

    def forward(self, x, deterministic: bool = True):
        if self.flat_io:
            x = reshape_input_for_cnn(x)
        h = self.policy.cast_in(x)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, deterministic)
        h = F.elu(self.pre_out(h))
        y = torch.cat([self.head_lin(h), F.relu(self.head_relu(h))],
                      dim=-1)
        y = self.policy.cast_out(y)
        if self.flat_io:
            y = reshape_target_from_cnn(y)
        return y

