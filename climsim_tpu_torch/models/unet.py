"""1-D EDM-style U-Net over the vertical column, the ClimSim-Online U-Net
(counterpart of ``climsim_tpu/models/unet.py``), and its cloud-state
classifier.

Profile variables are channels over the 60-level column, zero-padded at
the top to ``seq_resolution`` 64; scalars are broadcast over the levels
and a learnable 385 x 8 column-location embedding is appended. Residual
blocks (GroupNorm, SiLU, convolution) with single-head attention at the
configured resolutions make the encoder and decoder; identity-initialized
1x1 skip convolutions (frozen unless ``skip_conv``) join them; the skip
scale is 1/sqrt(2); the output convolution starts at zero; the scalar
head is ReLU'd and averaged over the levels; the stratosphere is pruned
from every level output but the first.

Activations stay channels-last [B, L, C] as JAX's. Each convolution is
``models/cnn.py::Conv``: one GEMM of the k level-shifted copies (on an
H100 in float32, cuDNN's ``conv1d`` runs such shapes through FFT
kernels, PERF.md §6). The attention over 64 levels is two batched
products with the scores and softmax in float32. Resampling is factor-2
mean pooling and nearest-neighbour repetition.

Three of JAX's behaviours are kept, because the parameters JAX trains are
the ones its tree holds:

* a frozen ``IdentityConv`` (``skip_conv=False``) computes with its
  detached kernel, so its gradient is zero, but it stays a parameter:
  ``adamw`` with weight decay shrinks it, as optax's does;
* ``emb_loc[0]`` feeds every column when ``loc_embedding`` is False, so
  that row trains;
* dropout acts only in a call with ``deterministic=False``, as flax's;
  the offline trainer and the classifier's steps call the model with
  the default, so they train without it.

Parameters keep flax's names: ``enc_in``, ``enc_{res}_{down,block{b}}``
with ``GroupNorm_0``, ``conv0``, ``GroupNorm_1``, ``conv1``, ``skip`` and
``AttnBlock_0`` (``GroupNorm_0``, ``qkv``, ``proj``), ``skipconv_{i}``,
``dec_{res}_{in0,in1,up,block{b}}``, the final ``GroupNorm_0``,
``out_conv``, ``emb_loc``; the classifier's under ``backbone``.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import resolve_device
from .cnn import Conv
from .common import F32, Policy
from .norm import GroupNorm

SKIP_SCALE = 0.5 ** 0.5


def _down(x):
    """Factor-2 mean pooling over the level axis ([B, L, C] -> [B, L/2,
    C])."""
    return 0.5 * (x[:, 0::2, :] + x[:, 1::2, :])


def _up(x):
    """Nearest-neighbour upsampling over the level axis."""
    return torch.repeat_interleave(x, 2, dim=1)


def _groups(channels: int) -> int:
    return min(32, channels // 4)


class AttnBlock(nn.Module):
    """EDM self-attention over the levels: softmax(q k^T / sqrt(c_head))
    in float32, single-head by default (the ClimSim U-Net pins
    num_heads=1)."""

    def __init__(self, channels: int, policy: Policy = F32,
                 num_heads: int = 1, generator=None):
        super().__init__()
        self.num_heads = num_heads
        dt = policy.compute_dtype
        self.GroupNorm_0 = GroupNorm(_groups(channels), channels)
        self.qkv = Conv(channels, 3 * channels, 1, dt, generator)
        self.proj = Conv(channels, channels, 1, dt)

    def forward(self, x):
        B, L, C = x.shape
        nh = self.num_heads
        ch = C // nh
        q, k, v = self.qkv(self.GroupNorm_0(x)).split(C, dim=-1)
        heads = lambda a: a.reshape(B, L, nh, ch).transpose(1, 2)
        q, k, v = heads(q), heads(k), heads(v)       # [B, nh, L, ch]
        w = torch.matmul(q.float(), (k.float() / math.sqrt(ch))
                         .transpose(-1, -2))
        w = torch.softmax(w, dim=-1).to(x.dtype)
        a = torch.matmul(w, v).transpose(1, 2).reshape(B, L, C)
        return (x + self.proj(a)) * SKIP_SCALE


class UNetBlock(nn.Module):
    """EDM residual block: GroupNorm, SiLU, optional resampling, conv (k 3),
    GroupNorm, dropout, conv (k 3, zero-initialized), plus the input
    through a learned 1x1 ``skip`` whenever the width changes or the
    block resamples; then optional attention."""

    def __init__(self, cin: int, cout: int, up: bool = False,
                 down: bool = False, attention: bool = False,
                 dropout: float = 0.10, policy: Policy = F32,
                 generator=None):
        super().__init__()
        dt = policy.compute_dtype
        self.up, self.down, self.dropout = up, down, dropout
        self.GroupNorm_0 = GroupNorm(_groups(cin), cin)
        self.conv0 = Conv(cin, cout, 3, dt, generator)
        self.GroupNorm_1 = GroupNorm(_groups(cout), cout)
        self.conv1 = Conv(cout, cout, 3, dt)
        self.skip = (Conv(cin, cout, 1, dt, generator)
                     if cin != cout or up or down else None)
        self.AttnBlock_0 = (AttnBlock(cout, policy, generator=generator)
                            if attention else None)

    def forward(self, x, deterministic: bool = True):
        h = F.silu(self.GroupNorm_0(x))
        if self.up:
            h, x = _up(h), _up(x)
        elif self.down:
            h, x = _down(h), _down(x)
        h = self.GroupNorm_1(self.conv0(h))
        if not deterministic:
            h = F.dropout(h, self.dropout, training=True)
        h = self.conv1(h)
        if self.skip is not None:
            x = self.skip(x)
        h = (h + x) * SKIP_SCALE
        if self.AttnBlock_0 is not None:
            h = self.AttnBlock_0(h)
        return h


class IdentityConv(nn.Module):
    """A 1x1 convolution initialized to the identity (``kernel`` [1, C,
    C], ``bias`` zeros); frozen unless ``trainable``: it then computes with
    the detached parameters, so their gradient is zero."""

    def __init__(self, channels: int, trainable: bool = False):
        super().__init__()
        self.trainable = trainable
        self.kernel = nn.Parameter(torch.eye(channels)[None])
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        kernel, bias = self.kernel, self.bias
        if not self.trainable:
            kernel, bias = kernel.detach(), bias.detach()
        return x @ kernel[0].to(x.dtype) + bias.to(x.dtype)


class ClimsimUNet(nn.Module):
    """Flat-vector in and out, the reference's contract: x =
    [profiles (nvp x 60), scalars (nvs), location index (1)] -> y =
    [output profiles (nvpo x 60), output scalars (nvso)].
    ``device=None`` means ``"cuda"``; weights from ``seed``."""

    def __init__(self, num_vars_profile: int, num_vars_scalar: int,
                 num_vars_profile_out: int, num_vars_scalar_out: int,
                 seq_resolution: int = 64, model_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 2, 2, 2),
                 num_blocks: int = 4, attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.10, n_model_levels: int = 60,
                 output_prune: bool = False, strato_lev: int = 12,
                 loc_embedding: bool = False, skip_conv: bool = False,
                 prev_2d: bool = False, policy: Policy = F32, device=None,
                 seed: int = 0):
        super().__init__()
        self.nvp, self.nvs = num_vars_profile, num_vars_scalar
        self.nvpo = num_vars_profile_out
        self.L, self.seq = n_model_levels, seq_resolution
        self.channel_mult = tuple(channel_mult)
        self.num_blocks = num_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.loc_embedding, self.prev_2d = loc_embedding, prev_2d
        self.policy = policy
        g = torch.Generator().manual_seed(seed)
        dt = policy.compute_dtype
        mc = model_channels
        block = lambda name, cin, cout, **kw: setattr(
            self, name, UNetBlock(cin, cout, dropout=dropout, policy=policy,
                                  generator=g, **kw))

        self.enc_in = Conv(self.nvp + self.nvs + 8, mc, 3, dt, g)
        skips, ch = [mc], mc
        for level, mult in enumerate(self.channel_mult):
            res = seq_resolution >> level
            if level > 0:
                block(f"enc_{res}_down", ch, ch, down=True)
                skips.append(ch)
            for b in range(num_blocks):
                block(f"enc_{res}_block{b}", ch, mc * mult,
                      attention=res in self.attn_resolutions)
                ch = mc * mult
                skips.append(ch)
        self.n_skips = len(skips)
        for i, c in enumerate(skips):
            setattr(self, f"skipconv_{i}", IdentityConv(c, skip_conv))
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            res = seq_resolution >> level
            if level == len(self.channel_mult) - 1:
                block(f"dec_{res}_in0", ch, ch, attention=True)
                block(f"dec_{res}_in1", ch, ch)
            else:
                block(f"dec_{res}_up", ch, ch, up=True)
            for b in range(num_blocks + 1):
                attn = b == num_blocks and res in self.attn_resolutions
                block(f"dec_{res}_block{b}", ch + skips.pop(), mc * mult,
                      attention=attn)
                ch = mc * mult
        self.GroupNorm_0 = GroupNorm(_groups(ch), ch)
        self.out_conv = Conv(ch, self.nvpo + num_vars_scalar_out, 3, dt)
        self.emb_loc = nn.Parameter(torch.randn((385, 8), generator=g))
        mask = None
        if output_prune:
            mask = np.ones(self.nvpo * self.L + num_vars_scalar_out,
                           np.float32)
            for v in range(1, self.nvpo):       # all but ptend_t
                mask[v * self.L: v * self.L + strato_lev] = 0.0
            mask = torch.as_tensor(mask)
        self.register_buffer("prune_mask", mask, persistent=False)
        self.to(resolve_device(device))

    def forward(self, x, deterministic: bool = True):
        nvp, L = self.nvp, self.L
        pad = self.seq - L
        if not self.prev_2d:
            # the previous step's 2-D inputs are zeroed
            x = torch.cat([x[:, :-8], torch.zeros_like(x[:, -8:-3]),
                           x[:, -3:]], dim=1)
        B = x.shape[0]
        x_profile = x[:, :nvp * L].reshape(B, nvp, L)
        x_scalar = x[:, nvp * L:-1]
        if self.loc_embedding:
            idx = torch.clamp(x[:, -1].to(torch.int32), 0, 384)
            loc = self.emb_loc[idx.long()]
        else:
            loc = self.emb_loc[0].expand(B, 8)
        h = torch.cat([x_profile.transpose(1, 2),
                       x_scalar[:, None, :].expand(B, L, self.nvs),
                       loc[:, None, :].expand(B, L, 8)], dim=-1)
        h = self.policy.cast_in(F.pad(h, (0, 0, pad, 0)))

        blocks = lambda name: getattr(self, name)(h, deterministic)
        h = self.enc_in(h)
        skips = [h]
        for level, mult in enumerate(self.channel_mult):
            res = self.seq >> level
            if level > 0:
                h = blocks(f"enc_{res}_down")
                skips.append(h)
            for b in range(self.num_blocks):
                h = blocks(f"enc_{res}_block{b}")
                skips.append(h)
        skips = [getattr(self, f"skipconv_{i}")(s)
                 for i, s in enumerate(skips)]
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            res = self.seq >> level
            if level == len(self.channel_mult) - 1:
                h = blocks(f"dec_{res}_in0")
                h = blocks(f"dec_{res}_in1")
            else:
                h = blocks(f"dec_{res}_up")
            for b in range(self.num_blocks + 1):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = blocks(f"dec_{res}_block{b}")

        h = self.out_conv(F.silu(self.GroupNorm_0(h)))
        h = self.policy.cast_out(h)[:, pad:, :]
        nvpo = self.nvpo
        y_profile = h[..., :nvpo].transpose(1, 2).reshape(B, nvpo * L)
        y_scalar = torch.relu(h[..., nvpo:]).mean(dim=1)
        y = torch.cat([y_profile, y_scalar], dim=1)
        if self.prune_mask is not None:
            y = y * self.prune_mask.to(y.dtype)
        return y


def unet_v4(**kw) -> ClimsimUNet:
    """The v4 configuration: 25 profile and 24 scalar inputs (and the
    location index), 6 profile and 8 scalar outputs, pruned."""
    args = dict(num_vars_profile=25, num_vars_scalar=24,
                num_vars_profile_out=6, num_vars_scalar_out=8,
                output_prune=True)
    args.update(kw)
    return ClimsimUNet(**args)


def unet_v5(**kw) -> ClimsimUNet:
    """The v5 configuration: 22 profile and 24 scalar inputs (and the
    location index), 5 profile and 8 scalar outputs, pruned."""
    args = dict(num_vars_profile=22, num_vars_scalar=24,
                num_vars_profile_out=5, num_vars_scalar_out=8,
                output_prune=True)
    args.update(kw)
    return ClimsimUNet(**args)


class ClimsimUNetClassifier(nn.Module):
    """The cloud-state classifier U-Net: per-level logits [B, nvar, 3, L]
    of the cloud tendency's regime, on a ``ClimsimUNet`` backbone with a
    dummy scalar head."""

    def __init__(self, num_vars_profile: int, num_vars_scalar: int,
                 num_profile_out: int = 1, num_classes: int = 3,
                 seq_resolution: int = 64, model_channels: int = 64,
                 channel_mult: Sequence[int] = (1, 2, 2),
                 num_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.0, n_model_levels: int = 60,
                 loc_embedding: bool = False, policy: Policy = F32,
                 device=None, seed: int = 0):
        super().__init__()
        self.nvar, self.ncls, self.L = (num_profile_out, num_classes,
                                        n_model_levels)
        self.backbone = ClimsimUNet(
            num_vars_profile, num_vars_scalar,
            num_profile_out * num_classes, 1, seq_resolution,
            model_channels, channel_mult, num_blocks, attn_resolutions,
            dropout, n_model_levels, output_prune=False,
            loc_embedding=loc_embedding, policy=policy, device=device,
            seed=seed)

    def forward(self, x, deterministic: bool = True):
        y = self.backbone(x, deterministic)
        n = self.nvar * self.ncls * self.L
        return y[:, :n].reshape(-1, self.nvar, self.ncls, self.L)


def cloud_class_labels(q_next, dq, threshold_class1: float = 1e-9,
                       threshold_class2: float = 1e-11):
    """3-class cloud labels (int64): 0 where |dq| <= threshold_class2 (no
    change), 1 where the next step's q <= threshold_class1 (the cloud
    clears), 2 otherwise."""
    mask = torch.where(q_next <= threshold_class1, 1, 2)
    return torch.where(torch.abs(dq) <= threshold_class2, 0, mask)


def classifier_loss(logits, labels):
    """Cross-entropy over the class axis; logits [B, nvar, ncls, L],
    labels [B, nvar, L] int."""
    logp = torch.log_softmax(logits, dim=2)
    onehot = F.one_hot(labels.long(), logits.shape[2]).to(logits.dtype)
    return -torch.mean(torch.sum(onehot.movedim(-1, 2) * logp, dim=2))
