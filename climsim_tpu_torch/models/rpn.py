"""Randomized-prior network (RPN) ensemble (counterpart of
``climsim_tpu/models/rpn.py``): M MLPs (default 124 -> 768 -> 640 -> 512
-> 640 -> 640 -> 128) where each member's prediction is ``net(x) +
prior(x)`` with a frozen randomly initialized prior of the same shape.

The members stay stacked on a leading axis, as JAX's vmapped params are:
each layer's ``kernel`` is [M, in, out] and its ``bias`` [M, out], so a
layer of the whole ensemble is one batched product (``baddbmm``) where
JAX vmaps; no Python loop over the members. The MLP is the reference's:
leaky ReLU with slope 0.15 on the hidden layers and a plain linear head.

The prior runs without autograd, so the loss does not reach it, as JAX's
``stop_gradient`` does; its parameters stay parameters (JAX keeps them in
the param tree), and the trainers give them the zero gradient JAX's
``grad`` gives (``train.loop.zero_missing_grads_``), so Adam leaves them
exactly as they are.

Parameters keep flax's names with its ``params`` level dropped:
``net.dense_{i}``, ``net.head``, ``prior.dense_{i}``, ``prior.head``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import resolve_device
from .cells import lecun_normal_
from .common import F32, Policy


class _StackedDense(nn.Module):
    """M flax ``nn.Dense`` layers side by side: ``kernel`` [M, in, out]
    (lecun-normal), ``bias`` [M, out] (zeros)."""

    def __init__(self, members: int, nin: int, nout: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        kernel = torch.zeros((members, nin, nout))
        for m in range(members):
            lecun_normal_(kernel[m], nin, generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(members, nout))

    def forward(self, h):
        """h [M, B, in] -> [M, B, out]."""
        dt = self.dtype
        return torch.baddbmm(self.bias.to(dt)[:, None, :], h.to(dt),
                             self.kernel.to(dt))


class _RPNMLP(nn.Module):
    def __init__(self, members: int, nin: int, out_dim: int, features,
                 policy: Policy, generator: torch.Generator):
        super().__init__()
        self.n, self.policy, self.members = len(features), policy, members
        dt = policy.compute_dtype
        for i, w in enumerate(features):
            setattr(self, f"dense_{i}", _StackedDense(members, nin, w, dt,
                                                      generator))
            nin = w
        self.head = _StackedDense(members, nin, out_dim, dt, generator)

    def forward(self, x):
        """x [B, in] (shared by the members) -> [M, B, out]."""
        h = self.policy.cast_in(x).expand((self.members,) + x.shape)
        for i in range(self.n):
            h = F.leaky_relu(getattr(self, f"dense_{i}")(h), 0.15)
        return self.policy.cast_out(self.head(h))


class RPNEnsemble(nn.Module):
    """``num_members`` trainable nets and their frozen priors.
    ``device=None`` means ``"cuda"``; weights from ``seed``."""

    def __init__(self, in_dim: int, out_dim: int = 128,
                 features=(768, 640, 512, 640, 640), num_members: int = 32,
                 policy: Policy = F32, device=None, seed: int = 0):
        super().__init__()
        features = tuple(features)
        self.in_dim, self.out_dim, self.features = in_dim, out_dim, features
        self.num_members, self.policy = num_members, policy
        g = torch.Generator().manual_seed(seed)
        self.net = _RPNMLP(num_members, in_dim, out_dim, features, policy, g)
        self.prior = _RPNMLP(num_members, in_dim, out_dim, features, policy,
                             g)
        self.to(resolve_device(device))

    def forward(self, x):
        """[M, B, out] ensemble predictions (trainable + frozen prior)."""
        with torch.no_grad():
            prior = self.prior(x)
        return self.net(x) + prior

    apply = forward

    def apply_mean(self, x):
        return torch.mean(self(x), dim=0)

    def samples(self, x):
        """The members as CRPS samples: [B, out, M]."""
        return torch.movedim(self(x), 0, -1)

    def loss(self, x, y):
        return torch.mean(torch.square(self(x) - y[None]))

    def member_block(self, lo: int, hi: int) -> "RPNEnsemble":
        """A new ensemble holding copies of members lo .. hi - 1 (net and
        prior), on this one's device."""
        block = RPNEnsemble(self.in_dim, self.out_dim, self.features,
                            hi - lo, self.policy,
                            device=self.net.head.kernel.device)
        block.load_state_dict({k: v[lo:hi]
                               for k, v in self.state_dict().items()})
        return block
