"""The flat MLP baseline emulator (counterpart of
``climsim_tpu/models/mlp.py``): a flat feature vector in, flat
tendencies out, a linear head for the tendencies and a ReLU'd head for
the trailing surface scalars, an optional static output prune mask; and
the static input prune masks of the online-trainer dataset variants.

The parameters keep flax's names and layout (``dense_{i}``, ``head``,
each a ``kernel`` [in, out] and a ``bias``), so
``models.convert.from_flax_params`` carries a JAX checkpoint across.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import variables as V
from ..ops import resolve_device
from .cells import Dense
from .common import F32, Policy

# flax's activations: nn.gelu is the tanh approximation, nn.leaky_relu's
# slope 0.01, nn.elu's alpha 1
ACTIVATIONS = {"relu": F.relu, "elu": F.elu,
               "gelu": lambda x: F.gelu(x, approximate="tanh"),
               "leakyrelu": lambda x: F.leaky_relu(x, 0.01)}


def output_prune_mask(vset: V.VariableSet, strato_lev: int = 12,
                      dtype=np.float32) -> np.ndarray:
    """Static mask zeroing the top ``strato_lev`` levels of every level
    output but ``ptend_t`` (the reference's 'aggressive pruning')."""
    mask = np.ones(vset.outputs.total, dtype)
    for name in vset.outputs.lev_names:
        if name == "ptend_t":
            continue
        sl = vset.outputs.slices[name]
        mask[sl.start:sl.start + strato_lev] = 0.0
    return mask


class MLP(nn.Module):
    """Flat MLP emulator: ``in_dim`` -> hidden ``features`` -> ``out_dim``,
    the last ``n_scalar_head`` outputs through ReLU (non-negative fluxes),
    then the optional ``prune_mask`` multiplier.

    ``device=None`` means ``"cuda"`` (and raises without a CUDA device);
    the kernels are lecun-normal from a ``torch.Generator`` seeded with
    ``seed``, the biases zero, as flax initialises them."""

    def __init__(self, in_dim: int, features: Sequence[int], out_dim: int,
                 n_scalar_head: int = 8, activation: str = "relu",
                 policy: Policy = F32, prune_mask=None, device=None,
                 seed: int = 0):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.features = tuple(features)
        self.n_scalar_head = n_scalar_head
        self.activation = activation
        self.policy = policy
        g = torch.Generator().manual_seed(seed)
        dt = policy.compute_dtype
        widths = (in_dim,) + self.features
        for i in range(len(self.features)):
            setattr(self, f"dense_{i}", Dense(widths[i], widths[i + 1], dt, g))
        self.head = Dense(widths[-1], out_dim, dt, g)
        mask = None if prune_mask is None else torch.as_tensor(
            np.asarray(prune_mask, np.float32))
        self.register_buffer("prune_mask", mask, persistent=False)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        h = self.policy.cast_in(x)
        for i in range(len(self.features)):
            h = act(getattr(self, f"dense_{i}")(h))
        y = self.policy.cast_out(self.head(h))
        n = self.n_scalar_head
        y = torch.cat([y[..., :-n], F.relu(y[..., -n:])], dim=-1)
        if self.prune_mask is not None:
            y = y * self.prune_mask.to(y.dtype)
        return y


def mlp_for(vset: V.VariableSet, features: Sequence[int] = (768, 640, 512,
            640, 640), policy: Policy = F32, prune: bool = False,
            device=None, seed: int = 0) -> MLP:
    """The MLP of a variable set's flat contract (BASELINE.json config 1
    at the default widths)."""
    mask = output_prune_mask(vset) if prune else None
    return MLP(vset.input_feature_len, features, vset.target_feature_len,
               policy=policy, prune_mask=mask, device=device, seed=seed)


def input_prune_mask(vset: V.VariableSet, mode: str,
                     strato_lev: int = 15, strato_lev_qc: int = 30,
                     strato_lev_qinput: int | None = None,
                     strato_lev_tinput: int = 0,
                     dtype=np.float32) -> np.ndarray:
    """Static input-feature mask of the online-trainer dataset variants,
    declared over the variable registry:

    * ``decouple_cloud``: zero every cloud-condensate profile (state and
      previous-physics q0002/q0003 channels).
    * ``aggressive``: zero the top stratosphere levels of every profile
      but state temperature and the gas profiles: humidity-like channels
      (rh/q0001/q0003) use ``strato_lev_qinput``, q0002 uses
      ``strato_lev_qc``, everything else ``strato_lev``; also SNOWHICE.
    * ``qinput``: zero only the top levels of state_q0002/q0003.

    ``strato_lev_tinput > 0`` also zeros the top temperature levels."""
    qin = strato_lev if strato_lev_qinput is None else strato_lev_qinput
    mask = np.ones(vset.inputs.total, dtype)
    sl_of = vset.inputs.slices
    if mode == "decouple_cloud":
        for n in vset.inputs.lev_names:
            if "q0002" in n or "q0003" in n:
                mask[sl_of[n]] = 0.0
    elif mode == "aggressive":
        for n in vset.inputs.lev_names:
            if n == "state_t" or n.startswith("pbuf"):
                continue
            if "_dyn" in n:
                k = strato_lev
            elif "q0002" in n:
                k = strato_lev_qc
            elif "q0001" in n or "q0003" in n or "rh" in n:
                k = qin
            else:
                k = strato_lev
            s = sl_of[n]
            mask[s.start:s.start + k] = 0.0
        if "cam_in_SNOWHICE" in sl_of:
            mask[sl_of["cam_in_SNOWHICE"]] = 0.0
    elif mode == "qinput":
        for n in ("state_q0002", "state_q0003"):
            if n in sl_of:
                s = sl_of[n]
                mask[s.start:s.start + strato_lev] = 0.0
    else:
        raise ValueError(f"unknown prune mode {mode!r}")
    if strato_lev_tinput > 0 and "state_t" in sl_of:
        s = sl_of["state_t"]
        mask[s.start:s.start + strato_lev_tinput] = 0.0
    return mask
