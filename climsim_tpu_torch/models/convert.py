"""Carry flax parameters across to the port.

The port's modules keep flax's names and flax's ``[in, out]`` kernel
layout (``FusedBiGRUHeadsLayer`` transposes at call, as
``climsim_tpu/models/cells.py`` does), so the mapping is one key per
leaf: ``bigru_fused/win1`` -> ``bigru_fused.win1``,
``mlp_surface1/kernel`` -> ``mlp_surface1.kernel``, and for
``PhysicalRNNAutoreg`` ``radiation/gas_lw/h0/kernel`` ->
``radiation.gas_lw.h0.kernel`` and the scalar ``radiation/gas_sw/sigma``
-> ``radiation.gas_sw.sigma``; for the offline baselines
``dense_0/kernel`` -> ``dense_0.kernel`` (``MLP``), ``enc_3/bias`` ->
``enc_3.bias`` (``ED``) and ``block_2/Conv_1/kernel`` ->
``block_2.Conv_1.kernel`` (``CNN``, kernels [k, in, out] as flax's).
An optax Adam state
(its moments are trees of the same shape) carries across the same way,
so a JAX training run can be resumed in the port.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key + "."))
        else:
            flat[key] = np.asarray(v)
    return flat


def from_flax_params(tree: Mapping, model: nn.Module) -> dict:
    """The port ``state_dict`` for ``model`` from a flax parameter tree
    (nested mappings of arrays, with ``params`` at the top or already
    stripped). Raises ``ValueError`` on a missing or extra key or a shape
    that differs from ``model``'s."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = _flatten(tree)
    want = model.state_dict()
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"flax tree does not match the model: missing "
                         f"{missing}, extra {extra}")
    out = {}
    for k, ref in want.items():
        a = flat[k]
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"{k}: shape {tuple(a.shape)}, the model has "
                             f"{tuple(ref.shape)}")
        out[k] = torch.tensor(np.asarray(a, np.float32))
    return out


def from_optax_adam(mu: Mapping, nu: Mapping, count: int, model: nn.Module,
                    optimizer: torch.optim.Optimizer) -> dict:
    """The ``state_dict`` of ``optimizer`` (a ``torch.optim.Adam`` or
    ``AdamW`` over ``model``'s parameters) holding an optax Adam state:
    the first and second moments ``mu``/``nu`` as flax trees and the
    update ``count``. optax's and torch's Adam apply the same update from
    these (bias corrections 1 - b**count), so a run resumed from the
    result continues the JAX run."""
    mu_t, nu_t = from_flax_params(mu, model), from_flax_params(nu, model)
    name_of = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    sd = optimizer.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(count)),
                       "exp_avg": mu_t[name_of[id(p)]],
                       "exp_avg_sq": nu_t[name_of[id(p)]]}
                   for i, p in enumerate(params)}
    return sd
