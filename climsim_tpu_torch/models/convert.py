"""Carry flax parameters across to the port.

The port's modules keep flax's names and flax's ``[in, out]`` kernel
layout (``FusedBiGRUHeadsLayer`` transposes at call, as
``climsim_tpu/models/cells.py`` does), so the mapping is one key per
leaf: ``bigru_fused/win1`` -> ``bigru_fused.win1``,
``mlp_surface1/kernel`` -> ``mlp_surface1.kernel``, and for
``PhysicalRNNAutoreg`` ``radiation/gas_lw/h0/kernel`` ->
``radiation.gas_lw.h0.kernel`` and the scalar ``radiation/gas_sw/sigma``
-> ``radiation.gas_sw.sigma``, and its options' leaves the same way
(``mlp_output_rad``, ``mlp_surface_output_rad``, ``rnn1_rad``/``rnn2_rad``
with ``input_proj`` and ``cell/hh``, ``mlp_surface_init_rad``,
``mlp_toa_rad``, ``mlp_overlap``, ``radiation/{cld_lw,cld_sw1,cld_sw2}``,
``radiation/{band_expand_kernel,band_expand_bias}``; ``RRTMGPGasOptics``'
``mlp1``..``mlp3`` and a reduced LW head's ``ymean``/``ystd``); for the
offline baselines
``dense_0/kernel`` -> ``dense_0.kernel`` (``MLP``), ``enc_3/bias`` ->
``enc_3.bias`` (``ED``) and ``block_2/Conv_1/kernel`` ->
``block_2.Conv_1.kernel`` (``CNN``, kernels [k, in, out] as flax's); the
stochastic layer's ``rnn_stoch/input_proj/{kernel,bias}`` and its cell's
bias-free ``rnn_stoch/cell/{encoder,zh}/kernel`` (``sgru``) or
``rnn_stoch/cell/hh/kernel`` (``slstm``) -> ``rnn_stoch.cell.zh.kernel``
and so on; the stochastic models' and U-Nets' trees the same way:
``HSR``'s ``mean/hidden_0/kernel`` -> ``mean.hidden_0.kernel``, ``CVAE``'s
``enc/ln1/scale`` -> ``enc.ln1.scale``, ``ClimsimUNet``'s
``enc_16_block0/AttnBlock_0/qkv/kernel`` -> ``enc_16_block0.AttnBlock_0.
qkv.kernel`` (the classifier's under ``backbone``). ``RPNEnsemble``'s
tree ``{"net": {"params": ...}, "prior": {"params": ...}}`` (each leaf
with its leading member axis) loads as it is: a ``params`` level is
dropped wherever it stands, so ``net/params/dense_0/kernel`` ->
``net.dense_0.kernel``.
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
            flat.update(_flatten(v, prefix if k == "params" else key + "."))
        else:
            flat[key] = np.asarray(v)
    return flat


def from_flax_params(tree: Mapping, model: nn.Module) -> dict:
    """The port ``state_dict`` for ``model`` from a flax parameter tree
    (nested mappings of arrays, with ``params`` at the top or already
    stripped). Raises ``ValueError`` on a missing or extra key or a shape
    that differs from ``model``'s."""
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
