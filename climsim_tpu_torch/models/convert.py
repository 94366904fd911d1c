"""Carry flax parameters across to the port.

The port's modules keep flax's names and flax's ``[in, out]`` kernel
layout (``FusedBiGRUHeadsLayer`` transposes at call, as
``climsim_tpu/models/cells.py`` does), so the mapping is one key per
leaf: ``bigru_fused/win1`` -> ``bigru_fused.win1``,
``mlp_surface1/kernel`` -> ``mlp_surface1.kernel``.
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
