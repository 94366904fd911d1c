"""Partial-load / freeze-retrain support (counterpart of
``climsim_tpu/train/finetune.py``): load whatever parameters a donor state
dict shares with the current model, and take frozen parameters out of
the optimizer so they receive no update.

Parameter names are matched as the JAX package matches its flax paths:
the torch name ``rnn_up.cell.kernel`` is the path
``params/rnn_up/cell/kernel`` (the port keeps flax's module and leaf
names, ``models/convert.py``), so the same glob patterns select the same
parameters in both packages.
"""
from __future__ import annotations

import fnmatch

import torch


def partial_load(model: torch.nn.Module, donor: dict) -> tuple[int, int]:
    """Copy the tensors of ``donor`` (a state dict) into ``model`` wherever
    the name AND the shape match; returns (n_loaded, n_skipped) over the
    model's state dict."""
    state = model.state_dict()
    loaded = skipped = 0
    with torch.no_grad():
        for k, v in state.items():
            r = donor.get(k)
            if r is not None and tuple(r.shape) == tuple(v.shape):
                v.copy_(r)
                loaded += 1
            else:
                skipped += 1
    return loaded, skipped


def flax_path(name: str) -> str:
    """The JAX package's label for a parameter (finetune.py's ``freeze``
    key): ``params/`` + the torch name with dots as slashes."""
    return "params/" + name.replace(".", "/")


def freeze(trainer, frozen_patterns: list[str]) -> list[str]:
    """Take every parameter whose path (:func:`flax_path`) matches a glob
    pattern, or holds a pattern as a substring, out of ``trainer``'s
    optimizer, which is rebuilt with fresh state over the rest (as the
    JAX CLI re-initializes its optimizer state after ``freeze``). Returns
    the frozen names."""
    from .rollout import make_optimizer

    frozen = [n for n, _ in trainer.model.named_parameters()
              if any(fnmatch.fnmatch(flax_path(n), pat) or pat in flax_path(n)
                     for pat in frozen_patterns)]
    keep = set(frozen)
    trainer.trainable = [p for n, p in trainer.model.named_parameters()
                         if n not in keep]
    trainer.opt = make_optimizer(trainer.cfg, trainer.trainable)
    return frozen
