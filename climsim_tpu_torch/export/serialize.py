"""Serialized deployment artifacts: the TorchScript-export equivalent
(counterpart of ``climsim_tpu/export/serialize.py``).

The reference ships every best checkpoint as TorchScript .pt (cpu+gpu,
wrapped+unwrapped, training script :1012-1034) for FTorch consumption;
the JAX package ships a ``jax.export`` StableHLO payload. The port's
artifact is a ``torch.export`` program (``.pt2``) of the raw-units
wrapper step or a model's forward at fixed example shapes, with the
weights and buffers baked in. Its kernels are ``torch.library`` ops
(``ops/library.py``), so the program holds one ``torch.ops.climsim.*``
node per kernel call and launches the hand-written kernel when it runs
on the card. Loading needs those op registrations (``load_step`` imports
them) and neither the model code nor its parameters. An export that
reaches a kernel which is not a registered op raises
(``ops/library.py::refuse_export``).
"""
from __future__ import annotations

import os

import torch
from torch import nn

__all__ = ["export_step", "load_step", "export_wrapper"]


class _Step(nn.Module):
    """A callable as a module for ``torch.export``. A bound method of a
    module (``model.forward``) registers that module, so its parameters
    and buffers are baked in as the module's own."""

    def __init__(self, fn):
        super().__init__()
        owner = getattr(fn, "__self__", None)
        if isinstance(owner, nn.Module):
            self.owner = owner
            self.name = fn.__name__
        else:
            self.fn = fn

    def forward(self, *args):
        if hasattr(self, "owner"):
            return getattr(self.owner, self.name)(*args)
        return self.fn(*args)


def export_step(fn, example_args, path: str) -> int:
    """Export ``fn`` (an ``nn.Module`` or a callable) for the example
    arguments' shapes, which are static, as JAX's are: ``torch.export``
    under ``torch.no_grad()``, saved to ``path``. Returns the byte
    size."""
    mod = fn if isinstance(fn, nn.Module) else _Step(fn)
    with torch.no_grad():
        program = torch.export.export(mod, tuple(example_args))
    # the artifact holds the program and its weights; torch.export would
    # also save the example inputs (with the whole storage of a view)
    program.example_inputs = None
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return os.path.getsize(path)


def load_step(path: str):
    """Load an exported step; returns a callable module. The ``climsim::``
    ops are registered first; nothing else of the package is needed."""
    from .. import ops  # noqa: F401  (registers the climsim:: ops)
    return torch.export.load(path).module()


def export_wrapper(wrapper, batch: int, nlev: int, nx: int, nx_sfc: int,
                   nh_mem: int, path: str) -> int:
    """Export an OnlineWrapper's raw-units step for fixed shapes (the
    384-column ne4 contract), at zeros on the wrapper's device. A
    stochastic model with ``ar_noise_rho > 0`` is exported in its AR(1)
    signature ``(x, xs, mem, eps_prev, noise) -> (out, out_sfc, mem,
    eps)`` with ``noise`` the draw as a tensor [Le, batch, nneur[-1]]: a
    generator cannot be an input of an exported program, so the caller
    draws (where the JAX artifact takes a key)."""
    dev = next(wrapper.parameters()).device
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    args = (z(batch, nlev, nx), z(batch, nx_sfc), z(batch, nlev, nh_mem))
    model = wrapper.model
    if getattr(model, "add_stochastic_layer", False) \
            and model.ar_noise_rho > 0.0:
        shape = model.noise_shape(batch, nlev)
        args = args + (z(*shape), z(*shape))
    return export_step(wrapper, args, path)
