"""Mixed-precision policy and the weight-clamped linear map (counterpart
of ``climsim_tpu/models/common.py``).

Parameters live in float32; activations are cast to ``compute_dtype`` at
the module entry and the outputs are returned in ``output_dtype``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Policy:
    """Cast activations to compute_dtype inside the network, emit outputs
    in output_dtype."""

    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_in(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_out(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.output_dtype)


F32 = Policy(torch.float32, torch.float32, torch.float32)
BF16 = Policy()


def positive_linear(kernel: torch.Tensor, bias: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Weight-clamped linear layer (rnn/layers.py:23-37 PositiveLinear;
    JAX's ``PositiveLinear.apply``): the kernel is clamped at use, not at
    init, so the updates stay unconstrained while the map is
    non-negative."""
    return x @ torch.clamp(kernel, min=0.0) + bias


def weak(v: float, dtype: torch.dtype) -> float:
    """The Python scalar ``v`` as JAX applies it to an array of ``dtype``:
    JAX rounds a weakly typed scalar to a half-precision array's dtype
    before the operation (1e5 becomes 99840 in bfloat16), where torch
    computes the operation with the scalar in float32."""
    if dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(v, dtype=dtype))
    return v
