"""Mixed-precision policy (counterpart of ``climsim_tpu/models/common.py``).

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
