"""Autoregressive bidirectional vertical RNN with latent convective memory
(counterpart of ``climsim_tpu/models/rnn.py::RNNAutoreg``).

Only the flagship serving path is ported: the gru cell with the fused,
channel-major kernel that also evaluates the initial MLP
(``use_pallas=fuse_heads=fuse_init=level_major=True``), latent memory
whose width differs from the RNN's, no pressure feature, no separate
radiation and no stochastic layer. Step contract (channel-major):

    (x_main [L, nx, B], x_sfc [B, nx_sfc], mem [L, nh_mem, B])
        -> (out [L, ny, B], out_sfc [B, ny_sfc], new_mem [L, nh_mem, B])
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import resolve_device
from .cells import FusedBiGRUHeadsLayer, flax_param
from .common import Policy, F32


class Dense(nn.Module):
    """flax ``nn.Dense`` with a compute dtype: ``kernel`` [in, out] and
    ``bias`` [out] in float32, applied as x @ kernel + bias in ``dtype``."""

    def __init__(self, nin: int, nout: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = flax_param((nin, nout), generator)
        self.bias = flax_param((nout,), generator)

    def forward(self, x):
        dt = self.dtype
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


def _unported(what: str, item: str):
    return NotImplementedError(f"RNNAutoreg {what} is not ported yet "
                               f"(ROADMAP {item})")


class RNNAutoreg(nn.Module):
    """Bi-directional vertical RNN emulator with latent convective memory,
    flagship serving configuration. Keyword names and defaults follow the
    flax module; options outside the ported path raise
    ``NotImplementedError`` naming the ROADMAP item that ports them.

    ``device=None`` means ``"cuda"`` (and raises without a CUDA device);
    parameters get flax's init (lecun-normal kernels, zero biases) from a
    ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(self, nx: int, nx_sfc: int, ny: int, ny_sfc: int,
                 nneur: Sequence[int] = (192, 192), nh_mem: int = 16,
                 use_memory: bool = True, cell: str = "gru",
                 use_initial_mlp: bool = True, add_pres: bool = True,
                 output_prune: bool = True,
                 separate_radiation: bool = False,
                 add_stochastic_layer: bool = False,
                 use_pallas: bool = False, fuse_heads: bool = False,
                 fuse_init: bool = False, level_major: bool = False,
                 policy: Policy = F32, device=None, seed: int = 0):
        super().__init__()
        nh1, nh2 = nneur[0], nneur[1]
        if add_pres:
            raise _unported("add_pres", "A.12")
        if separate_radiation:
            raise _unported("separate_radiation", "A.12")
        if add_stochastic_layer:
            raise _unported("add_stochastic_layer", "A.12")
        if cell != "gru":
            raise _unported(f"cell={cell!r}", "A.12")
        if not use_memory:
            raise _unported("memory=None (use_memory=False)", "A.12")
        if nh_mem == nh2 or nh1 != nh2 or len(nneur) != 2:
            raise _unported("with nh_mem == nneur[-1] or unequal widths",
                            "A.12")
        if not use_initial_mlp:
            raise _unported("without the initial MLP", "A.12")
        if not (use_pallas and fuse_heads and fuse_init):
            raise _unported("outside the fused v6 kernel path "
                            "(use_pallas=fuse_heads=fuse_init=True)",
                            "A.2/B4")
        if not level_major:
            raise _unported("batch-major layout (level_major=False)",
                            "A.2")
        self.device = resolve_device(device)
        self.ny, self.ny_sfc, self.nh_mem = ny, ny_sfc, nh_mem
        self.output_prune = output_prune
        self.policy = policy
        g = torch.Generator().manual_seed(seed)
        cdt = policy.compute_dtype
        # creation order = flax's module order (init streams differ from
        # JAX's anyway; from_flax_params carries JAX weights across)
        self.bigru_fused = FusedBiGRUHeadsLayer(
            nx, nh_mem, nh1, nh_mem, ny, init_width=nh1, level_major=True,
            generator=g)
        self.mlp_surface1 = Dense(nx_sfc, nh1, cdt, g)
        self.mlp_toa1 = Dense(2, nh2, cdt, g)
        self.mlp_surface_output = Dense(nh2, ny_sfc, cdt, g)
        self.to(self.device)

    def forward(self, x_main, x_sfc, mem):
        L = x_main.shape[0]
        pol = self.policy
        x_main = pol.cast_in(x_main)
        x_sfc = pol.cast_in(x_sfc)
        mem = pol.cast_in(mem)
        hx1 = torch.tanh(self.mlp_surface1(x_sfc))
        hx2 = self.mlp_toa1(x_sfc[:, [1, 6]])
        out, new_mem, last_h = self.bigru_fused(x_main, hx1, hx2, mem)
        out_sfc = self.mlp_surface_output(last_h)
        if self.output_prune:
            # only dT is nonzero in the top 12 levels (rnn.py:348-356)
            mask = torch.ones((L, self.ny, 1), dtype=out.dtype,
                              device=out.device)
            mask[:12, 1:, :] = 0.0
            out = out * mask
        return pol.cast_out(out), pol.cast_out(out_sfc), \
            pol.cast_out(new_mem)


# microphysics postprocessing (Base_RNN_autoreg.postprocessing, :273-339)

def temperature_scaling(T_raw: torch.Tensor) -> torch.Tensor:
    """Liquid fraction ramp (T-253.16)*0.05 clamped to [0,1]
    (models.py:260-266)."""
    return torch.clamp((T_raw - 253.16) * 0.05, 0.0, 1.0)


def temperature_scaling_precip(t_sfc: torch.Tensor) -> torch.Tensor:
    """Snow fraction (283.3-T)/14.6 clamped to [0,1] (models.py:268-271)."""
    return torch.clamp((283.3 - t_sfc) / 14.6, 0.0, 1.0)
