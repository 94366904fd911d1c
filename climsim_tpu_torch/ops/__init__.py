"""Hand-written CUDA kernels and their plain PyTorch versions.

Dispatch goes by the tensor's device, with no fallback: a CPU tensor runs
the plain version, a CUDA tensor launches the kernel or raises. Each
wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``. Importing this package registers the forward
kernels' ``torch.library`` ops (``library.py``), which a loaded
``torch.export`` program calls.
"""
from __future__ import annotations

import torch

from .pallas_rnn import (fused_bigru_heads_init_cm,
                         bigru_heads_init_cm_reference, fused_bigru_heads_cm,
                         bigru_heads_cm_reference, bigru_heads_cm_bwd,
                         bigru_heads_cm_bwd_reference, fused_bigru_lbh,
                         bigru_reference_lbh, bigru_bwd_lbh,
                         bigru_bwd_reference_lbh, fused_bigru, PallasBiGRU,
                         fused_bigru_heads_lbh, bigru_heads_lbh_reference,
                         fused_bigru_heads_init_lbh,
                         bigru_heads_init_lbh_reference)
from .pallas_radiation import (adding_sw_fast, lw_solver_noscat_fast,
                               adding_sw_bwd, adding_sw_bwd_reference,
                               lw_solver_noscat_bwd,
                               lw_solver_noscat_bwd_reference,
                               sw_bwd_geometry, rad_design)
from .pallas_stencil import (fv_advect_tracers_sphere,
                             fv_tracers_sphere_reference, fv_advect_tracers,
                             fv_tracers_reference, fv_advect_levels,
                             fv_design, first_fv_tracers_sphere,
                             first_fv_tracers_flat, first_fv_levels_flat)

__all__ = ["fused_bigru_heads_init_cm", "bigru_heads_init_cm_reference",
           "fused_bigru_heads_cm", "bigru_heads_cm_reference",
           "bigru_heads_cm_bwd", "bigru_heads_cm_bwd_reference",
           "fused_bigru_lbh", "bigru_reference_lbh", "bigru_bwd_lbh",
           "bigru_bwd_reference_lbh", "fused_bigru", "PallasBiGRU",
           "fused_bigru_heads_lbh", "bigru_heads_lbh_reference",
           "fused_bigru_heads_init_lbh", "bigru_heads_init_lbh_reference",
           "adding_sw_fast",
           "lw_solver_noscat_fast", "adding_sw_bwd", "adding_sw_bwd_reference",
           "lw_solver_noscat_bwd", "lw_solver_noscat_bwd_reference",
           "sw_bwd_geometry", "rad_design",
           "fv_advect_tracers_sphere",
           "fv_tracers_sphere_reference", "fv_advect_tracers",
           "fv_tracers_reference", "fv_advect_levels", "fv_design",
           "first_fv_tracers_sphere", "first_fv_tracers_flat",
           "first_fv_levels_flat",
           "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``, and
    asking for CUDA without a CUDA device raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev
