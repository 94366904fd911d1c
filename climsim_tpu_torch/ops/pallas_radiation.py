"""The radiation solvers' CUDA kernels (counterpart of
``climsim_tpu/ops/pallas_radiation.py``'s ``adding_sw_fast`` and
``lw_solver_noscat_fast``): B11, the SW two-stream adding solver
(``csrc/adding_sw.cu``), and B12, the LW no-scattering solver
(``csrc/lw_noscat.cu``).

Both take the solver-standard layout, layers [B, nlev, ng] and surface
[B, ng], float32, and return half-level fluxes [B, nlev+1, ng]. Their
plain versions are ``physics/radiation.py``'s level loops. Each wrapper
is a ``torch.autograd.Function``: on the CPU its backward differentiates
the plain version, as JAX's does off the TPU; on the card the backward
is a kernel not ported yet (B13, B14) and raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..physics.radiation import adding_sw, lw_solver_noscat
from . import _build
from .pallas_rnn import _on_card_backward, plain_vjp

__all__ = ["adding_sw_fast", "lw_solver_noscat_fast"]

_SW_ARGS = ("incoming_toa", "albedo_surf_diffuse", "albedo_surf_direct",
            "R", "T", "ref_dir", "T_dir_diff", "T_dir_dir")
_LW_ARGS = ("trans_lw", "source_dn", "source_up", "source_sfc",
            "emissivity_surf")
_SW_SFC = (True,) * 3 + (False,) * 5
_LW_SFC = (False,) * 3 + (True,) * 2


def _validate(names, args, is_sfc) -> None:
    """Raise ``ValueError`` unless every argument is float32 on one device,
    the surface arguments (``is_sfc``) [B, ng] and the layer arguments
    [B, nlev, ng] (checked on every device, so a CPU run catches what the
    kernel would refuse)."""
    B, nlev, ng = args[is_sfc.index(False)].shape
    dev = args[0].device
    for k, a, sfc in zip(names, args, is_sfc):
        if a.dtype != torch.float32 or a.device != dev:
            raise ValueError(f"{k}: {a.dtype} on {a.device}, the kernel "
                             f"takes float32 tensors on {dev}")
        want = (B, ng) if sfc else (B, nlev, ng)
        if tuple(a.shape) != want:
            raise ValueError(f"{k}: shape {tuple(a.shape)}, want {want}")


def _launch(name: str, args, outs) -> None:
    lib = _build.load(name)
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * (len(args) + len(outs)) \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, nlev, ng = outs[0].shape[0], outs[0].shape[1] - 1, outs[0].shape[2]
    stream = torch.cuda.current_stream(outs[0].device).cuda_stream
    ptrs = [a.contiguous() for a in args] + list(outs)
    rc = fn(*[t.data_ptr() for t in ptrs], B, nlev, ng, stream)
    _build.check_status(rc, name)


def _dispatch(args, plain, launch):
    dev = args[0].device
    if dev.type == "cpu":
        return plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return launch(args)


def _launch_sw(args):
    B, nlev, ng = args[3].shape
    outs = [torch.empty((B, nlev + 1, ng), dtype=torch.float32,
                        device=args[0].device) for _ in range(3)]
    _launch("adding_sw", args, outs)
    adding_sw_fast.launches += 1
    return tuple(outs)


def _launch_lw(args):
    B, nlev, ng = args[0].shape
    outs = [torch.empty((B, nlev + 1, ng), dtype=torch.float32,
                        device=args[0].device) for _ in range(2)]
    _launch("lw_noscat", args, outs)
    lw_solver_noscat_fast.launches += 1
    return tuple(outs)


class _AddingSW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        _validate(_SW_ARGS, args, _SW_SFC)
        ctx.save_for_backward(*args)
        return _dispatch(args, adding_sw, _launch_sw)

    @staticmethod
    def backward(ctx, *cts):
        args = ctx.saved_tensors
        if args[0].device.type != "cpu":
            raise _on_card_backward("adding_sw_fast (B13)",
                                    "ROADMAP A.11, slice 4 training")
        return plain_vjp(adding_sw, args, cts, ctx.needs_input_grad)


class _LWNoScat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        _validate(_LW_ARGS, args, _LW_SFC)
        ctx.save_for_backward(*args)
        return _dispatch(args, lw_solver_noscat, _launch_lw)

    @staticmethod
    def backward(ctx, *cts):
        args = ctx.saved_tensors
        if args[0].device.type != "cpu":
            raise _on_card_backward("lw_solver_noscat_fast (B14)",
                                    "ROADMAP A.11, slice 4 training")
        return plain_vjp(lw_solver_noscat, args, cts, ctx.needs_input_grad)


def adding_sw_fast(incoming_toa, albedo_surf_diffuse, albedo_surf_direct,
                   R, T, ref_dir, T_dir_diff, T_dir_dir):
    """SW two-stream adding solver, differentiable: surface arguments
    [B, ng], layer arguments [B, nlev, ng] -> (flux_up, flux_dn_diffuse,
    flux_dn_direct) [B, nlev+1, ng]. A CPU tensor runs
    ``physics.radiation.adding_sw``; a CUDA tensor launches kernel B11 or
    raises."""
    return _AddingSW.apply(incoming_toa, albedo_surf_diffuse,
                           albedo_surf_direct, R, T, ref_dir, T_dir_diff,
                           T_dir_dir)


def lw_solver_noscat_fast(trans_lw, source_dn, source_up, source_sfc,
                          emissivity_surf):
    """LW no-scattering solver, differentiable: layer arguments
    [B, nlev, ng], surface [B, ng] -> (flux_dn, flux_up) [B, nlev+1, ng].
    A CPU tensor runs ``physics.radiation.lw_solver_noscat``; a CUDA tensor
    launches kernel B12 or raises."""
    return _LWNoScat.apply(trans_lw, source_dn, source_up, source_sfc,
                           emissivity_surf)


adding_sw_fast.launches = 0
lw_solver_noscat_fast.launches = 0
