"""Spherical multi-tracer FV transport: the CUDA kernel and its plain
PyTorch version (counterpart of ``climsim_tpu/ops/pallas_stencil.py``'s
``fv_advect_tracers_sphere``; the kernel is ``csrc/fv_tracers_sphere.cu``).
"""
from __future__ import annotations

import ctypes

import torch

from ..online.advection import (MetricRows, fv_advect_2d_sphere,
                                metric_rows)
from . import _build

__all__ = ["fv_advect_tracers_sphere", "fv_tracers_sphere_reference"]


def fv_tracers_sphere_reference(qs: torch.Tensor, u: torch.Tensor,
                                v: torch.Tensor, m) -> torch.Tensor:
    """Plain version: the online FV step on every (tracer, level).
    qs [ntrac, nlev, nlat, nlon], u/v [nlev, nlat, nlon]."""
    return fv_advect_2d_sphere(qs, u, v, metric_rows(m, qs.device))


def _validate(qs, u, v, rows: MetricRows) -> None:
    """Check shapes, dtype, device and contiguity (on every device, so the
    CPU tests catch what the kernel would refuse)."""
    if qs.ndim != 4 or u.shape != qs.shape[1:] or v.shape != qs.shape[1:]:
        raise ValueError(f"shapes qs {tuple(qs.shape)}, u {tuple(u.shape)},"
                         f" v {tuple(v.shape)}: want [ntrac, L, nlat, nlon]"
                         " and [L, nlat, nlon]")
    nlat = qs.shape[2]
    want = {"dtdx": nlat, "cf_fac": nlat + 1, "wf": nlat + 1, "wc": nlat}
    tensors = {"qs": qs, "u": u, "v": v,
               **{k: getattr(rows, k) for k in want}}
    for k, t in tensors.items():
        if t.device != qs.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{k}: the kernel takes contiguous float32 "
                             f"tensors on {qs.device}, got {t.dtype} on "
                             f"{t.device} (contiguous={t.is_contiguous()})")
        if k in want and t.shape != (want[k],):
            raise ValueError(f"{k}: shape {tuple(t.shape)}, want "
                             f"({want[k]},)")


def _launch(qs, u, v, rows: MetricRows) -> torch.Tensor:
    ntrac, L, nlat, nlon = qs.shape
    lib = _build.load("fv_tracers_sphere")
    fn = lib.fv_tracers_sphere
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(qs)
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    rc = fn(qs.data_ptr(), u.data_ptr(), v.data_ptr(),
            rows.dtdx.data_ptr(), rows.cf_fac.data_ptr(),
            rows.wf.data_ptr(), rows.wc.data_ptr(), out.data_ptr(),
            ntrac, L, nlat, nlon, rows.cfl_max, stream)
    _build.check_status(rc, "fv_tracers_sphere")
    fv_advect_tracers_sphere.launches += 1
    return out


class _FVSphere(torch.autograd.Function):
    """Kernel forward; the backward differentiates the plain version, as
    the JAX op's custom_vjp differentiates its jnp reference."""

    @staticmethod
    def forward(ctx, qs, u, v, rows):
        ctx.save_for_backward(qs, u, v)
        ctx.rows = rows
        return _launch(qs, u, v, rows)

    @staticmethod
    def backward(ctx, ct):
        qs, u, v = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_(True) for t in (qs, u, v)]
            out = fv_tracers_sphere_reference(*args, ctx.rows)
            grads = torch.autograd.grad(out, args, ct, allow_unused=True)
        return (*grads, None)


def fv_advect_tracers_sphere(qs: torch.Tensor, u: torch.Tensor,
                             v: torch.Tensor, m) -> torch.Tensor:
    """Fused multi-tracer spherical FV transport: qs [ntrac, nlev, nlat,
    nlon] advected by u/v [nlev, nlat, nlon] in m/s with the per-row
    metric ``m`` (a SphericalMetric or its MetricRows). A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel or raises."""
    rows = metric_rows(m, qs.device)
    _validate(qs, u, v, rows)
    if qs.device.type == "cpu":
        return fv_tracers_sphere_reference(qs, u, v, rows)
    if qs.device.type != "cuda":
        raise ValueError(f"no kernel for device {qs.device}")
    return _FVSphere.apply(qs, u, v, rows)


fv_advect_tracers_sphere.launches = 0
