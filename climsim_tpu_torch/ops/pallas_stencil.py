"""Finite-volume transport stencils: the CUDA kernels and their plain
PyTorch versions (counterpart of ``climsim_tpu/ops/pallas_stencil.py``):
the spherical multi-tracer step ``fv_advect_tracers_sphere``
(``csrc/fv_tracers_sphere.cu``), and the flat-raster multi-tracer step
``fv_advect_tracers`` and one-field step ``fv_advect_levels``
(``csrc/fv_tracers_flat.cu``, one kernel launched through two entry
points). Each is differentiable: its backward differentiates the plain
version, as the JAX ops' custom_vjp differentiates their jnp reference.
"""
from __future__ import annotations

import ctypes

import torch

from ..online.advection import (MetricRows, fv_advect_2d,
                                fv_advect_2d_sphere, metric_rows)
from . import _build

__all__ = ["fv_advect_tracers_sphere", "fv_tracers_sphere_reference",
           "fv_advect_tracers", "fv_tracers_reference", "fv_advect_levels"]


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


# --------------------------------------------------------------------------
# flat raster (B5 and B6, csrc/fv_tracers_flat.cu): constant dt/dx and
# dt/dy, fluxes in velocity units, no Courant clip
# --------------------------------------------------------------------------


def fv_tracers_reference(qs: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         dt_dx: float, dt_dy: float) -> torch.Tensor:
    """Plain version of B5 and B6 (JAX's ``_fv_reference``): the online
    flat FV step ``fv_advect_2d`` on every (tracer, level). qs [ntrac,
    nlev, nlat, nlon] (or one field [nlev, nlat, nlon]), u/v [nlev, nlat,
    nlon]."""
    return fv_advect_2d(qs, u, v, dt_dx, dt_dy)


def _validate_flat(q, u, v, ndim: int) -> None:
    """Check shapes, dtype, device and contiguity of a flat stencil's
    arguments: q [ntrac, L, nlat, nlon] (ndim 4) or [L, nlat, nlon]
    (ndim 3), u/v [L, nlat, nlon]."""
    if q.ndim != ndim or u.shape != q.shape[-3:] or v.shape != q.shape[-3:]:
        want = "[ntrac, L, nlat, nlon]" if ndim == 4 else "[L, nlat, nlon]"
        raise ValueError(f"shapes q {tuple(q.shape)}, u {tuple(u.shape)}, "
                         f"v {tuple(v.shape)}: want {want} and "
                         "[L, nlat, nlon]")
    for k, t in (("q", q), ("u", u), ("v", v)):
        if t.device != q.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{k}: the kernel takes contiguous float32 "
                             f"tensors on {q.device}, got {t.dtype} on "
                             f"{t.device} (contiguous={t.is_contiguous()})")


def _launch_flat(q, u, v, dt_dx, dt_dy) -> torch.Tensor:
    """B5 for q [ntrac, L, nlat, nlon], B6 for one field [L, nlat, nlon]."""
    L, nlat, nlon = q.shape[-3:]
    lib = _build.load("fv_tracers_flat")
    tail = [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr())
    if q.ndim == 4:
        fn = lib.fv_tracers_flat
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + tail
        fn.restype = ctypes.c_int
        rc = fn(*ptrs, q.shape[0], L, nlat, nlon, dt_dx, dt_dy, stream)
        _build.check_status(rc, "fv_tracers_flat")
        fv_advect_tracers.launches += 1
    else:
        fn = lib.fv_levels_flat
        fn.argtypes = [ctypes.c_void_p] * 4 + tail
        fn.restype = ctypes.c_int
        rc = fn(*ptrs, L, nlat, nlon, dt_dx, dt_dy, stream)
        _build.check_status(rc, "fv_levels_flat")
        fv_advect_levels.launches += 1
    return out


class _FVFlat(torch.autograd.Function):
    """Kernel forward; the backward differentiates the plain version."""

    @staticmethod
    def forward(ctx, q, u, v, dt_dx, dt_dy):
        ctx.save_for_backward(q, u, v)
        ctx.steps = (dt_dx, dt_dy)
        return _launch_flat(q, u, v, dt_dx, dt_dy)

    @staticmethod
    def backward(ctx, ct):
        q, u, v = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_(True) for t in (q, u, v)]
            out = fv_tracers_reference(*args, *ctx.steps)
            grads = torch.autograd.grad(out, args, ct, allow_unused=True)
        return (*grads, None, None)


def _flat_op(q, u, v, dt_dx, dt_dy, ndim):
    _validate_flat(q, u, v, ndim)
    if q.device.type == "cpu":
        return fv_tracers_reference(q, u, v, dt_dx, dt_dy)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _FVFlat.apply(q, u, v, float(dt_dx), float(dt_dy))


def fv_advect_tracers(qs: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                      dt_dx: float, dt_dy: float) -> torch.Tensor:
    """Fused multi-tracer flat-raster FV transport (kernel B5): qs [ntrac,
    nlev, nlat, nlon] advected by u/v [nlev, nlat, nlon], with the
    constant Courant factors dt_dx, dt_dy. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises."""
    return _flat_op(qs, u, v, dt_dx, dt_dy, 4)


def fv_advect_levels(q: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     dt_dx: float, dt_dy: float) -> torch.Tensor:
    """Flat-raster FV transport of one field (kernel B6): q/u/v [nlev,
    nlat, nlon] -> the advected q. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel or raises."""
    return _flat_op(q, u, v, dt_dx, dt_dy, 3)


fv_advect_tracers.launches = 0
fv_advect_levels.launches = 0
