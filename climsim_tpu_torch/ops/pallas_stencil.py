"""Finite-volume transport stencils: the CUDA kernels and their plain
PyTorch versions (counterpart of ``climsim_tpu/ops/pallas_stencil.py``):
the spherical multi-tracer step ``fv_advect_tracers_sphere``
(``csrc/fv_tracers_sphere.cu``), and the flat-raster multi-tracer step
``fv_advect_tracers`` and one-field step ``fv_advect_levels``
(``csrc/fv_tracers_flat.cu``, one kernel launched through two entry
points). Each is differentiable: its backward differentiates the plain
version, as the JAX ops' custom_vjp differentiates their jnp reference.

B2, B5 and B6 have two designs each, chosen by ``fv_design`` from the
shape (and the tensors' alignment) before the launch and recorded on the
wrapper as ``.design``: the band tile of ``csrc/fv_tile.cuh`` ("tile")
where it takes the shape, else the first design ("first").
``first_fv_tracers_sphere``, ``first_fv_tracers_flat`` and
``first_fv_levels_flat`` run the first designs at any shape, for timing
them on the card; they count no launch.
"""
from __future__ import annotations

import ctypes

import torch

from ..online.advection import (MetricRows, fv_advect_2d,
                                fv_advect_2d_sphere, metric_rows)
from . import _build
from .library import refuse_export
from .pallas_radiation import _SM_SMEM, _SM_THREADS, _SMEM_MAX, _sms

__all__ = ["fv_advect_tracers_sphere", "fv_tracers_sphere_reference",
           "fv_advect_tracers", "fv_tracers_reference", "fv_advect_levels",
           "fv_design", "fv_tile_smem", "first_fv_tracers_sphere",
           "first_fv_tracers_flat", "first_fv_levels_flat"]

# the band tile's most rows a band (PERF.md §6: the fastest R measured on
# the H100 for B2 at (6, 60, 120, 180), within 2.5% of B6's best)
_FV_R = 12
_FV_MAX_THREADS = 512
_FIRST_R, _FIRST_NTH = 8, 256  # the first designs' band and block


def fv_tile_smem(ntrac: int, nlon: int, R: int) -> int:
    """The shared memory of a band-tile CTA (``csrc/fv_tile.cuh::Geom::
    smem``): 128 bytes for the mbarrier, then the stage: u's R+4 rows, v's
    R+1 rows and each tracer's R+4 rows of ``nlon`` floats."""
    return 128 + 4 * nlon * ((R + 4) * (1 + ntrac) + R + 1)


def fv_design(kind: str, ntrac: int, L: int, nlat: int, nlon: int,
              sms: int = 132, aligned: bool = True) -> dict:
    """The design of kernel ``kind`` ("b2": the spherical step of
    ``ntrac`` tracers; "b5": the flat step of ``ntrac`` tracers; "b6":
    one flat field, ntrac 1) at (L, nlat, nlon), from the shape alone
    (and whether the tensors are 16-byte aligned), never from a failed
    attempt:
      * "tile" (csrc/fv_tile.cuh's band tile) where nlon % 4 == 0 (a row
        is then a multiple of the bulk copy's 16 bytes), the tensors are
        aligned and a tile fits 232,448 bytes of shared memory: bands of
        at most ``_FV_R`` rows (halved until the tile fits), as even as
        the rows allow (R = ceil(nlat / ceil(nlat / max)), so a small grid
        has no short band to wait for); a thread a pair of columns (a
        group of threads covers the pairs in passes of at most 512,
        rounded up to warps, as ``Geom::group_threads``), in as many
        groups as the largest divisor of ntrac that keeps a block within
        512 threads, group k taking tracers k, k + groups, ...; as many
        persistent CTAs a SM as the SM's shared memory and threads hold
        (``sms`` SMs), at most one a tile;
      * "first" otherwise (bands of 8 rows, one block of 256 threads a
        band and level).
    Returns dict(design, R, groups, threads, smem, blocks)."""
    if kind not in ("b2", "b5", "b6") or ntrac < 1 \
            or (kind == "b6" and ntrac != 1):
        raise ValueError(f"no band tile for kernel {kind!r} with {ntrac} "
                         "tracers")
    first = dict(design="first", R=_FIRST_R, groups=1, threads=_FIRST_NTH,
                 smem=4 * 3 * (_FIRST_R + 4) * nlon,
                 blocks=-(-nlat // _FIRST_R) * L)
    if nlon % 4 or not aligned:
        return first
    most = _FV_R
    while most > 1 and fv_tile_smem(ntrac, nlon, most) > _SMEM_MAX:
        most //= 2
    if fv_tile_smem(ntrac, nlon, most) > _SMEM_MAX:
        return first
    R = -(-nlat // -(-nlat // most))
    smem = fv_tile_smem(ntrac, nlon, R)
    pairs = nlon // 2
    per_pass = -(-pairs // -(-pairs // _FV_MAX_THREADS))
    tpg = -(-per_pass // 32) * 32               # threads of a group
    groups = max(g for g in range(1, ntrac + 1)
                 if ntrac % g == 0 and g * tpg <= _FV_MAX_THREADS)
    threads = groups * tpg
    per_sm = max(1, min(_SM_SMEM // (smem + 1024), _SM_THREADS // threads))
    return dict(design="tile", R=R, groups=groups, threads=threads,
                smem=smem, blocks=min(-(-nlat // R) * L, sms * per_sm))


def _fv_select(wrapper, kind, tensors, ntrac) -> dict:
    """``fv_design`` for a launch of ``wrapper`` on ``tensors``, recorded
    as ``wrapper.design``."""
    L, nlat, nlon = tensors[-1].shape
    d = fv_design(kind, ntrac, L, nlat, nlon,
                  sms=_sms(tensors[0].device.index or 0),
                  aligned=all(t.data_ptr() % 16 == 0 for t in tensors))
    wrapper.design = d["design"]
    return d


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


def _run_sphere(qs, u, v, rows: MetricRows, d: dict) -> torch.Tensor:
    """B2 at design ``d`` (an ``fv_design`` dict) on validated CUDA
    tensors; counts nothing."""
    ntrac, L, nlat, nlon = qs.shape
    lib = _build.load("fv_tracers_sphere")
    tile = d["design"] == "tile"
    fn = lib.fv_tracers_sphere_tile if tile else lib.fv_tracers_sphere
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_float] + [ctypes.c_int] * (3 if tile else 0) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(qs)
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    geom = (d["R"], d["blocks"], d["groups"]) if tile else ()
    rc = fn(qs.data_ptr(), u.data_ptr(), v.data_ptr(),
            rows.dtdx.data_ptr(), rows.cf_fac.data_ptr(),
            rows.wf.data_ptr(), rows.wc.data_ptr(), out.data_ptr(),
            ntrac, L, nlat, nlon, rows.cfl_max, *geom, stream)
    _build.check_status(rc, fn.__name__)
    return out


def _launch(qs, u, v, rows: MetricRows) -> torch.Tensor:
    d = _fv_select(fv_advect_tracers_sphere, "b2", (qs, u, v), qs.shape[0])
    out = _run_sphere(qs, u, v, rows, d)
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
    the plain version; a CUDA tensor launches kernel B2 (the design
    ``fv_design`` picks, recorded as ``fv_advect_tracers_sphere.design``)
    or raises."""
    refuse_export("fv_advect_tracers_sphere")
    rows = metric_rows(m, qs.device)
    _validate(qs, u, v, rows)
    if qs.device.type == "cpu":
        return fv_tracers_sphere_reference(qs, u, v, rows)
    if qs.device.type != "cuda":
        raise ValueError(f"no kernel for device {qs.device}")
    return _FVSphere.apply(qs, u, v, rows)


def first_fv_tracers_sphere(qs: torch.Tensor, u: torch.Tensor,
                            v: torch.Tensor, m) -> torch.Tensor:
    """B2's first design on the card, which the wrapper selects only where
    the band tile cannot take the shape: for timing the designs. Counts no
    launch."""
    rows = metric_rows(m, qs.device)
    _validate(qs, u, v, rows)
    if qs.device.type != "cuda":
        raise ValueError(f"the first design runs on the card, not "
                         f"{qs.device}")
    return _run_sphere(qs, u, v, rows, dict(design="first"))


fv_advect_tracers_sphere.launches = 0
fv_advect_tracers_sphere.design = None


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


def _run_flat(qs, u, v, dt_dx, dt_dy, d: dict) -> torch.Tensor:
    """B5, or B6 as one tracer, at design ``d`` (an ``fv_design`` dict) on
    validated CUDA tensors qs [ntrac, L, nlat, nlon]; counts nothing."""
    ntrac, L, nlat, nlon = qs.shape
    lib = _build.load("fv_tracers_flat")
    tile = d["design"] == "tile"
    fn = lib.fv_tracers_flat_tile if tile else lib.fv_tracers_flat
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] * (3 if tile else 0) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(qs)
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    geom = (d["R"], d["groups"], d["blocks"]) if tile else ()
    rc = fn(qs.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
            ntrac, L, nlat, nlon, dt_dx, dt_dy, *geom, stream)
    _build.check_status(rc, fn.__name__)
    return out


def _launch_flat(q, u, v, dt_dx, dt_dy) -> torch.Tensor:
    """B5 for q [ntrac, L, nlat, nlon], B6 for one field [L, nlat, nlon],
    each at the design ``fv_design`` picks, recorded as ``.design`` on
    ``fv_advect_tracers`` or ``fv_advect_levels``."""
    if q.ndim == 3:
        d = _fv_select(fv_advect_levels, "b6", (q, u, v), 1)
        out = _run_flat(q[None], u, v, dt_dx, dt_dy, d)[0]
        fv_advect_levels.launches += 1
        return out
    d = _fv_select(fv_advect_tracers, "b5", (q, u, v), q.shape[0])
    out = _run_flat(q, u, v, dt_dx, dt_dy, d)
    fv_advect_tracers.launches += 1
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
    refuse_export("fv_advect_tracers" if ndim == 4 else "fv_advect_levels")
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
    version; a CUDA tensor launches the kernel (the design ``fv_design``
    picks, recorded as ``fv_advect_tracers.design``) or raises."""
    return _flat_op(qs, u, v, dt_dx, dt_dy, 4)


def fv_advect_levels(q: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     dt_dx: float, dt_dy: float) -> torch.Tensor:
    """Flat-raster FV transport of one field (kernel B6): q/u/v [nlev,
    nlat, nlon] -> the advected q. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel (the design ``fv_design`` picks,
    recorded as ``fv_advect_levels.design``) or raises."""
    return _flat_op(q, u, v, dt_dx, dt_dy, 3)


def first_fv_levels_flat(q: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         dt_dx: float, dt_dy: float) -> torch.Tensor:
    """B6's first design on the card, which the wrapper selects only where
    the band tile cannot take the shape: for timing the designs. Counts no
    launch."""
    _validate_flat(q, u, v, 3)
    if q.device.type != "cuda":
        raise ValueError(f"the first design runs on the card, not "
                         f"{q.device}")
    return _run_flat(q[None], u, v, float(dt_dx), float(dt_dy),
                     dict(design="first"))[0]


def first_fv_tracers_flat(qs: torch.Tensor, u: torch.Tensor,
                          v: torch.Tensor, dt_dx: float,
                          dt_dy: float) -> torch.Tensor:
    """B5's first design on the card, which the wrapper selects only where
    the band tile cannot take the shape: for timing the designs. Counts no
    launch."""
    _validate_flat(qs, u, v, 4)
    if qs.device.type != "cuda":
        raise ValueError(f"the first design runs on the card, not "
                         f"{qs.device}")
    return _run_flat(qs, u, v, float(dt_dx), float(dt_dy),
                     dict(design="first"))


fv_advect_tracers.launches = 0
fv_advect_tracers.design = None
fv_advect_levels.launches = 0
fv_advect_levels.design = None
