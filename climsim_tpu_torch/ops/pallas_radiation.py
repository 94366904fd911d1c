"""The radiation solvers' CUDA kernels (counterpart of
``climsim_tpu/ops/pallas_radiation.py``): B11, the SW two-stream adding
solver (``csrc/adding_sw.cu``), and B12, the LW no-scattering solver
(``csrc/lw_noscat.cu``), behind the differentiable ``adding_sw_fast`` and
``lw_solver_noscat_fast``; and their backward kernels B13
(``csrc/adding_sw_bwd.cu``, ``adding_sw_bwd``) and B14
(``csrc/lw_noscat_bwd.cu``, ``lw_solver_noscat_bwd``).

B11 and B14 have two designs each, chosen by ``rad_design`` from the shape
(and the tensors' alignment) before the launch and recorded on the
wrapper as ``.design``: the staged tile of ``csrc/rad_tile.cuh``
("staged") where it takes the shape, else the first design ("first").
``first_adding_sw`` and ``first_lw_solver_noscat_bwd`` run the first
designs at any shape, for timing them on the card; they count no launch.

All take the solver-standard layout, layers [B, nlev, ng] and surface
[B, ng], float32; fluxes and their cotangents are half-level
[B, nlev+1, ng]. The forwards' plain versions are ``physics/radiation.py``'s
level loops; the backwards' are ``adding_sw_bwd_reference`` and
``lw_solver_noscat_bwd_reference`` here, which follow the TPU bodies
level by level. Each forward wrapper is a ``torch.autograd.Function``
whose forward calls its ``torch.library`` op (``climsim::adding_sw_fast``,
``climsim::lw_solver_noscat_fast``; ``ops/library.py``) and whose
backward calls the backward wrapper on every device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..physics.radiation import adding_sw, lw_solver_noscat
from . import _build
from .library import fresh

__all__ = ["adding_sw_fast", "lw_solver_noscat_fast", "adding_sw_bwd",
           "adding_sw_bwd_reference", "lw_solver_noscat_bwd",
           "lw_solver_noscat_bwd_reference", "sw_bwd_geometry",
           "rad_design", "rad_tile_layout", "rad_tile_smem",
           "first_adding_sw", "first_lw_solver_noscat_bwd"]

_SW_ARGS = ("incoming_toa", "albedo_surf_diffuse", "albedo_surf_direct",
            "R", "T", "ref_dir", "T_dir_diff", "T_dir_dir")
_LW_ARGS = ("trans_lw", "source_dn", "source_up", "source_sfc",
            "emissivity_surf")
_SW_SFC = (True,) * 3 + (False,) * 5
_LW_SFC = (False,) * 3 + (True,) * 2


def _validate(names, args, is_sfc, cts=()) -> tuple[int, int, int]:
    """Raise ``ValueError`` unless every argument is float32 on one device,
    the surface arguments (``is_sfc``) [B, ng], the layer arguments
    [B, nlev, ng] and the cotangents ``cts`` [B, nlev+1, ng] (checked on
    every device, so a CPU run catches what the kernel would refuse);
    returns (B, nlev, ng)."""
    B, nlev, ng = args[is_sfc.index(False)].shape
    dev = args[0].device
    named = list(zip(names, args, is_sfc)) + [
        (f"cotangent {i}", c, None) for i, c in enumerate(cts)]
    for k, a, sfc in named:
        if a.dtype != torch.float32 or a.device != dev:
            raise ValueError(f"{k}: {a.dtype} on {a.device}, the kernel "
                             f"takes float32 tensors on {dev}")
        want = (B, nlev + 1, ng) if sfc is None else \
            (B, ng) if sfc else (B, nlev, ng)
        if tuple(a.shape) != want:
            raise ValueError(f"{k}: shape {tuple(a.shape)}, want {want}")
    return B, nlev, ng


def _launch(name: str, ptrs, dims, extra=(), fn=None) -> None:
    """Call ``csrc/<name>.cu``'s entry point (or its entry point ``fn``)
    with the tensors ``ptrs`` (made contiguous), ``extra`` device buffers,
    then the ints ``dims`` ((B, nlev, ng), and a staged design's C and
    blocks) and the current stream."""
    lib = _build.load(name)
    fn = getattr(lib, fn or name)
    ptrs = [a.contiguous() for a in ptrs] + list(extra)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) \
        + [ctypes.c_int] * len(dims) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(ptrs[0].device).cuda_stream
    rc = fn(*[t.data_ptr() for t in ptrs], *dims, stream)
    _build.check_status(rc, fn.__name__)


def _dispatch(args, plain, launch, *more):
    dev = args[0].device
    if dev.type == "cpu":
        return plain(args, *more)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return launch(args, *more)


def _empty(dev, *shapes):
    return [torch.empty(s, dtype=torch.float32, device=dev) for s in shapes]


# ------------------------------------------------ the designs of B11, B14

# surface, layer and half-level arrays a tile of each staged kernel copies
_RAD_ARRAYS = {"b11": (3, 5, 0), "b14": (2, 3, 2)}
# the staged designs' widest tile in columns (PERF.md §6: the fastest C
# measured on the H100 at (21,600, 60, 8) for both kernels)
_RAD_C = 4
_RAD_MAX_THREADS = 512
_SMEM_MAX = 232448           # dynamic shared memory a block
_SM_SMEM = 233472            # shared memory of an H100 SM
_SM_THREADS = 2048
_FIRST_NTH = 256             # the first designs' block


def rad_tile_layout(kind: str, nlev: int, ng: int, C: int) -> dict:
    """The stage of kind's staged kernel at (nlev, ng) and C columns a
    tile, as ``csrc/rad_tile.cuh::Geom`` lays it out, in floats: the
    surface arrays [nsfc][C ng] first, then the layer arrays
    [nlay][C][str_lay], then the half-level ones [nhalf][C][str_half]; a
    column's stride is its length rounded up to the next count = ng
    (mod 32), so item c ng + g reads level j in bank (c ng + g + j ng)
    mod 32. Returns the strides, the offsets of the three groups and the
    stage's size."""
    nsfc, nlay, nhalf = _RAD_ARRAYS[kind]
    pad = lambda n: n + (ng - n) % 32
    str_lay, str_half = pad(nlev * ng), pad((nlev + 1) * ng)
    lay0 = nsfc * C * ng
    half0 = lay0 + nlay * C * str_lay
    return dict(str_lay=str_lay, str_half=str_half, lay0=lay0, half0=half0,
                stage=half0 + nhalf * C * str_half)


def rad_tile_smem(kind: str, nlev: int, ng: int, C: int) -> int:
    """The shared memory of a staged kernel's CTA (``Geom::smem``): 128
    bytes for the mbarrier, the stage, and the replay of (nlev+1) float
    pairs an item."""
    stage = rad_tile_layout(kind, nlev, ng, C)["stage"]
    return 128 + 4 * (stage + 2 * (nlev + 1) * C * ng)


def rad_design(kind: str, B: int, nlev: int, ng: int, sms: int = 132,
               aligned: bool = True) -> dict:
    """The design of kernel ``kind`` ("b11" or "b14") at (B, nlev, ng),
    from the shape alone (and whether the tensors are 16-byte aligned),
    never from a failed attempt:
      * "staged" (csrc/rad_tile.cuh's stage) where ng % 4 == 0, the
        tensors are aligned and one column's stage and replay fit 232,448
        bytes of shared memory: C columns a tile (``_RAD_C``, halved until
        the tile fits), as many persistent CTAs a SM as the SM's shared
        memory and threads hold (``sms`` SMs), at most one a tile;
      * "first" otherwise.
    Returns dict(design, C, threads, smem, blocks)."""
    if kind not in _RAD_ARRAYS:
        raise ValueError(f"unknown radiation kernel {kind!r}")
    first = dict(design="first", C=None, threads=_FIRST_NTH, smem=0,
                 blocks=-(-B * ng // _FIRST_NTH))
    fits = lambda c: (rad_tile_smem(kind, nlev, ng, c) <= _SMEM_MAX
                      and c * ng <= _RAD_MAX_THREADS)
    if ng % 4 or not aligned:
        return first
    C = _RAD_C
    while C > 1 and not fits(C):
        C //= 2
    if not fits(C):
        return first
    smem = rad_tile_smem(kind, nlev, ng, C)
    threads = -(-C * ng // 32) * 32
    per_sm = max(1, min(_SM_SMEM // (smem + 1024), _SM_THREADS // threads))
    return dict(design="staged", C=C, threads=threads, smem=smem,
                blocks=max(1, min(-(-B // C), sms * per_sm)))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _rad_select(wrapper, kind, tensors, B, nlev, ng) -> dict:
    """``rad_design`` for a launch of ``wrapper`` on ``tensors`` (made
    contiguous), recorded as ``wrapper.design``."""
    dev = tensors[0].device
    d = rad_design(kind, B, nlev, ng, sms=_sms(dev.index or 0),
                   aligned=all(t.data_ptr() % 16 == 0 for t in tensors))
    wrapper.design = d["design"]
    return d


def _run_sw(args, d):
    """B11 at design ``d`` (a ``rad_design`` dict) on contiguous CUDA
    tensors; counts nothing."""
    B, nlev, ng = args[3].shape
    outs = _empty(args[0].device, *[(B, nlev + 1, ng)] * 3)
    if d["design"] == "staged":
        _launch("adding_sw", list(args) + outs,
                (B, nlev, ng, d["C"], d["blocks"]), fn="adding_sw_staged")
    else:
        _launch("adding_sw", list(args) + outs, (B, nlev, ng))
    return tuple(outs)


def _launch_sw(args):
    args = [a.contiguous() for a in args]
    d = _rad_select(adding_sw_fast, "b11", args, *args[3].shape)
    outs = _run_sw(args, d)
    adding_sw_fast.launches += 1
    return outs


def _launch_lw(args):
    B, nlev, ng = args[0].shape
    outs = _empty(args[0].device, *[(B, nlev + 1, ng)] * 2)
    _launch("lw_noscat", list(args) + outs, (B, nlev, ng))
    lw_solver_noscat_fast.launches += 1
    return tuple(outs)


def adding_sw_bwd_reference(args, cts):
    """Plain version of kernel B13 (JAX's ``_adding_sw_bwd_kernel``), level
    by level as the TPU body: replay both sweeps, the half-level albedo
    gradients from fup = fdir albdir + fdiff alb, the down sweep's backward
    (the gradient on the constant fdiff[0] is dropped), then the up
    sweep's. ``args`` = the forward's eight arguments, ``cts`` = the
    cotangents of (flux_up, flux_dn_diffuse, flux_dn_direct); returns the
    eight gradients in the arguments' order."""
    toa, ad, adir, R, T, rd, tdd, tdir = args
    dfup, dfdiff, dfdir = cts
    nlev = R.shape[1]
    # replay the up sweep (albedos below every half-level)
    alb, albdir = ad, adir
    albs, albdirs = [alb] * (nlev + 1), [albdir] * (nlev + 1)
    for j in range(nlev - 1, -1, -1):
        Rj, Tj = R[:, j], T[:, j]
        inv = 1.0 / (1.0 - alb * Rj)
        albdir = rd[:, j] + (tdir[:, j] * albdir + tdd[:, j] * alb) * Tj * inv
        alb = Rj + Tj * Tj * alb * inv
        albs[j], albdirs[j] = alb, albdir
    # replay the down sweep (direct and diffuse downwelling fluxes)
    fdir, fdiff = [toa], [torch.zeros_like(toa)]
    for j in range(nlev):
        Rj, Tj, tdj = R[:, j], T[:, j], tdir[:, j]
        fdiff.append((Tj * fdiff[j] + fdir[j] * (tdj * albdirs[j + 1] * Rj
                                                 + tdd[:, j]))
                     / (1.0 - Rj * albs[j + 1]))
        fdir.append(fdir[j] * tdj)
    # half-level albedo gradients from fup[j] = fdir[j] albdir[j] + fdiff[j]
    # alb[j]
    galb = [dfup[:, j] * fdiff[j] for j in range(nlev + 1)]
    galbdir = [dfup[:, j] * fdir[j] for j in range(nlev + 1)]
    dR, dT, drd, dtdd, dtdir = ([None] * nlev for _ in range(5))
    # down sweep backward; the carry holds the total gradients on
    # (fdir[j+1], fdiff[j+1])
    gdir = dfdir[:, nlev] + dfup[:, nlev] * albdirs[nlev]
    gdiff = dfdiff[:, nlev] + dfup[:, nlev] * albs[nlev]
    for j in range(nlev - 1, -1, -1):
        Rj, Tj, tdj, tddj = R[:, j], T[:, j], tdir[:, j], tdd[:, j]
        alb1, adir1 = albs[j + 1], albdirs[j + 1]
        denom = 1.0 - Rj * alb1
        fdirj, fdiffj, fdiff1 = fdir[j], fdiff[j], fdiff[j + 1]
        K = tdj * adir1 * Rj + tddj
        dN = gdiff / denom
        dT[j] = dN * fdiffj
        dtdd[j] = dN * fdirj
        dtdir[j] = gdir * fdirj + dN * fdirj * adir1 * Rj
        dR[j] = dN * fdirj * tdj * adir1 + gdiff * fdiff1 * alb1 / denom
        galb[j + 1] = galb[j + 1] + gdiff * fdiff1 * Rj / denom
        galbdir[j + 1] = galbdir[j + 1] + dN * fdirj * tdj * Rj
        gdir, gdiff = (gdir * tdj + dN * K + dfdir[:, j]
                       + dfup[:, j] * albdirs[j],
                       dN * Tj + dfdiff[:, j] + dfup[:, j] * albs[j])
    dtoa = gdir
    # up sweep backward; the carry holds the total gradients on (alb[j],
    # albdir[j])
    ga, gd = galb[0], galbdir[0]
    for j in range(nlev):
        Rj, Tj, tdj, tddj = R[:, j], T[:, j], tdir[:, j], tdd[:, j]
        A1, Adir1 = albs[j + 1], albdirs[j + 1]
        inv = 1.0 / (1.0 - A1 * Rj)
        M = tdj * Adir1 + tddj * A1
        drd[j] = gd
        dtdir[j] = dtdir[j] + gd * Adir1 * Tj * inv
        dtdd[j] = dtdd[j] + gd * A1 * Tj * inv
        dT[j] = dT[j] + (ga * 2.0 * Tj * A1 * inv + gd * M * inv)
        TAinv = Tj * A1 * inv
        dR[j] = dR[j] + (ga * (1.0 + TAinv * TAinv)
                         + gd * M * Tj * A1 * inv * inv)
        Tinv = Tj * inv
        gA1 = ga * Tj * Tinv * inv + gd * (tddj * Tinv + M * Tinv * Rj * inv)
        gAdir1 = gd * tdj * Tinv
        ga, gd = gA1 + galb[j + 1], gAdir1 + galbdir[j + 1]
    lay = lambda xs: torch.stack(xs, dim=1)
    return (dtoa, ga, gd, lay(dR), lay(dT), lay(drd), lay(dtdd),
            lay(dtdir))


def lw_solver_noscat_bwd_reference(args, cts):
    """Plain version of kernel B14 (JAX's ``_lw_noscat_bwd_kernel``), level
    by level as the TPU body: replay both accumulations, the up
    accumulation's backward, the surface terms, the down accumulation's
    backward (the gradient on the constant fdn[0] is dropped). ``args`` =
    the forward's five arguments, ``cts`` = the cotangents of (flux_dn,
    flux_up); returns the five gradients in the arguments' order."""
    trans, sdn, sup, ssfc, emis = args
    dfdn, dfup = cts
    nlev = trans.shape[1]
    fdn = [torch.zeros_like(ssfc)]
    for j in range(nlev):
        fdn.append(trans[:, j] * fdn[j] + sdn[:, j])
    fup = [None] * (nlev + 1)
    fup[nlev] = emis * ssfc + (1.0 - emis) * fdn[nlev]
    for j in range(nlev - 1, -1, -1):
        fup[j] = trans[:, j] * fup[j + 1] + sup[:, j]
    dtrans, dsdn, dsup = ([None] * nlev for _ in range(3))
    # up accumulation backward (ascending)
    g = dfup[:, 0]
    for j in range(nlev):
        dsup[j] = g
        dtrans[j] = g * fup[j + 1]
        g = dfup[:, j + 1] + g * trans[:, j]
    demis = g * (ssfc - fdn[nlev])
    dssfc = g * emis
    # down accumulation backward (descending)
    h = dfdn[:, nlev] + g * (1.0 - emis)
    for j in range(nlev - 1, -1, -1):
        dsdn[j] = h
        dtrans[j] = dtrans[j] + h * fdn[j]
        h = dfdn[:, j] + h * trans[:, j]
    lay = lambda xs: torch.stack(xs, dim=1)
    return lay(dtrans), lay(dsdn), lay(dsup), dssfc, demis


# the B13 kernel's block: one warp of items, each parking 4 floats every
# chunk of levels in shared memory (csrc/adding_sw_bwd.cu)
_SW_BWD_ITEMS, _SW_BWD_CHUNK = 32, 4


def sw_bwd_geometry(B: int, nlev: int, ng: int) -> tuple[int, int, int]:
    """The launch of kernel B13 at (B, nlev, ng), as csrc/adding_sw_bwd.cu
    makes it: (blocks, items a block, shared-memory bytes a block). Each
    block is one warp of items (B ng of them in all, the last block
    ragged) and parks 4 floats an item for every chunk of 4 levels (the
    last chunk ragged); past a block's shared memory (nlev above 1,816)
    the kernel refuses the shape, and so does this."""
    chunks = -(-nlev // _SW_BWD_CHUNK)
    smem = 4 * 4 * chunks * _SW_BWD_ITEMS
    if smem > _SMEM_MAX:
        raise ValueError(f"adding_sw_bwd: nlev {nlev} parks {smem} bytes a "
                         f"block, above the {_SMEM_MAX} of shared memory")
    return -(-B * ng // _SW_BWD_ITEMS), _SW_BWD_ITEMS, smem


def _launch_sw_bwd(args, cts, scratch_design=False):
    """B13; with ``scratch_design`` its first design, which keeps the
    replay in a [4, B, nlev+1, ng] device scratch (for timing it against
    the kernel on the card; counts no launch)."""
    B, nlev, ng = args[3].shape
    dev = args[0].device
    grads = _empty(dev, *[(B, ng)] * 3, *[(B, nlev, ng)] * 5)
    if scratch_design:
        scratch = torch.empty((4, B, nlev + 1, ng), dtype=torch.float32,
                              device=dev)
        _launch("adding_sw_bwd", list(args) + list(cts) + grads,
                (B, nlev, ng), extra=[scratch], fn="adding_sw_bwd_scratch")
        return tuple(grads)
    sw_bwd_geometry(B, nlev, ng)
    _launch("adding_sw_bwd", list(args) + list(cts) + grads, (B, nlev, ng))
    adding_sw_bwd.launches += 1
    return tuple(grads)


def scratch_adding_sw_bwd(args, cts):
    """B13's first design on the card, which no wrapper selects: for
    timing it against the kernel. Counts no launch."""
    _validate(_SW_ARGS, args, _SW_SFC, cts)
    return _launch_sw_bwd(args, cts, scratch_design=True)


def _run_lw_bwd(args, cts, d):
    """B14 at design ``d`` (a ``rad_design`` dict) on contiguous CUDA
    tensors; counts nothing."""
    B, nlev, ng = args[0].shape
    grads = _empty(args[0].device, *[(B, nlev, ng)] * 3, *[(B, ng)] * 2)
    ptrs = list(args) + list(cts) + grads
    if d["design"] == "staged":
        _launch("lw_noscat_bwd", ptrs,
                (B, nlev, ng, d["C"], d["blocks"]), fn="lw_noscat_bwd_staged")
    else:
        _launch("lw_noscat_bwd", ptrs, (B, nlev, ng))
    return tuple(grads)


def _launch_lw_bwd(args, cts):
    args = [a.contiguous() for a in args]
    cts = [c.contiguous() for c in cts]
    d = _rad_select(lw_solver_noscat_bwd, "b14", args + cts,
                    *args[0].shape)
    grads = _run_lw_bwd(args, cts, d)
    lw_solver_noscat_bwd.launches += 1
    return grads


def first_adding_sw(*args):
    """B11's first design on the card, which the wrapper selects only
    where the staged tile cannot take the shape: for timing the designs.
    Counts no launch."""
    _validate(_SW_ARGS, args, _SW_SFC)
    return _run_sw([a.contiguous() for a in args], dict(design="first"))


def first_lw_solver_noscat_bwd(args, cts):
    """B14's first design on the card (four sweeps, the replay parked in
    the outputs), which the wrapper selects only where the staged tile
    cannot take the shape: for timing the designs. Counts no launch."""
    _validate(_LW_ARGS, args, _LW_SFC, cts)
    return _run_lw_bwd([a.contiguous() for a in args],
                       [c.contiguous() for c in cts], dict(design="first"))


def adding_sw_bwd(args, cts):
    """SW adding solver backward (JAX's ``adding_sw_bwd_fused``): ``args`` =
    the forward's eight arguments, ``cts`` = the cotangents of (flux_up,
    flux_dn_diffuse, flux_dn_direct) [B, nlev+1, ng] -> the eight
    gradients. A CPU tensor runs the plain version; a CUDA tensor launches
    kernel B13 or raises."""
    _validate(_SW_ARGS, args, _SW_SFC, cts)
    return _dispatch(args, adding_sw_bwd_reference, _launch_sw_bwd, cts)


def lw_solver_noscat_bwd(args, cts):
    """LW no-scattering solver backward (JAX's
    ``lw_solver_noscat_bwd_fused``): ``args`` = the forward's five
    arguments, ``cts`` = the cotangents of (flux_dn, flux_up)
    [B, nlev+1, ng] -> the five gradients. A CPU tensor runs the plain
    version; a CUDA tensor launches kernel B14 (the design ``rad_design``
    picks, recorded as ``lw_solver_noscat_bwd.design``) or raises."""
    _validate(_LW_ARGS, args, _LW_SFC, cts)
    return _dispatch(args, lw_solver_noscat_bwd_reference, _launch_lw_bwd,
                     cts)


def _needed(grads, needs):
    return tuple(g if n else None for g, n in zip(grads, needs))


@torch.library.custom_op("climsim::adding_sw_fast", mutates_args=(),
                         device_types="cpu")
def _b11_op(args: list[torch.Tensor]
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B11 as a custom op: on the CPU its plain version,
    ``physics.radiation.adding_sw``."""
    _validate(_SW_ARGS, args, _SW_SFC)
    return fresh(adding_sw(*args), args)


@torch.library.custom_op("climsim::lw_solver_noscat_fast", mutates_args=(),
                         device_types="cpu")
def _b12_op(args: list[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """B12 as a custom op: on the CPU its plain version,
    ``physics.radiation.lw_solver_noscat``."""
    _validate(_LW_ARGS, args, _LW_SFC)
    return fresh(lw_solver_noscat(*args), args)


def _fluxes_fake(args, n: int, layer: int):
    B, nlev, ng = args[layer].shape
    return tuple(args[layer].new_empty((B, nlev + 1, ng)) for _ in range(n))


@_b11_op.register_kernel("cuda")
def _b11_cuda(args):
    _validate(_SW_ARGS, args, _SW_SFC)
    return _launch_sw(args)


@_b12_op.register_kernel("cuda")
def _b12_cuda(args):
    _validate(_LW_ARGS, args, _LW_SFC)
    return _launch_lw(args)


@_b11_op.register_fake
def _b11_fake(args):
    _validate(_SW_ARGS, args, _SW_SFC)
    return _fluxes_fake(args, 3, 3)


@_b12_op.register_fake
def _b12_fake(args):
    _validate(_LW_ARGS, args, _LW_SFC)
    return _fluxes_fake(args, 2, 0)


class _AddingSW(torch.autograd.Function):
    """Forward: the op ``climsim::adding_sw_fast``; backward:
    ``adding_sw_bwd``."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return torch.ops.climsim.adding_sw_fast(list(args))

    @staticmethod
    def backward(ctx, *cts):
        return _needed(adding_sw_bwd(ctx.saved_tensors,
                                     [c.contiguous() for c in cts]),
                       ctx.needs_input_grad)


class _LWNoScat(torch.autograd.Function):
    """Forward: the op ``climsim::lw_solver_noscat_fast``; backward:
    ``lw_solver_noscat_bwd``."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return torch.ops.climsim.lw_solver_noscat_fast(list(args))

    @staticmethod
    def backward(ctx, *cts):
        return _needed(lw_solver_noscat_bwd(ctx.saved_tensors,
                                            [c.contiguous() for c in cts]),
                       ctx.needs_input_grad)


def adding_sw_fast(incoming_toa, albedo_surf_diffuse, albedo_surf_direct,
                   R, T, ref_dir, T_dir_diff, T_dir_dir):
    """SW two-stream adding solver, differentiable: surface arguments
    [B, ng], layer arguments [B, nlev, ng] -> (flux_up, flux_dn_diffuse,
    flux_dn_direct) [B, nlev+1, ng]. A CPU tensor runs
    ``physics.radiation.adding_sw`` (and ``adding_sw_bwd_reference`` for
    gradients); a CUDA tensor launches kernel B11 (the design
    ``rad_design`` picks, recorded as ``adding_sw_fast.design``; and B13)
    or raises."""
    return _AddingSW.apply(incoming_toa, albedo_surf_diffuse,
                           albedo_surf_direct, R, T, ref_dir, T_dir_diff,
                           T_dir_dir)


def lw_solver_noscat_fast(trans_lw, source_dn, source_up, source_sfc,
                          emissivity_surf):
    """LW no-scattering solver, differentiable: layer arguments
    [B, nlev, ng], surface [B, ng] -> (flux_dn, flux_up) [B, nlev+1, ng].
    A CPU tensor runs ``physics.radiation.lw_solver_noscat`` (and
    ``lw_solver_noscat_bwd_reference`` for gradients); a CUDA tensor
    launches kernel B12 (and B14) or raises."""
    return _LWNoScat.apply(trans_lw, source_dn, source_up, source_sfc,
                           emissivity_surf)


adding_sw_fast.launches = 0
lw_solver_noscat_fast.launches = 0
adding_sw_bwd.launches = 0
lw_solver_noscat_bwd.launches = 0
adding_sw_fast.design = None
lw_solver_noscat_bwd.design = None
