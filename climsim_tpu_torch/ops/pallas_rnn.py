"""The fused BiGRU kernels and their plain PyTorch versions (counterpart of
``climsim_tpu/ops/pallas_rnn.py``): the v6 and v5 fused emulator forwards
(``fused_bigru_heads_init_cm``, ``fused_bigru_heads_cm``; kernels
``csrc/bigru_heads_init_cm.cu`` and ``csrc/bigru_heads_cm.cu``) and their
shared backward (``bigru_heads_cm_bwd``, ``csrc/bigru_heads_cm_bwd.cu``),
and, at the end of this module, the v2 level-major forward and backward
(``fused_bigru_lbh``, ``bigru_bwd_lbh``; kernels ``csrc/bigru_lbh.cu`` and
``csrc/bigru_lbh_bwd.cu``) of the physics trunk and the batch-major
flagship, with its batch-major wrapper ``fused_bigru`` and the
``PallasBiGRU`` op; and last the batch-major v3 and v4 fused emulator
forwards (``fused_bigru_heads_lbh``, ``fused_bigru_heads_init_lbh``;
kernel ``csrc/bigru_heads_lbh.cu``), whose gradients go through the v2
pair.

Channel-major contract, as in JAX: feat [L, nf, B] raw features, mem_in
[L, nm_in, B], h0_up/h0_dn [H, B]; weights pre-transposed [out, in] and
biases [ch, 1] -> (outmem [L, nm+ny, B] = mem || out, lasth [H, B]).
Every sum is accumulated in float32; the input type (float32 or
bfloat16) is the storage type of xi, the projections, the up stream, the
heads and the outputs, where the TPU kernel stores them.

``fused_bigru_heads_init_cm`` is differentiable: its backward recomputes
the initial-MLP stream, runs ``bigru_heads_cm_bwd`` (replay, heads and
down-sweep BPTT, up-sweep BPTT, weight gradients) and applies the
initial MLP's VJP, as JAX's ``_heads_init_cm_bwd`` does.
``fused_bigru_heads_cm`` (v5) takes that stream as its input, so its
backward is ``bigru_heads_cm_bwd`` alone, as JAX's ``_heads_cm_bwd``.

The forward kernels B1, B4, B7, B9 and B10 are ``torch.library`` custom
ops (``torch.ops.climsim.*``, ``ops/library.py``): each wrapper's
``autograd.Function`` calls its op, whose CPU implementation is the plain
version and whose CUDA implementation the launch.

Each forward takes the TPU bodies' ``acc32`` (its op carries it in its
schema, so an exported program keeps it). ``acc32=False`` with a bf16
input carries the hidden state in bf16 and rounds every gate operation
to bf16, sigmoid and tanh built from exp and division as JAX's typed
helpers build them (``_gates_typed``; ``csrc/gates16.cuh``); every
projection is then rounded before the gates. With a float32 input the
mode is the float32 computation. The backward kernels linearise the
float32-gate forward in both modes, as JAX's do.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .library import fresh

__all__ = ["fused_bigru_heads_init_cm", "bigru_heads_init_cm_reference",
           "fused_bigru_heads_cm", "bigru_heads_cm_reference",
           "bigru_heads_cm_bwd", "bigru_heads_cm_bwd_reference",
           "fused_bigru_lbh", "bigru_reference_lbh", "bigru_bwd_lbh",
           "bigru_bwd_reference_lbh", "fused_bigru", "PallasBiGRU",
           "fused_bigru_heads_lbh", "bigru_heads_lbh_reference",
           "fused_bigru_heads_init_lbh", "bigru_heads_init_lbh_reference"]

_ARGS = ("feat", "mem_in", "h0_up", "h0_dn", "winit_t", "binit", "win1h_t",
         "win1m_t", "bin1", "whh_up_t", "bhh_up", "win2_t", "bin2",
         "whh_dn_t", "bhh_dn", "wlat_t", "blat", "wout_t", "bout")
# the backward's residuals: the forward's arguments with feat replaced
# by the initial-MLP stream x = xi [L, CH, B] and without winit/binit
_RES = ("x",) + _ARGS[1:4] + _ARGS[6:]
# column splits of the weight-gradient reductions in the backward kernel
_SPLITS = 32


def _mm(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[out, in] @ [in, B] with float32 accumulation of the dt products
    (bf16 x bf16 products are exact in float32)."""
    return torch.matmul(w.float(), x.float())


def _tmm(w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """w [K, M] contracted over dim 0 with d [K, B] rounded to w's type
    -> [M, B] float32 (JAX's ``_tcontract0``)."""
    return torch.matmul(w.float().t(), d.to(w.dtype).float())


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, B] x b [N, B] -> [M, N] float32, contracting the columns."""
    return torch.matmul(a.float(), b.float().t())


def _gru_step_gates_cm(h, xp, whh_t, bhh, H: int):
    """Channel-major GRU update with gates [r; z; n]: h [H, B] float32,
    xp [3H, B] (input bias included) -> (new h, (r, z, n, hn)), all
    float32; the gates are what the backward stores (JAX's
    ``_gru_fwd_store_cm``). The recurrent product takes h rounded to the
    weight type."""
    hh = _mm(whh_t, h.to(whh_t.dtype)) + bhh.float()
    xr, xz, xn = xp.float().split(H)
    hr, hz, hn = hh.split(H)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h, (r, z, n, hn)


def _sigmoid_typed(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``_sigmoid_typed`` on a sub-f32 tensor: 1 / (1 + exp(-x)),
    every operation rounded to x's type (``torch.sigmoid`` rounds once)."""
    return 1.0 / (1.0 + torch.exp(-x))


def _tanh_typed(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``_tanh_typed``: 2 sigmoid(2x) - 1, each operation in x's
    type."""
    return 2.0 * _sigmoid_typed(2.0 * x) - 1.0


def _gates_typed(x, hh, h, H: int, dim: int):
    """The GRU gates in the input type (JAX's ``_gru_step`` under
    ``acc32=False``): x the projection (input bias included) and hh the
    recurrent product with its bias, both rounded to h's type, h the
    carried state; every sum, product and transcendental rounds."""
    xr, xz, xn = x.split(H, dim)
    hr, hz, hn = hh.split(H, dim)
    r = _sigmoid_typed(xr + hr)
    z = _sigmoid_typed(xz + hz)
    n = _tanh_typed(xn + r * hn)
    return (1.0 - z) * n + z * h


def _gru_step_cm(h, xp, whh_t, bhh, H: int):
    """``_gru_step_gates_cm`` without the gates: the new h. The state's
    type is the gate arithmetic's: float32, or with ``acc32=False`` the
    input type (bf16), where the recurrent product accumulates in float32,
    takes its bias there and is rounded, and every gate operation rounds
    (``_gates_typed``)."""
    if h.dtype == torch.float32:
        return _gru_step_gates_cm(h, xp, whh_t, bhh, H)[0]
    hh = (_mm(whh_t, h) + bhh.float()).to(h.dtype)
    return _gates_typed(xp.to(h.dtype), hh, h, H, 0)


def _gru_bwd_step_cm(dh, gates, h_prev, whh_t, H: int):
    """One channel-major GRU backward step (JAX's ``_gru_bwd_step_cm``):
    dh/h_prev [H, B] float32, gates [4H, B] as stored -> (d_xp [3H, B],
    dh_prev [H, B], d_hh [3H, B]), all float32."""
    r, z, n, hn = gates.float().split(H)
    dz = dh * (h_prev - n)
    dan = dh * (1.0 - z) * (1.0 - n * n)
    dar = dan * hn * r * (1.0 - r)
    daz = dz * z * (1.0 - z)
    dhn = dan * r
    d_hh = torch.cat([dar, daz, dhn])
    d_xp = torch.cat([dar, daz, dan])
    return d_xp, dh * z + _tmm(whh_t, d_hh), d_hh


def bigru_heads_cm_reference(x, mem_in, h0_up, h0_dn, win1h_t, win1m_t,
                             bin1, whh_up_t, bhh_up, win2_t, bin2, whh_dn_t,
                             bhh_dn, wlat_t, blat, wout_t, bout,
                             hoist_proj=True, acc32=True):
    """Plain version of the v5 forward kernel (B4), level by level: x
    [L, CH, B] is the initial-MLP stream. With ``hoist_proj`` the sweeps'
    input projections are rounded to x's type before the gates, as the
    TPU's hoisted body stores them; without, they stay float32.
    ``acc32=False`` runs the gates and carries the states in x's type
    (both TPU bodies then round the projections, so ``hoist_proj`` changes
    nothing); with a float32 x it is the float32 computation."""
    dt = x.dtype
    acc = torch.float32 if acc32 else dt
    rnd = (lambda t: t.to(dt)) if hoist_proj or not acc32 else (lambda t: t)
    L = x.shape[0]
    H = whh_up_t.shape[1]
    h = h0_up.to(acc)
    up = [None] * L
    for l in range(L - 1, -1, -1):
        xp = rnd(_mm(win1h_t, x[l]) + _mm(win1m_t, mem_in[l])
                 + bin1.float())
        h = _gru_step_cm(h, xp, whh_up_t, bhh_up, H)
        up[l] = h.to(dt)
    h2 = h0_dn.to(acc)
    outmem = []
    for l in range(L):
        xp2 = rnd(_mm(win2_t, up[l]) + bin2.float())
        h2 = _gru_step_cm(h2, xp2, whh_dn_t, bhh_dn, H)
        mem_l = (_mm(wlat_t, h2.to(dt)) + blat.float()).to(dt)
        out_l = (_mm(wout_t, mem_l) + bout.float()).to(dt)
        outmem.append(torch.cat([mem_l, out_l], dim=0))
    return torch.stack(outmem), h2.to(dt)


def _xi_tanh(pre: torch.Tensor, acc32: bool) -> torch.Tensor:
    """The initial MLP's tanh of its pre-activation ``pre``, already
    rounded to the input type: float32 tanh rounded once, or with
    ``acc32=False`` and a sub-f32 input the TPU bodies' typed tanh. (The
    TPU bodies take the typed tanh for a bf16 input in both modes; the
    float32-gate kernels keep the float32 one, a departure of at most a
    few bf16 ulps: ROADMAP C.)"""
    if acc32 or pre.dtype == torch.float32:
        return torch.tanh(pre.float()).to(pre.dtype)
    return _tanh_typed(pre)


def bigru_heads_init_cm_reference(feat, mem_in, h0_up, h0_dn, winit_t,
                                  binit, *weights, acc32=True):
    """Plain version of the v6 forward kernel (B1): the initial MLP's
    stream xi = dt(tanh(dt(Winit feat_l + binit))) (``_xi_tanh``), then
    the v5 sweeps and heads with the projections rounded, as the v6 kernel
    stores them. ``weights`` are (win1h_t, win1m_t, bin1, whh_up_t,
    bhh_up, win2_t, bin2, whh_dn_t, bhh_dn, wlat_t, blat, wout_t, bout);
    ``acc32`` as ``bigru_heads_cm_reference``'s."""
    dt = feat.dtype
    xi = torch.stack([
        _xi_tanh((_mm(winit_t, feat[l]) + binit.float()).to(dt), acc32)
        for l in range(feat.shape[0])])
    return bigru_heads_cm_reference(xi, mem_in, h0_up, h0_dn, *weights,
                                    hoist_proj=True, acc32=acc32)


def bigru_heads_cm_bwd_reference(res, d_outmem, d_lasth):
    """Plain version of the backward kernel, phase by phase and level by
    level as the TPU kernel's body: (A) replay both sweeps storing h and
    the gates in the input type, the up projection in float32 without
    rounding; (B) heads and down-sweep BPTT; (C) up-sweep BPTT. Weight
    gradients are float32 sums of products whose left factor is rounded to
    the weight type, cast to each weight's type at the end.

    Returns (dx, dmem, dh0u, dh0d, dwin1h, dwin1m, dbin1, dwhh_up, dbhh_up,
    dwin2, dbin2, dwhh_dn, dbhh_dn, dwlat, dblat, dwout, dbout)."""
    (x, mem_in, h0_up, h0_dn, win1h_t, win1m_t, bin1, whh_up_t, bhh_up,
     win2_t, bin2, whh_dn_t, bhh_dn, wlat_t, blat, wout_t, bout) = res
    dt, wdt = x.dtype, whh_up_t.dtype
    L, H, nm = x.shape[0], whh_up_t.shape[1], wlat_t.shape[0]
    # phase A: replay, up sweep (surface to top), then down sweep
    up_h, gates_u = [None] * L, [None] * L
    h = h0_up.float()
    for l in range(L - 1, -1, -1):
        xp = _mm(win1h_t, x[l]) + _mm(win1m_t, mem_in[l]) + bin1.float()
        h, g = _gru_step_gates_cm(h, xp, whh_up_t, bhh_up, H)
        up_h[l], gates_u[l] = h.to(dt), torch.cat(g).to(dt)
    g_h, gates_d = [None] * L, [None] * L
    h2 = h0_dn.float()
    for l in range(L):
        xp2 = _mm(win2_t, up_h[l]) + bin2.float()
        h2, g = _gru_step_gates_cm(h2, xp2, whh_dn_t, bhh_dn, H)
        g_h[l], gates_d[l] = h2.to(dt), torch.cat(g).to(dt)

    # phase B: heads + down sweep backward (surface to top)
    grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=x.device)
             for k, p in zip(_RES[4:], res[4:])}
    dup = [None] * L
    dg = d_lasth.float()
    for l in range(L - 1, -1, -1):
        dmo = d_outmem[l].float()
        dmem_head, dout = dmo[:nm], dmo[nm:]
        hd = g_h[l].to(wlat_t.dtype)
        mem_l = (_mm(wlat_t, hd) + blat.float()).to(dt)
        grads["wout_t"] += _outer(dout.to(wdt), mem_l)
        grads["bout"] += dout.sum(1, keepdim=True)
        dmem_tot = dmem_head + _tmm(wout_t, dout)
        grads["wlat_t"] += _outer(dmem_tot.to(wdt), hd)
        grads["blat"] += dmem_tot.sum(1, keepdim=True)
        dg = dg + _tmm(wlat_t, dmem_tot)
        g_prev = (h0_dn if l == 0 else g_h[l - 1]).float()
        dxp2, dg, d_hh = _gru_bwd_step_cm(dg, gates_d[l], g_prev, whh_dn_t,
                                          H)
        dup[l] = _tmm(win2_t, dxp2)
        grads["win2_t"] += _outer(dxp2.to(wdt), up_h[l])
        grads["bin2"] += dxp2.sum(1, keepdim=True)
        grads["whh_dn_t"] += _outer(d_hh.to(wdt), g_prev.to(wdt))
        grads["bhh_dn"] += d_hh.sum(1, keepdim=True)
    dh0d = dg.to(h0_dn.dtype)

    # phase C: up sweep backward (top to surface)
    dx, dmem = torch.empty_like(x), torch.empty_like(mem_in)
    du = torch.zeros_like(dg)
    for l in range(L):
        du = du + dup[l]
        h_prev = (h0_up if l == L - 1 else up_h[l + 1]).float()
        d_xp, du, d_hh = _gru_bwd_step_cm(du, gates_u[l], h_prev, whh_up_t,
                                          H)
        dx[l] = _tmm(win1h_t, d_xp).to(dx.dtype)
        dmem[l] = _tmm(win1m_t, d_xp).to(dmem.dtype)
        grads["win1h_t"] += _outer(d_xp.to(wdt), x[l])
        grads["win1m_t"] += _outer(d_xp.to(wdt), mem_in[l])
        grads["bin1"] += d_xp.sum(1, keepdim=True)
        grads["whh_up_t"] += _outer(d_hh.to(wdt), h_prev.to(wdt))
        grads["bhh_up"] += d_hh.sum(1, keepdim=True)
    dh0u = du.to(h0_up.dtype)
    return (dx, dmem, dh0u, dh0d) + tuple(
        grads[k].to(p.dtype) for k, p in zip(_RES[4:], res[4:]))


def _check(named: dict, shapes: dict, contiguous) -> None:
    """Raise ``ValueError`` unless every tensor has the first one's dtype
    (float32 or bfloat16) and device, the given shape, and, for the names
    in ``contiguous``, contiguous storage."""
    first = next(iter(named.values()))
    dt, dev = first.dtype, first.device
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{dt}: the kernels take float32 or bfloat16")
    for k, t in named.items():
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{k}: {t.dtype} on {t.device}, the kernel "
                             f"takes every tensor as {dt} on {dev}")
        if tuple(t.shape) != shapes[k]:
            raise ValueError(f"{k}: shape {tuple(t.shape)}, want "
                             f"{shapes[k]}")
    for k in contiguous:
        if not named[k].is_contiguous():
            raise ValueError(f"{k} must be contiguous")


def _weight_shapes(H: int, CH: int, nm_in: int, nm: int, ny: int) -> dict:
    return {"win1h_t": (3 * H, CH), "win1m_t": (3 * H, nm_in),
            "bin1": (3 * H, 1), "whh_up_t": (3 * H, H),
            "bhh_up": (3 * H, 1), "win2_t": (3 * H, H), "bin2": (3 * H, 1),
            "whh_dn_t": (3 * H, H), "bhh_dn": (3 * H, 1), "wlat_t": (nm, H),
            "blat": (nm, 1), "wout_t": (ny, nm), "bout": (ny, 1)}


def _validate(args) -> tuple[int, ...]:
    """Check dtype, device, shapes and contiguity of the forward's
    arguments (on every device, so the CPU tests catch what the kernel
    would refuse); returns (L, nf, nm_in, H, nm, ny, B)."""
    named = dict(zip(_ARGS, args))
    L, nf, B = named["feat"].shape
    nm_in, H = named["mem_in"].shape[1], named["whh_up_t"].shape[1]
    nm, ny = named["wlat_t"].shape[0], named["wout_t"].shape[0]
    shapes = {"feat": (L, nf, B), "mem_in": (L, nm_in, B), "h0_up": (H, B),
              "h0_dn": (H, B), "winit_t": (H, nf), "binit": (H, 1),
              **_weight_shapes(H, H, nm_in, nm, ny)}
    _check(named, shapes, ("feat", "mem_in", "h0_up", "h0_dn"))
    return L, nf, nm_in, H, nm, ny, B


def _validate_cm(res, cotangents=()) -> tuple[int, ...]:
    """Check the v5 forward's arguments, which are the backward's
    residuals, and with ``cotangents`` = (d_outmem, d_lasth) those of the
    backward; returns (L, CH, nm_in, H, nm, ny, B)."""
    named = dict(zip(_RES, res))
    L, CH, B = named["x"].shape
    nm_in, H = named["mem_in"].shape[1], named["whh_up_t"].shape[1]
    nm, ny = named["wlat_t"].shape[0], named["wout_t"].shape[0]
    shapes = {"x": (L, CH, B), "mem_in": (L, nm_in, B), "h0_up": (H, B),
              "h0_dn": (H, B), **_weight_shapes(H, CH, nm_in, nm, ny)}
    contiguous = ["x", "mem_in", "h0_up", "h0_dn"]
    if cotangents:
        named.update(d_outmem=cotangents[0], d_lasth=cotangents[1])
        shapes.update(d_outmem=(L, nm + ny, B), d_lasth=(H, B))
        contiguous += ["d_outmem", "d_lasth"]
    _check(named, shapes, contiguous)
    return L, CH, nm_in, H, nm, ny, B


# the kernels read weights k-major ([in, out], flax's layout): free when
# the caller passes transposed views of such storage, as
# FusedBiGRUHeadsLayer does
def _kmaj(w: torch.Tensor) -> torch.Tensor:
    return w.t().contiguous()


def _flat(b: torch.Tensor) -> torch.Tensor:
    return b.reshape(-1).contiguous()


def _dtype_code(dt) -> int:
    """The CUDA-core entries' dtype argument: 0 float32, 1 bf16 (the gate
    mode is their ``g16`` argument, as the tensor-core entries')."""
    return 0 if dt == torch.float32 else 1


def _launch(args, dims, cudacore_bf16=False, g16=False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA-core design of B1 (f32, and bf16 past the tensor-core
    plan; ``g16``: its bf16-gate instantiation), its tiles in shared
    memory or, where they do not fit, in a device scratch
    (``_tile_scratch``); with ``cudacore_bf16`` its bf16 instantiation
    under the timing twin's C symbol (``cudacore_bigru_heads_init_cm``),
    which counts no launch."""
    (feat, mem_in, h0_up, h0_dn, winit_t, binit, win1h_t, win1m_t, bin1,
     whh_up_t, bhh_up, win2_t, bin2, whh_dn_t, bhh_dn, wlat_t, blat, wout_t,
     bout) = args
    L, nf, nm_in, H, nm, ny, B = dims
    dt, dev = feat.dtype, feat.device
    outmem = torch.empty((L, nm + ny, B), dtype=dt, device=dev)
    lasth = torch.empty((H, B), dtype=dt, device=dev)
    up = torch.empty((L, H, B), dtype=dt, device=dev)   # up-stream scratch
    tiles = _tile_scratch("b1", (H, H, nm_in, nm, ny, nf), B, dev)
    ptrs = [feat, mem_in, h0_up, h0_dn, _kmaj(winit_t), _flat(binit),
            _kmaj(win1h_t), _kmaj(win1m_t), _flat(bin1), _kmaj(whh_up_t),
            _flat(bhh_up), _kmaj(win2_t), _flat(bin2), _kmaj(whh_dn_t),
            _flat(bhh_dn), _kmaj(wlat_t), _flat(blat), _kmaj(wout_t),
            _flat(bout), outmem, lasth, up]
    lib = _build.load("bigru_heads_init_cm")
    head = []
    if cudacore_bf16:
        if g16:
            raise ValueError("the timing twin runs float32 gates only")
        fn = lib.bigru_heads_init_cm_cudacore
    else:
        fn = lib.bigru_heads_init_cm
        head = [_dtype_code(dt)]
    ints = [L, nf, nm_in, H, nm, ny, B] + [int(g16)] * (not cudacore_bf16)
    fn.argtypes = [ctypes.c_int] * len(head) + [ctypes.c_void_p] * 22 \
        + [ctypes.c_int] * len(ints) + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(*head, *[t.data_ptr() for t in ptrs], *ints, _ptr(tiles), stream)
    _build.check_status(rc, "bigru_heads_init_cm")
    if not cudacore_bf16:
        fused_bigru_heads_init_cm.launches += 1
    return outmem, lasth


def _launch_bwd(res, d_outmem, d_lasth, dims, cudacore_bf16=False
                ) -> tuple[torch.Tensor, ...]:
    """The CUDA-core design of B3 (f32, and bf16 past the tensor-core
    plan), its tiles in shared memory or a device scratch, as ``_launch``;
    with ``cudacore_bf16`` the timing twin (``cudacore_bigru_heads_cm_bwd``,
    no launch counted)."""
    (x, mem_in, h0_up, h0_dn, win1h_t, win1m_t, bin1, whh_up_t, bhh_up,
     win2_t, bin2, whh_dn_t, bhh_dn, wlat_t, blat, wout_t, bout) = res
    L, CH, nm_in, H, nm, ny, B = dims
    dt, dev = x.dtype, x.device
    new = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    f32 = torch.float32
    grads = [new(*p.shape) for p in res[4:]]
    outs = [new(L, CH, B), new(L, nm_in, B), new(H, B), new(H, B)]
    # scratch the TPU kernel kept in VMEM: h and the gates of both sweeps
    # and the recomputed latent head (input type); d_up and the per-level
    # gradient streams the weight-gradient reductions read (float32); the
    # reductions' per-split partial sums of the largest weight
    largest = max(3 * H * max(CH, H, nm_in), nm * H, ny * nm)
    scratch = [new(L, H, B), new(L, H, B), new(L, 4 * H, B),
               new(L, 4 * H, B), new(L, nm, B), new(L, H, B, dtype=f32),
               new(L, 4 * H, B, dtype=f32), new(L, 4 * H, B, dtype=f32),
               new(L, nm, B, dtype=f32), new(_SPLITS * largest, dtype=f32),
               _tile_scratch("b3", (H, CH, nm_in, nm, ny), B, dev)]
    # the slot order of csrc/bigru_heads_cm_bwd.cu's enum Slot
    ptrs = [x, mem_in, h0_up, h0_dn,
            _kmaj(win1h_t), _kmaj(win1m_t), _kmaj(whh_up_t), _kmaj(win2_t),
            _kmaj(whh_dn_t), _kmaj(wlat_t),
            *(w.contiguous() for w in (win1h_t, win1m_t, whh_up_t, win2_t,
                                       whh_dn_t, wlat_t, wout_t)),
            *(_flat(b) for b in (bin1, bhh_up, bin2, bhh_dn, blat)),
            d_outmem, d_lasth, *outs, *grads, *scratch]
    table = (ctypes.c_void_p * len(ptrs))(*[_ptr(t) for t in ptrs])
    lib = _build.load("bigru_heads_cm_bwd")
    head = []
    if cudacore_bf16:
        fn = lib.bigru_heads_cm_bwd_cudacore
    else:
        fn = lib.bigru_heads_cm_bwd
        head = [0 if dt == torch.float32 else 1]
    fn.argtypes = [ctypes.c_int] * (len(head) + 1) + [ctypes.c_void_p] \
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(*head, len(ptrs), table, L, CH, nm_in, H, nm, ny, B, _SPLITS,
            stream)
    _build.check_status(rc, "bigru_heads_cm_bwd")
    if not cudacore_bf16:
        bigru_heads_cm_bwd.launches += 1
    return tuple(outs) + tuple(grads)


# --------------------------------------------------------------------------
# bf16 tensor-core design of B1, B3, B4, B7-B10 (csrc/bigru_mma.cuh): the
# cluster plan, the zero-padding of widths the tiling does not divide, and
# the packing of weights into the CTAs' slices. The constants mirror the
# CUDA sources.
# --------------------------------------------------------------------------

_MMA_NTH, _MMA_MAXP, _MMA_PAD, _MMA_PF, _MMA_MAXI = 384, 2, 8, 8, 2
_MMA_KC = 64            # k-chunk of a streamed weight slice
_SMEM_MAX = 232448
# (cluster CTAs C, tile columns BT), in order of preference
_MMA_CONFIGS = ((4, 64), (4, 32), (8, 64), (8, 32), (8, 16), (4, 16))
# the widest hidden layer every kind of the tensor-core design takes at
# the flagship's other widths (B7 and B8: 960); past it ``gru_design``
# selects the CUDA-core design, which takes any width
MMA_H_MAX = 832


def _ceil(a: int, m: int) -> int:
    return -(-a // m) * m


def _regions(*sizes) -> int:
    """Bytes of shared-memory regions (count, item size), each rounded up
    to 16 bytes (``bmma::Smem``)."""
    return sum(_ceil(n * b, 16) for n, b in sizes)


def _ring(stream: bool, rows: int) -> int:
    """Elements of the streamed mode's ring: two [rows][KC + PAD] slots."""
    return 2 * rows * (_MMA_KC + _MMA_PAD) if stream else 0


def _up_bytes(Hc, KX, H, BT, nraw, nf, CHc, stream, xt=False):
    """The up sweep's regions (``bmma::up_bufs``); with ``xt`` B4's X tile,
    stored transposed and unpadded."""
    P = _MMA_PAD
    res = 0 if stream else 3 * Hc
    kx = KX + P if KX else 0
    return _regions((res * kx, 2), (res * (H + P), 2),
                    (_ring(stream, 3 * Hc), 2), (2 * BT * (H + P), 2),
                    (2 * BT * (KX if xt else kx), 2), (nraw * BT, 4),
                    (CHc * nf, 4), (CHc if nf else 0, 4))


def _dn_bytes(Hc, H, BT, nm8, nhw, stream):
    P = _MMA_PAD
    res = 0 if stream else 3 * Hc
    return _regions((res * (H + P), 2), (res * (H + P), 2),
                    (_ring(stream, 3 * Hc), 2), (2 * BT * (H + P), 2),
                    (2 * BT * (H + P), 2), (nm8 * (H + P), 2),
                    (BT * nm8, 4), (nhw, 4))


def _bwd_bytes(Hc, H, BT, nm, ny, wu_rows, heads, stream):
    P, nm16 = _MMA_PAD, _ceil(nm, 16)
    ldt = 3 * H + P
    rows = max(nm + ny, nm16)
    return _regions((0 if stream else Hc * ldt, 2),
                    (0 if stream else wu_rows * ldt, 2),
                    (_ring(stream, max(Hc, wu_rows)), 2),
                    (Hc * (nm16 + P) if heads else 0, 2),
                    (BT * (4 * H + P), 2),
                    (BT * (nm16 + P) if heads else 0, 2),
                    (rows * BT if heads else 0, 4), (BT // 16 * 4 * Hc, 4))


def _smem(kind, Hc, Hp, CHp, nmip, KXc, BT, nm, ny, nf, stream) -> int:
    """Dynamic shared memory of a CTA of the kind's kernel (the largest of
    its phases), as the CUDA sources lay it out."""
    nm8 = _ceil(nm, 8)
    KX = CHp + nmip
    if kind == "b7":
        return max(_up_bytes(Hc, 0, Hp, BT, 0, 0, 0, stream),
                   _dn_bytes(Hc, Hp, BT, 0, 0, stream))
    if kind in ("b1", "b4", "b9", "b10"):
        return max(_up_bytes(Hc, KX, Hp, BT, nf, nf, CHp // (Hp // Hc),
                             stream, xt=kind == "b4"),
                   _dn_bytes(Hc, Hp, BT, nm8, nm + ny * nm + ny, stream))
    if kind == "b3":
        return max(_up_bytes(Hc, KX, Hp, BT, 0, 0, 0, stream),
                   _dn_bytes(Hc, Hp, BT, nm8, nm, stream),
                   _bwd_bytes(Hc, Hp, BT, nm, ny, Hc, True, stream),
                   _bwd_bytes(Hc, Hp, BT, nm, ny, KXc, False, stream))
    return max(_up_bytes(Hc, 0, Hp, BT, 0, 0, 0, stream),
               _dn_bytes(Hc, Hp, BT, 0, 0, stream),
               _bwd_bytes(Hc, Hp, BT, 0, 0, Hc, False, stream),
               _bwd_bytes(Hc, Hp, BT, 0, 0, 0, False, stream))


def find_mma_plan(kind: str, H: int, CH: int, nm_in: int, nm: int, ny: int,
                  nf: int = 0) -> dict | None:
    """The tensor-core design's tiling for B1 (``kind`` "b1"), B3 ("b3"),
    B4 ("b4": CH is x's width, no initial MLP, the X tile channel-major),
    B7 and B8 ("b7", "b8": CH, nm_in, nm, ny unused), B9 ("b9": CH is x's
    width, nm_in 0, no initial MLP) or B10 ("b10"): the first (C, BT) of
    ``_MMA_CONFIGS`` whose CTA carries its state in one pass and fits in
    shared memory with its weight slices resident; else the first that
    fits with them streamed through the ring (``stream`` True). With it
    the padded widths (H to a multiple of 8 C; B1's stream is H wide,
    B10's CH padded to a multiple of 8 C, B9's to 16, B3's CH and nm_in to
    16; B4's CH kept and nm_in padded so that CH + nm_in is a multiple of
    16) and KXc, the rows of [W1h | W1m]^T each CTA owns in B3. Every kind
    takes every H up to ``MMA_H_MAX`` (832) at the flagship's other
    widths; beyond, where even 16-column tiles over clusters of 8 leave no
    room for the state and input tiles, it returns None (``gru_design``
    then selects the CUDA-core design)."""
    nmip = (0 if kind in ("b7", "b8", "b9") else
            _ceil(CH + nm_in, 16) - CH if kind == "b4" else _ceil(nm_in, 16))
    nw = _MMA_NTH // 32
    PF, MAXI = _MMA_PF * _MMA_NTH, _MMA_MAXI * _MMA_NTH
    for stream in (False, True):
        for C, BT in _MMA_CONFIGS:
            Hp = _ceil(H, 8 * C)
            CHp = {"b1": Hp, "b10": _ceil(CH, 8 * C), "b9": _ceil(CH, 16),
                   "b3": _ceil(CH, 16), "b4": CH, "b7": 0, "b8": 0}[kind]
            nwm = BT // 16
            Hc, nwn = Hp // C, nw // nwm
            KXc = _ceil(-(-(CHp + nmip) // C), 8)
            if nw % nwm or Hc // 8 > nwn * _MMA_MAXP or Hc // 8 * BT > MAXI:
                continue
            if kind in ("b1", "b10") and (nf + nmip) * BT > PF:
                continue
            if kind == "b3" and (max(nm + ny, _ceil(nm, 16)) * BT > PF
                                 or KXc // 8 * BT > MAXI):
                continue
            smem = _smem(kind, Hc, Hp, CHp, nmip, KXc, BT, nm, ny, nf,
                         stream)
            if smem <= _SMEM_MAX:
                return dict(C=C, BT=BT, H=Hp, CH=CHp, nm_in=nmip, KXc=KXc,
                            smem=smem, stream=stream)
    return None


def mma_plan(kind: str, H: int, CH: int, nm_in: int, nm: int, ny: int,
             nf: int = 0) -> dict:
    """``find_mma_plan`` for a caller that needs the tensor-core design
    itself: raises ``ValueError`` where no tiling fits. The wrappers ask
    ``gru_design``, which then runs the CUDA-core design."""
    plan = find_mma_plan(kind, H, CH, nm_in, nm, ny, nf)
    if plan is None:
        raise ValueError(f"{kind}: H {H}, CH {CH}, nm_in {nm_in}, nm {nm}, "
                         f"ny {ny}: no tiling of the bf16 tensor-core "
                         f"design fits a CTA's shared memory, even with its "
                         f"weights streamed; gru_design selects the "
                         f"CUDA-core design for these widths")
    return plan


# --------------------------------------------------------------------------
# f32 cluster design of B7 and B8 (csrc/bigru_f32.cuh): FFMA on the CUDA
# cores, weight slices resident, the state in registers. The constants
# mirror the CUDA source.
# --------------------------------------------------------------------------

_F32_NTH = 256          # threads of a CTA at most (bf32::NTH_MAX)
# cluster sizes C and column tiles BT, in order of preference
_F32_CS, _F32_BTS = (4, 8), (64, 32)


def _f32_sweep_smem(Hp: int, C: int, BT: int) -> int:
    """Bytes of the sweeps' shared memory (``bf32::sweep_smem``): the up
    sweep's Whh slice [H][3Hc] and double-buffered state tile [2][H][BT],
    the down sweep's W2 and Whh slices, state tile and up_l tile [H][BT]."""
    w = Hp * 3 * (Hp // C)
    return 4 * max(w + 2 * Hp * BT, 2 * w + 3 * Hp * BT)


def _f32_bptt_smem(Hp: int, C: int, BT: int) -> int:
    """Bytes of B8's BPTT kernel (``bf32::bptt_smem``): two [3H][Hc]
    slices and the level's bundle tile [4H][BT]."""
    return 4 * (2 * 3 * Hp * (Hp // C) + 4 * Hp * BT)


def f32_plan(kind: str, H: int) -> dict | None:
    """The f32 cluster design's tiling for B7 (``kind`` "b7") or B8
    ("b8"): the first cluster size C of ``_F32_CS`` (H padded to a multiple
    of 8 C) at which the sweeps (and, for B8, the BPTT kernel) each have a
    column tile BT of ``_F32_BTS`` within a CTA's shared memory and
    ``_F32_NTH`` threads (Hc / 2 x BT / 4: a thread owns 2 hidden units x
    4 columns); each phase takes the widest. None where no C fits (from H
    200 on): ``gru_design`` then selects the CUDA-core design."""
    phases = [("sweep", _f32_sweep_smem)]
    if kind == "b8":
        phases.append(("bptt", _f32_bptt_smem))
    for C in _F32_CS:
        Hp = _ceil(H, 8 * C)
        plan = dict(C=C, H=Hp)
        for name, smem_of in phases:
            fit = next(((BT, smem_of(Hp, C, BT)) for BT in _F32_BTS
                        if Hp // C // 2 * (BT // 4) <= _F32_NTH
                        and smem_of(Hp, C, BT) <= _SMEM_MAX), None)
            if fit is None:
                break
            key = "" if name == "sweep" else "_bptt"
            plan.update({"BT" + key: fit[0], "smem" + key: fit[1]})
        else:
            return plan
    return None


# --------------------------------------------------------------------------
# The selector: which hand-written design a GRU wrapper launches, from the
# dtype and the widths alone
# --------------------------------------------------------------------------

GRU_KINDS = ("b1", "b3", "b4", "b7", "b8", "b9", "b10")
DESIGNS = ("tensor_core", "f32_cluster", "cudacore_smem", "cudacore_scratch")


def cudacore_rows(kind: str, H: int, CH: int = 0, nm_in: int = 0,
                  nm: int = 0, ny: int = 0, nf: int = 0) -> int:
    """The f32 rows of 32 columns a block of the kind's CUDA-core design
    keeps in its tiles (the launchers' shared-memory sizes in
    csrc/*.cu); the arguments as ``find_mma_plan``'s."""
    if kind == "b1":
        return 4 * H + nm_in + nf + nm
    if kind == "b3":
        return max(3 * H + max(CH + nm_in, H), 6 * H + 2 * nm + ny)
    if kind == "b4":
        return 3 * H + max(CH + nm_in, H) + nm
    if kind == "b7":
        return 4 * H
    if kind == "b8":
        return 5 * H
    if kind == "b9":
        return 3 * H + max(H, CH) + nm
    if kind == "b10":
        return 3 * H + max(H, CH + nm_in) + nf + nm
    raise ValueError(f"unknown GRU kernel kind {kind!r}")


def gru_design(kind: str, dtype, H: int, CH: int = 0, nm_in: int = 0,
               nm: int = 0, ny: int = 0, nf: int = 0,
               acc32: bool = True) -> dict:
    """The hand-written design that the kind's wrapper launches, from the
    dtype and the widths (the arguments as ``find_mma_plan``'s), never
    from a failed attempt:
      * bf16: the tensor-core design ("tensor_core") where
        ``find_mma_plan`` finds a tiling;
      * f32 B7 and B8: the cluster FFMA design ("f32_cluster") where
        ``f32_plan`` finds one;
      * otherwise the CUDA-core design, its 32-column tiles in shared
        memory ("cudacore_smem") where 4 x 32 x ``cudacore_rows`` bytes
        fit a block, else in a device scratch ("cudacore_scratch"), which
        takes any width.
    ``acc32=False`` with a bf16 input asks for the gates in bf16 (the TPU
    bodies' ``acc32=False``): every forward design above takes that mode
    as a template parameter of its gate step, so the choice of design is
    the same; the backward kinds B3 and B8 linearise the float32-gate
    forward in both modes and take no such mode. A float32 input's gates
    are float32 in both modes.
    Returns dict(design=..., plan=..., gates="f32" or "bf16") (plan None
    for the CUDA-core design)."""
    if kind not in GRU_KINDS:
        raise ValueError(f"unknown GRU kernel kind {kind!r}")
    gates = "f32" if acc32 or dtype == torch.float32 else "bf16"
    if gates == "bf16" and kind in ("b3", "b8"):
        raise ValueError(f"{kind} has no bf16-gate mode: the backward "
                         "linearises the float32-gate forward")
    plan = None
    if dtype == torch.bfloat16:
        plan = find_mma_plan(kind, H, CH, nm_in, nm, ny, nf)
        design = "tensor_core"
    elif kind in ("b7", "b8"):
        plan = f32_plan(kind, H)
        design = "f32_cluster"
    if plan is None:
        rows = cudacore_rows(kind, H, CH, nm_in, nm, ny, nf)
        design = ("cudacore_smem" if 4 * 32 * rows <= _SMEM_MAX
                  else "cudacore_scratch")
    return dict(design=design, plan=plan, gates=gates)


def _tile_scratch(kind: str, dims: tuple, B: int, dev) -> torch.Tensor | None:
    """The CUDA-core design's tile scratch [blocks, rows, 32] f32 where
    its tiles do not fit a block's shared memory (None where they do);
    ``dims`` = (H, CH, nm_in, nm, ny, nf) as ``cudacore_rows``."""
    rows = cudacore_rows(kind, *dims)
    if 4 * 32 * rows <= _SMEM_MAX:
        return None
    return torch.empty((-(-B // 32), rows, 32), dtype=torch.float32,
                       device=dev)


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _select(wrapper, kind: str, dtype, *widths, acc32: bool = True) -> dict:
    """``gru_design`` for a launch of ``wrapper``, recorded as
    ``wrapper.design`` (the name of the design its last launch ran, with
    ``+bf16_gates`` where its gates ran in bf16)."""
    d = gru_design(kind, dtype, *widths, acc32=acc32)
    wrapper.design = d["design"] + ("+bf16_gates" if d["gates"] == "bf16"
                                    else "")
    return d


def _pad(t: torch.Tensor, shape) -> torch.Tensor:
    """t zero-padded at the end of each dimension to ``shape`` (t itself
    when it already has that shape)."""
    if tuple(t.shape) == tuple(shape):
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _pad_gates(w: torch.Tensor, Hp: int, Kp: int | None = None):
    """A gate-stacked [3H, K] weight (or [3H, 1] bias) padded to [3Hp, Kp]
    per gate block."""
    H3, K = w.shape
    Kp = K if Kp is None else Kp
    return _pad(w.reshape(3, H3 // 3, K), (3, Hp, Kp)).reshape(3 * Hp, Kp)


def _unpad_gates(w: torch.Tensor, H: int, K: int) -> torch.Tensor:
    """The real [3H, K] block of a padded gate-stacked tensor."""
    return w.reshape(3, w.shape[0] // 3, w.shape[1])[:, :H, :K] \
        .reshape(3 * H, K).contiguous()


def pad_res(res, Hp: int, CHp: int, nmip: int) -> tuple:
    """The v5/backward arguments ``res`` (x, mem_in, h0_up, h0_dn, 13
    weights) zero-padded to hidden width Hp, stream width CHp and memory
    width nmip. Padded hidden units stay 0 through both sweeps and their
    weights and gradients are zero, so the real outputs do not change."""
    (x, mem_in, h0_up, h0_dn, win1h_t, win1m_t, bin1, whh_up_t, bhh_up,
     win2_t, bin2, whh_dn_t, bhh_dn, wlat_t, blat, wout_t, bout) = res
    L, _, B = mem_in.shape
    return (_pad(x, (L, CHp, x.shape[2])), _pad(mem_in, (L, nmip, B)),
            _pad(h0_up, (Hp, B)), _pad(h0_dn, (Hp, B)),
            _pad_gates(win1h_t, Hp, CHp), _pad_gates(win1m_t, Hp, nmip),
            _pad_gates(bin1, Hp), _pad_gates(whh_up_t, Hp, Hp),
            _pad_gates(bhh_up, Hp), _pad_gates(win2_t, Hp, Hp),
            _pad_gates(bin2, Hp), _pad_gates(whh_dn_t, Hp, Hp),
            _pad_gates(bhh_dn, Hp), _pad(wlat_t, (wlat_t.shape[0], Hp)),
            blat, wout_t, bout)


def pad_init_args(args, Hp: int, nmip: int) -> tuple:
    """The v6 forward's 19 arguments zero-padded as ``pad_res`` (the
    initial MLP's rows to Hp; feat keeps its width)."""
    feat, winit_t, binit = args[0], args[4], args[5]
    res = pad_res((feat.new_zeros((feat.shape[0], winit_t.shape[0], 0)),)
                  + tuple(args[1:4]) + tuple(args[6:]), Hp, Hp, nmip)
    return (feat, *res[1:4], _pad(winit_t, (Hp, winit_t.shape[1])),
            _pad(binit, (Hp, 1)), *res[4:])


def unpad_grads(grads, H: int, CH: int, nm_in: int) -> tuple:
    """``bigru_heads_cm_bwd``'s 17 outputs computed at padded widths, cut
    back to the real ones."""
    (dx, dmem, dh0u, dh0d, dw1h, dw1m, db1, dwhu, dbhu, dw2, db2, dwhd,
     dbhd, dwl, dbl, dwo, dbo) = grads
    g = _unpad_gates
    return (dx[:, :CH].contiguous(), dmem[:, :nm_in].contiguous(),
            dh0u[:H].contiguous(), dh0d[:H].contiguous(),
            g(dw1h, H, CH), g(dw1m, H, nm_in), g(db1, H, 1), g(dwhu, H, H),
            g(dbhu, H, 1), g(dw2, H, H), g(db2, H, 1), g(dwhd, H, H),
            g(dbhd, H, 1), dwl[:, :H].contiguous(), dbl, dwo, dbo)


def pack_rows(w: torch.Tensor, C: int) -> torch.Tensor:
    """A padded gate-stacked [3Hp, K] weight as C CTA slices [C, 3Hc, K]:
    slice r holds rows g Hp + r Hc + jj at g Hc + jj (the gate blocks of
    CTA r's hidden units)."""
    H3, K = w.shape
    Hc = H3 // 3 // C
    return w.reshape(3, C, Hc, K).transpose(0, 1).reshape(C, 3 * Hc, K) \
        .contiguous()


def unpack_rows(p: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_rows``."""
    C, H3c, K = p.shape
    return p.reshape(C, 3, H3c // 3, K).transpose(0, 1).reshape(C * H3c, K)


def pack_t(w: torch.Tensor, C: int, rows: int, width: int | None = None
           ) -> torch.Tensor:
    """The transpose of an [N, K] weight as C CTA slices [C, rows, width]:
    slice r holds w^T's rows [r rows, (r + 1) rows) (the inputs whose
    gradient CTA r computes), K zero-padded to C rows and N to width."""
    N, K = w.shape
    width = N if width is None else width
    return _pad(w.t(), (C * rows, width)).reshape(C, rows, width) \
        .contiguous()


def unpack_t(p: torch.Tensor, N: int, K: int) -> torch.Tensor:
    """Inverse of ``pack_t``: the [N, K] weight."""
    return p.reshape(-1, p.shape[2])[:K, :N].t()


def _table(ptrs):
    """A C array of the tensors' device pointers. The packed weights the
    kernels copy with cp.async are fresh allocations, so 16-byte aligned;
    the weight-gradient GEMMs check the rest before vector loads."""
    return (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])


def _launch_mma(args, dims, pl, g16=False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """B1 in bf16 on the tensor-core design with the plan ``pl`` (weights
    resident or streamed, as ``find_mma_plan`` chooses from the widths);
    ``g16``: the gates in bf16."""
    L, nf, nm_in, H, nm, ny, B = dims
    C, Hp = pl["C"], pl["H"]
    (feat, mem_in, h0_up, h0_dn, winit_t, binit, win1h_t, win1m_t, bin1,
     whh_up_t, bhh_up, win2_t, bin2, whh_dn_t, bhh_dn, wlat_t, blat, wout_t,
     bout) = pad_init_args(args, Hp, pl["nm_in"])
    dt, dev = feat.dtype, feat.device
    outmem = torch.empty((L, nm + ny, B), dtype=dt, device=dev)
    lasth = torch.empty((Hp, B), dtype=dt, device=dev)
    up = torch.empty((L, Hp, B), dtype=dt, device=dev)   # up-stream scratch
    wlat8 = _pad(wlat_t, (_ceil(nm, 8), Hp)).contiguous()
    ptrs = [feat, mem_in, h0_up, h0_dn, winit_t.contiguous(), _flat(binit),
            pack_rows(torch.cat([win1h_t, win1m_t], 1), C), _flat(bin1),
            pack_rows(whh_up_t, C), _flat(bhh_up), pack_rows(win2_t, C),
            _flat(bin2), pack_rows(whh_dn_t, C), _flat(bhh_dn), wlat8,
            _flat(blat), wout_t.contiguous(), _flat(bout), outmem, lasth, up]
    fn = _build.load("bigru_heads_init_cm").bigru_heads_init_cm_mma
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(_table(ptrs), L, nf, pl["nm_in"], Hp, nm, ny, B, C, pl["BT"],
            int(pl["stream"]), int(g16), stream)
    _build.check_status(rc, "bigru_heads_init_cm_mma")
    fused_bigru_heads_init_cm.launches += 1
    return outmem, (lasth if Hp == H else lasth[:H].contiguous())


def _launch_bwd_mma(res, d_outmem, d_lasth, dims, pl
                    ) -> tuple[torch.Tensor, ...]:
    """B3 in bf16 on the tensor-core design with the plan ``pl``."""
    L, CH, nm_in, H, nm, ny, B = dims
    C, BT, Hp, CHp, nmip, KXc = (pl[k] for k in
                                 ("C", "BT", "H", "CH", "nm_in", "KXc"))
    (x, mem_in, h0_up, h0_dn, win1h_t, win1m_t, bin1, whh_up_t, bhh_up,
     win2_t, bin2, whh_dn_t, bhh_dn, wlat_t, blat, wout_t,
     bout) = pad_res(res, Hp, CHp, nmip)
    dt, dev = x.dtype, x.device
    new = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    f32 = torch.float32
    tiles = -(-B // BT)
    w1 = torch.cat([win1h_t, win1m_t], 1)
    weights = [pack_rows(w1, C), _flat(bin1), pack_rows(whh_up_t, C),
               _flat(bhh_up), pack_rows(win2_t, C), _flat(bin2),
               pack_rows(whh_dn_t, C), _flat(bhh_dn),
               _pad(wlat_t, (_ceil(nm, 8), Hp)).contiguous(), _flat(blat),
               pack_t(whh_dn_t, C, Hp // C), pack_t(win2_t, C, Hp // C),
               pack_t(wlat_t, C, Hp // C, _ceil(nm, 16)),
               wout_t.contiguous(), pack_t(whh_up_t, C, Hp // C),
               pack_t(w1, C, KXc)]
    outs = [new(L, CHp, B), new(L, nmip, B), new(Hp, B), new(Hp, B)]
    # scratch the TPU kernel kept in VMEM: h and the gates of both sweeps
    # (the gates overwritten in place by the rounded gradient bundles the
    # weight gradients read), the latent head and dt(dmem_tot) (bf16);
    # d_up (f32); the tiles' bias partials and the weight-gradient GEMMs'
    # per-split partials of the largest weight (f32)
    largest = max(3 * Hp * max(CHp, Hp, nmip), nm * Hp, ny * nm)
    scratch = [new(L, Hp, B), new(L, Hp, B), new(L, 4 * Hp, B),
               new(L, 4 * Hp, B), new(L, nm, B), new(L, nm, B),
               new(L, Hp, B, dtype=f32),
               new(tiles, 8 * Hp + nm + ny, dtype=f32),
               new(_SPLITS * largest, dtype=f32)]
    grads = [new(3 * Hp, CHp), new(3 * Hp, nmip), new(3 * Hp),
             new(3 * Hp, Hp), new(3 * Hp), new(3 * Hp, Hp), new(3 * Hp),
             new(3 * Hp, Hp), new(3 * Hp), new(nm, Hp), new(nm), new(ny, nm),
             new(ny)]
    # the pointer order of csrc/bigru_heads_cm_bwd.cu's bigru_heads_cm_bwd_mma
    ptrs = [x, mem_in, h0_up, h0_dn, d_outmem, _pad(d_lasth, (Hp, B)),
            *weights, *outs, *scratch, *grads]
    fn = _build.load("bigru_heads_cm_bwd").bigru_heads_cm_bwd_mma
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 12 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(len(ptrs), _table(ptrs), L, CHp, nmip, Hp, nm, ny, B, C, BT, KXc,
            _SPLITS, int(pl["stream"]), stream)
    _build.check_status(rc, "bigru_heads_cm_bwd_mma")
    bigru_heads_cm_bwd.launches += 1
    grads = [g if g.dim() == 2 else g[:, None] for g in grads]
    return unpad_grads(outs + grads, H, CH, nm_in)


def cudacore_bigru_heads_init_cm(*args) -> tuple[torch.Tensor, ...]:
    """B1's CUDA-core design in bf16, which no wrapper selects where the
    tensor-core design has a plan: for timing it against that design on
    the card. Counts no launch."""
    return _launch(args, _validate(args), cudacore_bf16=True)


def cudacore_bigru_heads_cm_bwd(res, d_outmem, d_lasth
                                ) -> tuple[torch.Tensor, ...]:
    """B3's CUDA-core design in bf16, as ``cudacore_bigru_heads_init_cm``."""
    return _launch_bwd(res, d_outmem, d_lasth,
                       _validate_cm(res, (d_outmem, d_lasth)),
                       cudacore_bf16=True)


def bigru_heads_cm_bwd(res, d_outmem, d_lasth):
    """Channel-major BiGRU + heads backward (JAX's
    ``_bigru_heads_cm_bwd_pallas``): ``res`` = (x [L, CH, B], mem_in,
    h0_up, h0_dn, win1h_t, win1m_t, bin1, whh_up_t, bhh_up, win2_t, bin2,
    whh_dn_t, bhh_dn, wlat_t, blat, wout_t, bout), the cotangents of
    (outmem, lasth) -> (dx, dmem, dh0u, dh0d, 13 weight/bias gradients in
    the weights' type). A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel or raises."""
    dims = _validate_cm(res, (d_outmem, d_lasth))
    dev = res[0].device
    if dev.type == "cpu":
        return bigru_heads_cm_bwd_reference(res, d_outmem, d_lasth)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    L, CH, nm_in, H, nm, ny, B = dims
    d = _select(bigru_heads_cm_bwd, "b3", res[0].dtype, H, CH, nm_in, nm, ny)
    if d["design"] == "tensor_core":
        return _launch_bwd_mma(res, d_outmem, d_lasth, dims, d["plan"])
    return _launch_bwd(res, d_outmem, d_lasth, dims)


@torch.library.custom_op("climsim::fused_bigru_heads_init_cm",
                         mutates_args=(), device_types="cpu")
def _b1_op(acc32: bool, args: list[torch.Tensor]
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """B1 as a custom op, its gate mode in the schema: on the CPU its plain
    version."""
    _validate(args)
    return fresh(bigru_heads_init_cm_reference(*args, acc32=acc32), args)


@_b1_op.register_kernel("cuda")
def _b1_cuda(acc32, args):
    dims = _validate(args)
    L, nf, nm_in, H, nm, ny, B = dims
    d = _select(fused_bigru_heads_init_cm, "b1", args[0].dtype, H, H,
                nm_in, nm, ny, nf, acc32=acc32)
    g16 = d["gates"] == "bf16"
    if d["design"] == "tensor_core":
        return _launch_mma(args, dims, d["plan"], g16)
    return _launch(args, dims, g16=g16)


@_b1_op.register_fake
def _b1_fake(acc32, args):
    L, nf, nm_in, H, nm, ny, B = _validate(args)
    return args[0].new_empty((L, nm + ny, B)), args[0].new_empty((H, B))


class _FusedHeadsInitCM(torch.autograd.Function):
    """Forward: the op ``climsim::fused_bigru_heads_init_cm`` (the B1
    kernel, or its plain version on the CPU), saving only the inputs, as
    JAX's residuals are. Backward: the initial-MLP recompute,
    ``bigru_heads_cm_bwd``, and the initial MLP's VJP, which JAX leaves to
    XLA einsums outside the kernel. The backward linearises the
    float32-gate forward whatever ``acc32`` the forward ran, as JAX's
    does."""

    @staticmethod
    def forward(ctx, acc32, *args):
        ctx.save_for_backward(*args)
        return torch.ops.climsim.fused_bigru_heads_init_cm(acc32, list(args))

    @staticmethod
    def backward(ctx, d_outmem, d_lasth):
        args = ctx.saved_tensors
        feat, mem_in, h0_up, h0_dn, winit_t, binit = args[:6]
        dt, f32 = feat.dtype, torch.float32
        pre = (torch.einsum("hf,lfb->lhb", winit_t.float(), feat.float())
               + binit.float()).to(dt)
        xi = torch.tanh(pre.float()).to(dt).contiguous()
        dxi, dmem, dh0u, dh0d, *wgrads = bigru_heads_cm_bwd(
            (xi, mem_in, h0_up, h0_dn) + tuple(args[6:]),
            d_outmem.to(dt).contiguous(), d_lasth.to(dt).contiguous())
        dpre = dxi.to(f32) * (1.0 - xi.to(f32) ** 2)
        dfeat = torch.einsum("hf,lhb->lfb", winit_t.float(),
                             dpre).to(feat.dtype)
        dwinit = torch.einsum("lhb,lfb->hf", dpre,
                              feat.float()).to(winit_t.dtype)
        dbinit = dpre.sum(dim=(0, 2))[:, None].to(binit.dtype)
        return (None, dfeat, dmem, dh0u, dh0d, dwinit, dbinit, *wgrads)


def fused_bigru_heads_init_cm(feat, mem_in, h0_up, h0_dn, winit_t, binit,
                              win1h_t, win1m_t, bin1, whh_up_t, bhh_up,
                              win2_t, bin2, whh_dn_t, bhh_dn, wlat_t, blat,
                              wout_t, bout, acc32=True):
    """v6 channel-major fused initial-MLP + BiGRU + heads, differentiable
    in all 19 arguments. A CPU tensor runs the plain versions; a CUDA
    tensor launches the forward kernel (and, for gradients, the backward
    kernel) or raises. ``acc32=False`` runs a bf16 input's gates in bf16
    (JAX's ``acc32``); the gradients are the float32-gate forward's."""
    return _FusedHeadsInitCM.apply(bool(acc32), feat, mem_in, h0_up, h0_dn,
                                   winit_t, binit, win1h_t, win1m_t, bin1,
                                   whh_up_t, bhh_up, win2_t, bin2, whh_dn_t,
                                   bhh_dn, wlat_t, blat, wout_t, bout)


fused_bigru_heads_init_cm.launches = 0
bigru_heads_cm_bwd.launches = 0
fused_bigru_heads_init_cm.design = bigru_heads_cm_bwd.design = None


# --------------------------------------------------------------------------
# v5 channel-major forward (B4, csrc/bigru_heads_cm.cu): the initial-MLP
# stream x [L, CH, B] and the memory in, JAX's ``fused_bigru_heads_cm``;
# its backward is B3 on the forward's own arguments
# --------------------------------------------------------------------------


def _launch_cm(args, dims, hoist_proj, cudacore_bf16=False, g16=False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA-core design of B4 (f32, and bf16 past the tensor-core
    plan; ``g16``: the gates in bf16), its tiles in shared memory or a
    device scratch, as ``_launch``;
    with ``cudacore_bf16`` the timing twin
    (``cudacore_fused_bigru_heads_cm``), which counts no launch."""
    (x, mem_in, h0_up, h0_dn, win1h_t, win1m_t, bin1, whh_up_t, bhh_up,
     win2_t, bin2, whh_dn_t, bhh_dn, wlat_t, blat, wout_t, bout) = args
    L, CH, nm_in, H, nm, ny, B = dims
    dt, dev = x.dtype, x.device
    outmem = torch.empty((L, nm + ny, B), dtype=dt, device=dev)
    lasth = torch.empty((H, B), dtype=dt, device=dev)
    up = torch.empty((L, H, B), dtype=dt, device=dev)   # up-stream scratch
    tiles = _tile_scratch("b4", (H, CH, nm_in, nm), B, dev)
    ptrs = [x, mem_in, h0_up, h0_dn, _kmaj(win1h_t), _kmaj(win1m_t),
            _flat(bin1), _kmaj(whh_up_t), _flat(bhh_up), _kmaj(win2_t),
            _flat(bin2), _kmaj(whh_dn_t), _flat(bhh_dn), _kmaj(wlat_t),
            _flat(blat), _kmaj(wout_t), _flat(bout), outmem, lasth, up]
    lib = _build.load("bigru_heads_cm")
    head = [int(hoist_proj)]
    if cudacore_bf16:
        if g16:
            raise ValueError("the timing twin runs float32 gates only")
        fn = lib.bigru_heads_cm_cudacore
    else:
        fn = lib.bigru_heads_cm
        head = [_dtype_code(dt)] + head
    ints = [L, CH, nm_in, H, nm, ny, B] + [int(g16)] * (not cudacore_bf16)
    fn.argtypes = [ctypes.c_int] * len(head) + [ctypes.c_void_p] * 20 \
        + [ctypes.c_int] * len(ints) + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(*head, *[t.data_ptr() for t in ptrs], *ints, _ptr(tiles), stream)
    _build.check_status(rc, "bigru_heads_cm")
    if not cudacore_bf16:
        fused_bigru_heads_cm.launches += 1
    return outmem, lasth


def pad_cm_args(args, Hp: int, nmip: int) -> tuple:
    """B4's 17 arguments zero-padded for its tensor-core design: hidden
    width Hp (per gate block) and memory width nmip, so that x's CH rows
    and the memory's nmip stack into whole 16-row k-steps. x keeps its
    width (the kernel reads its rows where they lie), so only the small
    tensors are copied. A padded memory row meets zero weight columns;
    padded hidden units stay 0 through both sweeps and meet zero head
    weights: the outputs do not change."""
    return pad_res(args, Hp, args[0].shape[1], nmip)


def _launch_cm_mma(args, dims, hoist_proj, pl, g16=False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """B4 in bf16 on the tensor-core design with the plan ``pl``
    (bigru_mma_fwd.cuh's channel-major instance with a loaded X tile;
    weights resident or streamed, as ``find_mma_plan`` chooses from the
    widths); ``g16``: the gates in bf16."""
    L, CH, nm_in, H, nm, ny, B = dims
    C, Hp, nmip = pl["C"], pl["H"], pl["nm_in"]
    (x, mem_in, h0_up, h0_dn, win1h_t, win1m_t, bin1, whh_up_t, bhh_up,
     win2_t, bin2, whh_dn_t, bhh_dn, wlat_t, blat, wout_t,
     bout) = pad_cm_args(args, Hp, nmip)
    dt, dev = x.dtype, x.device
    outmem = torch.empty((L, nm + ny, B), dtype=dt, device=dev)
    lasth = torch.empty((Hp, B), dtype=dt, device=dev)
    up = torch.empty((L, Hp, B), dtype=dt, device=dev)   # up-stream scratch
    ptrs = [x, mem_in, h0_up, h0_dn,
            pack_rows(torch.cat([win1h_t, win1m_t], 1), C), _flat(bin1),
            pack_rows(whh_up_t, C), _flat(bhh_up), pack_rows(win2_t, C),
            _flat(bin2), pack_rows(whh_dn_t, C), _flat(bhh_dn),
            _pad(wlat_t, (_ceil(nm, 8), Hp)).contiguous(), _flat(blat),
            wout_t.contiguous(), _flat(bout), outmem, lasth, up]
    fn = _build.load("bigru_heads_cm").bigru_heads_cm_mma
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(_table(ptrs), L, CH, nmip, Hp, nm, ny, B, C, pl["BT"],
            int(pl["stream"]), int(hoist_proj), int(g16), stream)
    _build.check_status(rc, "bigru_heads_cm_mma")
    fused_bigru_heads_cm.launches += 1
    return outmem, (lasth if Hp == H else lasth[:H].contiguous())


def cudacore_fused_bigru_heads_cm(*args, hoist_proj=True
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """B4's CUDA-core design in bf16, which no wrapper selects where the
    tensor-core design has a plan: for timing it against that design on
    the card. Counts no launch."""
    return _launch_cm(args, _validate_cm(args), hoist_proj,
                      cudacore_bf16=True)


@torch.library.custom_op("climsim::fused_bigru_heads_cm", mutates_args=(),
                         device_types="cpu")
def _b4_op(hoist_proj: bool, acc32: bool, args: list[torch.Tensor]
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """B4 as a custom op, its gate mode in the schema: on the CPU its plain
    version."""
    _validate_cm(args)
    return fresh(bigru_heads_cm_reference(*args, hoist_proj=hoist_proj,
                                          acc32=acc32), args)


@_b4_op.register_kernel("cuda")
def _b4_cuda(hoist_proj, acc32, args):
    dims = _validate_cm(args)
    L, CH, nm_in, H, nm, ny, B = dims
    d = _select(fused_bigru_heads_cm, "b4", args[0].dtype, H, CH, nm_in, nm,
                ny, acc32=acc32)
    g16 = d["gates"] == "bf16"
    if d["design"] == "tensor_core":
        return _launch_cm_mma(args, dims, hoist_proj, d["plan"], g16)
    return _launch_cm(args, dims, hoist_proj, g16=g16)


@_b4_op.register_fake
def _b4_fake(hoist_proj, acc32, args):
    L, CH, nm_in, H, nm, ny, B = _validate_cm(args)
    return args[0].new_empty((L, nm + ny, B)), args[0].new_empty((H, B))


class _FusedHeadsCM(torch.autograd.Function):
    """Forward: the op ``climsim::fused_bigru_heads_cm`` (the B4 kernel in
    the design ``gru_design`` selects; its plain version on the CPU),
    saving only the inputs.
    Backward, as JAX's ``_heads_cm_bwd``: with memory
    (nm_in > 0) ``bigru_heads_cm_bwd`` on the forward's arguments (kernel
    B3 on the card, which replays the sweeps with float32 projections
    whatever the forward rounded); without, autograd of the plain
    version. Both linearise the float32-gate forward whatever ``acc32``
    the forward ran, as JAX's do."""

    @staticmethod
    def forward(ctx, hoist_proj, acc32, *args):
        ctx.save_for_backward(*args)
        ctx.hoist_proj = hoist_proj
        return torch.ops.climsim.fused_bigru_heads_cm(hoist_proj, acc32,
                                                      list(args))

    @staticmethod
    def backward(ctx, d_outmem, d_lasth):
        args = ctx.saved_tensors
        dt = args[0].dtype
        if args[1].shape[1] > 0:
            grads = bigru_heads_cm_bwd(args, d_outmem.to(dt).contiguous(),
                                       d_lasth.to(dt).contiguous())
        else:
            with torch.enable_grad():
                a = [t.detach().requires_grad_(True) for t in args]
                out = bigru_heads_cm_reference(*a,
                                               hoist_proj=ctx.hoist_proj)
                grads = torch.autograd.grad(out, a, (d_outmem, d_lasth),
                                            allow_unused=True)
        return (None, None, *grads)


def fused_bigru_heads_cm(x, mem_in, h0_up, h0_dn, win1h_t, win1m_t, bin1,
                         whh_up_t, bhh_up, win2_t, bin2, whh_dn_t, bhh_dn,
                         wlat_t, blat, wout_t, bout, hoist_proj=True,
                         acc32=True):
    """v5 channel-major fused BiGRU + heads with the split up projection:
    x [L, CH, B] (the initial-MLP stream), mem_in [L, nm_in, B] (nm_in may
    be 0), h0_up/h0_dn [H, B], weights [out, in], biases [ch, 1] ->
    (outmem [L, nm+ny, B] = mem || out, lasth [H, B]); differentiable in
    all 17. ``hoist_proj`` picks the TPU body whose roundings the kernel
    reproduces (see ``bigru_heads_cm_reference``). A CPU tensor runs the
    plain versions; a CUDA tensor launches kernel B4 (the design
    ``gru_design`` selects) and, for gradients, B3, or raises.
    ``acc32=False`` runs a bf16 input's gates in bf16; the gradients are
    the float32-gate forward's."""
    return _FusedHeadsCM.apply(bool(hoist_proj), bool(acc32), x, mem_in,
                               h0_up, h0_dn, win1h_t, win1m_t, bin1,
                               whh_up_t, bhh_up, win2_t, bin2, whh_dn_t,
                               bhh_dn, wlat_t, blat, wout_t, bout)


fused_bigru_heads_cm.launches = 0
fused_bigru_heads_cm.design = None


# --------------------------------------------------------------------------
# v2 level-major fused BiGRU forward (B7, csrc/bigru_lbh.cu) and backward
# (B8, csrc/bigru_lbh_bwd.cu): the trunk of the physics-constrained
# emulator, JAX's ``fused_bigru_lbh``
# --------------------------------------------------------------------------

_ARGS_LBH = ("xp", "h0_up", "h0_dn", "whh_up", "bhh_up", "win2", "bin2",
             "whh_dn", "bhh_dn")


def _gru_step_gates_lbh(h, xp, whh, bhh, H: int):
    """One GRU update, batch-major (JAX's ``_gru_step`` and, with the gate
    bundle, ``_gru_fwd_store``): h [B, H] float32, xp [B, 3H] float32 with
    the input bias included -> (new h, [r, z, n, hn] [B, 4H]), float32. The
    recurrent product takes h rounded to the weight type and adds the
    recurrent bias before the gates."""
    hh = torch.matmul(h.to(whh.dtype).float(), whh.float()) + bhh.float()
    xr, xz, xn = xp.split(H, dim=-1)
    hr, hz, hn = hh.split(H, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h, torch.cat([r, z, n, hn], dim=-1)


def _gru_step_lbh(h, xp, whh, bhh, H: int):
    """``_gru_step_gates_lbh`` without the gates: the new h, in the state's
    type (float32, or bf16 gates as ``_gru_step_cm``)."""
    if h.dtype == torch.float32:
        return _gru_step_gates_lbh(h, xp.float(), whh, bhh, H)[0]
    hh = (torch.matmul(h.float(), whh.float()) + bhh.float()).to(h.dtype)
    return _gates_typed(xp.to(h.dtype), hh, h, H, -1)


def _gru_bwd_step_lbh(dh, gates, h_prev, whh, H: int):
    """One batch-major GRU backward step (JAX's ``_gru_bwd_step``): dh and
    h_prev [B, H] float32, gates [B, 4H] as stored -> (d_xp [B, 3H],
    dh_prev [B, H], d_hh [B, 3H]), float32; dh_prev = dh z + dt(d_hh)
    Whh^T with dt the weight type."""
    r, z, n, hn = gates.float().split(H, dim=-1)
    dz = dh * (h_prev - n)
    dan = dh * (1.0 - z) * (1.0 - n * n)
    dar = dan * hn * r * (1.0 - r)
    daz = dz * z * (1.0 - z)
    dhn = dan * r
    d_hh = torch.cat([dar, daz, dhn], dim=-1)
    d_xp = torch.cat([dar, daz, dan], dim=-1)
    dh_prev = dh * z + torch.matmul(d_hh.to(whh.dtype).float(),
                                    whh.float().t())
    return d_xp, dh_prev, d_hh


def bigru_reference_lbh(xp, h0_up, h0_dn, whh_up, bhh_up, win2, bin2,
                        whh_dn, bhh_dn, acc32=True):
    """Plain version of B7 (JAX's ``_bigru_reference_lbh``, and with
    ``acc32=False`` the TPU body ``_bigru_kernel``'s bf16 gates): xp
    [L, B, 3H] -> (down [L, B, H], last_h [B, H]) in xp's type. The
    carries are float32; the up states are stored in xp's type and the
    down sweep's input projection reads them rounded, in float32 without
    rounding its result. With ``acc32=False`` the carries and the gates
    are in xp's type and the down projection is rounded to it; with a
    float32 xp that is the float32 computation."""
    dt = xp.dtype
    acc = torch.float32 if acc32 else dt
    L, H = xp.shape[0], h0_up.shape[-1]
    h = h0_up.to(acc)
    up = [None] * L
    for l in range(L - 1, -1, -1):
        h = _gru_step_lbh(h, xp[l], whh_up, bhh_up, H)
        up[l] = h.to(dt)
    h2 = h0_dn.to(acc)
    down = []
    for l in range(L):
        xp2 = (torch.matmul(up[l].to(win2.dtype).float(), win2.float())
               + bin2.float()).to(acc)
        h2 = _gru_step_lbh(h2, xp2, whh_dn, bhh_dn, H)
        down.append(h2.to(dt))
    return torch.stack(down), h2.to(dt)


def _validate_lbh(args) -> tuple[int, int, int]:
    """Check the v2 arguments on every device; returns (L, B, H)."""
    named = dict(zip(_ARGS_LBH, args))
    L, B, H3 = named["xp"].shape
    H = H3 // 3
    w, b = (H, 3 * H), (3 * H,)
    shapes = {"xp": (L, B, 3 * H), "h0_up": (B, H), "h0_dn": (B, H),
              "whh_up": w, "bhh_up": b, "win2": w, "bin2": b, "whh_dn": w,
              "bhh_dn": b}
    _check(named, shapes, ("xp", "h0_up", "h0_dn"))
    return L, B, H


def _launch_lbh(args, dims, twin=False, g16=False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA-core design of B7 (f32 or bf16; ``g16``: the gates in
    bf16), its tiles in shared memory or, past H 448, in a device scratch;
    with ``twin`` the timing twin (``cudacore_fused_bigru_lbh``), which
    counts no launch."""
    xp = args[0]
    L, B, H = dims
    dt, dev = xp.dtype, xp.device
    down = torch.empty((L, B, H), dtype=dt, device=dev)
    lasth = torch.empty((B, H), dtype=dt, device=dev)
    # weights are [in, out] (flax's layout), the k-major order the kernel
    # reads; biases flat
    ptrs = [a.contiguous() for a in args] + [down, lasth]
    tiles = _tile_scratch("b7", (H,), B, dev)
    lib = _build.load("bigru_lbh")
    fn = lib.bigru_lbh
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(_dtype_code(dt), *[t.data_ptr() for t in ptrs],
            L, H, B, int(g16), _ptr(tiles), stream)
    _build.check_status(rc, "bigru_lbh")
    if not twin:
        fused_bigru_lbh.launches += 1
    return down, lasth


def bigru_bwd_reference_lbh(res, d_down, d_lasth):
    """Plain version of kernel B8 (JAX's ``_bigru_bwd_kernel``), phase by
    phase and level by level as the TPU body: (A) replay both sweeps,
    storing h and the gate bundle [r, z, n, hn] in xp's type, the down
    sweep's projection reading the up states rounded and staying float32;
    (B1) the down-sweep BPTT from d_lasth, adding d_down[l] before each
    step, giving d_up in float32; (B2) the up-sweep BPTT from a zero carry,
    giving d_xp in xp's type. Weight gradients are float32 sums of products
    whose factors are rounded to the weight type, bias gradients the sums
    of the unrounded bundles, each cast to its weight's type at the end.

    ``res`` = (xp [L, B, 3H], h0_up, h0_dn [B, H], whh_up, bhh_up, win2,
    bin2, whh_dn, bhh_dn); d_down [L, B, H], d_lasth [B, H]. Returns
    (d_xp, dh0_up, dh0_dn, dwhh_up, dbhh_up, dwin2, dbin2, dwhh_dn,
    dbhh_dn), the order of JAX's ``_bigru_bwd_pallas_lbh``."""
    xp, h0_up, h0_dn, whh_up, bhh_up, win2, bin2, whh_dn, bhh_dn = res
    dt, wdt = xp.dtype, whh_up.dtype
    L, H = xp.shape[0], h0_up.shape[-1]
    # ---- phase A: replay the up sweep (surface to top), then the down
    up_h, gates_u = [None] * L, [None] * L
    h = h0_up.float()
    for l in range(L - 1, -1, -1):
        h, g = _gru_step_gates_lbh(h, xp[l].float(), whh_up, bhh_up, H)
        up_h[l], gates_u[l] = h.to(dt), g.to(dt)
    g_h, gates_d = [None] * L, [None] * L
    h2 = h0_dn.float()
    for l in range(L):
        xp2 = torch.matmul(up_h[l].float(), win2.float()) + bin2.float()
        h2, g = _gru_step_gates_lbh(h2, xp2, whh_dn, bhh_dn, H)
        g_h[l], gates_d[l] = h2.to(dt), g.to(dt)

    def outer(a, b):        # a [B, M], b [B, N] -> [M, N], factors in wdt
        return torch.matmul(a.to(wdt).float().t(), b.to(wdt).float())

    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=xp.device)
    dwhh_up, dbhh_up, dwin2, dbin2, dwhh_dn, dbhh_dn = map(
        zeros, (whh_up, bhh_up, win2, bin2, whh_dn, bhh_dn))
    # ---- phase B1: down-sweep BPTT (surface to top)
    dup = [None] * L
    dg = d_lasth.float()
    for l in range(L - 1, -1, -1):
        dg = dg + d_down[l].float()
        g_prev = (h0_dn if l == 0 else g_h[l - 1]).float()
        dxp2, dg, d_hh = _gru_bwd_step_lbh(dg, gates_d[l], g_prev, whh_dn,
                                           H)
        dup[l] = torch.matmul(dxp2.to(wdt).float(), win2.float().t())
        dwin2 += outer(up_h[l], dxp2)
        dbin2 += dxp2.sum(0)
        dwhh_dn += outer(g_prev, d_hh)
        dbhh_dn += d_hh.sum(0)
    dh0_dn = dg.to(h0_dn.dtype)
    # ---- phase B2: up-sweep BPTT (top to surface); the up sweep's final
    # carry is not an output, so its gradient starts at zero
    d_xp = torch.empty_like(xp)
    du = torch.zeros_like(dg)
    for l in range(L):
        du = du + dup[l]
        h_prev = (h0_up if l == L - 1 else up_h[l + 1]).float()
        dxl, du, d_hh = _gru_bwd_step_lbh(du, gates_u[l], h_prev, whh_up, H)
        d_xp[l] = dxl.to(dt)
        dwhh_up += outer(h_prev, d_hh)
        dbhh_up += d_hh.sum(0)
    dh0_up = du.to(h0_up.dtype)
    return (d_xp, dh0_up, dh0_dn) + tuple(
        g.to(p.dtype) for g, p in ((dwhh_up, whh_up), (dbhh_up, bhh_up),
                                   (dwin2, win2), (dbin2, bin2),
                                   (dwhh_dn, whh_dn), (dbhh_dn, bhh_dn)))


def _validate_bwd_lbh(res, d_down, d_lasth) -> tuple[int, int, int]:
    """The backward's counterpart of ``_validate_lbh``: the residuals as the
    forward's arguments, and the cotangents d_down [L, B, H] and d_lasth
    [B, H] of the same type, contiguous; returns (L, B, H)."""
    L, B, H = _validate_lbh(res)
    _check({"xp": res[0], "d_down": d_down, "d_lasth": d_lasth},
           {"xp": (L, B, 3 * H), "d_down": (L, B, H), "d_lasth": (B, H)},
           ("d_down", "d_lasth"))
    return L, B, H


# column splits of B8's weight-gradient reductions
_SPLITS_LBH = 64


def _launch_bwd_lbh(res, d_down, d_lasth, dims, twin=False
                    ) -> tuple[torch.Tensor, ...]:
    """The CUDA-core design of B8 (f32 or bf16), its tiles in shared memory
    or, past H 360, in a device scratch; with ``twin`` the timing twin
    (``cudacore_bigru_bwd_lbh``), which counts no launch."""
    xp, h0_up, h0_dn, whh_up, bhh_up, win2, bin2, whh_dn, bhh_dn = res
    L, B, H = dims
    dt, dev = xp.dtype, xp.device
    new = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    f32 = torch.float32
    outs = [new(L, B, 3 * H), new(B, H), new(B, H)]
    grads = [new(*p.shape) for p in res[3:]]
    # scratch the TPU kernel kept in VMEM: h and the gate bundles of both
    # sweeps (xp's type) and d_up (f32); the per-level f32 gradient streams
    # the weight-gradient reductions read (d_hh of the up and the down
    # sweep, dxp2); the reductions' per-split partial sums. At L 50, B
    # 21,600, H 128 in f32 that is ~11 GB (csrc/bigru_lbh_bwd.cu).
    scratch = [new(L, B, H), new(L, B, H), new(L, B, 4 * H),
               new(L, B, 4 * H), new(L, B, H, dtype=f32),
               new(L, B, 3 * H, dtype=f32), new(L, B, 3 * H, dtype=f32),
               new(L, B, 3 * H, dtype=f32),
               new(_SPLITS_LBH * H * 3 * H, dtype=f32),
               _tile_scratch("b8", (H,), B, dev)]
    # the slot order of csrc/bigru_lbh_bwd.cu's enum Slot: k-major weights
    # ([in, out], flax's layout) for the replay, [out, in] copies for the
    # transposed products of the BPTT
    ptrs = [xp, h0_up, h0_dn, *(w.contiguous() for w in (whh_up, win2,
                                                         whh_dn)),
            *(w.t().contiguous() for w in (whh_up, win2, whh_dn)),
            *(b.contiguous() for b in (bhh_up, bin2, bhh_dn)),
            d_down, d_lasth, *outs, *grads, *scratch]
    table = (ctypes.c_void_p * len(ptrs))(*[_ptr(t) for t in ptrs])
    fn = _build.load("bigru_lbh_bwd").bigru_lbh_bwd
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(0 if dt == torch.float32 else 1, len(ptrs), table, L, H, B,
            _SPLITS_LBH, stream)
    _build.check_status(rc, "bigru_lbh_bwd")
    if not twin:
        bigru_bwd_lbh.launches += 1
    return tuple(outs) + tuple(grads)


def _pad_gates_last(t: torch.Tensor, Hp: int) -> torch.Tensor:
    """A tensor whose last dimension stacks three gate blocks [..., 3H]
    (the v2 layout: xp, the [in, out] weights' columns, the biases) padded
    to [..., 3Hp] per gate block."""
    H = t.shape[-1] // 3
    return _pad(t.reshape(*t.shape[:-1], 3, H),
                (*t.shape[:-1], 3, Hp)).reshape(*t.shape[:-1], 3 * Hp)


def _unpad_gates_last(t: torch.Tensor, H: int) -> torch.Tensor:
    """The real [..., 3H] blocks of a ``_pad_gates_last`` tensor."""
    Hp = t.shape[-1] // 3
    return t.reshape(*t.shape[:-1], 3, Hp)[..., :H] \
        .reshape(*t.shape[:-1], 3 * H).contiguous()


def pad_lbh_res(res, Hp: int) -> tuple:
    """B8's residuals (the v2 forward's nine arguments, batch-major, [in,
    out] weights) zero-padded to hidden width Hp per gate block. Padded
    hidden units have a zero projection, state and weights, so r = z =
    1/2, n = 0 and h stays 0 in both sweeps, and their gradients are zero:
    the real outputs do not change."""
    xp, h0_up, h0_dn, whh_up, bhh_up, win2, bin2, whh_dn, bhh_dn = res
    gl = lambda t: _pad_gates_last(t, Hp)
    w = lambda t: gl(_pad(t, (Hp, t.shape[1])))
    B = h0_up.shape[0]
    return (gl(xp), _pad(h0_up, (B, Hp)), _pad(h0_dn, (B, Hp)), w(whh_up),
            gl(bhh_up), w(win2), gl(bin2), w(whh_dn), gl(bhh_dn))


def unpad_lbh_grads(grads, H: int) -> tuple:
    """B8's nine outputs computed at a padded width, cut back to H."""
    d_xp, dh0u, dh0d, dwhu, dbhu, dw2, db2, dwhd, dbhd = grads
    gl = lambda t: _unpad_gates_last(t, H)
    w = lambda t: gl(t[:H])
    return (gl(d_xp), dh0u[:, :H].contiguous(), dh0d[:, :H].contiguous(),
            w(dwhu), gl(dbhu), w(dw2), gl(db2), w(dwhd), gl(dbhd))


def _launch_bwd_lbh_mma(res, d_down, d_lasth, dims, pl
                        ) -> tuple[torch.Tensor, ...]:
    """B8 in bf16 on the tensor-core design with the plan ``pl`` (weights
    resident or streamed, as ``find_mma_plan`` chooses from the width)."""
    L, B, H = dims
    C, BT, Hp = pl["C"], pl["BT"], pl["H"]
    Hc = Hp // C
    (xp, h0_up, h0_dn, whh_up, bhh_up, win2, bin2, whh_dn,
     bhh_dn) = pad_lbh_res(res, Hp)
    dt, dev = xp.dtype, xp.device
    new = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    f32 = torch.float32
    cm = lambda t: t.t().contiguous()           # [B, H] -> [H, B]
    # [in, out] weights: their transposes' gate slices for the replay, and
    # their input-row slices for the transposed products
    wt = [w.t() for w in (whh_up, win2, whh_dn)]
    weights = [pack_rows(wt[0], C), bhh_up.contiguous(), pack_rows(wt[1], C),
               bin2.contiguous(), pack_rows(wt[2], C), bhh_dn.contiguous(),
               pack_t(wt[2], C, Hc), pack_t(wt[1], C, Hc),
               pack_t(wt[0], C, Hc)]
    outs = [new(L, B, 3 * Hp), new(Hp, B), new(Hp, B)]
    # scratch the TPU kernel kept in VMEM: h and the gate bundles of both
    # sweeps (bf16; the gates overwritten by the rounded gradient bundles
    # the weight gradients read) and d_up (f32); the tiles' bias partials
    # and the weight-gradient GEMMs' per-split partials (f32)
    tiles = -(-B // BT)
    scratch = [new(L, Hp, B), new(L, Hp, B), new(L, 4 * Hp, B),
               new(L, 4 * Hp, B), new(L, Hp, B, dtype=f32),
               new(tiles, 8 * Hp, dtype=f32),
               new(_SPLITS * 3 * Hp * Hp, dtype=f32)]
    grads = [new(3 * Hp, Hp), new(3 * Hp), new(3 * Hp, Hp), new(3 * Hp),
             new(3 * Hp, Hp), new(3 * Hp)]
    # the pointer order of csrc/bigru_lbh_bwd.cu's bigru_lbh_bwd_mma
    ptrs = [xp, cm(h0_up), cm(h0_dn), _pad(d_down, (L, B, Hp)),
            _pad(cm(d_lasth), (Hp, B)), *weights, *outs, *scratch, *grads]
    fn = _build.load("bigru_lbh_bwd").bigru_lbh_bwd_mma
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(len(ptrs), _table(ptrs), L, Hp, B, C, BT, _SPLITS,
            int(pl["stream"]), stream)
    _build.check_status(rc, "bigru_lbh_bwd_mma")
    bigru_bwd_lbh.launches += 1
    d_xp, dh0u, dh0d = outs
    dwhu, dbhu, dw2, db2, dwhd, dbhd = grads
    return unpad_lbh_grads((d_xp, dh0u.t(), dh0d.t(), dwhu.t(), dbhu,
                            dw2.t(), db2, dwhd.t(), dbhd), H)


def _launch_lbh_mma(args, dims, pl, g16=False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """B7 in bf16 on the tensor-core design with the plan ``pl`` (B8's
    replay without the gate bundle; weights resident or streamed, as
    ``find_mma_plan`` chooses from the width; ``g16``: the gates in bf16).
    The kernel writes down and last_h batch-major and keeps the up states
    in ``down`` (no scratch)."""
    L, B, H = dims
    C, Hp = pl["C"], pl["H"]
    (xp, h0_up, h0_dn, whh_up, bhh_up, win2, bin2, whh_dn,
     bhh_dn) = pad_lbh_res(args, Hp)
    dt, dev = xp.dtype, xp.device
    down = torch.empty((L, B, Hp), dtype=dt, device=dev)
    lasth = torch.empty((B, Hp), dtype=dt, device=dev)
    cm = lambda t: t.t().contiguous()           # [B, H] -> [H, B]
    # [in, out] weights as the kernel's [out, in] gate slices
    ptrs = [xp, cm(h0_up), cm(h0_dn), pack_rows(whh_up.t(), C),
            bhh_up.contiguous(), pack_rows(win2.t(), C), bin2.contiguous(),
            pack_rows(whh_dn.t(), C), bhh_dn.contiguous(), down, lasth]
    fn = _build.load("bigru_lbh").bigru_lbh_mma
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(_table(ptrs), L, Hp, B, C, pl["BT"], int(pl["stream"]), int(g16),
            stream)
    _build.check_status(rc, "bigru_lbh_mma")
    fused_bigru_lbh.launches += 1
    if Hp == H:
        return down, lasth
    return down[..., :H].contiguous(), lasth[:, :H].contiguous()


def pack_k(w: torch.Tensor, C: int) -> torch.Tensor:
    """A k-major gate-stacked [K, 3Hp] weight ([in, out], the v2 layout) as
    C CTA slices [C, K, 3Hc]: slice r holds column g Hp + r Hc + jj at
    g Hc + jj (the gate columns of CTA r's hidden units), the f32 cluster
    design's resident layout."""
    K, H3 = w.shape
    Hc = H3 // 3 // C
    return w.reshape(K, 3, C, Hc).permute(2, 0, 1, 3).reshape(C, K, 3 * Hc) \
        .contiguous()


def pack_kt(w: torch.Tensor, C: int) -> torch.Tensor:
    """A k-major [Hp, 3Hp] weight's input rows as C CTA slices,
    transposed: [C, 3Hp, Hc], slice r = w[r Hc:(r + 1) Hc]^T (the rows
    whose gradient CTA r forms in the f32 BPTT)."""
    K, N = w.shape
    return w.reshape(C, K // C, N).transpose(1, 2).contiguous()


def _lbh_f32_inputs(res, Hp: int, C: int, B: int) -> tuple:
    """The v2 arguments as the f32 cluster kernels take them: padded to Hp
    (``pad_lbh_res``), the initial states channel-major [Hp, Bs] (Bs = B
    rounded up to 4, zero past B), the weights as ``pack_k`` slices."""
    (xp, h0_up, h0_dn, whh_up, bhh_up, win2, bin2, whh_dn,
     bhh_dn) = pad_lbh_res(res, Hp)
    Bs = _ceil(B, 4)
    cm = lambda t: _pad(t.t(), (Hp, Bs)).contiguous()
    sweeps = [xp, cm(h0_up), cm(h0_dn), pack_k(whh_up, C),
              bhh_up.contiguous(), pack_k(win2, C), bin2.contiguous(),
              pack_k(whh_dn, C), bhh_dn.contiguous()]
    return sweeps, (whh_up, win2, whh_dn), Bs, cm


def _launch_lbh_f32(args, dims, pl) -> tuple[torch.Tensor, torch.Tensor]:
    """B7 in f32 on the cluster FFMA design with the plan ``pl``
    (``f32_plan``): the up states go to a channel-major f32 scratch that
    the down sweep reads back."""
    L, B, H = dims
    C, Hp = pl["C"], pl["H"]
    sweeps, _, Bs, _ = _lbh_f32_inputs(args, Hp, C, B)
    dev = sweeps[0].device
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    down, lasth = new(L, B, Hp), new(B, Hp)
    ptrs = sweeps + [new(L, Hp, Bs), down, lasth]
    fn = _build.load("bigru_lbh").bigru_lbh_f32
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(_table(ptrs), L, Hp, B, Bs, C, pl["BT"], stream)
    _build.check_status(rc, "bigru_lbh_f32")
    fused_bigru_lbh.launches += 1
    if Hp == H:
        return down, lasth
    return down[..., :H].contiguous(), lasth[:, :H].contiguous()


def wgrad_splits(H: int, device) -> int:
    """Column splits of the f32 weight-gradient GEMM: two blocks a SM over
    its 3 jobs' 128 x 128 output tiles (fixed for a card and a width, so
    two calls add the same partials in the same order)."""
    tiles = 3 * -(-H // 128) * -(-3 * H // 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, 2 * sms // tiles)


def _launch_bwd_lbh_f32(res, d_down, d_lasth, dims, pl
                        ) -> tuple[torch.Tensor, ...]:
    """B8 in f32 on the cluster FFMA design with the plan ``pl``
    (``f32_plan``): the replay, the two BPTT sweeps (the gradient bundles
    overwrite the stored gates) and the weight-gradient GEMM over them."""
    L, B, H = dims
    C, Hp, BTb = pl["C"], pl["H"], pl["BT_bptt"]
    sweeps, (whh_up, win2, whh_dn), Bs, cm = _lbh_f32_inputs(res, Hp, C, B)
    dev = sweeps[0].device
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    S = wgrad_splits(Hp, dev)
    outs = [new(L, B, 3 * Hp), new(B, Hp), new(B, Hp)]
    # scratch: h of both sweeps, their gate bundles (overwritten by the
    # gradient bundles), d_up, the tiles' bias sums, the GEMM's splits
    scratch = [new(L, Hp, Bs), new(L, Hp, Bs), new(L, 4 * Hp, Bs),
               new(L, 4 * Hp, Bs), new(L, Hp, Bs), new(-(-B // BTb), 8 * Hp),
               new(S, 3, Hp, 3 * Hp)]
    # dwhh_up, dwin2, dwhh_dn [Hp, 3Hp] (k-major), then their biases
    grads = [new(Hp, 3 * Hp) for _ in range(3)] + [new(3 * Hp)
                                                  for _ in range(3)]
    # the pointer order of csrc/bigru_lbh_bwd.cu's bigru_lbh_bwd_f32
    ptrs = sweeps[:3] + [_pad(d_down, (L, B, Hp)), cm(d_lasth)] \
        + sweeps[3:] + [pack_kt(w, C) for w in (whh_dn, win2, whh_up)] \
        + outs + scratch + grads
    fn = _build.load("bigru_lbh_bwd").bigru_lbh_bwd_f32
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(len(ptrs), _table(ptrs), L, Hp, B, Bs, C, pl["BT"], BTb, S,
            stream)
    _build.check_status(rc, "bigru_lbh_bwd_f32")
    bigru_bwd_lbh.launches += 1
    dwhu, dw2, dwhd, dbhu, db2, dbhd = grads
    return unpad_lbh_grads((*outs, dwhu, dbhu, dw2, db2, dwhd, dbhd), H)


def cudacore_fused_bigru_lbh(*args) -> tuple[torch.Tensor, torch.Tensor]:
    """B7's CUDA-core design in bf16 or f32, which no wrapper selects at the
    widths the tensor-core (bf16) and cluster (f32) designs take: for
    timing it against them on the card. Counts no launch."""
    return _launch_lbh(args, _validate_lbh(args), twin=True)


def cudacore_bigru_bwd_lbh(res, d_down, d_lasth) -> tuple[torch.Tensor, ...]:
    """B8's CUDA-core design in bf16 or f32, as
    ``cudacore_fused_bigru_lbh``. Counts no launch."""
    return _launch_bwd_lbh(res, d_down, d_lasth,
                           _validate_bwd_lbh(res, d_down, d_lasth),
                           twin=True)


def bigru_bwd_lbh(res, d_down, d_lasth):
    """v2 BiGRU backward (JAX's ``_bigru_bwd_pallas_lbh``): ``res`` = the
    forward's nine arguments, the cotangents of (down, last_h) in xp's type
    -> (d_xp, dh0_up, dh0_dn, dwhh_up, dbhh_up, dwin2, dbin2, dwhh_dn,
    dbhh_dn). A CPU tensor runs the plain version; a CUDA tensor launches
    kernel B8 (the design ``gru_design`` selects: bf16 the tensor-core
    design, f32 the cluster FFMA design, each where its plan fits, else
    the CUDA-core one) or raises."""
    dims = _validate_bwd_lbh(res, d_down, d_lasth)
    dev = res[0].device
    if dev.type == "cpu":
        return bigru_bwd_reference_lbh(res, d_down, d_lasth)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    d = _select(bigru_bwd_lbh, "b8", res[0].dtype, dims[2])
    if d["design"] == "tensor_core":
        return _launch_bwd_lbh_mma(res, d_down, d_lasth, dims, d["plan"])
    if d["design"] == "f32_cluster":
        return _launch_bwd_lbh_f32(res, d_down, d_lasth, dims, d["plan"])
    return _launch_bwd_lbh(res, d_down, d_lasth, dims)


@torch.library.custom_op("climsim::fused_bigru_lbh", mutates_args=(),
                         device_types="cpu")
def _b7_op(acc32: bool, args: list[torch.Tensor]
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """B7 as a custom op, its gate mode in the schema: on the CPU its plain
    version."""
    _validate_lbh(args)
    return fresh(bigru_reference_lbh(*args, acc32=acc32), args)


@_b7_op.register_kernel("cuda")
def _b7_cuda(acc32, args):
    dims = _validate_lbh(args)
    d = _select(fused_bigru_lbh, "b7", args[0].dtype, dims[2], acc32=acc32)
    g16 = d["gates"] == "bf16"
    if d["design"] == "tensor_core":
        return _launch_lbh_mma(args, dims, d["plan"], g16)
    if d["design"] == "f32_cluster":
        return _launch_lbh_f32(args, dims, d["plan"])
    return _launch_lbh(args, dims, g16=g16)


@_b7_op.register_fake
def _b7_fake(acc32, args):
    L, B, H = _validate_lbh(args)
    return args[0].new_empty((L, B, H)), args[0].new_empty((B, H))


class _FusedBiGRULBH(torch.autograd.Function):
    """Forward: the op ``climsim::fused_bigru_lbh`` (B7 in the design
    ``gru_design`` selects; the plain version on the CPU), saving the
    inputs, as JAX's residuals are. Backward: ``bigru_bwd_lbh``, kernel B8
    on the card and its plain version on the CPU, which linearise the
    float32-gate forward whatever ``acc32`` the forward ran, as JAX's
    ``_bwd`` does."""

    @staticmethod
    def forward(ctx, acc32, *args):
        ctx.save_for_backward(*args)
        return torch.ops.climsim.fused_bigru_lbh(acc32, list(args))

    @staticmethod
    def backward(ctx, d_down, d_lasth):
        args = ctx.saved_tensors
        dt = args[0].dtype
        grads = bigru_bwd_lbh(args, d_down.to(dt).contiguous(),
                              d_lasth.to(dt).contiguous())
        return (None,) + tuple(g if need else None for g, need in
                               zip(grads, ctx.needs_input_grad[1:]))


def fused_bigru_lbh(xp, h0_up, h0_dn, whh_up, bhh_up, win2, bin2, whh_dn,
                    bhh_dn, acc32=True):
    """v2 fused bidirectional GRU, level-major: xp [L, B, 3H] (the hoisted
    up-sweep projection, input bias included), h0_up/h0_dn [B, H], weights
    [H, 3H] and biases [3H], all float32 or all bfloat16 -> (down
    [L, B, H], last_h [B, H]); differentiable in all nine. A CPU tensor
    runs the plain versions; a CUDA tensor launches kernel B7 (the design
    ``gru_design`` selects: bf16 the tensor-core design, f32 the cluster
    FFMA design, each where its plan fits, else the CUDA-core one) and,
    for gradients, B8, or raises. ``acc32=False`` runs a bf16 input's
    gates in bf16; the gradients are the float32-gate forward's."""
    return _FusedBiGRULBH.apply(bool(acc32), xp, h0_up, h0_dn, whh_up,
                                bhh_up, win2, bin2, whh_dn, bhh_dn)


fused_bigru_lbh.launches = 0
bigru_bwd_lbh.launches = 0
fused_bigru_lbh.design = bigru_bwd_lbh.design = None


def fused_bigru(x_proj_up, h0_up, h0_dn, whh_up, bhh_up, win2, bin2,
                whh_dn, bhh_dn):
    """Batch-major v2 (JAX's ``fused_bigru``): x_proj_up [B, L, 3H] ->
    (down [B, L, H], last_h [B, H]) through ``fused_bigru_lbh``, one
    level-major copy in and one out."""
    down, lasth = fused_bigru_lbh(x_proj_up.transpose(0, 1).contiguous(),
                                  h0_up, h0_dn, whh_up, bhh_up, win2, bin2,
                                  whh_dn, bhh_dn)
    return down.transpose(0, 1).contiguous(), lasth


class PallasBiGRU:
    """Parameters and apply of the fused v2 BiGRU (JAX's ``PallasBiGRU``):
    the same products as two ``RNNLayer`` GRU sweeps, with the up input
    projection hoisted (written level-major, so the kernel reads it without
    a copy) and the recurrences in ``fused_bigru_lbh``."""

    @staticmethod
    def init_params(generator: torch.Generator, nx: int, H: int,
                    dtype=torch.float32) -> dict:
        """Glorot-normal weights (scale sqrt(2 / (fan in + fan out))) and
        zero biases, as JAX draws them, from a ``torch.Generator`` in place
        of a JAX key (so the values differ)."""
        def glorot(*shape):
            return torch.randn(shape, generator=generator).to(dtype) \
                * (2.0 / sum(shape)) ** 0.5
        z = lambda: torch.zeros(3 * H, dtype=dtype)
        return {"win1": glorot(nx, 3 * H), "bin1": z(),
                "whh_up": glorot(H, 3 * H), "bhh_up": z(),
                "win2": glorot(H, 3 * H), "bin2": z(),
                "whh_dn": glorot(H, 3 * H), "bhh_dn": z()}

    @staticmethod
    def apply(p: dict, x, h0_up, h0_dn, use_pallas: bool = True):
        """x [B, L, nx] -> (down [B, L, H], last_h [B, H]); with
        ``use_pallas=False`` the plain version on any device."""
        xp = torch.matmul(x.transpose(0, 1), p["win1"]) + p["bin1"]
        args = (xp, h0_up, h0_dn, p["whh_up"], p["bhh_up"], p["win2"],
                p["bin2"], p["whh_dn"], p["bhh_dn"])
        op = fused_bigru_lbh if use_pallas else bigru_reference_lbh
        down, lasth = op(*args)
        return down.transpose(0, 1), lasth


# --------------------------------------------------------------------------
# v3 and v4 batch-major fused BiGRU + heads (B9 and B10, one source
# csrc/bigru_heads_lbh.cu with two entry points): JAX's
# ``fused_bigru_heads_lbh`` and ``fused_bigru_heads_init_lbh``
# --------------------------------------------------------------------------

_ARGS_HEADS_LBH = ("x", "h0_up", "h0_dn", "win1", "bin1", "whh_up", "bhh_up",
                   "win2", "bin2", "whh_dn", "bhh_dn", "wlat", "blat", "wout",
                   "bout")
_ARGS_HEADS_INIT_LBH = ("feat", "mem_in", "h0_up", "h0_dn", "w_init",
                        "b_init") + _ARGS_HEADS_LBH[3:]


def _heads_sweeps_lbh(xp_of, L, dt, h0_up, h0_dn, whh_up, bhh_up, win2, bin2,
                      whh_dn, bhh_dn, wlat, blat, wout, bout, acc32=True):
    """The v3/v4 TPU bodies' sweeps and heads level by level, batch-major:
    ``xp_of(l)`` gives the up sweep's float32 projection [B, 3H] (bias
    included, not rounded). The up states are stored in dt, the down
    sweep's projection reads them and stays float32; mem_l = dt(dt(h2) Wlat
    + blat), out_l = dt(mem_l Wout + bout). With ``acc32=False`` both
    projections are rounded to dt and the carries and gates are in dt (the
    bodies' ``acc``). Returns (out [L, B, ny], mem [L, B, nm], last_h
    [B, H]) in dt."""
    H = h0_up.shape[-1]
    acc = torch.float32 if acc32 else dt
    f = lambda t: t.float()
    h = h0_up.to(acc)
    up = [None] * L
    for l in range(L - 1, -1, -1):
        h = _gru_step_lbh(h, xp_of(l).to(acc), whh_up, bhh_up, H)
        up[l] = h.to(dt)
    h2 = h0_dn.to(acc)
    outs, mems = [], []
    for l in range(L):
        xp2 = (torch.matmul(f(up[l]), f(win2)) + f(bin2)).to(acc)
        h2 = _gru_step_lbh(h2, xp2, whh_dn, bhh_dn, H)
        mem_l = (torch.matmul(f(h2.to(dt)), f(wlat)) + f(blat)).to(dt)
        outs.append((torch.matmul(f(mem_l), f(wout)) + f(bout)).to(dt))
        mems.append(mem_l)
    return torch.stack(outs), torch.stack(mems), h2.to(dt)


def bigru_heads_lbh_reference(x, h0_up, h0_dn, win1, bin1, *weights,
                              acc32=True):
    """Plain version of B9 (the TPU body ``_bigru_heads_kernel``'s
    roundings, not the composition's): x [L, B, nx] -> (out [L, B, ny],
    mem [L, B, nm], last_h [B, H]) in x's type; the up projection x_l win1
    + bin1 stays float32 (``acc32=False``: rounded, gates in x's type).
    ``weights`` are (whh_up, bhh_up, win2, bin2, whh_dn, bhh_dn, wlat,
    blat, wout, bout), [in, out] and flat."""
    return _heads_sweeps_lbh(
        lambda l: torch.matmul(x[l].float(), win1.float()) + bin1.float(),
        x.shape[0], x.dtype, h0_up, h0_dn, *weights, acc32=acc32)


def bigru_heads_init_lbh_reference(feat, mem_in, h0_up, h0_dn, w_init,
                                   b_init, win1, bin1, *weights, acc32=True):
    """Plain version of B10 (the TPU body ``_bigru_heads_init_kernel_merged``):
    per level xi = dt(tanh(dt(feat_l w_init + b_init))) (``_xi_tanh``),
    then the up projection on [xi || mem_in_l] as two products (K = init
    width and K = nm_in, no concatenation), float32; the rest as B9."""
    dt, CH = feat.dtype, w_init.shape[1]
    f = lambda t: t.float()

    def xp_of(l):
        xi = _xi_tanh((torch.matmul(f(feat[l]), f(w_init))
                       + f(b_init)).to(dt), acc32)
        return (torch.matmul(f(xi), f(win1[:CH]))
                + torch.matmul(f(mem_in[l]), f(win1[CH:])) + f(bin1))

    return _heads_sweeps_lbh(xp_of, feat.shape[0], dt, h0_up, h0_dn,
                             *weights, acc32=acc32)


def _validate_heads_lbh(args, init: bool) -> tuple[int, ...]:
    """Check the v3 (or, with ``init``, v4) arguments on every device;
    returns (L, B, nx, ch, nm_in, H, nm, ny): nx is x's (v4: the raw
    features') width, ch and nm_in the two parts of the up projection's
    input (v3: nx and 0)."""
    named = dict(zip(_ARGS_HEADS_INIT_LBH if init else _ARGS_HEADS_LBH,
                     args))
    H = named["whh_up"].shape[0]
    nm, ny = named["wout"].shape
    if init:
        L, B, nx = named["feat"].shape
        ch, nm_in = named["w_init"].shape[1], named["mem_in"].shape[-1]
        shapes = {"feat": (L, B, nx), "mem_in": (L, B, nm_in),
                  "w_init": (nx, ch), "b_init": (ch,)}
        contiguous = ("feat", "mem_in", "h0_up", "h0_dn")
    else:
        L, B, nx = named["x"].shape
        ch, nm_in = nx, 0
        shapes = {"x": (L, B, nx)}
        contiguous = ("x", "h0_up", "h0_dn")
    w, b = (H, 3 * H), (3 * H,)
    shapes.update(h0_up=(B, H), h0_dn=(B, H), win1=(ch + nm_in, 3 * H),
                  bin1=b, whh_up=w, bhh_up=b, win2=w, bin2=b, whh_dn=w,
                  bhh_dn=b, wlat=(H, nm), blat=(nm,), wout=(nm, ny),
                  bout=(ny,))
    _check(named, shapes, contiguous)
    return L, B, nx, ch, nm_in, H, nm, ny


def _launch_heads_lbh(args, dims, init: bool, cudacore_bf16=False,
                      g16=False):
    """The CUDA-core design of B9 and B10 (f32, and bf16 past the
    tensor-core plan; ``g16``: the gates in bf16), its tiles in shared
    memory or a device scratch, as
    ``_launch``; with ``cudacore_bf16`` the timing twins
    (``cudacore_bigru_heads_lbh``, ``cudacore_bigru_heads_init_lbh``),
    which count no launch."""
    L, B, nx, ch, nm_in, H, nm, ny = dims
    dt, dev = args[0].dtype, args[0].device
    out = torch.empty((L, B, ny), dtype=dt, device=dev)
    mem = torch.empty((L, B, nm), dtype=dt, device=dev)
    lasth = torch.empty((B, H), dtype=dt, device=dev)
    # the up-stream scratch the TPU kept in VMEM (23 KB a column in bf16 at
    # L 60, H 192): [L, H, B], so that its stores and loads are coalesced
    up = torch.empty((L, H, B), dtype=dt, device=dev)
    # weights [in, out] (flax's layout) are the k-major order the kernel
    # reads; biases flat
    ptrs = [a.contiguous() for a in args] + [out, mem, lasth, up]
    lib = _build.load("bigru_heads_lbh")
    if init:
        fn, wrapper = lib.bigru_heads_init_lbh, fused_bigru_heads_init_lbh
        ints = (L, nx, ch, nm_in, H, nm, ny, B, int(g16))
        tiles = _tile_scratch("b10", (H, ch, nm_in, nm, ny, nx), B, dev)
    else:
        fn, wrapper = lib.bigru_heads_lbh, fused_bigru_heads_lbh
        ints = (L, nx, H, nm, ny, B, int(g16))
        tiles = _tile_scratch("b9", (H, nx, 0, nm), B, dev)
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * len(ptrs) \
        + [ctypes.c_int] * len(ints) + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(_dtype_code(dt), *[t.data_ptr() for t in ptrs],
            *ints, _ptr(tiles), stream)
    name = "bigru_heads_init_lbh" if init else "bigru_heads_lbh"
    _build.check_status(rc, name)
    if not cudacore_bf16:
        wrapper.launches += 1
    return out, mem, lasth


def pad_heads_lbh(args, Hp: int, KX: int) -> tuple:
    """B9's 15 arguments zero-padded to hidden width Hp (per gate block)
    and input width KX. A padded x channel meets zero weight rows; padded
    hidden units stay 0 through both sweeps and meet zero head weights:
    the outputs do not change."""
    (x, h0_up, h0_dn, win1, bin1, whh_up, bhh_up, win2, bin2, whh_dn, bhh_dn,
     wlat, blat, wout, bout) = args
    L, B, _ = x.shape
    gl = lambda t: _pad_gates_last(t, Hp)
    w = lambda t: gl(_pad(t, (Hp, t.shape[1])))
    return (_pad(x, (L, B, KX)), _pad(h0_up, (B, Hp)), _pad(h0_dn, (B, Hp)),
            gl(_pad(win1, (KX, win1.shape[1]))), gl(bin1), w(whh_up),
            gl(bhh_up), w(win2), gl(bin2), w(whh_dn), gl(bhh_dn),
            _pad(wlat, (Hp, wlat.shape[1])), blat, wout, bout)


def pad_heads_init_lbh(args, Hp: int, CHp: int, nmip: int) -> tuple:
    """B10's 18 arguments zero-padded to hidden width Hp (per gate block),
    initial-MLP width CHp and memory width nmip. A padded xi row is
    tanh(0) = 0 and meets zero weights; padded hidden units stay 0 through
    both sweeps and meet zero head weights: the outputs do not change."""
    (feat, mem_in, h0_up, h0_dn, w_init, b_init, win1, bin1, whh_up, bhh_up,
     win2, bin2, whh_dn, bhh_dn, wlat, blat, wout, bout) = args
    L, B, nf = feat.shape
    CH = w_init.shape[1]
    gl = lambda t: _pad_gates_last(t, Hp)
    w = lambda t: gl(_pad(t, (Hp, t.shape[1])))
    w1 = torch.cat([_pad(win1[:CH], (CHp, win1.shape[1])),
                    _pad(win1[CH:], (nmip, win1.shape[1]))])
    return (feat, _pad(mem_in, (L, B, nmip)), _pad(h0_up, (B, Hp)),
            _pad(h0_dn, (B, Hp)), _pad(w_init, (nf, CHp)),
            _pad(b_init, (CHp,)), gl(w1), gl(bin1), w(whh_up), gl(bhh_up),
            w(win2), gl(bin2), w(whh_dn), gl(bhh_dn),
            _pad(wlat, (Hp, wlat.shape[1])), blat, wout, bout)


def _launch_heads_lbh_mma(args, dims, init: bool, pl, g16=False):
    """B9 or, with ``init``, B10 in bf16 on the tensor-core design with the
    plan ``pl`` (bigru_mma_fwd.cuh's batch-major instances: B9's X tile
    loaded, B10's computed by the initial MLP; weights resident or
    streamed, as ``find_mma_plan`` chooses from the widths; ``g16``: the
    gates in bf16)."""
    L, B, nx, ch, nm_in, H, nm, ny = dims
    if init:
        a = pad_heads_init_lbh(args, pl["H"], pl["CH"], pl["nm_in"])
        lead, weights = a[:6], a[6:]
        widths = (nx, pl["CH"], pl["nm_in"])
    else:
        a = pad_heads_lbh(args, pl["H"], pl["CH"])
        lead, weights = a[:3], a[3:]
        widths = (pl["CH"],)
    C, Hp = pl["C"], pl["H"]
    (win1, bin1, whh_up, bhh_up, win2, bin2, whh_dn, bhh_dn, wlat, blat,
     wout, bout) = weights
    dt, dev = lead[0].dtype, lead[0].device
    out = torch.empty((L, B, ny), dtype=dt, device=dev)
    mem = torch.empty((L, B, nm), dtype=dt, device=dev)
    lasth = torch.empty((Hp, B), dtype=dt, device=dev)
    up = torch.empty((L, Hp, B), dtype=dt, device=dev)   # up-stream scratch
    cm = lambda t: t.t().contiguous()
    # the inputs (h0s [H, B], B10's w_init [CH, nf]), then the [in, out]
    # weights as the kernel's [out, in] gate slices and heads
    if init:
        feat, mem_in, h0_up, h0_dn, w_init, b_init = lead
        inputs = [feat, mem_in.contiguous(), cm(h0_up), cm(h0_dn),
                  cm(w_init), b_init.contiguous()]
    else:
        x, h0_up, h0_dn = lead
        inputs = [x, cm(h0_up), cm(h0_dn)]
    ptrs = inputs + [
        pack_rows(win1.t(), C), bin1.contiguous(), pack_rows(whh_up.t(), C),
        bhh_up.contiguous(), pack_rows(win2.t(), C), bin2.contiguous(),
        pack_rows(whh_dn.t(), C), bhh_dn.contiguous(),
        _pad(wlat.t(), (_ceil(nm, 8), Hp)).contiguous(), blat.contiguous(),
        cm(wout), bout.contiguous(), out, mem, lasth, up]
    name = "bigru_heads_init_lbh_mma" if init else "bigru_heads_lbh_mma"
    fn = getattr(_build.load("bigru_heads_lbh"), name)
    ints = (L, *widths, Hp, nm, ny, B, C, pl["BT"], int(pl["stream"]),
            int(g16))
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * len(ints) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(_table(ptrs), *ints, stream)
    _build.check_status(rc, name)
    (fused_bigru_heads_init_lbh if init else fused_bigru_heads_lbh) \
        .launches += 1
    return out, mem, lasth[:H].t().contiguous()


def cudacore_bigru_heads_lbh(*args) -> tuple[torch.Tensor, ...]:
    """B9's CUDA-core design in bf16, which no wrapper selects where the
    tensor-core design has a plan: for timing it against that design on
    the card. Counts no launch."""
    return _launch_heads_lbh(args, _validate_heads_lbh(args, False), False,
                             cudacore_bf16=True)


def cudacore_bigru_heads_init_lbh(*args) -> tuple[torch.Tensor, ...]:
    """B10's CUDA-core design in bf16, which no wrapper selects where the
    tensor-core design has a plan: for timing it against that design on
    the card. Counts no launch."""
    return _launch_heads_lbh(args, _validate_heads_lbh(args, True), True,
                             cudacore_bf16=True)


def _heads_compose_lbh(x, h0_up, h0_dn, win1, bin1, whh_up, bhh_up, win2,
                       bin2, whh_dn, bhh_dn, wlat, blat, wout, bout):
    """JAX's ``_heads_compose`` with the v2 kernel: the projection rounded
    to x's type, ``fused_bigru_lbh`` (B7, and B8 for its gradients, on the
    card), and the head products rounded to x's type. Differentiable."""
    dt = x.dtype
    xp = (torch.matmul(x, win1) + bin1).to(dt).contiguous()
    down, lasth = fused_bigru_lbh(xp, h0_up, h0_dn, whh_up, bhh_up, win2,
                                  bin2, whh_dn, bhh_dn)
    mem = (torch.matmul(down, wlat) + blat).to(dt)
    out = (torch.matmul(mem, wout) + bout).to(dt)
    return out, mem, lasth


def _heads_init_compose_lbh(feat, mem_in, h0_up, h0_dn, w_init, b_init,
                            *rest):
    """JAX's ``_heads_init_compose``: the initial MLP and the memory concat,
    then ``_heads_compose_lbh``."""
    xi = torch.tanh((torch.matmul(feat, w_init) + b_init).to(feat.dtype))
    return _heads_compose_lbh(torch.cat([xi, mem_in], dim=-1), h0_up, h0_dn,
                              *rest)


def _heads_lbh_cuda(args, init: bool, acc32: bool = True):
    dims = _validate_heads_lbh(args, init)
    L, B, nx, ch, nm_in, H, nm, ny = dims
    if init:
        d = _select(fused_bigru_heads_init_lbh, "b10", args[0].dtype, H, ch,
                    nm_in, nm, ny, nx, acc32=acc32)
    else:
        d = _select(fused_bigru_heads_lbh, "b9", args[0].dtype, H, nx, 0, nm,
                    ny, acc32=acc32)
    g16 = d["gates"] == "bf16"
    if d["design"] == "tensor_core":
        return _launch_heads_lbh_mma(args, dims, init, d["plan"], g16)
    return _launch_heads_lbh(args, dims, init, g16=g16)


def _heads_lbh_fake(args, init: bool):
    L, B, nx, ch, nm_in, H, nm, ny = _validate_heads_lbh(args, init)
    new = args[0].new_empty
    return new((L, B, ny)), new((L, B, nm)), new((B, H))


@torch.library.custom_op("climsim::fused_bigru_heads_lbh", mutates_args=(),
                         device_types="cpu")
def _b9_op(acc32: bool, args: list[torch.Tensor]
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B9 as a custom op, its gate mode in the schema: on the CPU its plain
    version."""
    _validate_heads_lbh(args, False)
    return fresh(bigru_heads_lbh_reference(*args, acc32=acc32), args)


@torch.library.custom_op("climsim::fused_bigru_heads_init_lbh",
                         mutates_args=(), device_types="cpu")
def _b10_op(acc32: bool, args: list[torch.Tensor]
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B10 as a custom op, its gate mode in the schema: on the CPU its
    plain version."""
    _validate_heads_lbh(args, True)
    return fresh(bigru_heads_init_lbh_reference(*args, acc32=acc32), args)


_b9_op.register_kernel("cuda")(
    lambda acc32, args: _heads_lbh_cuda(args, False, acc32))
_b9_op.register_fake(lambda acc32, args: _heads_lbh_fake(args, False))
_b10_op.register_kernel("cuda")(
    lambda acc32, args: _heads_lbh_cuda(args, True, acc32))
_b10_op.register_fake(lambda acc32, args: _heads_lbh_fake(args, True))


class _FusedHeadsLBH(torch.autograd.Function):
    """Forward: the op ``climsim::fused_bigru_heads_lbh`` (B9), or with
    ``init`` ``climsim::fused_bigru_heads_init_lbh`` (B10), in the designs
    ``gru_design`` selects (their plain versions on the CPU), saving the
    inputs, as JAX's residuals are. Backward, as JAX's
    ``_heads_bwd`` / ``_heads_init_bwd``: autograd through the composition,
    whose recurrent core replays with B7 and differentiates with B8 on the
    card. The composition rounds the up projection to the input type
    before the v2 kernel, so in bf16 the replay differs from the forward
    kernel by that rounding, as on the TPU. The replay runs float32 gates
    whatever ``acc32`` the forward ran, so the gradients are the
    float32-gate forward's in both modes."""

    @staticmethod
    def forward(ctx, init, acc32, *args):
        ctx.save_for_backward(*args)
        ctx.init = init
        op = (torch.ops.climsim.fused_bigru_heads_init_lbh if init
              else torch.ops.climsim.fused_bigru_heads_lbh)
        return op(acc32, list(args))

    @staticmethod
    def backward(ctx, d_out, d_mem, d_lasth):
        args = ctx.saved_tensors
        compose = _heads_init_compose_lbh if ctx.init else _heads_compose_lbh
        with torch.enable_grad():
            a = [t.detach().requires_grad_(True) for t in args]
            outs = compose(*a)
            grads = torch.autograd.grad(outs, a, (d_out, d_mem, d_lasth),
                                        allow_unused=True)
        return (None, None) + tuple(g if need else None for g, need in
                                     zip(grads, ctx.needs_input_grad[2:]))


def fused_bigru_heads_lbh(x, h0_up, h0_dn, win1, bin1, whh_up, bhh_up, win2,
                          bin2, whh_dn, bhh_dn, wlat, blat, wout, bout,
                          acc32=True):
    """v3 fused BiGRU with the up-sweep input projection and the latent and
    output heads inside, batch-major: x [L, B, nx], h0_up/h0_dn [B, H],
    weights [in, out] (win1 [nx, 3H], wlat [H, nm], wout [nm, ny]) and flat
    biases, all float32 or all bfloat16 -> (out [L, B, ny], mem [L, B, nm],
    last_h [B, H]); differentiable in all 15. A CPU tensor runs the plain
    versions; a CUDA tensor launches kernel B9 (the design ``gru_design``
    selects) and, for gradients, B7 and B8, or raises. ``acc32=False``
    runs a bf16 input's gates in bf16; the gradients are the float32-gate
    forward's."""
    return _FusedHeadsLBH.apply(False, bool(acc32), x, h0_up, h0_dn, win1,
                                bin1, whh_up, bhh_up, win2, bin2, whh_dn,
                                bhh_dn, wlat, blat, wout, bout)


def fused_bigru_heads_init_lbh(feat, mem_in, h0_up, h0_dn, w_init, b_init,
                               win1, bin1, whh_up, bhh_up, win2, bin2,
                               whh_dn, bhh_dn, wlat, blat, wout, bout,
                               acc32=True):
    """v4: v3 with the initial tanh MLP and the memory concat inside:
    feat [L, B, nf], mem_in [L, B, nm_in], w_init [nf, CH], b_init [CH],
    win1 [CH + nm_in, 3H], the rest as ``fused_bigru_heads_lbh`` -> (out,
    mem, last_h); differentiable in all 18. A CPU tensor runs the plain
    versions; a CUDA tensor launches kernel B10 (the design ``gru_design``
    selects) and, for gradients, B7 and B8, or raises. ``acc32`` as
    ``fused_bigru_heads_lbh``'s."""
    return _FusedHeadsLBH.apply(True, bool(acc32), feat, mem_in, h0_up,
                                h0_dn, w_init, b_init, win1, bin1, whh_up,
                                bhh_up, win2, bin2, whh_dn, bhh_dn, wlat,
                                blat, wout, bout)


fused_bigru_heads_lbh.launches = 0
fused_bigru_heads_init_lbh.launches = 0
fused_bigru_heads_lbh.design = fused_bigru_heads_init_lbh.design = None
