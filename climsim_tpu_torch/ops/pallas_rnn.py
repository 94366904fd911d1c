"""The v6 fused emulator forward: the CUDA kernel and its plain PyTorch
version (counterpart of ``climsim_tpu/ops/pallas_rnn.py``'s
``fused_bigru_heads_init_cm``; the kernel is
``csrc/bigru_heads_init_cm.cu``).

Channel-major contract, as in JAX: feat [L, nf, B] raw features, mem_in
[L, nm_in, B], h0_up/h0_dn [H, B]; weights pre-transposed [out, in] and
biases [ch, 1] -> (outmem [L, nm+ny, B] = mem || out, lasth [H, B]).
Every sum is accumulated in float32; the input type (float32 or
bfloat16) is the storage type of xi, the projections, the up stream, the
heads and the outputs, where the TPU kernel stores them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_bigru_heads_init_cm", "bigru_heads_init_cm_reference"]

_ARGS = ("feat", "mem_in", "h0_up", "h0_dn", "winit_t", "binit", "win1h_t",
         "win1m_t", "bin1", "whh_up_t", "bhh_up", "win2_t", "bin2",
         "whh_dn_t", "bhh_dn", "wlat_t", "blat", "wout_t", "bout")


def _mm(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[out, in] @ [in, B] with float32 accumulation of the dt products
    (bf16 x bf16 products are exact in float32)."""
    return torch.matmul(w.float(), x.float())


def _gru_step_cm(h, xp, whh_t, bhh, H: int):
    """Channel-major GRU update with gates [r; z; n]: h [H, B] float32,
    xp [3H, B] (input bias included) -> new h (float32). The recurrent
    product takes h rounded to the weight type."""
    hh = _mm(whh_t, h.to(whh_t.dtype)) + bhh.float()
    xr, xz, xn = xp.float().split(H)
    hr, hz, hn = hh.split(H)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def bigru_heads_init_cm_reference(feat, mem_in, h0_up, h0_dn, winit_t,
                                  binit, win1h_t, win1m_t, bin1, whh_up_t,
                                  bhh_up, win2_t, bin2, whh_dn_t, bhh_dn,
                                  wlat_t, blat, wout_t, bout):
    """Plain version of the kernel: the same arithmetic, level by level."""
    dt = feat.dtype
    L = feat.shape[0]
    H = whh_up_t.shape[1]
    h = h0_up.float()
    up = []
    for l in range(L - 1, -1, -1):
        xi = torch.tanh((_mm(winit_t, feat[l]) + binit.float()).to(dt)
                        .float()).to(dt)
        xp = (_mm(win1h_t, xi) + _mm(win1m_t, mem_in[l])
              + bin1.float()).to(dt)
        h = _gru_step_cm(h, xp, whh_up_t, bhh_up, H)
        up.append(h.to(dt))
    up.reverse()
    h2 = h0_dn.float()
    outmem = []
    for l in range(L):
        xp2 = (_mm(win2_t, up[l]) + bin2.float()).to(dt)
        h2 = _gru_step_cm(h2, xp2, whh_dn_t, bhh_dn, H)
        mem_l = (_mm(wlat_t, h2.to(dt)) + blat.float()).to(dt)
        out_l = (_mm(wout_t, mem_l) + bout.float()).to(dt)
        outmem.append(torch.cat([mem_l, out_l], dim=0))
    return torch.stack(outmem), h2.to(dt)


def _validate(args) -> tuple[int, ...]:
    """Check dtype, device, shapes and contiguity of the wrapper's
    arguments (on every device, so the CPU tests catch what the kernel
    would refuse); returns (L, nf, nm_in, H, nm, ny, B)."""
    named = dict(zip(_ARGS, args))
    feat = named["feat"]
    dt, dev = feat.dtype, feat.device
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feat: {dt}; the kernel takes float32 or bfloat16")
    for k, t in named.items():
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{k}: {t.dtype} on {t.device}, the kernel "
                             f"takes every tensor as {dt} on {dev}")
    L, nf, B = feat.shape
    nm_in, H = named["mem_in"].shape[1], named["whh_up_t"].shape[1]
    nm, ny = named["wlat_t"].shape[0], named["wout_t"].shape[0]
    shapes = {"feat": (L, nf, B), "mem_in": (L, nm_in, B), "h0_up": (H, B),
              "h0_dn": (H, B), "winit_t": (H, nf), "binit": (H, 1),
              "win1h_t": (3 * H, H), "win1m_t": (3 * H, nm_in),
              "bin1": (3 * H, 1), "whh_up_t": (3 * H, H),
              "bhh_up": (3 * H, 1), "win2_t": (3 * H, H),
              "bin2": (3 * H, 1), "whh_dn_t": (3 * H, H),
              "bhh_dn": (3 * H, 1), "wlat_t": (nm, H), "blat": (nm, 1),
              "wout_t": (ny, nm), "bout": (ny, 1)}
    for k, want in shapes.items():
        if tuple(named[k].shape) != want:
            raise ValueError(f"{k}: shape {tuple(named[k].shape)}, want "
                             f"{want}")
    for k in ("feat", "mem_in", "h0_up", "h0_dn"):
        if not named[k].is_contiguous():
            raise ValueError(f"{k} must be contiguous")
    return L, nf, nm_in, H, nm, ny, B


def _launch(args, dims) -> tuple[torch.Tensor, torch.Tensor]:
    (feat, mem_in, h0_up, h0_dn, winit_t, binit, win1h_t, win1m_t, bin1,
     whh_up_t, bhh_up, win2_t, bin2, whh_dn_t, bhh_dn, wlat_t, blat, wout_t,
     bout) = args
    L, nf, nm_in, H, nm, ny, B = dims
    dt, dev = feat.dtype, feat.device
    # the kernel reads weights k-major ([in, out], flax's layout): free
    # when the caller passes transposed views of such storage, as
    # FusedBiGRUHeadsLayer does
    kmaj = lambda w: w.t().contiguous()
    flat = lambda b: b.reshape(-1).contiguous()
    outmem = torch.empty((L, nm + ny, B), dtype=dt, device=dev)
    lasth = torch.empty((H, B), dtype=dt, device=dev)
    up = torch.empty((L, H, B), dtype=dt, device=dev)   # up-stream scratch
    ptrs = [feat, mem_in, h0_up, h0_dn, kmaj(winit_t), flat(binit),
            kmaj(win1h_t), kmaj(win1m_t), flat(bin1), kmaj(whh_up_t),
            flat(bhh_up), kmaj(win2_t), flat(bin2), kmaj(whh_dn_t),
            flat(bhh_dn), kmaj(wlat_t), flat(blat), kmaj(wout_t),
            flat(bout), outmem, lasth, up]
    lib = _build.load("bigru_heads_init_cm")
    fn = lib.bigru_heads_init_cm
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 22 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(0 if dt == torch.float32 else 1, *[t.data_ptr() for t in ptrs],
            L, nf, nm_in, H, nm, ny, B, stream)
    _build.check_status(rc, "bigru_heads_init_cm")
    fused_bigru_heads_init_cm.launches += 1
    return outmem, lasth


def fused_bigru_heads_init_cm(feat, mem_in, h0_up, h0_dn, winit_t, binit,
                              win1h_t, win1m_t, bin1, whh_up_t, bhh_up,
                              win2_t, bin2, whh_dn_t, bhh_dn, wlat_t, blat,
                              wout_t, bout):
    """v6 channel-major fused initial-MLP + BiGRU + heads. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel or raises.
    Forward only: the training backward kernel is not ported yet, so a
    CUDA call that would need gradients raises."""
    args = (feat, mem_in, h0_up, h0_dn, winit_t, binit, win1h_t, win1m_t,
            bin1, whh_up_t, bhh_up, win2_t, bin2, whh_dn_t, bhh_dn, wlat_t,
            blat, wout_t, bout)
    dims = _validate(args)
    if feat.device.type == "cpu":
        return bigru_heads_init_cm_reference(*args)
    if feat.device.type != "cuda":
        raise ValueError(f"no kernel for device {feat.device}")
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        raise NotImplementedError(
            "the backward of the fused BiGRU kernel is not ported yet "
            "(ROADMAP B3); call under torch.no_grad()")
    return _launch(args, dims)


fused_bigru_heads_init_cm.launches = 0
