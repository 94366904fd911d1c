"""Recurrent layers of the ported paths (counterpart of
``climsim_tpu/models/cells.py``): the channel-major fused BiGRU + heads
layer with the initial MLP inside the kernel (the v6 path of the flagship)
and the v2 fused BiGRU layer (the physics trunk). The other cells wait
for ROADMAP A.12.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import fused_bigru_heads_init_cm, fused_bigru_lbh


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations with variance 1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def flax_param(shape, generator: torch.Generator | None) -> nn.Parameter:
    """A float32 parameter in flax's layout: kernels [in, out] get
    lecun-normal values, biases (1-D) zeros."""
    w = torch.zeros(shape, dtype=torch.float32)
    if len(shape) == 2 and generator is not None:
        lecun_normal_(w, shape[0], generator)
    return nn.Parameter(w)


class FusedBiGRULayer(nn.Module):
    """Both column sweeps as one fused kernel (v2, ``fused_bigru_lbh``):
    the up sweep surface -> TOA, the down sweep TOA -> surface with its
    input projection inside the kernel.

    Called as ``(x [B, L, nx], h0_up [B, H], h0_dn [B, H])`` ->
    ``(down [B, L, H], last_h [B, H])`` in x's type. Parameters keep
    flax's names and [in, out] layout (``win1, bin1, whh_up, bhh_up, win2,
    bin2, whh_dn, bhh_dn``). The up-sweep projection xp = x win1 + bin1 is
    hoisted out of the kernel as one matmul, level-major, as JAX computes
    it.
    """

    def __init__(self, nx: int, hidden: int, acc32: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not acc32:
            raise NotImplementedError(
                "FusedBiGRULayer acc32=False (gates in the input type) is "
                "not ported yet (ROADMAP A.11)")
        H = hidden
        self.hidden = H
        p = lambda *s: flax_param(s, generator)
        self.win1 = p(nx, 3 * H)
        self.bin1 = p(3 * H)
        self.whh_up = p(H, 3 * H)
        self.bhh_up = p(3 * H)
        self.win2 = p(H, 3 * H)
        self.bin2 = p(3 * H)
        self.whh_dn = p(H, 3 * H)
        self.bhh_dn = p(3 * H)

    def forward(self, x, h0_up, h0_dn):
        dt = x.dtype
        xp = torch.matmul(x.transpose(0, 1), self.win1.to(dt)) \
            + self.bin1.to(dt)                               # [L, B, 3H]
        down, lasth = fused_bigru_lbh(
            xp, h0_up.to(dt).contiguous(), h0_dn.to(dt).contiguous(),
            self.whh_up.to(dt), self.bhh_up.to(dt), self.win2.to(dt),
            self.bin2.to(dt), self.whh_dn.to(dt), self.bhh_dn.to(dt))
        # batch-major once: a transposed view would be copied, and the
        # copy kept for the backward, by every Dense head that reads it
        return down.transpose(0, 1).contiguous(), lasth


class FusedBiGRUHeadsLayer(nn.Module):
    """Initial tanh MLP + split up-projection + up/down GRU sweeps +
    latent-memory and output heads in one kernel, channel-major.

    Called as ``(x [L, nx, B] raw features, h0_up [B, H], h0_dn [B, H],
    mem [L, nm_in, B])`` -> ``(out [L, ny, B], mem [L, nh_mem, B],
    last_h [B, H])``. Parameters keep flax's names and [in, out] layout
    (``bigru_fused/{w_init, b_init, win1, ...}``), so a flax checkpoint
    loads unchanged; they are transposed at call as views, which the
    kernel wrapper turns back into k-major storage without a copy.
    """

    def __init__(self, nx: int, nm_in: int, hidden: int, nh_mem: int,
                 ny: int, init_width: int = 0, level_major: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not level_major:
            raise NotImplementedError(
                "batch-major FusedBiGRUHeadsLayer is not ported yet "
                "(ROADMAP A.2, batch-major layout)")
        if init_width <= 0 or nm_in <= 0:
            raise NotImplementedError(
                "only the v6 path (init_width > 0 with memory) is ported; "
                "the v5 kernel is ROADMAP B4")
        H = hidden
        self.hidden, self.nh_mem, self.ny = H, nh_mem, ny
        self.init_width = init_width
        p = lambda *s: flax_param(s, generator)
        self.w_init = p(nx, init_width)
        self.b_init = p(init_width)
        self.win1 = p(init_width + nm_in, 3 * H)
        self.bin1 = p(3 * H)
        self.whh_up = p(H, 3 * H)
        self.bhh_up = p(3 * H)
        self.win2 = p(H, 3 * H)
        self.bin2 = p(3 * H)
        self.whh_dn = p(H, 3 * H)
        self.bhh_dn = p(3 * H)
        self.wlat = p(H, nh_mem)
        self.blat = p(nh_mem)
        self.wout = p(nh_mem, ny)
        self.bout = p(ny)

    def forward(self, x, h0_up, h0_dn, mem):
        dt = x.dtype
        tw = lambda t: t.to(dt).t()              # [out, in] view
        tb = lambda t: t.to(dt)[:, None]         # [ch, 1]
        CH = self.init_width
        outmem, lasth = fused_bigru_heads_init_cm(
            x.contiguous(), mem.to(dt).contiguous(),
            h0_up.to(dt).t().contiguous(),
            h0_dn.to(dt).t().contiguous(), tw(self.w_init),
            tb(self.b_init), tw(self.win1[:CH]), tw(self.win1[CH:]),
            tb(self.bin1), tw(self.whh_up), tb(self.bhh_up), tw(self.win2),
            tb(self.bin2), tw(self.whh_dn), tb(self.bhh_dn), tw(self.wlat),
            tb(self.blat), tw(self.wout), tb(self.bout))
        nm = self.nh_mem
        return outmem[:, nm:, :], outmem[:, :nm, :], lasth.t()
