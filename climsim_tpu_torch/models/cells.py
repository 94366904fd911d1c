"""Recurrent layers of the ported paths (counterpart of
``climsim_tpu/models/cells.py``): the GRU cell and the scanned
``RNNLayer`` (the flagship's unfused path and the physics model's scan
trunk), the stochastic GRU and LSTM cells that ``RNNLayer(noise=True)``
steps with per-level noise (the stochastic third layer of
``RNNAutoreg``), the fused BiGRU + heads layer with the initial MLP
inside the kernel or outside it (channel-major v6 and v5, batch-major v4
and v3), and the v2 fused BiGRU layer (the physics model's fused trunk
and the batch-major flagship). The other cells (LSTM, LN-LSTM, SRU, the
stochastic LayerNorm LSTM) wait for ROADMAP A.12.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import (fused_bigru_heads_cm, fused_bigru_heads_init_cm,
                   fused_bigru_heads_init_lbh, fused_bigru_heads_lbh,
                   fused_bigru_lbh)


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


class Dense(nn.Module):
    """flax ``nn.Dense`` with a compute dtype: ``kernel`` [in, out] and
    ``bias`` [out] in float32, applied as x @ kernel + bias in ``dtype``.
    ``use_bias=False`` has no bias, as flax's has none then."""

    def __init__(self, nin: int, nout: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None,
                 use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = flax_param((nin, nout), generator)
        self.bias = flax_param((nout,), generator) if use_bias else None

    def forward(self, x):
        dt = self.dtype
        y = x.to(dt) @ self.kernel.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


class GRUCell(nn.Module):
    """flax's ``GRUCell`` of ``climsim_tpu/models/cells.py``: the recurrent
    projection ``hh`` (a Dense H -> 3H in the compute dtype) and the gates
    [r; z; n] on a precomputed input projection (bias included). Every
    step runs in the projection's dtype, bf16 under the BF16 policy."""

    def __init__(self, hidden: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = hidden
        self.hh = Dense(hidden, 3 * hidden, dtype, generator)

    def forward(self, h, x_proj):
        hh = self.hh(h)
        xr, xz, xn = x_proj.split(self.hidden, dim=-1)
        hr, hz, hn = hh.split(self.hidden, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h


class StochasticGRUCell(nn.Module):
    """flax's ``StochasticGRUCell`` (``sgru``): the hidden state gives
    (mean, logvar) through the bias-free ``encoder`` (H -> 2H), the sample
    z = mean + exp(logvar / 2) * noise_scale * eps drives all three gates
    through the bias-free ``zh`` (H -> 3H):
    r = sigmoid(x_r + z_r), g = sigmoid(x_z + z_z), n = tanh(x_n + r z_n),
    h' = n + g (h - n). ``eps`` [B, H] is a standard-normal draw."""

    def __init__(self, hidden: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None,
                 noise_scale: float = 1.0):
        super().__init__()
        self.hidden = hidden
        self.noise_scale = noise_scale
        self.encoder = Dense(hidden, 2 * hidden, dtype, generator,
                             use_bias=False)
        self.zh = Dense(hidden, 3 * hidden, dtype, generator, use_bias=False)

    def forward(self, h, x_proj, eps):
        mean, logvar = self.encoder(h).split(self.hidden, dim=-1)
        z = mean + torch.exp(0.5 * logvar) * (self.noise_scale * eps)
        zr, zz, zn = self.zh(z).split(self.hidden, dim=-1)
        xr, xz, xn = x_proj.split(self.hidden, dim=-1)
        r = torch.sigmoid(xr + zr)
        g = torch.sigmoid(xz + zz)
        n = torch.tanh(xn + r * zn)
        return n + g * (h - n)


class StochasticLSTMCell(nn.Module):
    """flax's ``StochasticLSTMCell`` (``slstm``) on the carry (h, c): the
    input projection plus the bias-free ``hh`` (H -> 5H) give (mean,
    logvar, i, f, g); the output gate is the stochastic part,
    o = sigmoid(mean + exp(logvar / 2) * noise_scale * eps),
    c' = sigmoid(f) c + sigmoid(i) tanh(g), h' = o tanh(c')."""

    def __init__(self, hidden: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None,
                 noise_scale: float = 1.0):
        super().__init__()
        self.hidden = hidden
        self.noise_scale = noise_scale
        self.hh = Dense(hidden, 5 * hidden, dtype, generator, use_bias=False)

    def forward(self, carry, x_proj, eps):
        h, c = carry
        mean, logvar, i, f, g = (x_proj + self.hh(h)).split(self.hidden,
                                                            dim=-1)
        o = torch.sigmoid(mean + torch.exp(0.5 * logvar)
                          * (self.noise_scale * eps))
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return o * torch.tanh(c_new), c_new


# the ported cells: (class, input-projection width in units of hidden,
# whether it steps with per-level noise)
CELLS = {"gru": (GRUCell, 3, False), "sgru": (StochasticGRUCell, 3, True),
         "slstm": (StochasticLSTMCell, 5, True)}


def needs_cell_state(kind: str) -> bool:
    return kind in ("lstm", "ln_lstm", "slstm")


class RNNLayer(nn.Module):
    """One directional RNN over the level axis: the hoisted input
    projection ``input_proj`` and the cell ``cell`` stepped level by level
    (JAX's ``nn.scan``). Input [B, L, nx] -> (outputs [B, L, hidden],
    final carry). ``reverse=True`` steps from the last level (the surface,
    since TOA is level 0) upward. The carry ((h, c) for the cells with a
    cell state) is cast to the projection's dtype, as JAX unifies it for
    its scan. The stochastic cells (``sgru``, ``slstm``; ``noise=True``)
    take ``eps`` [L, B, hidden], level l's noise stepping with level l.
    The other cells wait for ROADMAP A.12."""

    def __init__(self, nx: int, hidden: int, kind: str = "gru",
                 reverse: bool = False, noise: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if kind not in CELLS:
            raise NotImplementedError(f"RNNLayer kind={kind!r} is not "
                                      "ported yet (ROADMAP A.12)")
        cell_cls, width, stochastic = CELLS[kind]
        if noise != stochastic:
            raise ValueError(f"RNNLayer kind={kind!r} takes noise="
                             f"{stochastic}")
        self.reverse = reverse
        self.noise = noise
        self.cell_state = needs_cell_state(kind)
        self.input_proj = Dense(nx, width * hidden, dtype, generator)
        self.cell = cell_cls(hidden, dtype, generator)

    def forward(self, xs, h0, eps=None):
        xs_proj = self.input_proj(xs)                  # [B, L, kH]
        dt = xs_proj.dtype
        carry = tuple(a.to(dt) for a in h0) if self.cell_state \
            else h0.to(dt)
        if self.noise and eps is None:
            raise ValueError("a stochastic cell needs eps [L, B, hidden]")
        # one unbind, whose backward is one stack: a select per level would
        # add a whole zero [B, L, 3H] gradient per level in the backward
        levels = xs_proj.unbind(1)
        noise = eps.to(dt).unbind(0) if self.noise else None
        L = len(levels)
        ys = [None] * L
        for l in (range(L - 1, -1, -1) if self.reverse else range(L)):
            if noise is None:
                carry = self.cell(carry, levels[l])
            else:
                carry = self.cell(carry, levels[l], noise[l])
            ys[l] = carry[0] if self.cell_state else carry
        return torch.stack(ys, dim=1), carry


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
    """Split up-projection + up/down GRU sweeps + latent-memory and output
    heads in one kernel. With ``init_width > 0`` the initial tanh MLP runs
    inside the kernel too.

    Channel-major (``level_major=True``): ``(x [L, nx, B], h0_up [B, H],
    h0_dn [B, H], mem [L, nm_in, B] or None)`` -> ``(out [L, ny, B], mem
    [L, nh_mem, B], last_h [B, H])``: x holds the raw features (v6,
    ``fused_bigru_heads_init_cm``) or the initial-MLP stream (v5,
    ``fused_bigru_heads_cm``); v5 takes ``nm_in = 0`` and ``mem=None`` as
    a zero-width memory.

    Batch-major (``level_major=False``): ``(x [B, L, nx], h0_up, h0_dn,
    mem [B, L, nm_in] or None)`` -> ``(out [B, L, ny], mem [B, L, nh_mem],
    last_h [B, H])``: with ``init_width > 0`` x holds the raw features and
    mem goes in separately (v4, ``fused_bigru_heads_init_lbh``); else x is
    the model's [tanh(mlp_initial) || memory] concatenation and the layer
    takes no memory (v3, ``fused_bigru_heads_lbh``, ``nm_in = 0``).

    Parameters keep flax's names and [in, out] layout (``bigru_fused/
    {w_init, b_init, win1, ...}``; win1 is [x width + nm_in, 3H], or with
    the initial MLP [init_width + nm_in, 3H]), so a flax checkpoint loads
    unchanged. Channel-major they are transposed at call as views, which
    the kernel wrapper turns back into k-major storage without a copy.
    ``hoist_proj`` (v5 only) picks the TPU body whose roundings the kernel
    reproduces.
    """

    def __init__(self, nx: int, nm_in: int, hidden: int, nh_mem: int,
                 ny: int, init_width: int = 0, level_major: bool = False,
                 hoist_proj: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        if init_width > 0 and nm_in <= 0:
            raise NotImplementedError(
                "the fused initial MLP (init_width > 0) needs the memory "
                "input")
        if not level_major and init_width == 0 and nm_in != 0:
            raise ValueError("the batch-major v3 layer takes the memory "
                             "concatenated into x (nm_in = 0)")
        H = hidden
        self.hidden, self.nh_mem, self.ny = H, nh_mem, ny
        self.init_width, self.nm_in = init_width, nm_in
        self.level_major = level_major
        self.hoist_proj = hoist_proj
        p = lambda *s: flax_param(s, generator)
        if init_width > 0:
            self.w_init = p(nx, init_width)
            self.b_init = p(init_width)
        self.ch = init_width if init_width > 0 else nx
        self.win1 = p(self.ch + nm_in, 3 * H)
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

    def forward(self, x, h0_up, h0_dn, mem=None):
        dt = x.dtype
        if (mem is None) != (self.nm_in == 0):
            raise ValueError(f"the layer was built for nm_in={self.nm_in}, "
                             f"got mem {None if mem is None else mem.shape}")
        if not self.level_major:
            return self._forward_batch_major(x, h0_up, h0_dn, mem)
        tw = lambda t: t.to(dt).t()              # [out, in] view
        tb = lambda t: t.to(dt)[:, None]         # [ch, 1]
        CH = self.ch
        mem_in = x.new_zeros((x.shape[0], 0, x.shape[2])) if mem is None \
            else mem.to(dt).contiguous()
        args = (x.contiguous(), mem_in, h0_up.to(dt).t().contiguous(),
                h0_dn.to(dt).t().contiguous(), tw(self.win1[:CH]),
                tw(self.win1[CH:]), tb(self.bin1), tw(self.whh_up),
                tb(self.bhh_up), tw(self.win2), tb(self.bin2),
                tw(self.whh_dn), tb(self.bhh_dn), tw(self.wlat),
                tb(self.blat), tw(self.wout), tb(self.bout))
        if self.init_width > 0:
            outmem, lasth = fused_bigru_heads_init_cm(
                *args[:4], tw(self.w_init), tb(self.b_init), *args[4:])
        else:
            outmem, lasth = fused_bigru_heads_cm(*args,
                                                 hoist_proj=self.hoist_proj)
        nm = self.nh_mem
        return outmem[:, nm:, :], outmem[:, :nm, :], lasth.t()

    def _forward_batch_major(self, x, h0_up, h0_dn, mem):
        """v3/v4: one level-major copy of each input in and of each output
        out, contiguous (a transposed view would be copied, and the copy
        kept for the backward, by whatever reads it)."""
        dt = x.dtype
        lm = lambda t: t.to(dt).transpose(0, 1).contiguous()
        w = lambda t: t.to(dt)
        wargs = (w(self.win1), w(self.bin1), w(self.whh_up), w(self.bhh_up),
                 w(self.win2), w(self.bin2), w(self.whh_dn), w(self.bhh_dn),
                 w(self.wlat), w(self.blat), w(self.wout), w(self.bout))
        h0 = (h0_up.to(dt).contiguous(), h0_dn.to(dt).contiguous())
        if self.init_width > 0:
            out, mem_o, lasth = fused_bigru_heads_init_lbh(
                lm(x), lm(mem), *h0, w(self.w_init), w(self.b_init), *wargs)
        else:
            out, mem_o, lasth = fused_bigru_heads_lbh(lm(x), *h0, *wargs)
        bm = lambda t: t.transpose(0, 1).contiguous()
        return bm(out), bm(mem_o), lasth
