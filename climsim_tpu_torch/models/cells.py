"""Recurrent layers of the ported paths (counterpart of
``climsim_tpu/models/cells.py``): every cell of JAX's ``CELL_TYPES`` (GRU,
LSTM, LayerNorm-LSTM, SRU, and the stochastic GRU, LSTM and
LayerNorm-LSTM that ``RNNLayer(noise=True)`` steps with per-level noise)
and the scanned ``RNNLayer`` (the flagship's unfused path, the physics
model's scan trunk and the stochastic third layer of ``RNNAutoreg``), the
``GLU`` block and the ``QRNNLayer`` trunk, the fused BiGRU + heads layer
with the initial MLP inside the kernel or outside it (channel-major v6
and v5, batch-major v4 and v3), and the v2 fused BiGRU layer (the physics
model's fused trunk and the batch-major flagship). Every LayerNorm is
flax's (``norm.py``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import (fused_bigru_heads_cm, fused_bigru_heads_init_cm,
                   fused_bigru_heads_init_lbh, fused_bigru_heads_lbh,
                   fused_bigru_lbh)
from .norm import LayerNorm


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


class LSTMCell(nn.Module):
    """flax's ``LSTMCell`` on the carry (h, c): the recurrent projection
    ``hh`` (H -> 4H, with bias) added to the input projection gives
    (i, f, g, o); c' = sigmoid(f) c + sigmoid(i) tanh(g),
    h' = sigmoid(o) tanh(c')."""

    def __init__(self, hidden: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = hidden
        self.hh = Dense(hidden, 4 * hidden, dtype, generator)

    def forward(self, carry, x_proj):
        h, c = carry
        i, f, g, o = (x_proj + self.hh(h)).split(self.hidden, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new


class LayerNormLSTMCell(nn.Module):
    """flax's ``LayerNormLSTMCell``: the LSTM with the bias-free ``hh``,
    the gates' sum through the LayerNorm ``ln_g`` (over 4H) and the new
    cell state through ``ln_c`` before the output tanh. The LayerNorms
    return float32 for a bf16 input, as flax's do, so under the BF16
    policy the carry changes type and ``RNNLayer`` refuses the cell
    (``f32_carry``), as JAX's scan does."""

    f32_carry = True

    def __init__(self, hidden: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = hidden
        self.hh = Dense(hidden, 4 * hidden, dtype, generator, use_bias=False)
        self.ln_g = LayerNorm(4 * hidden)
        self.ln_c = LayerNorm(hidden)

    def forward(self, carry, x_proj):
        h, c = carry
        i, f, g, o = self.ln_g(x_proj + self.hh(h)).split(self.hidden,
                                                          dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(self.ln_c(c_new)), c_new


class StochasticLayerNormLSTMCell(nn.Module):
    """flax's ``StochasticLayerNormLSTMCell`` (``sln_lstm``) on the carry
    (h, c) and the noise eps [B, eps_size]. Each of its three
    normalizations (``ln_ih`` of the input projection, ``ln_hh`` of ``hh``
    (H -> 4H, with bias), ``ln_ho`` of the new cell state) is
    (x - mean) / (std + 1e-5) (eps G) + eps B over the last axis, std
    unbiased, with the gain G and bias B [eps_size, nf] (float32 leaves
    ``{name}_gain``, ``{name}_bias``, ones and zeros) cast to x's type.
    The gates are ln_ih + ln_hh; c' = sigmoid(f) c + sigmoid(i) tanh(g),
    h' = sigmoid(o) tanh(ln_ho(c'))."""

    def __init__(self, hidden: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None,
                 eps_size: int = 16):
        super().__init__()
        self.hidden = hidden
        self.hh = Dense(hidden, 4 * hidden, dtype, generator)
        for name, nf in (("ln_ih", 4 * hidden), ("ln_hh", 4 * hidden),
                         ("ln_ho", hidden)):
            self.register_parameter(f"{name}_gain",
                                    nn.Parameter(torch.ones(eps_size, nf)))
            self.register_parameter(f"{name}_bias",
                                    nn.Parameter(torch.zeros(eps_size, nf)))

    def _sln(self, x, eps, name):
        g, b = getattr(self, f"{name}_gain"), getattr(self, f"{name}_bias")
        mean = x.mean(-1, keepdim=True)
        std = x.std(-1, keepdim=True, correction=1)
        return (x - mean) / (std + 1e-5) * (eps @ g.to(x.dtype)) \
            + eps @ b.to(x.dtype)

    def forward(self, carry, x_proj, eps):
        h, c = carry
        gates = self._sln(x_proj, eps, "ln_ih") \
            + self._sln(self.hh(h), eps, "ln_hh")
        i, f, g, o = gates.split(self.hidden, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(
            self._sln(c_new, eps, "ln_ho")), c_new


class SRUCell(nn.Module):
    """flax's ``SRUCell``: x-only gates f, r = sigmoid(gate_ln(x_proj[H:]))
    (LayerNorm over 2H), the elementwise recurrence c' = f c + (1 - f) x~
    (x~ = x_proj[:H]) and the highway output y = r sigmoid(act_ln(c'))
    + (1 - r) x, with x the raw input where its width is H, else x~.
    Called as (c, x_proj, x) -> (c', y): the carry is not the output, and
    ``RNNLayer`` hands it the raw input (``needs_raw_x``). Under the BF16
    policy the LayerNorms' float32 results change the carry's type, and
    ``RNNLayer`` refuses the cell (``f32_carry``), as JAX's scan does."""

    needs_raw_x = True
    f32_carry = True

    def __init__(self, hidden: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = hidden
        self.gate_ln = LayerNorm(2 * hidden)
        self.act_ln = LayerNorm(hidden)

    def forward(self, c, x_proj, x):
        H = self.hidden
        x_tilde = x_proj[..., :H]
        gate = torch.sigmoid(self.gate_ln(x_proj[..., H:]))
        f, r = gate[..., :H], gate[..., H:]
        c_new = f * c + (1.0 - f) * x_tilde
        resid = x if x.shape[-1] == H else x_tilde
        return c_new, r * torch.sigmoid(self.act_ln(c_new)) \
            + (1.0 - r) * resid


# the cells of JAX's CELL_TYPES: (class, input-projection width in units of
# hidden, whether it steps with per-level noise)
CELLS = {"gru": (GRUCell, 3, False), "lstm": (LSTMCell, 4, False),
         "ln_lstm": (LayerNormLSTMCell, 4, False), "sru": (SRUCell, 3, False),
         "sgru": (StochasticGRUCell, 3, True),
         "slstm": (StochasticLSTMCell, 5, True),
         "sln_lstm": (StochasticLayerNormLSTMCell, 4, True)}


def needs_cell_state(kind: str) -> bool:
    """JAX's ``needs_cell_state``: the cells whose carry ``RNNAutoreg``
    builds as (h, c). Like JAX's it leaves out ``sln_lstm``, whose cell
    unpacks an (h, c) carry all the same (climsim_tpu/models/cells.py:
    250-251, :119)."""
    return kind in ("lstm", "ln_lstm", "slstm")


class RNNLayer(nn.Module):
    """One directional RNN over the level axis: the hoisted input projection
    ``input_proj`` and the cell ``cell`` stepped level by level (JAX's
    ``nn.scan``). Input [B, L, nx] -> (outputs [B, L, hidden], final carry).
    ``reverse=True`` steps from the last level (the surface, since TOA is
    level 0) upward. The carry (a tuple (h, c) where the caller gives one)
    is cast to the projection's dtype, as JAX unifies it for its scan; a
    cell whose step returns a float32 carry (``f32_carry``: its
    LayerNorms') under a narrower dtype raises ``TypeError`` at
    construction, where JAX's scan raises at trace. The stochastic cells (``sgru``, ``slstm``,
    ``sln_lstm``; ``noise=True``) take ``eps`` [L, B, width], level l's
    noise stepping with level l (width ``hidden``, or ``eps_size`` for
    ``sln_lstm``); SRU sees the raw input beside its projection."""

    def __init__(self, nx: int, hidden: int, kind: str = "gru",
                 reverse: bool = False, noise: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 eps_size: int = 16):
        super().__init__()
        if kind not in CELLS:
            raise ValueError(f"RNNLayer kind={kind!r} is not a cell "
                             f"({' | '.join(CELLS)})")
        cell_cls, width, stochastic = CELLS[kind]
        if noise != stochastic:
            raise ValueError(f"RNNLayer kind={kind!r} takes noise="
                             f"{stochastic}")
        if getattr(cell_cls, "f32_carry", False) and \
                torch.promote_types(dtype, torch.float32) != dtype:
            raise TypeError(
                f"the {cell_cls.__name__} step turns the {dtype} carry into "
                "float32 (its LayerNorms'): JAX's scan refuses a carry that "
                "changes type")
        self.reverse = reverse
        self.noise = noise
        self.raw_x = getattr(cell_cls, "needs_raw_x", False)
        self.input_proj = Dense(nx, width * hidden, dtype, generator)
        kw = {"eps_size": eps_size} if kind == "sln_lstm" else {}
        self.cell = cell_cls(hidden, dtype, generator, **kw)

    def forward(self, xs, h0, eps=None):
        xs_proj = self.input_proj(xs)                  # [B, L, kH]
        dt = xs_proj.dtype
        carry = tuple(a.to(dt) for a in h0) if isinstance(h0, tuple) \
            else h0.to(dt)
        if self.noise and eps is None:
            raise ValueError("a stochastic cell needs eps [L, B, width]")
        # one unbind, whose backward is one stack: a select per level would
        # add a whole zero [B, L, 3H] gradient per level in the backward
        levels = xs_proj.unbind(1)
        extra = eps.to(dt).unbind(0) if self.noise \
            else xs.to(dt).unbind(1) if self.raw_x else None
        L = len(levels)
        ys = [None] * L
        for l in (range(L - 1, -1, -1) if self.reverse else range(L)):
            if extra is None:
                new = self.cell(carry, levels[l])
            else:
                new = self.cell(carry, levels[l], extra[l])
            if self.raw_x:
                new, ys[l] = new
            else:
                ys[l] = new[0] if isinstance(new, tuple) else new
            carry = new
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
    it. ``acc32=False`` runs a bf16 input's gates in bf16 (the kernel's
    bf16-gate mode).
    """

    def __init__(self, nx: int, hidden: int, acc32: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        H = hidden
        self.hidden = H
        self.acc32 = acc32
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
            self.bin2.to(dt), self.whh_dn.to(dt), self.bhh_dn.to(dt),
            acc32=self.acc32)
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
    reproduces; ``acc32=False`` runs a bf16 input's gates in bf16 (the
    kernels' bf16-gate mode).
    """

    def __init__(self, nx: int, nm_in: int, hidden: int, nh_mem: int,
                 ny: int, init_width: int = 0, level_major: bool = False,
                 hoist_proj: bool = True, acc32: bool = True,
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
        self.acc32 = acc32
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
                *args[:4], tw(self.w_init), tb(self.b_init), *args[4:],
                acc32=self.acc32)
        else:
            outmem, lasth = fused_bigru_heads_cm(*args,
                                                 hoist_proj=self.hoist_proj,
                                                 acc32=self.acc32)
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
                lm(x), lm(mem), *h0, w(self.w_init), w(self.b_init), *wargs,
                acc32=self.acc32)
        else:
            out, mem_o, lasth = fused_bigru_heads_lbh(lm(x), *h0, *wargs,
                                                      acc32=self.acc32)
        bm = lambda t: t.transpose(0, 1).contiguous()
        return bm(out), bm(mem_o), lasth


class GLU(nn.Module):
    """flax's ``GLU`` block: with ``block`` the optional LayerNorm ``norm``
    over the level and feature axes together (its scale and bias [L,
    features]), the exact (erf) GELU, the Dense ``expand`` (features ->
    expand_factor features) and the gated split a sigmoid(b); without,
    the gate alone from two Dense layers ``lin`` and ``gate``. x [B, L,
    features] (with ``block``: ``levels`` = L). Dropout is JAX's default
    ``deterministic=True`` path, the identity; float32 parameters and
    compute, as flax's Dense without a dtype."""

    def __init__(self, features: int, block: bool = False,
                 layernorm: bool = True, expand_factor: int = 2,
                 levels: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.block, self.layernorm = block, layernorm
        f32 = torch.float32
        if block:
            if layernorm:
                if levels is None:
                    raise ValueError("GLU(block=True, layernorm=True) needs "
                                     "the level count for its [L, features] "
                                     "LayerNorm")
                self.norm = LayerNorm((levels, features))
            self.expand = Dense(features, expand_factor * features, f32,
                                generator)
        else:
            self.lin = Dense(features, features, f32, generator)
            self.gate = Dense(features, features, f32, generator)

    def forward(self, x):
        if not self.block:
            return self.lin(x) * torch.sigmoid(self.gate(x))
        if self.layernorm:
            x = self.norm(x)
        h = self.expand(nn.functional.gelu(x, approximate="none"))
        a, b = h.chunk(2, dim=-1)
        return a * torch.sigmoid(b)


class QRNNLayer(nn.Module):
    """flax's ``QRNNLayer``: a convolution over the level axis (``conv``,
    kernel [kernel, nx, 3H] and bias [3H] as flax's ``nn.Conv``; causal,
    padded on the side the sweep comes from, or centred as flax's "SAME")
    gives the gate streams z, f, o (z sigmoid or tanh, f and o sigmoid),
    and the only recurrence is the fo-pooling c_l = f_l c_{l-1} +
    (1 - f_l) z_l, h_l = o_l c_l, stepped one level at a time or, with
    ``assoc``, as a parallel prefix over the affine maps c -> f c + g
    (log2 L whole-tensor steps; JAX's ``associative_scan``, so the sums
    associate differently). x [B, L, nx], c0 [B, H] or None ->
    (h [B, L, H], c_last [B, H]) in the compute dtype."""

    def __init__(self, nx: int, hidden: int, kernel: int = 2,
                 causal: bool = True, reverse: bool = False,
                 z_activation: str = "sigmoid", assoc: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if z_activation not in ("sigmoid", "tanh"):
            raise ValueError(f"z_activation={z_activation!r} "
                             "(sigmoid | tanh)")
        self.hidden, self.k = hidden, kernel
        self.causal, self.reverse, self.assoc = causal, reverse, assoc
        self.z_act = torch.sigmoid if z_activation == "sigmoid" \
            else torch.tanh
        self.dtype = dtype
        self.conv = nn.Module()
        self.conv.kernel = flax_param((kernel, nx, 3 * hidden), None)
        if generator is not None:
            lecun_normal_(self.conv.kernel, kernel * nx, generator)
        self.conv.bias = flax_param((3 * hidden,), None)

    def forward(self, x, c0=None):
        dt, K = self.dtype, self.k
        B, L, _ = x.shape
        if self.causal:
            lo, hi = (0, K - 1) if self.reverse else (K - 1, 0)
        else:
            lo = (K - 1) // 2
            hi = K - 1 - lo
        xp = nn.functional.pad(x.to(dt), (0, 0, lo, hi))
        # the convolution accumulates in float32 and rounds once, then
        # takes its bias in dt, as flax's Conv (conv, then + bias)
        w = self.conv.kernel.to(dt).float()
        conv = sum(torch.matmul(xp[:, j:j + L].float(), w[j])
                   for j in range(K))
        gates = conv.to(dt) + self.conv.bias.to(dt)
        z, f, o = gates.transpose(0, 1).split(self.hidden, dim=-1)
        z, f, o = self.z_act(z), torch.sigmoid(f), torch.sigmoid(o)
        c0 = gates.new_zeros((B, self.hidden)) if c0 is None else c0.to(dt)
        if self.assoc:
            cs = self._prefix(f, (1.0 - f) * z, c0)
            c_last = cs[0] if self.reverse else cs[-1]
        else:
            cs = [None] * L
            c = c0
            for l in (range(L - 1, -1, -1) if self.reverse else range(L)):
                c = f[l] * c + (1.0 - f[l]) * z[l]
                cs[l] = c
            c_last = c
            cs = torch.stack(cs)
        return (o * cs).transpose(0, 1), c_last

    def _prefix(self, f, g, c0):
        """c_l = F_l c0 + G_l with (F, G) the inclusive prefix of the maps
        (f_l, g_l) under (fa, ga) then (fb, gb) = (fa fb, gb + fb ga), in
        the sweep's direction, by doubling steps."""
        if self.reverse:
            f, g = f.flip(0), g.flip(0)
        F, G = f, g
        d = 1
        while d < F.shape[0]:
            Fn, Gn = F.clone(), G.clone()
            Fn[d:] = F[:-d] * F[d:]
            Gn[d:] = G[d:] + F[d:] * G[:-d]
            F, G = Fn, Gn
            d *= 2
        cs = F * c0[None] + G
        return cs.flip(0) if self.reverse else cs
