"""Autoregressive bidirectional vertical RNN with latent convective memory
(counterpart of ``climsim_tpu/models/rnn.py::RNNAutoreg``).

Six trunks of the gru cell are ported, each on the flax parameter tree of
the JAX model with the same flags:

* v6, channel-major (``use_pallas=fuse_heads=fuse_init=level_major=True``):
  the initial MLP, both sweeps and the heads in one kernel (B1);
* v5, channel-major (the same with ``fuse_init=False``): the initial MLP
  as a channel Dense + tanh, then the sweeps and heads in one kernel (B4)
  with the memory as a separate input;
* v4, batch-major (``use_pallas=fuse_heads=fuse_init=True``,
  ``level_major=False``): v6's work on [B, L, C] activations in one kernel
  (B10), the memory a separate input;
* v3, batch-major (the same with ``fuse_init=False``): the initial MLP as
  a Dense + tanh and the memory concat in the model, then the up
  projection, both sweeps and the heads in one kernel (B9);
* v2, batch-major (``use_pallas=True``, ``fuse_heads=False``): the initial
  MLP and the memory concat, the fused BiGRU (B7), then the latent and
  output heads as Dense layers;
* the scan (``use_pallas=False``): the same with two ``RNNLayer`` sweeps
  (``rnn_up`` from the surface, ``rnn_down``) in place of the kernel.

``add_pres`` (the normalized sqrt-pressure feature from ``hyam``,
``hybm``, ``sp_mean``, ``sp_div``) works in both layouts. Step contract,
channel-major:

    (x_main [L, nx, B], x_sfc [B, nx_sfc], mem [L, nh_mem, B])
        -> (out [L, ny, B], out_sfc [B, ny_sfc], new_mem [L, nh_mem, B])

and batch-major ``x_main [B, L, nx]``, ``mem`` and the outputs
``[B, L, .]``.

``add_stochastic_layer`` adds JAX's stochastic third sweep ``rnn_stoch``
(an ``RNNLayer`` of the ``sgru`` or ``slstm`` cell, TOA -> surface, from
a zero carry) on the down sweep's output, driven by per-level noise
``eps [L, B, nneur[-1]]`` (one level's draw shared by every level with
``ar_noise_vertical=False``); as in JAX a stochastic model always runs
the scan trunk. With ``ar_noise_rho > 0`` the noise is AR(1) in time,
``eps = rho * eps_prev + sqrt(1 - rho^2) * fresh``, and the forward
returns ``eps`` as a fourth output.

The scan trunk takes every cell of JAX's trunk (``cell``: gru, lstm,
ln_lstm, sru; lstm and ln_lstm start their cell states from the Dense
layers ``mlp_surface2`` and ``mlp_toa2``), and ``cell="qrnn"`` runs two
``QRNNLayer`` sweeps; none reaches a kernel, as in JAX.
``use_memory=False`` (the yaml's ``memory: None``) feeds no memory and
passes ``mem`` through; ``separate_radiation`` runs the CRM trunk on the
bottom levels without the gases and adds the radiation BiGRU on every
level (``_radiation``).
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Sequence

import torch
from torch import nn

from ..ops import resolve_device
from .cells import (Dense, FusedBiGRUHeadsLayer, FusedBiGRULayer, QRNNLayer,
                    RNNLayer, flax_param, needs_cell_state)
from .common import Policy, F32

__all__ = ["RNNAutoreg", "Dense", "ChannelDense", "params_unfused_to_fused",
           "params_fused_to_unfused", "temperature_scaling",
           "temperature_scaling_precip", "postprocess_mp", "DT", "INV_DT"]

DT = 1200.0
INV_DT = 1.0 / DT


class ChannelDense(nn.Module):
    """Dense over the channel axis of [L, C, B] activations with
    ``nn.Dense``'s parameters (``kernel`` [C, F], ``bias`` [F]), JAX's
    ``_ChannelDense``: x [L, C, B] -> [L, F, B] in ``dtype``, produced
    contiguous (one batched product, no permuted einsum result)."""

    def __init__(self, nin: int, nout: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = flax_param((nin, nout), generator)
        self.bias = flax_param((nout,), generator)

    def forward(self, x):
        dt = self.dtype
        return torch.matmul(self.kernel.to(dt).t(), x.to(dt)) \
            + self.bias.to(dt)[:, None]


# the arms whose fused layer evaluates the initial MLP inside its kernel
_INIT_INSIDE = ("v6", "v4")
# the trunk cells of JAX's RNNAutoreg (rnn.py:74, :254)
TRUNK_CELLS = ("gru", "lstm", "ln_lstm", "sru", "qrnn")
# the radiation BiGRU's width (rnn.py:349)
NH_RAD = 96
# JAX's RNNAutoreg cannot run this option: its needs_cell_state leaves out
# sln_lstm, so the stochastic layer's carry is a bare array, which the
# cell unpacks as (h, c); the port refuses it at construction
SLN_LSTM_FAULT = (
    "stochastic_cell='sln_lstm' fails in JAX's RNNAutoreg (its carry is a "
    "bare array, climsim_tpu/models/rnn.py:312-313, which the cell unpacks "
    "as h, c = carry at climsim_tpu/models/cells.py:119), so the port "
    "refuses it; RNNLayer(kind='sln_lstm', noise=True) with an (h, c) "
    "carry runs the cell")


class RNNAutoreg(nn.Module):
    """Bi-directional vertical RNN emulator with latent convective memory.
    Keyword names and defaults follow the flax module, every field of it.
    ``arm`` says which trunk the flags selected ("v6", "v5", "v4", "v3",
    "v2", "qrnn" or "scan").

    ``device=None`` means ``"cuda"`` (and raises without a CUDA device);
    parameters get flax's init (lecun-normal kernels, zero biases) from a
    ``torch.Generator`` seeded with ``seed``.

    The stochastic layer's fresh draw comes in through ``forward``'s
    ``noise``: a ``torch.Generator`` on the model's device, or the
    standard-normal draw [Le, B, nneur[-1]] itself (Le = L, or 1 with
    ``ar_noise_vertical=False``). Nothing is drawn from the global RNG.

    ``pallas_acc32=False`` runs the fused arms' gates in bf16 under the
    BF16 policy (the kernels' bf16-gate mode). ``pallas_block_b`` (the TPU
    kernels' column tile) and ``scan_unroll`` (the level scan's unroll
    factor) change no result in JAX and are accepted and unused here: the
    port's plans pick their own tiles, and its sweeps step one level at a
    time. ``stochastic_cell='sln_lstm'`` raises ``ValueError``, because
    JAX's model cannot run it (see ``SLN_LSTM_FAULT``).
    """

    def __init__(self, nx: int, nx_sfc: int, ny: int, ny_sfc: int,
                 nneur: Sequence[int] = (192, 192), nh_mem: int = 16,
                 use_memory: bool = True, cell: str = "gru",
                 use_initial_mlp: bool = True, add_pres: bool = True,
                 output_prune: bool = True,
                 separate_radiation: bool = False,
                 add_stochastic_layer: bool = False,
                 stochastic_cell: str = "sgru",
                 use_pallas: bool = False, pallas_acc32: bool = True,
                 fuse_heads: bool = False, fuse_init: bool = False,
                 pallas_hoist_proj: bool = True, level_major: bool = False,
                 pallas_block_b: int | None = None,
                 ar_noise_rho: float = 0.0, ar_noise_vertical: bool = True,
                 hyam: Sequence[float] = (), hybm: Sequence[float] = (),
                 sp_mean: float = 0.0, sp_div: float = 1.0,
                 scan_unroll: int = 1,
                 policy: Policy = F32, device=None, seed: int = 0):
        super().__init__()
        nh1, nh2, nh3 = nneur[0], nneur[1], nneur[-1]
        if cell not in TRUNK_CELLS:
            raise ValueError(f"cell={cell!r} is not a trunk cell "
                             f"({' | '.join(TRUNK_CELLS)})")
        if add_stochastic_layer:
            if stochastic_cell == "sln_lstm":
                raise ValueError(SLN_LSTM_FAULT)
            if stochastic_cell not in ("sgru", "slstm"):
                raise ValueError(f"stochastic_cell={stochastic_cell!r} is "
                                 "not a stochastic cell (sgru | slstm | "
                                 "sln_lstm)")
        # the JAX model's choice of trunk (rnn.py:196-290): a stochastic
        # model runs the scan, whatever use_pallas says
        gru_kernel = use_pallas and cell == "gru" and nh1 == nh2 \
            and not add_stochastic_layer
        fused_heads = gru_kernel and fuse_heads and use_memory \
            and nh_mem != nh2 and not separate_radiation
        if level_major and not fused_heads:
            raise ValueError("level_major requires the fused-heads path "
                             "(use_pallas + fuse_heads with gru cell)")
        if fused_heads:
            init_inside = use_initial_mlp and fuse_init
            self.arm = {(True, True): "v6", (True, False): "v5",
                        (False, True): "v4",
                        (False, False): "v3"}[level_major, init_inside]
        else:
            self.arm = "v2" if gru_kernel else \
                "qrnn" if cell == "qrnn" else "scan"
        self.device = resolve_device(device)
        self.cell = cell
        self.use_memory = use_memory
        self.separate_radiation = separate_radiation
        self.add_stochastic_layer = add_stochastic_layer
        self.stochastic_cell = stochastic_cell
        self.ar_noise_rho = float(ar_noise_rho)
        self.ar_noise_vertical = ar_noise_vertical
        self.nneur = tuple(nneur)
        self.ny, self.ny_sfc, self.nh_mem = ny, ny_sfc, nh_mem
        self.level_major = level_major
        self.use_initial_mlp = use_initial_mlp
        self.add_pres = add_pres
        self.sp_mean, self.sp_div = sp_mean, sp_div
        self.output_prune = output_prune
        self.policy = policy
        # the hybrid coefficients as given (float64), rounded once to the
        # compute dtype at call; buffers outside the state_dict, so the
        # flax parameter tree maps one to one
        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
        self.register_buffer("hyam", f64(hyam), persistent=False)
        self.register_buffer("hybm", f64(hybm), persistent=False)
        g = torch.Generator().manual_seed(seed)
        cdt = policy.compute_dtype
        nx_in = nx + (1 if add_pres else 0)
        # separate radiation: the CRM trunk sees the level inputs without
        # the three gases and the surface inputs without the six radiative
        # ones (rnn.py:184-194)
        nx_crm = nx_in - 3 if separate_radiation else nx_in
        nx_sfc_crm = nx_sfc - 6 if separate_radiation else nx_sfc
        nh_in = nh1 if use_initial_mlp else nx_crm
        nm_cat = nh_mem if use_memory else 0
        # creation order = flax's module order (init streams differ from
        # JAX's anyway; from_flax_params carries JAX weights across)
        if use_initial_mlp and self.arm not in _INIT_INSIDE:
            dense = ChannelDense if level_major else Dense
            self.mlp_initial = dense(nx_crm, nh1, cdt, g)
        self.mlp_surface1 = Dense(nx_sfc_crm, nh1, cdt, g)
        self.mlp_toa1 = Dense(2, nh2, cdt, g)
        if self.arm in _INIT_INSIDE:
            self.bigru_fused = FusedBiGRUHeadsLayer(
                nx_in, nh_mem, nh1, nh_mem, ny, init_width=nh1,
                level_major=level_major, acc32=pallas_acc32, generator=g)
        elif self.arm == "v5":
            self.bigru_fused = FusedBiGRUHeadsLayer(
                nh_in, nh_mem, nh1, nh_mem, ny, level_major=True,
                hoist_proj=pallas_hoist_proj, acc32=pallas_acc32,
                generator=g)
        elif self.arm == "v3":
            # the memory is concatenated by the model, as JAX's
            # batch-major v3 (rnn.py:218-247)
            self.bigru_fused = FusedBiGRUHeadsLayer(
                nh_in + nh_mem, 0, nh1, nh_mem, ny, level_major=False,
                acc32=pallas_acc32, generator=g)
        elif self.arm == "v2":
            self.bigru_fused = FusedBiGRULayer(nh_in + nm_cat, nh1,
                                               acc32=pallas_acc32,
                                               generator=g)
        elif self.arm == "qrnn":
            self.rnn_up = QRNNLayer(nh_in + nm_cat, nh1, reverse=True,
                                    dtype=cdt, generator=g)
            self.rnn_down = QRNNLayer(nh1, nh2, dtype=cdt, generator=g)
        else:
            if needs_cell_state(cell):
                self.mlp_surface2 = Dense(nx_sfc_crm, nh1, cdt, g)
            self.rnn_up = RNNLayer(nh_in + nm_cat, nh1, cell, reverse=True,
                                   dtype=cdt, generator=g)
            if needs_cell_state(cell):
                self.mlp_toa2 = Dense(2, nh2, cdt, g)
            self.rnn_down = RNNLayer(nh1, nh2, cell, dtype=cdt, generator=g)
        if add_stochastic_layer:
            self.rnn_stoch = RNNLayer(nh2, nh3, stochastic_cell, noise=True,
                                      dtype=cdt, generator=g)
        if self.arm in ("v2", "qrnn", "scan"):
            # the latent head exists only when the memory width differs
            # from the last RNN's (rnn.py:326-337); without memory the
            # output head reads the RNN stream
            nh_last = nh3 if add_stochastic_layer else nh2
            self.mlp_latent = Dense(nh_last, nh_mem, cdt, g) \
                if use_memory and nh_mem != nh_last else None
            self.mlp_output = Dense(nh_mem if use_memory else nh_last, ny,
                                    cdt, g)
        self.mlp_surface_output = Dense(
            nh2, 2 if separate_radiation else ny_sfc, cdt, g)
        if separate_radiation:
            # the radiation BiGRU on every level (rnn.py:361-393): its
            # Dense layers in the compute dtype, its sweeps in float32
            # (JAX's RNNLayer without a dtype promotes to the float32
            # parameters)
            f32 = torch.float32
            self.mlp_surface_rad = Dense(6, NH_RAD, cdt, g)
            self.rnn1_rad = RNNLayer(3 + nh_mem, NH_RAD, reverse=True,
                                     dtype=f32, generator=g)
            self.mlp_toa_rad = Dense(2, NH_RAD, cdt, g)
            self.rnn2_rad = RNNLayer(NH_RAD, NH_RAD, dtype=f32, generator=g)
            self.mlp_output_rad = Dense(NH_RAD, 1, cdt, g)
            self.mlp_surface_output_rad = Dense(NH_RAD, ny_sfc - 2, cdt, g)
        self.to(self.device)

    def forward(self, x_main, x_sfc, mem, deterministic: bool = True,
                eps_prev=None, noise=None):
        """One step; ``deterministic``, ``eps_prev`` and ``noise`` drive
        the stochastic layer (see the class) and are ignored without
        it. With ``use_memory=False`` ``mem`` passes through as the third
        output; with ``separate_radiation`` it covers the CRM's bottom
        levels (fewer than x_main's), as the new memory does."""
        lm = self.level_major
        L = x_main.shape[0] if lm else x_main.shape[1]
        pol = self.policy
        x_main = pol.cast_in(x_main)
        x_sfc = pol.cast_in(x_sfc)
        mem = pol.cast_in(mem)
        if self.add_pres:
            # normalized sqrt-pressure feature, the last input channel
            sp = x_sfc[:, 0] * self.sp_div + self.sp_mean
            hyam = self.hyam.to(x_main.dtype)
            hybm = self.hybm.to(x_main.dtype)
            if lm:
                pres = hyam[:, None] * 1.0e5 + sp[None, :] * hybm[:, None]
                pres = torch.sqrt(pres) / 314.0
                x_main = torch.cat([x_main, pres[:, None, :]], dim=1)
            else:
                pres = hyam * 1.0e5 + sp[:, None] * hybm
                pres = torch.sqrt(pres) / 314.0
                x_main = torch.cat([x_main, pres[..., None]], dim=-1)
        x_sfc_crm, h = x_sfc, x_main
        if self.separate_radiation:
            # the CRM: no radiative surface inputs, no gases, the bottom
            # levels the memory covers (rnn.py:184-194)
            x_sfc_crm = torch.cat([x_sfc[:, 0:6], x_sfc[:, 12:]], dim=1)
            gases = x_main[:, :, 12:15]
            h = torch.cat([x_main[:, :, :12], x_main[:, :, 15:]],
                          dim=-1)[:, L - mem.shape[1]:, :]
        hx1 = torch.tanh(self.mlp_surface1(x_sfc_crm))
        # SOLIN and COSZRS (columns 1 and 6) as a strided view: a list
        # index would copy a host index tensor to the device every call
        x_toa = x_sfc[:, 1:7:5]
        hx2 = self.mlp_toa1(x_toa)
        if self.use_initial_mlp and self.arm not in _INIT_INSIDE:
            h = torch.tanh(self.mlp_initial(h))
        if self.arm in ("v6", "v5", "v4"):
            out, new_mem, last_h = self.bigru_fused(h, hx1, hx2, mem)
        elif self.arm == "v3":
            out, new_mem, last_h = self.bigru_fused(
                torch.cat([h, mem], dim=-1), hx1, hx2)
        else:
            if self.use_memory:
                h = torch.cat([h, mem], dim=-1)
            if self.arm == "v2":
                down_out, last_h = self.bigru_fused(h, hx1, hx2)
            elif self.arm == "qrnn":
                up_out, _ = self.rnn_up(h, hx1)
                down_out, last_h = self.rnn_down(up_out, hx2)
            else:
                cs = needs_cell_state(self.cell)
                carry1 = (hx1, self.mlp_surface2(x_sfc_crm)) if cs else hx1
                up_out, _ = self.rnn_up(h, carry1)
                carry2 = (hx2, self.mlp_toa2(x_toa)) if cs else hx2
                down_out, carry_dn = self.rnn_down(up_out, carry2)
                last_h = carry_dn[0] if cs else carry_dn
            eps_out = eps_prev
            if self.add_stochastic_layer:
                down_out, eps_out = self._stochastic(
                    down_out, deterministic, eps_prev, noise)
            if not self.use_memory:
                # memory None: the output head reads the RNN stream and
                # the memory passes through
                head_in, new_mem = down_out, mem
            else:
                head_in = new_mem = down_out if self.mlp_latent is None \
                    else self.mlp_latent(down_out)
            out = self.mlp_output(head_in)
        out_sfc = self.mlp_surface_output(last_h)
        if self.output_prune and not self.separate_radiation:
            # only dT is nonzero in the top 12 levels (rnn.py:348-356)
            if lm:
                mask = torch.ones((L, self.ny, 1), dtype=out.dtype,
                                  device=out.device)
                mask[:12, 1:, :] = 0.0
            else:
                mask = torch.ones((1, L, self.ny), dtype=out.dtype,
                                  device=out.device)
                mask[:, :12, 1:] = 0.0
            out = out * mask
        if self.separate_radiation:
            out, out_sfc = self._radiation(x_sfc, gases, new_mem, out,
                                           out_sfc)
        if self.add_stochastic_layer and self.ar_noise_rho > 0.0:
            return pol.cast_out(out), pol.cast_out(out_sfc), \
                pol.cast_out(new_mem), eps_out
        return pol.cast_out(out), pol.cast_out(out_sfc), \
            pol.cast_out(new_mem)

    def _radiation(self, x_sfc, gases, mem, out_crm, out_sfc_crm):
        """JAX's ``_radiation`` (rnn.py:361-393): the radiation BiGRU on
        every level from the gases and the CRM's memory (zero above the
        CRM's levels) adds its heating to the CRM's dT there and predicts
        the six radiative surface outputs; PRECSC and PRECC stay the
        CRM's."""
        L50, L = mem.shape[1], gases.shape[1]
        pad = L - L50 if L != L50 else 10
        above = lambda t: nn.functional.pad(t, (0, 0, pad, 0))
        x_rad = torch.cat([gases, above(mem)], dim=-1)
        hx = self.mlp_surface_rad(x_sfc[:, 6:12])
        up, _ = self.rnn1_rad(x_rad, hx)
        hx2 = self.mlp_toa_rad(x_sfc[:, 1:7:5])
        down, last_h = self.rnn2_rad(up, hx2)
        d_t_rad = self.mlp_output_rad(down)
        out_sfc_rad = self.mlp_surface_output_rad(last_h)
        out = above(out_crm)
        out = torch.cat([out[..., :1] + d_t_rad, out[..., 1:]], dim=-1)
        # [NETSW, FLWDS, PRECSC, PRECC, SOLS, SOLL, SOLSD, SOLLD]
        out_sfc = torch.cat([out_sfc_rad[:, 0:2], out_sfc_crm,
                             out_sfc_rad[:, 2:]], dim=1)
        return out, out_sfc

    def noise_shape(self, B: int, L: int) -> tuple:
        """The shape of the stochastic layer's draw for B columns of L
        levels: [Le, B, nneur[-1]]."""
        return (L if self.ar_noise_vertical else 1, B, self.nneur[-1])

    def _stochastic(self, down_out, deterministic, eps_prev, noise):
        """The stochastic third sweep (rnn.py:294-319): (its output
        [B, L, nneur[-1]], the noise it used, or ``eps_prev`` when
        deterministic)."""
        B, L = down_out.shape[0], down_out.shape[1]
        shape = self.noise_shape(B, L)
        dt = down_out.dtype
        if deterministic:
            eps = down_out.new_zeros(shape)
            eps_out = eps_prev
        else:
            if isinstance(noise, torch.Generator):
                fresh = torch.randn(shape, generator=noise, dtype=dt,
                                    device=down_out.device)
            elif isinstance(noise, torch.Tensor):
                if tuple(noise.shape) != shape:
                    raise ValueError(f"noise shape {tuple(noise.shape)}, "
                                     f"the layer draws {shape}")
                fresh = noise.to(dt)
            else:
                raise ValueError("a stochastic forward needs noise=: a "
                                 "torch.Generator on the model's device "
                                 f"or the standard-normal draw {shape}")
            rho = self.ar_noise_rho
            if rho > 0.0 and eps_prev is not None:
                eps = rho * eps_prev.to(dt) + (1.0 - rho * rho) ** 0.5 * fresh
            else:
                eps = fresh
            eps_out = eps
        h0 = down_out.new_zeros((B, self.nneur[-1]))
        carry = (h0, torch.zeros_like(h0)) \
            if needs_cell_state(self.stochastic_cell) else h0
        eps_lev = eps if self.ar_noise_vertical \
            else eps.expand(L, B, self.nneur[-1])
        out, _ = self.rnn_stoch(down_out, carry, eps_lev)
        return out, eps_out


# fused <-> unfused checkpoint conversion (rnn.py:407-450): ``fuse_heads``
# moves the latent/output heads (and with ``fuse_init`` the initial MLP)
# into the fused layer's ``bigru_fused`` subtree


def params_unfused_to_fused(params: Mapping, fuse_init: bool = False):
    """Remap a ``fuse_heads=False`` flax parameter tree (nested mappings)
    to the ``fuse_heads=True`` layout (optionally ``fuse_init=True``)."""
    wrapped = "params" in params
    inner = dict(params["params"]) if wrapped else dict(params)
    fused = dict(inner["bigru_fused"])
    lat = inner.pop("mlp_latent")
    out = inner.pop("mlp_output")
    fused["wlat"], fused["blat"] = lat["kernel"], lat["bias"]
    fused["wout"], fused["bout"] = out["kernel"], out["bias"]
    if fuse_init:
        ini = inner.pop("mlp_initial")
        fused["w_init"], fused["b_init"] = ini["kernel"], ini["bias"]
    inner["bigru_fused"] = fused
    return {"params": inner} if wrapped else inner


def params_fused_to_unfused(params: Mapping):
    """Inverse of :func:`params_unfused_to_fused` (the v3/v5 and the
    v4/v6 fused layouts)."""
    wrapped = "params" in params
    inner = dict(params["params"]) if wrapped else dict(params)
    fused = dict(inner["bigru_fused"])
    inner["mlp_latent"] = {"kernel": fused.pop("wlat"),
                           "bias": fused.pop("blat")}
    inner["mlp_output"] = {"kernel": fused.pop("wout"),
                           "bias": fused.pop("bout")}
    if "w_init" in fused:
        inner["mlp_initial"] = {"kernel": fused.pop("w_init"),
                                "bias": fused.pop("b_init")}
    inner["bigru_fused"] = fused
    return {"params": inner} if wrapped else inner


# microphysics postprocessing (Base_RNN_autoreg.postprocessing, :273-339)

def temperature_scaling(T_raw: torch.Tensor) -> torch.Tensor:
    """Liquid fraction ramp (T-253.16)*0.05 clamped to [0,1]
    (models.py:260-266)."""
    return torch.clamp((T_raw - 253.16) * 0.05, 0.0, 1.0)


def temperature_scaling_precip(t_sfc: torch.Tensor) -> torch.Tensor:
    """Snow fraction (283.3-T)/14.6 clamped to [0,1] (models.py:268-271)."""
    return torch.clamp((283.3 - t_sfc) / 14.6, 0.0, 1.0)


def postprocess_mp(out, out_sfc, x_denorm, yscale_lev, yscale_sca,
                   mp_mode: int = 0, qv_index: int = -1):
    """Un-scale outputs and re-split qn into (dqliq, dqice).

    out/out_sfc: scaled model outputs [B, L, ny], [B, ny_sfc].
    x_denorm:    raw (un-normalized) level inputs with T at channel 0,
                 qliq at 2, qice at 3 (v4 ordering).
    mp_mode semantics (models.py:200-227):
      0: passthrough un-scaling (6 raw tendency outputs)
      1: 5 outputs [dT, dqv, dqn, du, dv]; liq fraction diagnosed from T_new
     -1: 6 outputs [dT, dqv, dqn, liq_frac, du, dv]; predicted fraction
         clamped to +-0.2 of the T-diagnosed value (Hu et al. Fig 2b).
         (The reference contains a leftover line discarding the clamp,
         models.py:318-320; the documented clamped behavior is kept, as
         in the JAX package.)
     -2: [dT, dqtot, cld_water_frac, liq_frac, ...]: total-water split,
         qv read at channel ``qv_index`` of x_denorm (the last channel
         when negative).
    Returns raw-unit (out_denorm [B, L, 6], out_sfc_denorm).
    """
    out_denorm = out / yscale_lev
    out_sfc_denorm = out_sfc / yscale_sca
    if mp_mode == 0:
        return out_denorm, out_sfc_denorm

    T_old = x_denorm[:, :, 0:1]
    qliq_old = x_denorm[:, :, 2:3]
    qice_old = x_denorm[:, :, 3:4]
    qn_old = qliq_old + qice_old

    if mp_mode == -2:
        dqtot = out_denorm[:, :, 1:2]
        cwf = torch.clamp(torch.square(torch.square(out_denorm[:, :, 2:3])),
                          0.0, 1.0)
        qv_old = x_denorm[:, :, qv_index:qv_index + 1] if qv_index >= 0 \
            else x_denorm[:, :, -1:]
        qtot_old = qn_old + qv_old
        qtot_new = qtot_old + dqtot * DT
        qv_new = (1.0 - cwf) * qtot_new
        qn_new_tot = cwf * qtot_new
        dqv = (qv_new - qv_old) * INV_DT
        dqn = (qn_new_tot - qn_old) * INV_DT
        out_denorm = torch.cat([out_denorm[:, :, 0:1], dqv, dqn,
                                out_denorm[:, :, 3:]], dim=2)

    T_new = T_old + out_denorm[:, :, 0:1] * DT
    liq_frac = temperature_scaling(T_new)

    if mp_mode in (-1, -2):
        liq_frac_pred = out_denorm[:, :, 3:4]
        max_frac = torch.clamp(liq_frac + 0.2, max=1.0)
        min_frac = torch.clamp(liq_frac - 0.2, min=0.0)
        # jnp.clip(x, lo, hi) = min(max(x, lo), hi)
        liq_frac = torch.minimum(torch.maximum(liq_frac_pred, min_frac),
                                 max_frac)

    qn_new = qn_old + out_denorm[:, :, 2:3] * DT
    qliq_new = liq_frac * qn_new
    qice_new = (1.0 - liq_frac) * qn_new
    dqliq = (qliq_new - qliq_old) * INV_DT
    dqice = (qice_new - qice_old) * INV_DT

    rest = out_denorm[:, :, 4:] if mp_mode in (-1, -2) \
        else out_denorm[:, :, 3:]
    out_denorm = torch.cat([out_denorm[:, :, 0:2], dqliq, dqice, rest],
                           dim=2)
    return out_denorm, out_sfc_denorm
