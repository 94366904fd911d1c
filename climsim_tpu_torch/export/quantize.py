"""Int8 quantized serving path for the flagship emulator (counterpart of
``climsim_tpu/export/quantize.py``).

* :func:`quantize_params` — per-output-channel symmetric int8 weight
  quantization of every 2-D kernel in a parameter tree (biases and
  non-matmul parameters stay float).
* :func:`qdot` — dynamic per-tensor activation quantization + an
  int8 x int8 -> int32 product, rescaled to float.
* :class:`QuantGRUForward` — an int8 forward for the memory-BiGRU
  emulator's scan arm (JAX's parameter tree: ``rnn_up/input_proj``,
  ``rnn_up/cell/hh``, ...): hoisted input projections and the recurrent
  3H products all run int8; gates and carries stay float.

The products go through ``torch._int_mm`` (cuBLASLt's int8 GEMM on the
card, an exact int32 product on the CPU), as JAX leaves them to XLA's
``dot_general`` outside any Pallas kernel. The reference has no quantized
path (TorchScript fp32/amp only).
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["quantize_params", "qdot", "QuantGRUForward", "param_tree"]


def _quant_kernel(k: torch.Tensor):
    """Per-output-channel symmetric int8: k [in, out] -> (q int8, scale
    [out] f32)."""
    amax = torch.amax(torch.abs(k), dim=0)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def quantize_params(params):
    """Quantize every rank-2 'kernel' leaf of a nested mapping; returns a
    tree of {'q','scale'} dicts in place of kernels, other leaves
    unchanged."""
    def walk(p):
        if isinstance(p, Mapping):
            out = {}
            for k, v in p.items():
                if k == "kernel" and getattr(v, "ndim", 0) == 2:
                    q, s = _quant_kernel(v)
                    out[k] = {"q": q, "scale": s}
                else:
                    out[k] = walk(v)
            return out
        return p
    return walk(params)


def param_tree(module: torch.nn.Module) -> dict:
    """The module's parameters as a nested dict in flax's layout
    (``rnn_up.cell.hh.kernel`` -> tree['rnn_up']['cell']['hh']['kernel'])."""
    tree: dict = {}
    for name, t in module.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32. cuBLASLt's int8 GEMM
    (``torch._int_mm`` on the card) takes M > 16 and K, N multiples of 8;
    the operands are zero-padded up to that (K at least 16) on every
    device, which is exact in integers: padded rows and columns add
    zero products, and the result is cut back to [M, N]."""
    M, K = a.shape
    N = b.shape[1]
    Mp, Kp, Np = max(M, 17), max(_ceil(K, 8), 16), _ceil(N, 8)
    if (Mp, Kp) != (M, K):
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        b = torch.nn.functional.pad(b, (0, Np - N, 0, Kp - K))
    return torch._int_mm(a.contiguous(), b.contiguous())[:M, :N]


def qdot(x: torch.Tensor, qk: dict, bias=None) -> torch.Tensor:
    """Dynamic per-tensor activation int8 quantization + int8 matmul.

    x [..., in] float; qk {'q' int8 [in, out], 'scale' [out]}.
    """
    xmax = torch.clamp(torch.amax(torch.abs(x)), min=1e-12)
    xs = xmax / 127.0
    xq = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)
    q = qk["q"]
    acc = _int_mm(xq.reshape(-1, q.shape[0]), q) \
        .reshape(*x.shape[:-1], q.shape[1])
    out = acc.float() * (xs * qk["scale"])
    if bias is not None:
        out = out + bias
    return out


class QuantGRUForward:
    """Int8 forward of the port's scan-arm ``RNNAutoreg`` (gru cell, no
    stochastic layer or separate radiation), on its parameter tree.
    Mirrors the model's compute graph; all big products go through
    :func:`qdot`. Call under any grad mode; nothing is differentiated."""

    def __init__(self, model):
        if getattr(model, "arm", None) != "scan":
            raise ValueError(f"QuantGRUForward takes the scan arm of "
                             f"RNNAutoreg, not {getattr(model, 'arm', None)}")
        self.model = model
        self.p = param_tree(model)
        self.qp = quantize_params(self.p)

    def _dense_path(self, path, x):
        node_q, node_p = self.qp, self.p
        for k in path:
            node_q, node_p = node_q[k], node_p[k]
        return qdot(x, node_q["kernel"], node_p.get("bias"))

    def _dense(self, name, x):
        return self._dense_path((name,), x)

    def _gru_sweep(self, layer, xs, h0, reverse):
        """Hoisted int8 input projection + the int8 recurrent GRU level by
        level (JAX's lax.scan)."""
        proj = self._dense_path((layer, "input_proj"), xs)
        whh = self.qp[layer]["cell"]["hh"]["kernel"]
        bhh = self.p[layer]["cell"]["hh"].get("bias")
        h = h0
        L = proj.shape[1]
        hs = [None] * L
        for l in (range(L - 1, -1, -1) if reverse else range(L)):
            hh = qdot(h, whh, bhh)
            rx, zx, nx_ = torch.chunk(proj[:, l], 3, dim=-1)
            rh, zh, nh_ = torch.chunk(hh, 3, dim=-1)
            r = torch.sigmoid(rx + rh)
            z = torch.sigmoid(zx + zh)
            n = torch.tanh(nx_ + r * nh_)
            h = (1.0 - z) * n + z * h
            hs[l] = h
        return torch.stack(hs, dim=1), h

    @torch.no_grad()
    def __call__(self, x_main, x_sfc, mem):
        m = self.model
        L = x_main.shape[1]
        feats = x_main
        if m.add_pres:
            hyam = m.hyam.to(x_main.dtype)
            hybm = m.hybm.to(x_main.dtype)
            sp = x_sfc[:, 0] * m.sp_div + m.sp_mean
            pres = 1e5 * hyam + sp[:, None] * hybm
            feats = torch.cat([feats, (torch.sqrt(pres) / 314.0)[..., None]],
                              dim=-1)
        h = torch.tanh(self._dense("mlp_initial", feats)) \
            if m.use_initial_mlp else feats
        h = torch.cat([h, mem], dim=-1)
        hx1 = torch.tanh(self._dense("mlp_surface1", x_sfc))
        up, _ = self._gru_sweep("rnn_up", h, hx1, reverse=True)
        x_toa = torch.cat([x_sfc[:, 1:2], x_sfc[:, 6:7]], dim=1)
        hx2 = self._dense("mlp_toa1", x_toa)
        down, last_h = self._gru_sweep("rnn_down", up, hx2, reverse=False)
        new_mem = self._dense("mlp_latent", down) if "mlp_latent" in self.p \
            else down
        out = self._dense("mlp_output", new_mem)
        out_sfc = self._dense("mlp_surface_output", last_h)
        if m.output_prune:
            mask = np.ones((1, L, m.ny), np.float32)
            mask[:, :12, 1:] = 0.0
            out = out * torch.as_tensor(mask, dtype=out.dtype,
                                        device=out.device)
        return out, out_sfc, new_mem
