"""RRTMGP-NN gas optics: schema-faithful weight loading, fabrication, and
the frozen-base / retrained-reduction training flow (counterpart of
``climsim_tpu/models/rrtmgp.py``).

The reference rebuilds frozen gas-optics MLPs from netCDF weight files and
optionally retrains ONLY a replacement output layer that reduces the native
128 (LW) / 112 (SW) g-points to a smaller custom-band set, with Slingo-band
mapping and solar-source band weights (rnn/utils.py:314-645
``mlp_gasopt_inlined_processing`` / ``load_gas_optics_model``;
rnn/layers.py:170-281 ``gasopt_mlp``). The weight files are looked up
under ``reference/rnn/data`` of the checkout (``DEFAULT_LW``,
``DEFAULT_SW``); :func:`write_gas_optics_weights` fabricates files of the
same schema.

Schema (RRTMGP-NN convention, matching the reference loader
rnn/utils.py:616-645):
    nn_weights_1 [nx, nh], nn_weights_2 [nh, nh], nn_weights_3 [nh, ny]
    nn_bias_1 [nh], nn_bias_2 [nh], nn_bias_3 [ny]
    nn_input_coeffs_min / _max [nx]         (input normalization)
    nn_output_coeffs_mean / _std [ny or ng] (output de-scaling)
    nn_inputs: list of gas/feature names; 'cfc11' present => longwave
LW heads emit ny = 2*ng (tau || planck-fraction); SW emit ny = ng.

Files are read with ``io.read_netcdf`` and written with h5py, which is
imported only when a file is written (or an HDF5 file read).
"""
from __future__ import annotations

import os
import re
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops import resolve_device
from ..physics.radiation import pow4
from .cells import Dense

_REF_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "reference", "rnn", "data")
DEFAULT_LW = os.path.join(_REF_DATA,
                          "rrtmgp-data-lw-g128-210809_NN_GCM_NWP.nc")
DEFAULT_SW = os.path.join(
    _REF_DATA, "rrtmgp-data-sw-g112-210809_NN_GCM_NWP_absorption.nc")
DEFAULT_SW_RAY = os.path.join(
    _REF_DATA, "rrtmgp-data-sw-g112-210809_NN_GCM_NWP_rayleigh.nc")

# RRTMGP's 14 SW bands (physical constants of the correlated-k model;
# rnn/utils.py:521-523)
RRTMGP_WAVENUM_LOW = [820, 2680, 3250, 4000, 4650, 5150, 6150, 7700, 8050,
                      12850, 16000, 22650, 29000, 38000]
RRTMGP_WAVENUM_HIGH = [2680, 3250, 4000, 4650, 5150, 6150, 7700, 8050,
                       12850, 16000, 22650, 29000, 38000, 50000]
RRTMGP_GPT_BOUNDS = [0, 10, 18, 29, 37, 46, 56, 67, 71, 80, 89, 96, 102,
                     109, 112]

# Native RRTMGP SW solar source per g-point (W/m2; physical data of the
# correlated-k distribution, total ~1360.4 — rnn/norm_coefficients.py:148)
RRTMGP_SW_SOLAR_SOURCE = np.array([
    6.12496233e+00, 1.93416357e+00, 1.54202783e+00, 1.27604854e+00,
    1.40585101e+00, 1.16409123e+00, 7.08588421e-01, 2.38161907e-01,
    2.80633457e-02, 1.17647192e-02, 4.77236032e+00, 1.41260576e+00,
    1.27267337e+00, 1.10027778e+00, 9.01670992e-01, 6.75989628e-01,
    5.17114103e-01, 1.23600028e-01, 2.81340289e+00, 3.00515079e+00,
    5.66785860e+00, 2.44188213e+00, 2.09266114e+00, 1.71121204e+00,
    1.28693295e+00, 8.72636437e-01, 2.37112761e-01, 7.54697174e-02,
    1.25168161e-02, 1.40388412e+01, 2.73778558e+00, 2.34644890e+00,
    1.90880454e+00, 1.42339087e+00, 9.49046195e-01, 1.84368953e-01,
    1.53579384e-01, 1.25842094e+01, 2.71192098e+00, 2.37346220e+00,
    1.95650840e+00, 1.47565520e+00, 1.00127935e+00, 2.00756401e-01,
    1.24308534e-01, 4.75310981e-02, 2.67146435e+01, 7.31047630e+00,
    6.03680420e+00, 5.62099934e+00, 4.40638685e+00, 3.24467373e+00,
    2.19979000e+00, 5.95967412e-01, 1.87873006e-01, 3.18016969e-02,
    3.11399059e+01, 1.48087206e+01, 1.36782532e+01, 1.23425665e+01,
    1.07046766e+01, 8.77752304e+00, 6.60841894e+00, 4.48445177e+00,
    1.21470773e+00, 3.84841442e-01, 6.44010156e-02, 2.31922035e+01,
    1.04592717e+00, 3.37244779e-01, 4.99117821e-02, 1.98145676e+02,
    4.06918793e+01, 3.51424675e+01, 2.87645893e+01, 2.16718941e+01,
    1.47965593e+01, 2.95515990e+00, 1.83591473e+00, 7.06192613e-01,
    6.58608856e+01, 1.23497276e+02, 1.37219658e+01, 9.39462662e+00,
    1.87920797e+00, 6.74776673e-01, 4.97130632e-01, 3.21763933e-01,
    1.38897270e-01, 6.36205292e+01, 5.73208961e+01, 5.15562134e+01,
    4.37227135e+01, 6.95342178e+01, 2.47825108e+01, 3.38733940e+01,
    3.04849205e+01, 2.82836380e+01, 2.06528168e+01, 2.52860794e+01,
    9.46283913e+00, 1.57151060e+01, 1.47029314e+01, 1.06884203e+01,
    7.67680740e+00, 5.14239740e+00, 3.29607511e+00, 1.44944358e+00,
    2.80638266e+00, 6.16410017e-01, 6.90493107e-01, 1.48562384e+00,
], np.float64)


def available(path: str = DEFAULT_LW) -> bool:
    """True when the RRTMGP weight netCDF is present (absent or
    truncated-placeholder files are rejected; the schema is checked by
    :func:`read_gas_optics_schema`)."""
    try:
        return os.path.getsize(path) > 1 << 12
    except OSError:
        return False


# ----------------------------------------------------------------- schema IO

def write_gas_optics_weights(path: str, nx: int = 7, nh: int = 58,
                             ng: int = 112, lw: bool = False,
                             seed: int = 0,
                             inputs: Sequence[str] | None = None):
    """Fabricate an RRTMGP-NN-schema weight file (an HDF5 container, the
    netCDF4 flavor of the real files) from numpy's ``default_rng(seed)``,
    the same file the JAX package writes. Weight magnitudes follow the
    real models' regime: softsign activations, outputs y with
    tau = col_dry * (ystd*y + ymean)^8 staying O(1e-2..1e2) optical depth
    for col_dry ~ 1e2."""
    import h5py

    rng = np.random.default_rng(seed)
    ny = 2 * ng if lw else ng
    if inputs is None:
        inputs = (["tlay", "play", "h2o", "o3", "co2", "n2o", "ch4"]
                  if not lw else
                  ["tlay", "play", "h2o", "o3", "co2", "n2o", "ch4",
                   "cfc11", "cfc12"][:max(nx, 8)])
        inputs = list(inputs)[:nx]
        while len(inputs) < nx:
            inputs.append(f"gas{len(inputs)}")
        if lw and "cfc11" not in inputs:
            inputs[-1] = "cfc11"
    glorot = lambda nin, nout: rng.normal(
        0, np.sqrt(2.0 / (nin + nout)), (nin, nout)).astype(np.float32)
    with h5py.File(path, "w") as f:
        f["nn_weights_1"] = glorot(nx, nh)
        f["nn_weights_2"] = glorot(nh, nh)
        f["nn_weights_3"] = glorot(nh, ny)
        f["nn_bias_1"] = np.zeros(nh, np.float32)
        f["nn_bias_2"] = np.zeros(nh, np.float32)
        f["nn_bias_3"] = rng.normal(0, 0.05, ny).astype(np.float32)
        f["nn_input_coeffs_min"] = np.zeros(nx, np.float32)
        f["nn_input_coeffs_max"] = np.ones(nx, np.float32)
        f["nn_output_coeffs_mean"] = np.full(ng, 0.4, np.float32)
        f["nn_output_coeffs_std"] = np.full(ng, 0.1, np.float32)
        f["nn_inputs"] = np.asarray([s.encode() for s in inputs])
    return path


_NEED = ["nn_weights_1", "nn_weights_2", "nn_weights_3",
         "nn_bias_1", "nn_bias_2", "nn_bias_3",
         "nn_input_coeffs_min", "nn_input_coeffs_max",
         "nn_output_coeffs_mean", "nn_output_coeffs_std"]


def read_gas_optics_schema(path: str) -> dict | None:
    """Parse an RRTMGP-NN weight file into raw arrays and metadata; None
    when the file is unavailable or not of the schema."""
    if not available(path):
        return None
    from ..io import read_netcdf

    try:
        raw = read_netcdf(path)
    except Exception:
        return None       # truncated/garbage placeholder
    if any(k not in raw for k in _NEED):
        return None
    names = [s.decode() if isinstance(s, bytes) else str(s)
             for s in np.ravel(raw.get("nn_inputs", []))]
    lw = any("cfc11" in s for s in names)
    ny = raw["nn_weights_3"].shape[-1]
    out = {k: np.asarray(raw[k], np.float32) for k in _NEED}
    out.update(inputs=names, lw=lw, ny=int(ny),
               ng=int(ny // 2 if lw else ny),
               nx=int(raw["nn_weights_1"].shape[0]),
               nh=int(raw["nn_weights_1"].shape[1]))
    return out


# ------------------------------------------------------------------- module

class RRTMGPGasOptics(nn.Module):
    """Pre-trained RRTMGP-NN gas-optics MLP with the reference's inlined
    postprocessing (rnn/layers.py:253-281): a 3-layer softsign MLP
    (``mlp1``..``mlp3``, flax's names and [in, out] kernels); the LW output
    splits into (tau_raw, planck_raw) with pfrac = planck_raw^2
    (softmax-normalized when reduced); tau = col_dry * (ystd*tau_raw +
    ymean)^8.

    ``reduce_to`` replaces the output layer by a fresh trainable one of
    the reduced width (for LW with trainable ``ymean``/``ystd``, the
    gasopt_mlp's change_last_layer mode) while mlp1/mlp2 keep the frozen
    pre-trained weights (:func:`reduced_retrain_tx`). The normalization
    constants are buffers outside the state dict, as JAX keeps them
    static. The module lives on ``device`` (None: the card, raising
    without one; ``"cpu"`` for the CPU)."""

    def __init__(self, nx: int, nh: int, ng: int, lw: bool = False,
                 reduce_to: int | None = None, xmin: Sequence[float] = (),
                 xdiv: Sequence[float] = (), ymean: Sequence[float] = (),
                 ystd: Sequence[float] = (),
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        f32 = torch.float32
        self.lw, self.reduce_to = lw, reduce_to
        ngr = reduce_to or ng
        self.mlp1 = Dense(nx, nh, f32, generator)
        self.mlp2 = Dense(nh, nh, f32, generator)
        self.mlp3 = Dense(nh, 2 * ngr if lw else ngr, f32, generator)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        self.register_buffer("xmin", t(xmin), persistent=False)
        self.register_buffer("xdiv", t(xdiv), persistent=False)
        if lw and reduce_to is not None:
            # an adaptable normalization for the retrained head
            self.ymean = nn.Parameter(torch.full((ngr,), 0.4, dtype=f32))
            self.ystd = nn.Parameter(torch.full((ngr,), 0.1, dtype=f32))
        else:
            self.register_buffer("ymean", t(ymean[:ngr]), persistent=False)
            self.register_buffer("ystd", t(ystd[:ngr]), persistent=False)
        self.to(resolve_device(device))

    def forward(self, x_raw, col_dry):
        """x_raw [..., nx] raw features, col_dry [...] -> tau [..., ng]
        (and pfrac [..., ng] for LW)."""
        x = (x_raw - self.xmin) / self.xdiv
        h = F.softsign(self.mlp1(x))
        h = F.softsign(self.mlp2(h))
        y = self.mlp3(h)
        if self.lw:
            tau_raw, planck = y.chunk(2, dim=-1)
            pfrac = torch.square(planck)
            if self.reduce_to is not None:
                pfrac = torch.softmax(pfrac, dim=-1)
        else:
            tau_raw = y
        # the eighth power as three squarings, as XLA evaluates it
        a4 = pow4(self.ystd * tau_raw + self.ymean)
        tau = col_dry[..., None] * (a4 * a4)
        return (tau, pfrac) if self.lw else tau


def load_gas_optics_weights(path: str, reduce_to: int | None = None,
                            seed: int = 0, device=None):
    """(module, schema): a :class:`RRTMGPGasOptics` holding a weight
    file's network, or None when the file is unavailable. With
    ``reduce_to`` mlp3 (and for LW ymean/ystd) are fresh, from a
    ``torch.Generator`` seeded with ``seed``, for retraining, and
    mlp1/mlp2 carry the pre-trained weights (rnn/utils.py:553-613). The
    module is built on ``device`` (None: the card)."""
    schema = read_gas_optics_schema(path)
    if schema is None:
        return None
    xmin = schema["nn_input_coeffs_min"]
    xdiv = np.maximum(schema["nn_input_coeffs_max"] - xmin, 1e-12)
    mod = RRTMGPGasOptics(
        nx=schema["nx"], nh=schema["nh"], ng=schema["ng"], lw=schema["lw"],
        reduce_to=reduce_to, xmin=xmin, xdiv=xdiv,
        ymean=schema["nn_output_coeffs_mean"],
        ystd=schema["nn_output_coeffs_std"],
        generator=torch.Generator().manual_seed(seed), device=device)
    lay = {"mlp1": ("nn_weights_1", "nn_bias_1"),
           "mlp2": ("nn_weights_2", "nn_bias_2")}
    if reduce_to is None:
        lay["mlp3"] = ("nn_weights_3", "nn_bias_3")
    with torch.no_grad():
        for name, (wk, bk) in lay.items():
            layer = getattr(mod, name)
            layer.kernel.copy_(torch.as_tensor(schema[wk]))
            layer.bias.copy_(torch.as_tensor(schema[bk]))
    return mod, schema


def load_reduced_checkpoint(path: str, native_ng: int = 112, device=None):
    """(module, meta) from one of the reference's RETRAINED reduced
    gas-optics checkpoints (a torch ``.pt`` of rnn/utils.py:553-613
    ``load_reduced_gas_optics_model``; e.g.
    rnn/data/sw_gasopt_bnd29-71-80-89-102_ng4-3-4-2-1-2_nh32_alpha0.10_abs.pt).
    Band boundaries in native g-space come from the ``bndA-B-..._ng``
    filename convention where the checkpoint has none. None when the file
    is absent. The module is built on ``device`` (None: the card)."""
    if not os.path.exists(path):
        return None
    ck = torch.load(path, map_location="cpu", weights_only=False)
    state = ck["model_state_dict"]
    t2n = lambda k: np.asarray(state[k].detach().cpu().numpy(), np.float32)
    ng = state["mlp3.weight"].shape[0]
    nh = state["mlp1.weight"].shape[0]
    nx = state["mlp1.weight"].shape[1]
    xmin = t2n("xmin")
    xdiv = t2n("xdiv") if "xdiv" in state else t2n("xmax") - xmin
    band_bounds = ck.get("band_bounds")
    native_bounds = ck.get("rrtmgp_band_bounds")
    if native_bounds is None:
        m = re.search(r"bnd([0-9-]+)_ng", os.path.basename(path))
        native_bounds = ([0] + [int(v) for v in m.group(1).split("-")]
                         + [native_ng]) if m else []
    # reduced checkpoints with do_norm=False bake the scaling into the
    # head: tau = col_dry * y^8 => ymean 0, ystd 1
    do_norm = bool(ck.get("do_norm", False))
    mod = RRTMGPGasOptics(
        nx=nx, nh=nh, ng=ng, lw=False, reduce_to=None, xmin=xmin,
        xdiv=np.maximum(xdiv, 1e-12),
        ymean=[0.0] * ng if not do_norm else t2n("ymean"),
        ystd=[1.0] * ng if not do_norm else t2n("ystd"), device=device)
    with torch.no_grad():
        for name in ("mlp1", "mlp2", "mlp3"):
            layer = getattr(mod, name)
            layer.kernel.copy_(torch.as_tensor(t2n(f"{name}.weight").T))
            layer.bias.copy_(torch.as_tensor(t2n(f"{name}.bias")))
    meta = {"band_bounds": band_bounds, "native_bounds": native_bounds,
            "sw_solar_weights_raw": t2n("sw_solar_weights").ravel()
            if "sw_solar_weights" in state else None,
            # the checkpoint carries its own native solar-source table
            # (slightly different vintage than RRTMGP_SW_SOLAR_SOURCE)
            "rrtmgp_solar": t2n("rrtmgp_sw_solar_weights").ravel()
            if "rrtmgp_sw_solar_weights" in state else None,
            "do_norm": do_norm, "ng": int(ng), "nh": int(nh),
            "nx": int(nx),
            # the inlined reference forward multiplies a fixed 1e-17 after
            # col_dry * y^8 when do_norm=False (rnn/utils.py:487-494)
            "coeff": 1e-17 if not do_norm else 1.0}
    return mod, meta


def reduced_retrain_tx(module: RRTMGPGasOptics,
                       make_optimizer=torch.optim.Adam, **kw):
    """The reduce-retrain flow's optimizer: the pre-trained trunk
    (mlp1/mlp2) frozen (``requires_grad`` off, so it gets no update, as
    JAX's ``freeze`` gives it none), only the reduction head (mlp3, and
    for LW ymean/ystd) trained — the reference's lock_weights
    (rnn/layers.py:245-250). Returns ``make_optimizer(head, **kw)``."""
    head = []
    for name, p in module.named_parameters():
        frozen = name.split(".")[0] in ("mlp1", "mlp2")
        p.requires_grad_(not frozen)
        if not frozen:
            head.append(p)
    return make_optimizer(head, **kw)


# -------------------------------------------------- band mapping + solar src

def band_gpt_bounds(num_bands: int, gpt_bounds=None):
    """Split the native RRTMGP band list into ``num_bands`` contiguous
    custom bands along g-points; returns their g-point boundaries."""
    gb = list(gpt_bounds or RRTMGP_GPT_BOUNDS)
    nb = len(gb) - 1
    per = nb // num_bands
    idx = [0] + [gb[min((i + 1) * per, nb)] for i in range(num_bands)]
    idx[-1] = gb[-1]
    return idx


def slingo_band_weights(wavenum_bounds: Sequence[float]) -> np.ndarray:
    """Overlap weights mapping custom wavenumber bands onto the 4 Slingo
    cloud-optics coefficient sets (rnn/utils.py:414-432): weights[b, s] is
    the fraction of band b's wavenumber extent covered by Slingo band s
    (in Slingo COEFFS index order)."""
    SLINGO_BOUNDS = [0.0, 4200.0, 8000.0, 14286.0, 50000.0]
    SLINGO_TO_COEFFS = [3, 2, 1, 0]
    nb = len(wavenum_bounds) - 1
    w = np.zeros((nb, 4), np.float32)
    for b in range(nb):
        wlo_b, whi_b = float(wavenum_bounds[b]), float(wavenum_bounds[b + 1])
        tot = 0.0
        for s in range(4):
            ov = max(0.0, min(whi_b, SLINGO_BOUNDS[s + 1])
                     - max(wlo_b, SLINGO_BOUNDS[s]))
            if ov > 0:
                w[b, SLINGO_TO_COEFFS[s]] += ov
                tot += ov
        if tot > 0:
            w[b] /= tot
    return w


def rrtmgp_bounds_to_wavenum_bounds(gpt_bounds: Sequence[int]):
    """Wavenumber edges of custom bands defined by g-point boundaries on
    the native RRTMGP SW grid (rnn/utils.py rrtmgp_bounds_to_wavenum
    _bounds)."""
    edges = [RRTMGP_WAVENUM_LOW[0]]
    native = list(RRTMGP_GPT_BOUNDS)
    for g in gpt_bounds[1:]:
        b = native.index(g)      # custom bounds align with native bands
        edges.append(RRTMGP_WAVENUM_HIGH[b - 1])
    return edges


def reduced_solar_weights(raw_weights, band_bounds: Sequence[int],
                          native_bounds: Sequence[int],
                          rrtmgp_solar) -> torch.Tensor:
    """Solar-source weights for a reduced g-point set (the reference's
    get_solar_weights, rnn/utils.py:494-518): per custom band, the softmax
    of the learned raw weights within the band (``band_bounds`` indexes
    the REDUCED g-space), each band scaled to its fraction of the native
    RRTMGP solar source (``native_bounds`` indexes the NATIVE 112-g
    space). Differentiable in ``raw_weights``; sums to 1."""
    raw = torch.as_tensor(raw_weights).reshape(-1)
    src = torch.as_tensor(np.asarray(rrtmgp_solar, np.float32),
                          device=raw.device).reshape(-1)
    total = torch.sum(src)
    parts = []
    for b in range(len(band_bounds) - 1):
        p_b = torch.sum(src[native_bounds[b]:native_bounds[b + 1]]) / total
        seg = raw[band_bounds[b]:band_bounds[b + 1]]
        parts.append(torch.softmax(seg, dim=0) * p_b)
    return torch.cat(parts)
