"""Training-side input preprocessing chain for keeplev data (counterpart
of ``climsim_tpu/data/preprocess.py``).

Host-pipeline (one-pass numpy) equivalent of the reference chunked
dataset's per-__getitem__ rewrites (rnn/utils.py:2160-2250, generator_xy):
snowhice fix, RH pruning/clipping, RH -> specific-humidity conversion
(optionally appended as an extra channel), v4 -> v5 input conversion
(qc+qi -> qn + temperature-diagnosed liquid fraction), the exponential /
sqrt-sqrt cloud-condensate transforms, and stratospheric q-input pruning.

Applied ONCE over the loaded time series before normalization statistics
are computed — the reference instead re-runs these per chunk on DataLoader
workers (with numba); here the arrays are static for the whole run, so a
single pass is both simpler and faster.

Channel convention (v4_rnn level inputs): 0=T, 1=rh, 2=qc(->qn), 3=qi
(->liq_frac), ...; x_sfc channel 0 is raw surface pressure.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class PreprocessConfig:
    """Mirrors the reference generator_xy options (rnn/utils.py:1868-1906
    + conf/autoreg_LSTM.yaml)."""
    snowhice_fix: bool = True          # >1e10 sentinel -> -1 (:2169-2170)
    rh_prune: bool = False             # clip rh to [0, 1.2] (:2175-2176)
    rh_input_to_q: bool = False        # rh channel -> q (:2178-2188)
    include_q_input: bool = False      # append q instead of replacing rh
    v4_to_v5_inputs: bool = False      # qc,qi -> qn,liq_frac (:2207-2228)
    cld_inp_transformation: str = "exp"   # 'exp' | 'sqrt' | 'none'
    qinput_prune: bool = False         # zero top levels of cloud inputs
    qinput_prune_lev: int = 15

    def __post_init__(self):
        if self.cld_inp_transformation not in ("exp", "sqrt", "none"):
            raise ValueError(
                f"cld_inp_transformation '{self.cld_inp_transformation}' "
                "not in ('exp', 'sqrt', 'none')")


def _rh_to_q(rh, T, p):
    """relative_to_specific_humidity_climsim (rnn/utils.py:674-699), in
    float32 through the port's thermodynamics (``physics/thermo.py``),
    which match the JAX package's."""
    from ..physics import thermo

    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return thermo.relative_to_specific_humidity(f(rh), f(T), f(p)).numpy()


def _liq_frac(T):
    """clipped (T-253.16)/20 ramp (data_utils.py:683-689)."""
    return np.clip((T - 253.16) / 20.0, 0.0, 1.0)


def preprocess_level_inputs(x_lev: np.ndarray, x_sfc: np.ndarray,
                            hyam: np.ndarray, hybm: np.ndarray,
                            cfg: PreprocessConfig,
                            lbd_qc: np.ndarray | None = None,
                            lbd_qi: np.ndarray | None = None,
                            lbd_qn: np.ndarray | None = None):
    """Apply the chain to raw arrays x_lev [..., L, nx], x_sfc [..., ns].

    Returns (x_proc, x_denorm, x_sfc): x_proc with cloud channels
    transformed (+ optional appended q channel), x_denorm the raw snapshot
    taken AFTER the humidity rewrites but BEFORE the cloud transforms —
    exactly the reference's x_lev_b_denorm (:2201), which feeds the
    physics model and the state-consistency losses.
    """
    x_lev = np.array(x_lev, np.float32, copy=True)
    x_sfc = np.array(x_sfc, np.float32, copy=True)
    hyam = np.asarray(hyam, np.float32).reshape(-1)
    hybm = np.asarray(hybm, np.float32).reshape(-1)

    if cfg.snowhice_fix:
        x_sfc[x_sfc > 1.0e10] = -1.0
    if cfg.rh_prune:
        x_lev[..., 1] = np.clip(x_lev[..., 1], 0.0, 1.2)
    if cfg.rh_input_to_q:
        sp = x_sfc[..., 0:1]                       # [..., 1]
        p = sp * hybm + 1.0e5 * hyam               # [..., L]
        q = _rh_to_q(x_lev[..., 1], x_lev[..., 0], p).astype(np.float32)
        if cfg.include_q_input:
            x_lev = np.concatenate([x_lev, q[..., None]], axis=-1)
        else:
            x_lev[..., 1] = q

    x_denorm = x_lev.copy()

    if cfg.v4_to_v5_inputs:
        qn = x_lev[..., 2] + x_lev[..., 3]
        if cfg.qinput_prune:
            qn[..., :cfg.qinput_prune_lev] = 0.0
        x_lev[..., 3] = _liq_frac(x_lev[..., 0])
        if cfg.cld_inp_transformation == "exp":
            if lbd_qn is None:
                raise ValueError("v4_to_v5 exp transform needs lbd_qn")
            qn = 1.0 - np.exp(-qn * np.asarray(lbd_qn, np.float32))
        elif cfg.cld_inp_transformation == "sqrt":
            qn = np.sqrt(np.sqrt(qn))
        x_lev[..., 2] = qn
    else:
        if cfg.cld_inp_transformation == "exp":
            if lbd_qc is None or lbd_qi is None:
                raise ValueError("exp cloud transform needs lbd_qc/lbd_qi")
            x_lev[..., 2] = 1.0 - np.exp(
                -x_lev[..., 2] * np.asarray(lbd_qc, np.float32))
            x_lev[..., 3] = 1.0 - np.exp(
                -x_lev[..., 3] * np.asarray(lbd_qi, np.float32))
        elif cfg.cld_inp_transformation == "sqrt":
            x_lev[..., 2] = np.sqrt(np.sqrt(x_lev[..., 2]))
            x_lev[..., 3] = np.sqrt(np.sqrt(x_lev[..., 3]))
        if cfg.qinput_prune:
            x_lev[..., :cfg.qinput_prune_lev, 2] = 0.0

    return x_lev, x_denorm, x_sfc
