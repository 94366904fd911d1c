"""E3SM cloud optics: effective radii and Slingo/Ebert-Curry SW properties
(counterpart of ``climsim_tpu/physics/cloud_optics.py``).

The ice effective-radius table ``reitab`` (physics_rad_e3sm.py:13-61), the
liquid droplet radius ``reltab`` (:62-97), Slingo 4-band liquid SW optics
(:98-264) with the RRTMGP g-point band mapping, and Ebert-Curry ice optics
(:265-301). The tables are this package's own copy.
"""
from __future__ import annotations

import numpy as np
import torch

_RETAB = np.array([
    0.05, 0.05, 0.05, 0.05, 0.05, 0.05,
    0.055, 0.06, 0.07, 0.08, 0.09, 0.1,
    0.2, 0.3, 0.40, 0.50, 0.60, 0.70,
    0.8, 0.9, 1.0, 1.1, 1.2, 1.3,
    1.4, 1.5, 1.6, 1.8, 2.0, 2.2,
    2.4, 2.6, 2.8, 3.0, 3.2, 3.5,
    3.8, 4.1, 4.4, 4.7, 5.0, 5.3,
    5.6,
    5.92779, 6.26422, 6.61973, 6.99539, 7.39234,
    7.81177, 8.25496, 8.72323, 9.21800, 9.74075, 10.2930,
    10.8765, 11.4929, 12.1440, 12.8317, 13.5581, 14.2319,
    15.0351, 15.8799, 16.7674, 17.6986, 18.6744, 19.6955,
    20.7623, 21.8757, 23.0364, 24.2452, 25.5034, 26.8125,
    27.7895, 28.6450, 29.4167, 30.1088, 30.7306, 31.2943,
    31.8151, 32.3077, 32.7870, 33.2657, 33.7540, 34.2601,
    34.7892, 35.3442, 35.9255, 36.5316, 37.1602, 37.8078,
    38.4720, 39.1508, 39.8442, 40.5552, 41.2912, 42.0635,
    42.8876, 43.7863, 44.7853, 45.9170, 47.2165, 48.7221,
    50.4710, 52.4980, 54.8315, 57.4898, 60.4785, 63.7898,
    65.5604, 71.2885, 75.4113, 79.7368, 84.2351, 88.8833,
    93.6658, 98.5739, 103.603, 108.752, 114.025, 119.424,
    124.954, 130.630, 136.457, 142.446, 148.608, 154.956,
    161.503, 168.262, 175.248, 182.473, 189.952, 197.699,
    205.728, 214.055, 222.694, 231.661, 240.971, 250.639,
])

# Slingo liquid coefficients per band (A..F), band order 4->1 on g-points
_LIQ = np.array([
    [2.817e-02, 2.682e-02, 2.264e-02, 1.281e-02],   # A ext
    [1.305, 1.346, 1.454, 1.641],                   # B ext
    [-5.62e-08, -6.94e-06, 4.64e-04, 0.201],        # C ssa
    [1.63e-07, 2.35e-05, 1.24e-03, 7.56e-03],       # D ssa
    [0.829, 0.794, 0.754, 0.826],                   # E asym
    [2.482e-03, 4.226e-03, 6.560e-03, 4.353e-03],   # F asym
])

# Ebert-Curry ice coefficients per band
_ICE = np.array([
    [3.448e-03, 3.448e-03, 3.448e-03, 3.448e-03],
    [2.431, 2.431, 2.431, 2.431],
    [1.00e-05, 1.10e-04, 1.861e-02, 0.46658],
    [0.0, 1.405e-05, 8.328e-04, 2.05e-05],
    [0.7661, 0.7730, 0.794, 0.9595],
    [5.851e-04, 5.665e-04, 7.267e-04, 1.076e-04],
])


def reitab(t: torch.Tensor) -> torch.Tensor:
    """Ice effective radius [um] from temperature through the E3SM table
    (physics_rad_e3sm.py:13-61), linear between entries. The JAX package
    gathers with a one-hot product, which selects the same entries
    exactly; here it is an index."""
    tab = torch.as_tensor(_RETAB, dtype=t.dtype, device=t.device)
    idx = torch.clamp((t - 136.0).to(torch.int64), 1, len(_RETAB) - 2)
    corr = t - torch.floor(t)
    return tab[idx] * (1.0 - corr) + tab[idx + 1] * corr


def reltab(t: torch.Tensor, landfrac, icefrac, snowh) -> torch.Tensor:
    """Liquid droplet effective radius [um] (physics_rad_e3sm.py:62-97)."""
    rliqocean, rliqice, rliqland = 14.0, 14.0, 8.0
    rel = rliqland + (rliqocean - rliqland) * \
        torch.clamp((273.15 - t) * 0.05, 0.0, 1.0)
    rel = rel + (rliqocean - rel) * torch.clamp(snowh * 10.0, 0.0, 1.0)
    rel = rel + (rliqocean - rel) * torch.clamp(1.0 - landfrac, 0.0, 1.0)
    rel = rel + (rliqice - rel) * torch.clamp(icefrac, 0.0, 1.0)
    return rel


def _band_expand(coeffs: np.ndarray, ng: int) -> np.ndarray:
    """Map the 4 Slingo bands onto ng g-points with the RRTMGP band
    allocation (physics_rad_e3sm.py:130-160): band 4 for the first 29/112,
    band 3 to 71/112, band 2 to 80/112, band 1 above."""
    if ng == 4:
        return coeffs
    y = np.empty((6, ng))
    i4 = round(29 / 112 * ng)
    i3 = round(71 / 112 * ng)
    i2 = round(80 / 112 * ng)
    y[:, :i4] = coeffs[:, 3:4]
    y[:, i4:i3] = coeffs[:, 2:3]
    y[:, i3:i2] = coeffs[:, 1:2]
    y[:, i2:] = coeffs[:, 0:1]
    return y


def _optics_sw(coeffs: np.ndarray, r: torch.Tensor, lo: float, hi: float,
               ng: int):
    y = torch.as_tensor(_band_expand(coeffs, ng), dtype=r.dtype,
                        device=r.device)
    re = torch.clamp(r, lo, hi)[..., None]
    k = y[0] + y[1] / re
    ssa = torch.clamp(1.0 - y[2] - re * y[3], max=0.999999)
    g = y[4] + re * y[5]
    return k, ssa, g


def slingo_liq_optics_sw(rel: torch.Tensor, ng: int = 4):
    """Normalized liquid cloud SW optical properties per g-point: mass
    extinction k [m2/g], ssa, asymmetry g. rel [...] -> [..., ng]."""
    return _optics_sw(_LIQ, rel, 4.2, 16.0, ng)


def ec_ice_optics_sw(rei: torch.Tensor, ng: int = 4):
    """Ebert-Curry ice SW optics per g-point (physics_rad_e3sm.py:265-301)."""
    return _optics_sw(_ICE, rei, 13.0, 130.0, ng)


def combine_optics(tau_liq, ssa_liq, g_liq, tau_ice, ssa_ice, g_ice,
                   eps: float = 1e-12):
    """Combine two optical media: tau adds, ssa and g combine tau- and
    tau*ssa-weighted (physics_rad_e3sm.py:302-423)."""
    tau = tau_liq + tau_ice
    ts = tau_liq * ssa_liq + tau_ice * ssa_ice
    ssa = ts / torch.clamp(tau, min=eps)
    g = (tau_liq * ssa_liq * g_liq + tau_ice * ssa_ice * g_ice) \
        / torch.clamp(ts, min=eps)
    return tau, ssa, g


def cloud_optics_sw(qliq_path, qice_path, T, landfrac, icefrac, snowh,
                    ng: int = 4):
    """E3SM SW cloud optics: water paths [g/m2] and T [K] (with the
    per-column surface fields broadcast over levels) -> (tau, ssa, g) per
    g-point."""
    rel = reltab(T, landfrac, icefrac, snowh)
    rei = reitab(T)
    k_l, ssa_l, g_l = slingo_liq_optics_sw(rel, ng)
    k_i, ssa_i, g_i = ec_ice_optics_sw(rei, ng)
    tau_l = k_l * qliq_path[..., None]
    tau_i = k_i * qice_path[..., None]
    return combine_optics(tau_l, ssa_l, g_l, tau_i, ssa_i, g_i)


def cloud_optics_sw_mcica(qliq_path_g, qice_path_g, T, landfrac, icefrac,
                          snowh):
    """E3SM SW cloud optics with per-g-point (McICA-sampled) water paths
    [..., ng]: each spectral point sees the cloud of its sampled subgrid
    region (models_phys.py:862-886)."""
    ng = qliq_path_g.shape[-1]
    rel = reltab(T, landfrac, icefrac, snowh)
    rei = reitab(T)
    k_l, ssa_l, g_l = slingo_liq_optics_sw(rel, ng)
    k_i, ssa_i, g_i = ec_ice_optics_sw(rei, ng)
    return combine_optics(k_l * qliq_path_g, ssa_l, g_l,
                          k_i * qice_path_g, ssa_i, g_i)
