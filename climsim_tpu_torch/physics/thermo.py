"""Saturation thermodynamics and moisture conversions (counterpart of
``climsim_tpu/physics/thermo.py``).

* ``eliq``/``eice`` polynomial fits        (climsim_utils/data_utils.py:19-44)
* ``state_rh`` derivation q -> RH          (data_utils.py:662-673)
* RH -> q inversion of the inference
  wrapper                                  (rnn/utils.py:674-814)
* ``liq_partition`` temperature ramp       (data_utils.py:683-689)
* snow-fraction ramp                       (rnn/models/models.py:268-271)
* the Clausius-Clapeyron variant           (rnn/metrics.py:318-476)

All elementwise on tensors; the polynomials use Horner's scheme.
"""
from __future__ import annotations

import torch

from .. import constants as C

# polynomial coefficients, highest order first (data_utils.py:23-37)
_A_LIQ = (-0.976195544e-15, -0.952447341e-13, 0.640689451e-10,
          0.206739458e-7, 0.302950461e-5, 0.264847430e-3,
          0.142986287e-1, 0.443987641, 6.11239921)
_A_ICE = (0.252751365e-14, 0.146898966e-11, 0.385852041e-9,
          0.602588177e-7, 0.615021634e-5, 0.420895665e-3,
          0.188439774e-1, 0.503160820, 6.11147274)
# ice branch constants (data_utils.py:39)
_C_ICE = (273.15, 185.0, -100.0, 0.00763685, 0.000151069, 7.48215e-07)


def _polyval(coeffs, x: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


def eliq(T: torch.Tensor) -> torch.Tensor:
    """Liquid saturation pressure [Pa] from temperature [K]."""
    return 100.0 * _polyval(_A_LIQ, torch.clamp(T - C.T0_FREEZE, min=-80.0))


def eice(T: torch.Tensor) -> torch.Tensor:
    """Ice saturation pressure [Pa]; three-branch polynomial fit."""
    c = _C_ICE
    dT = T - C.T0_FREEZE
    warm = eliq(T)
    mid = 100.0 * _polyval(_A_ICE, dT)
    dTc = torch.clamp(dT, min=c[2])
    cold = 100.0 * (c[3] + dTc * (c[4] + dTc * c[5]))
    return torch.where(T > c[0], warm, torch.where(T > c[1], mid, cold))


def liquid_fraction(T: torch.Tensor, t_low: float = C.T_ICE_RAMP,
                    t_high: float = C.T0_FREEZE) -> torch.Tensor:
    """omega ramp: 0 below 253.16 K, 1 above 273.16 K
    (data_utils.py:683-689)."""
    return torch.clamp((T - t_low) / (t_high - t_low), 0.0, 1.0)


def snow_fraction(T_sfc: torch.Tensor) -> torch.Tensor:
    """Fraction of frozen precipitation from near-surface temperature; linear
    ramp over [T0-10, T0] (rnn/models/models.py:268-271)."""
    return 1.0 - torch.clamp((T_sfc - (C.T0_FREEZE - 10.0)) / 10.0, 0.0, 1.0)


def esat(T: torch.Tensor) -> torch.Tensor:
    """Blended saturation pressure: omega*eliq + (1-omega)*eice [Pa]."""
    w = liquid_fraction(T)
    return w * eliq(T) + (1.0 - w) * eice(T)


def qsat(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Saturation specific humidity (Rd/Rv) * esat / p (data_utils.py:670-671);
    ``p`` is mid-level pressure [Pa]."""
    return (C.RD * esat(T)) / (C.RV * p)


def specific_to_relative_humidity(q: torch.Tensor, T: torch.Tensor,
                                  p: torch.Tensor) -> torch.Tensor:
    """q [kg/kg] -> RH (unitless), the ``state_rh`` derived input."""
    return q / qsat(T, p)


def relative_to_specific_humidity(rh: torch.Tensor, T: torch.Tensor,
                                  p: torch.Tensor) -> torch.Tensor:
    """RH -> q [kg/kg], the inverse transform at the online boundary."""
    return rh * qsat(T, p)


# ---- Clausius-Clapeyron variant (rnn/metrics.py:318-476) ----

_ES0 = 611.2       # Pa, saturation vapor pressure at the triple point
_RV_CC = 461.5     # J/(kg K)
_LV0 = 2.501e6     # J/kg
_LV_SLOPE = -2370.0  # J/(kg K), linear T-dependence of Lv
_EPSILON = 0.622   # Rd/Rv mass ratio


def esat_cc(T: torch.Tensor) -> torch.Tensor:
    """Clausius-Clapeyron saturation vapor pressure with linearly
    T-dependent latent heat (rnn/metrics.py:341-360)."""
    Lv = _LV0 + _LV_SLOPE * (T - C.T0_FREEZE)
    return _ES0 * torch.exp((Lv / _RV_CC) * (1.0 / C.T0_FREEZE - 1.0 / T))


def specific_to_relative_humidity_cc(q, T, p, return_excess: bool = False):
    """q -> RH via Clausius-Clapeyron, e = q p / (eps + q (1-eps))
    (rnn/metrics.py:318-380); ``return_excess=True`` gives the
    supersaturation excess in kg/kg."""
    e_sat = esat_cc(T)
    if return_excess:
        q_sat = (_EPSILON * e_sat) / (p - e_sat * (1.0 - _EPSILON))
        return torch.clamp(q - q_sat, min=0.0)
    e_actual = (q * p) / (_EPSILON + q * (1.0 - _EPSILON))
    return e_actual / e_sat
