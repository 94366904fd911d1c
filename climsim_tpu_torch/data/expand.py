"""Expanded-feature derivation: previous-step state, physics tendencies,
and dynamics forcings (counterpart of ``climsim_tpu/data/expand.py``).

Vectorized equivalent of the ClimSim-Online feature-expansion pipeline
(online_testing/data_preparation/expand_feature/climsim_adding_input.py:
6-81), which writes ``.mlexpand.`` files with:
  tm_X           = X from the previous input step
  X_prvphy       = (mlo_prev - mli_prev)/1200   (previous physics tendency)
  X_dyn          = (mli - mlo_prev)/1200        (dynamics forcing)
  tm_X_prvphy / tm_X_dyn = the two-steps-back versions
  clat/slat/icol = cos(lat), sin(lat), 1..ncol

The whole time series is transformed in one pass of tensor operations on
the tensors' own device.
"""
from __future__ import annotations

import math

import torch

from .. import constants as C

DT = C.DT_STEP


def _per_step(x: torch.Tensor) -> torch.Tensor:
    """x / DT as a true division on every device: CUDA divides by a host
    scalar through its reciprocal, which rounds one bit differently from
    the CPU and from JAX."""
    return x / torch.full((), DT, dtype=x.dtype, device=x.device)


def derive_tendencies(state_in: torch.Tensor,
                      state_out: torch.Tensor) -> torch.Tensor:
    """ptend = (mlo - mli)/1200 over any matching tensors
    (data_utils.get_target:735-745)."""
    return _per_step(state_out - state_in)


def _shift(a: torch.Tensor, n: int) -> torch.Tensor:
    """a[t-n], the first step repeated over the first n steps."""
    return torch.cat([a[:1].expand(n, *a.shape[1:]), a[:-n]], dim=0)


def expand_features(mli: dict[str, torch.Tensor],
                    mlo: dict[str, torch.Tensor],
                    var_names: tuple = ("state_t", "state_q0001",
                                        "state_q0002", "state_q0003",
                                        "state_u")):
    """The expanded feature dict from time-major input/output state
    tensors ([T, ncol, nlev] per variable).

    Returns a dict of [T, ncol, nlev] tensors for the tm_*/prvphy/dyn
    features. The history of the first steps repeats the first step (it is
    not zero-padded), so the features are meaningful from step 2 on, as the
    reference skips the first files."""
    out: dict[str, torch.Tensor] = {}
    for name in var_names:
        x_in = mli[name]
        x_out = mlo[name]
        prvphy = derive_tendencies(_shift(x_in, 1), _shift(x_out, 1))
        dyn = _per_step(x_in - _shift(x_out, 1))
        out[f"tm_{name}"] = _shift(x_in, 1)
        out[f"{name}_prvphy"] = prvphy
        out[f"tm_{name}_prvphy"] = _shift(prvphy, 1)
        out[f"{name}_dyn"] = dyn
        out[f"tm_{name}_dyn"] = _shift(dyn, 1)

    # merged humidity forcing: q0 = total-water dynamics (v4 uses
    # state_q0_dyn for the sum of the three water species)
    if all(f"state_q000{i}_dyn" in out for i in (1, 2, 3)):
        out["state_q0_dyn"] = (out["state_q0001_dyn"]
                               + out["state_q0002_dyn"]
                               + out["state_q0003_dyn"])
        out["tm_state_q0_dyn"] = (out["tm_state_q0001_dyn"]
                                  + out["tm_state_q0002_dyn"]
                                  + out["tm_state_q0003_dyn"])
    return out


def location_features(lat: torch.Tensor, lon: torch.Tensor):
    """clat/slat/icol scalars (climsim_adding_input.py; data_utils
    get_xrdata icol derivation :676-680); icol is 1..ncol in lat's
    dtype."""
    rad = lat * (math.pi / 180.0)
    return {"clat": torch.cos(rad), "slat": torch.sin(rad),
            "icol": torch.arange(1, lat.shape[0] + 1, dtype=lat.dtype,
                                 device=lat.device)}
