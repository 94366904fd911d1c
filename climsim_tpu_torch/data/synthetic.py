"""Synthetic ClimSim column states on tensors.

Counterpart of the state generator of ``climsim_tpu/data/synthetic.py``:
``_profile``, ``SyntheticConfig`` and ``generate_state``, from which the
coupled step's CLI (``cli/run_hybrid.py``) draws its initial state. The
rest of that module (``synthetic_physics``, ``make_timeseries``,
``equilibrium_physics``) waits for the data slice (ROADMAP A.8).

Randomness. JAX splits one key into 32 and draws each variable's noise
from its own key. Here every standard-normal draw goes through one draw
function ``draw(key, shape)``, indexed by the JAX key it replaces: ``i``
for ``keys[i]``, and ``(0, 0)`` and ``(0, 1)`` for the two sub-keys that
``_profile`` splits from ``keys[0]``. A key read twice gives the same
numbers both times, as in JAX (``keys[17]`` drives both the land and the
ocean fraction, ``keys[21]`` every filled scalar). The default draw takes
normals from a ``torch.Generator`` on the CPU, in the order in which the
keys are first read, and moves them to the grid's device, so one seed
gives the same state on every device; a test passes JAX's own draws.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import constants as C
from .. import variables as V
from ..grid import Grid
from ..physics import thermo


def _linspace(start: float, stop: float, num: int, dtype: torch.dtype,
              device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` by JAX's formula, start (1 - s)
    + stop s with s = i (1 / (num - 1)) and the last point ``stop``, so
    the profiles below round as the reference's do."""
    if num < 2:
        return torch.full((num,), start, dtype=dtype, device=device)
    div = num - 1
    s = torch.arange(div, dtype=dtype, device=device) \
        * torch.tensor(1.0 / div, dtype=dtype)
    stop_t = torch.full((1,), stop, dtype=dtype, device=device)
    return torch.cat([start * (1 - s) + stop * s, stop_t])


def _profile(normal, key, ncol, nlev, sfc_val, top_val, rel_noise, dtype,
             device):
    """Smooth vertical profile from top_val (lev 0 = TOA) to sfc_val plus
    column-correlated noise, the noise from the two sub-keys of ``key``."""
    s = _linspace(0.0, 1.0, nlev, dtype, device)
    base = top_val + (sfc_val - top_val) * s ** 1.2
    colnoise = normal((key, 0), (ncol, 1)) * rel_noise
    levnoise = normal((key, 1), (ncol, nlev)) * rel_noise * 0.3
    return base[None, :] * (1.0 + colnoise + levnoise)


@dataclass(frozen=True)
class SyntheticConfig:
    vset_name: str = "v1"
    ncol: int = C.NCOL_LOWRES
    nlev: int = C.NLEV
    noise: float = 0.05
    target_noise: float = 0.02
    dtype: str = "float32"


def generate_state(generator: torch.Generator | None, cfg: SyntheticConfig,
                   grid: Grid, draw=None) -> dict:
    """One 'timestep' of raw un-normalized inputs for all columns, on the
    grid's device: dict var -> [ncol(, nlev)] for the v1..v5 input
    variables and whatever else cfg's variable set names. ``draw(key,
    shape)`` gives the standard normals of JAX key ``key`` (module
    docstring); by default they come from ``generator`` (a CPU
    ``torch.Generator``; None: torch's default one)."""
    vset = V.get(cfg.vset_name)
    dt = getattr(torch, cfg.dtype)
    dev = grid.lat.device
    ncol, nlev = cfg.ncol, cfg.nlev
    if draw is None:
        draw = lambda key, shape: torch.randn(shape, generator=generator,
                                              dtype=dt)
    drawn = {}

    def normal(key, shape):
        if key not in drawn:
            drawn[key] = draw(key, shape).to(device=dev, dtype=dt)
        return drawn[key]

    lat = grid.lat[:ncol] if grid.ncol >= ncol else \
        _linspace(-88.0, 88.0, ncol, dt, dev)
    lin = lambda a, b: _linspace(a, b, nlev, dt, dev)

    coslat = torch.cos(torch.deg2rad(lat)).to(dt)
    T_sfc = 255.0 + 45.0 * coslat
    T = _profile(normal, 0, ncol, nlev, 1.0, 0.82, cfg.noise, dt, dev) \
        * T_sfc[:, None]  # ~ 210 K aloft to T_sfc
    ps = 9.8e4 + 6e3 * coslat + 800.0 * normal(1, (ncol,))
    pmid = grid.mid_pressure(ps)
    q_scale = 1.6e-2 * coslat + 1e-4
    q = q_scale[:, None] * torch.exp(-4.0 * lin(1.0, 0.0))[None, :]
    q = q * (1.0 + cfg.noise * normal(2, (ncol, nlev)))
    q = torch.clamp(q, min=1e-9)
    qc = torch.clamp(
        2e-5 * torch.exp(-((lin(0.0, 1.0) - 0.75) / 0.12) ** 2)[None, :]
        * (1.0 + normal(3, (ncol, nlev))), min=0)
    qi = torch.clamp(
        1e-5 * torch.exp(-((lin(0.0, 1.0) - 0.45) / 0.15) ** 2)[None, :]
        * (1.0 + normal(4, (ncol, nlev))), min=0)
    u = 20.0 * torch.sin(2 * torch.deg2rad(lat))[:, None] \
        + 5.0 * normal(5, (ncol, nlev))
    v = 3.0 * normal(6, (ncol, nlev))
    rh = thermo.specific_to_relative_humidity(q, T, pmid)

    ozone = 5e-6 * torch.exp(-((lin(0.0, 1.0) - 0.15) / 0.12) ** 2)[None, :] \
        * torch.ones((ncol, 1), dtype=dt, device=dev)
    ch4 = torch.full((ncol, nlev), 9.7e-7, dtype=dt, device=dev)
    n2o = torch.full((ncol, nlev), 4.8e-7, dtype=dt, device=dev)

    solin = torch.clamp(1360.0 * coslat + 30 * normal(7, (ncol,)), min=0)
    frac = lambda k: torch.clamp(0.3 + 0.2 * normal(k, (ncol,)), 0.02, 0.95)
    state = {
        "state_t": T, "state_q0001": q, "state_q0002": qc, "state_q0003": qi,
        "state_rh": rh, "state_qn": qc + qi,
        "liq_partition": thermo.liquid_fraction(T),
        "state_u": u, "state_v": v,
        "state_ps": ps, "pbuf_SOLIN": solin,
        "pbuf_LHFLX": torch.clamp(80 * coslat + 20 * normal(8, (ncol,)),
                                  min=0),
        "pbuf_SHFLX": torch.clamp(25 * coslat + 10 * normal(9, (ncol,)),
                                  min=0),
        "pbuf_TAUX": 0.05 * normal(10, (ncol,)),
        "pbuf_TAUY": 0.05 * normal(11, (ncol,)),
        "pbuf_COSZRS": torch.clamp(coslat + 0.2 * normal(12, (ncol,)), 0, 1),
        "cam_in_ALDIF": frac(13), "cam_in_ALDIR": frac(14),
        "cam_in_ASDIF": frac(15), "cam_in_ASDIR": frac(16),
        "cam_in_LWUP": 5.67e-8 * T_sfc ** 4,
        "cam_in_ICEFRAC": torch.clamp(1 - 2 * coslat, 0, 1),
        "cam_in_LANDFRAC": torch.clamp(0.3 + 0.4 * normal(17, (ncol,)), 0, 1),
        "cam_in_OCNFRAC": torch.clamp(0.7 - 0.4 * normal(17, (ncol,)), 0, 1),
        "cam_in_SNOWHICE": torch.clamp(-0.1 + 0.2 * normal(18, (ncol,)),
                                       min=0),
        "cam_in_SNOWHLAND": torch.clamp(0.05 * normal(19, (ncol,)), min=0),
        "pbuf_ozone": ozone, "pbuf_CH4": ch4, "pbuf_N2O": n2o,
        "clat": torch.cos(torch.deg2rad(lat)).to(dt),
        "slat": torch.sin(torch.deg2rad(lat)).to(dt),
        "icol": torch.arange(1, ncol + 1, dtype=dt, device=dev),
    }
    # dynamics/previous-step features default to small tendencies; the
    # level fields' factor is the reference's, Python's string hash
    # included, which changes from process to process (ROADMAP C)
    zero_lev = 1e-6 * normal(20, (ncol, nlev))
    for name in vset.inputs.names:
        if name not in state:
            if V.var_len(name) == nlev:
                state[name] = zero_lev * (1.0 + 0.1 * hash(name) % 7)
            else:
                base = {"tm_state_ps": ps, "tm_pbuf_SOLIN": solin}.get(name)
                state[name] = base if base is not None else \
                    0.01 * normal(21, (ncol,))
    return state
