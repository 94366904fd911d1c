"""Synthetic ClimSim column states, targets and time series on tensors.

Counterpart of ``climsim_tpu/data/synthetic.py``: ``_profile``,
``SyntheticConfig``, ``generate_state`` (the initial state of the coupled
step's CLI, ``cli/run_hybrid.py``), and ``synthetic_physics``,
``pack_keeplev``, ``pack_flat`` and ``make_timeseries`` (the training data
of the rollout-training CLI, ``cli/train_rollout.py``), and the balanced
physics of long coupled runs: ``EquilibriumConfig``,
``equilibrium_forcing``, ``equilibrium_physics`` and
``equilibrium_emulator`` (the ``HybridLoop`` emulator contract).

Randomness. JAX splits keys and draws each noise field from its own key.
Here every standard-normal draw goes through one draw function
``draw(key, shape)``, indexed by the JAX key it replaces:

* in ``generate_state``, ``i`` for ``keys[i]`` of its 32-way split, and
  ``(0, 0)`` and ``(0, 1)`` for the two sub-keys that ``_profile`` splits
  from ``keys[0]``. A key read twice gives the same numbers both times,
  as in JAX (``keys[17]`` drives both the land and the ocean fraction,
  ``keys[21]`` every filled scalar);
* in ``synthetic_physics``, ``j`` for the j-th key of its 4-way split of
  the noise key (dT, dq, dqc, dqi);
* in ``equilibrium_forcing``, ``i`` for the i-th key of its 4-way split
  (ps, LHFLX, SHFLX, LANDFRAC);
* in ``make_timeseries``, which splits its key into ``k0`` (the initial
  state) and ``kscan`` (one key per step, each split into ``k1``,
  ``k2``, ``k3``): ``("k0", i)`` for generate_state's key ``i``,
  ``("k1", t, j)`` for step t's physics noise j, ``("k2", t)`` for its
  temperature noise and ``("k3", t)`` for its wind noise.

The default draw takes normals from a ``torch.Generator`` on the CPU, in
the order in which the keys are first read, and moves them to the grid's
device, so one seed gives the same data on every device; a test passes
JAX's own draws. JAX's ``lax.scan`` over the steps is a Python loop here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import constants as C
from .. import variables as V
from ..grid import Grid
from ..physics import thermo


def _linspace(start: float, stop: float, num: int, dtype: torch.dtype,
              device, endpoint: bool = True) -> torch.Tensor:
    """``jnp.linspace(start, stop, num, endpoint=endpoint)`` by JAX's
    formula, start (1 - s) + stop s with s = i / div (div = num - 1 and
    the last point ``stop``, or div = num without the endpoint), so the
    profiles below round as the reference's do."""
    if num < 2:
        return torch.full((num,), start, dtype=dtype, device=device)
    div = num - 1 if endpoint else num
    s = torch.arange(div, dtype=dtype, device=device) / div
    out = start * (1 - s) + stop * s
    if not endpoint:
        return out
    return torch.cat([out, torch.full((1,), stop, dtype=dtype,
                                      device=device)])


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


def _default_draw(generator: torch.Generator | None, dtype: torch.dtype):
    return lambda key, shape: torch.randn(shape, generator=generator,
                                          dtype=dtype)


def synthetic_physics(state: dict, grid: Grid,
                      generator: torch.Generator | None,
                      cfg: SyntheticConfig, draw=None) -> dict:
    """Deterministic nonlinear 'CRM' producing targets from inputs, with
    multiplicative target noise from ``draw(j, shape)`` (j = 0..3 for dT,
    dq, dqc, dqi; by default normals from ``generator``). The tendencies
    and surface fluxes of the reference's smooth surrogate: heating from
    shortwave absorption and latent heating, moistening opposing the
    humidity anomaly, condensate relaxation, damped winds, and
    precipitation closing the column water budget."""
    dt = getattr(torch, cfg.dtype)
    if draw is None:
        draw = _default_draw(generator, dt)
    T, q = state["state_t"], state["state_q0001"]
    dev = T.device
    ps, solin = state["state_ps"], state["pbuf_SOLIN"]
    pmid = grid.mid_pressure(ps)
    rh = thermo.specific_to_relative_humidity(q, T, pmid)

    s = _linspace(0.0, 1.0, cfg.nlev, dt, dev)[None, :]
    sw_heat = (solin[:, None] / 1360.0) * 2e-5 * torch.exp(-2 * (1 - s))
    lat_heat = 4e-5 * torch.tanh(3 * (rh - 0.7)) * s
    dT = sw_heat + lat_heat \
        + 1e-5 * torch.sin(3 * s) * (T / 280.0 - 1.0)
    # diurnal convective moisture sink: every column's precc varies in
    # time, so the time-TSS R2 convention stays finite
    conv = (5e-9 + 2.5e-8 * state["pbuf_COSZRS"][:, None]) * s
    dq = -2e-8 * torch.tanh(3 * (rh - 0.7)) * s \
        - 5e-9 * (rh - 0.5) - conv
    # micro-variability keeps the condensate channels' time-axis TSS
    # nonzero at their structural zeros
    micro = 1e-12 * (0.05 + s) * state["pbuf_COSZRS"][:, None]
    fliq = thermo.liquid_fraction(T)
    dqc = 5e-9 * torch.tanh(5 * (rh - 0.9)) * fliq * s + micro
    dqi = 5e-9 * torch.tanh(5 * (rh - 0.9)) * (1 - fliq) * s + micro
    du = -state["state_u"] * 1e-6
    dv = -state["state_v"] * 1e-6

    noise = cfg.target_noise
    if noise > 0:
        n = lambda j, a: draw(j, tuple(a.shape)).to(device=dev, dtype=dt)
        dT = dT * (1 + noise * n(0, dT))
        dq = dq * (1 + noise * n(1, dq))
        dqc = dqc * (1 + noise * n(2, dqc))
        dqi = dqi * (1 + noise * n(3, dqi))

    # column water sink -> precip (closes the water budget by construction)
    dp_g = grid.mass_weights(ps)
    sink = -torch.sum(dp_g * (dq + dqc + dqi), dim=1)        # kg m-2 s-1
    precc = torch.clamp(sink / C.RHO_H2O, min=0.0)          # m s-1
    # 2% snow-fraction floor keeps PRECSC varying in warm columns
    snow_frac = torch.clamp(thermo.snow_fraction(T[:, -1]), min=0.02)
    precsc = precc * snow_frac

    coszrs = state["pbuf_COSZRS"]
    netsw = solin * (1.0 - 0.3) * coszrs
    flwds = 5.67e-8 * (T[:, -1] ** 4) * 0.8
    return {
        "ptend_t": dT, "ptend_q0001": dq, "ptend_q0002": dqc,
        "ptend_q0003": dqi, "ptend_qn": dqc + dqi,
        "ptend_u": du, "ptend_v": dv,
        "cam_out_NETSW": netsw, "cam_out_FLWDS": flwds,
        "cam_out_PRECSC": precsc, "cam_out_PRECC": precc,
        "cam_out_SOLS": netsw * 0.3, "cam_out_SOLL": netsw * 0.35,
        "cam_out_SOLSD": netsw * 0.15, "cam_out_SOLLD": netsw * 0.2,
    }


def pack_keeplev(state: dict, target: dict, vset: V.VariableSet):
    """Pack per-variable dicts into the keeplev 4-tuple
    (x_lev, x_sfc, y_lev, y_sfc)."""
    st = lambda src, names: torch.stack([src[n] for n in names], dim=-1)
    return (st(state, vset.inputs.lev_names), st(state, vset.inputs.sfc_names),
            st(target, vset.outputs.lev_names),
            st(target, vset.outputs.sfc_names))


def pack_flat(state: dict, target: dict, vset: V.VariableSet):
    """Pack into flat (x [N, nx], y [N, ny]) vectors in registry order."""
    col = lambda src, n: src[n] if V.var_len(n) == V.NLEV \
        else src[n][:, None]
    return (torch.cat([col(state, n) for n in vset.inputs.names], dim=1),
            torch.cat([col(target, n) for n in vset.outputs.names], dim=1))


@dataclass(frozen=True)
class EquilibriumConfig:
    """Balanced moist 'CRM' physics for long coupled runs: Newtonian
    relaxation toward a solar-dependent radiative-convective profile,
    saturation-adjustment condensation with latent heating,
    autoconversion precipitation, surface evaporation and sensible flux,
    and Rayleigh friction toward a jet, so the hybrid loop has a stable
    truth climate (the role of E3SM-MMF in the reference's online
    evaluation, online_testing/README.md §5-6). The timescales are
    explicit-Euler stable at DT_STEP = 1200 s and the tendencies of the
    ClimSim dataset's magnitudes."""
    tau_rad: float = 1.296e6     # radiative relaxation, 15 days      [s]
    tau_cond: float = 3600.0     # condensation relaxation            [s]
    tau_evap: float = 7200.0     # cloud re-evaporation               [s]
    tau_auto_liq: float = 7200.0   # qc -> precip autoconversion      [s]
    tau_auto_ice: float = 10800.0  # qi -> precip autoconversion      [s]
    tau_fric: float = 4.32e5     # Rayleigh friction, 5 days          [s]
    rain_eff: float = 0.5        # fraction of condensate raining out
    #                              directly (convective precipitation)
    rh_cond: float = 0.9         # condensation onset relative humidity
    rh_evap: float = 0.8         # cloud evaporation below this rh
    t_top: float = 205.0         # equilibrium TOA temperature        [K]
    t_sfc_base: float = 235.0    # equilibrium surface T at solin_eff=0
    t_sfc_solar: float = 62.0    # dT_sfc per unit (solin_eff/1360)
    n_sfc_levels: int = 5        # levels receiving surface fluxes
    u_jet: float = 25.0          # equilibrium jet amplitude       [m/s]
    # stationary-wave meridional forcing: v relaxes toward
    # v_wave * sin(4 lon) cos(lat) * sin(pi sigma) (the pattern in x_sfc
    # channel 8)
    v_wave: float = 6.0          # meridional wave amplitude       [m/s]


def equilibrium_forcing(generator: torch.Generator | None, grid: Grid,
                        ncol: int, dtype: torch.dtype = torch.float32,
                        draw=None) -> torch.Tensor:
    """Fixed per-column boundary forcing x_sfc [ncol, 24] on the grid's
    device, raw units: 0 ps, 1 SOLIN, 2 COSZRS, 3 LHFLX, 4 SHFLX,
    5 sin(lat), 6 cos(lat), 7 LANDFRAC, 8 the stationary-wave pattern
    sin(4 lon) cos(lat), 9..23 zero (channel 0 must be the surface
    pressure: the host loop reads it). The normals come from ``draw(i,
    shape)`` (module docstring), by default from ``generator``."""
    if draw is None:
        draw = _default_draw(generator, dtype)
    dev = grid.lat.device
    normal = lambda i: draw(i, (ncol,)).to(dtype=dtype, device=dev)
    lat, lon = grid.lat[:ncol], grid.lon[:ncol]
    coslat = torch.cos(torch.deg2rad(lat)).to(dtype)
    ps = 1.0e5 + 3e3 * (coslat - coslat.mean()) + 300.0 * normal(0)
    solin = torch.clamp(1360.0 * coslat, min=0.0)
    coszrs = torch.clamp(coslat, 0.05, 1.0)
    lhflx = torch.clamp(90.0 * coslat + 10.0 + 8.0 * normal(1), min=5.0)
    shflx = torch.clamp(25.0 * coslat + 5.0 + 4.0 * normal(2), min=2.0)
    landfrac = torch.clamp(0.3 + 0.4 * normal(3), 0.0, 1.0)
    cols = [ps, solin, coszrs, lhflx, shflx,
            torch.sin(torch.deg2rad(lat)).to(dtype), coslat, landfrac,
            (torch.sin(4.0 * torch.deg2rad(lon)) * coslat).to(dtype)]
    zero = torch.zeros((ncol,), dtype=dtype, device=dev)
    return torch.stack(cols + [zero] * (24 - len(cols)), dim=1)


def equilibrium_physics(T, qv, qc, qi, u, v, x_sfc, grid: Grid,
                        cfg: EquilibriumConfig = EquilibriumConfig()):
    """Balanced column physics: (state [B, L] fields, forcing [B, 24]) ->
    (ptend [B, L, 6], sfc_out [B, 8]). Smooth (tanh/exp gates, no hard
    switches) and water-closed by construction: column precipitation is
    the autoconversion and direct-rain sink, surface evaporation an
    explicit source. sfc_out follows the v1 output scalars (NETSW, FLWDS,
    PRECSC, PRECC, SOLS, SOLL, SOLSD, SOLLD)."""
    ps, solin, coszrs = x_sfc[:, 0], x_sfc[:, 1], x_sfc[:, 2]
    lhflx, shflx = x_sfc[:, 3], x_sfc[:, 4]
    B, L = T.shape
    pmid = grid.mid_pressure(ps)
    dp = grid.layer_thickness(ps)
    sigma = pmid / ps[:, None]

    # 1. Newtonian relaxation toward a solar-dependent RCE profile; the
    # quadratic boost (tau/2 at |T-Teq| = 30 K) keeps local heating
    # bursts from running away
    solin_eff = solin * coszrs
    t_sfc_eq = cfg.t_sfc_base + cfg.t_sfc_solar * (solin_eff / 1360.0)
    Teq = cfg.t_top + (t_sfc_eq[:, None] - cfg.t_top) * sigma ** 1.1
    dT = (Teq - T) * (1.0 + ((T - Teq) / 30.0) ** 2) / cfg.tau_rad

    # 2. saturation adjustment, implicit in the latent heating (the
    # moist-adjustment denominator 1 + L^2 qs / (cp Rv T^2))
    qs = thermo.qsat(T, pmid)
    fliq = thermo.liquid_fraction(T)
    L_eff = C.LV * fliq + C.LSUB * (1.0 - fliq)
    gamma = 1.0 + L_eff ** 2 * qs / (C.CP * C.RV * T ** 2)
    cond = torch.clamp(qv - cfg.rh_cond * qs, min=0.0) \
        / (cfg.tau_cond * gamma)
    cloud = qc + qi
    subsat = torch.clamp(cfg.rh_evap * qs - qv, min=0.0) \
        / torch.clamp(qs, min=1e-8)
    evap = cloud * subsat / (cfg.tau_evap * gamma)
    wc = qc / torch.clamp(cloud, min=1e-12)
    dqv = -cond + evap
    dT = dT + (C.LV * (cond * fliq - evap * wc)
               + C.LSUB * (cond * (1 - fliq) - evap * (1 - wc))) / C.CP

    # 3. precipitation: a rain_eff share of fresh condensate falls out
    # directly; the stored cloud autoconverts slowly
    auto_c = qc / cfg.tau_auto_liq
    auto_i = qi / cfg.tau_auto_ice
    store = 1.0 - cfg.rain_eff
    dqc = store * cond * fliq - evap * wc - auto_c
    dqi = store * cond * (1 - fliq) - evap * (1 - wc) - auto_i

    # 4. surface fluxes into the lowest n_sfc_levels (mass-weighted)
    nb = cfg.n_sfc_levels
    mask = torch.zeros((L,), dtype=T.dtype, device=T.device)
    mask[-nb:] = 1.0
    mask = mask[None, :]
    mcol = torch.sum(dp * mask, dim=1, keepdim=True) / C.GRAV  # kg m-2
    E = lhflx[:, None] / C.LV                                   # kg m-2 s-1
    # evaporation shuts off as the boundary layer saturates
    dryness = torch.clamp(1.0 - qv / torch.clamp(qs, min=1e-8), 0.0, 1.0)
    dqv = dqv + mask * dryness * E / mcol
    dT = dT + mask * shflx[:, None] / (C.CP * mcol)

    # 5. Rayleigh friction toward the jet (baroclinic: peaks mid-column
    # at mid-latitudes) and the stationary wave
    sinl, cosl = x_sfc[:, 5], x_sfc[:, 6]
    ujet = cfg.u_jet * (2 * sinl * cosl)[:, None] \
        * torch.sin(math.pi * sigma)
    veq = cfg.v_wave * x_sfc[:, 8][:, None] * torch.sin(math.pi * sigma)
    du = (ujet - u) / cfg.tau_fric
    dv = (veq - v) / cfg.tau_fric

    ptend = torch.stack([dT, dqv, dqc, dqi, du, dv], dim=-1)

    # surface scalars: precip = direct convective rain + autoconversion,
    # exactly the column water sink
    sink = torch.sum((dp / C.GRAV) * (auto_c + auto_i
                                      + cfg.rain_eff * cond), dim=1)
    precc = sink / C.RHO_H2O                                   # m s-1
    precsc = precc * thermo.snow_fraction(T[:, -1])
    netsw = solin_eff * 0.7
    flwds = 5.67e-8 * 0.8 * T[:, -1] ** 4
    sfc_out = torch.stack([netsw, flwds, precsc, precc, netsw * 0.3,
                           netsw * 0.35, netsw * 0.15, netsw * 0.2], dim=-1)
    return ptend, sfc_out


def equilibrium_emulator(grid: Grid,
                         cfg: EquilibriumConfig = EquilibriumConfig()):
    """:func:`equilibrium_physics` in the ``HybridLoop`` emulator contract
    (online/host_loop.py): (x_main_raw [B, L, 6], x_sfc_raw [B, 24], mem)
    -> (ptend, sfc_out, mem)."""
    def emulator(x_main, x_sfc, mem):
        ptend, sfc = equilibrium_physics(
            x_main[..., 0], x_main[..., 1], x_main[..., 2], x_main[..., 3],
            x_main[..., 4], x_main[..., 5], x_sfc, grid, cfg)
        return ptend, sfc, mem
    return emulator


def make_timeseries(generator: torch.Generator | None, cfg: SyntheticConfig,
                    grid: Grid, nsteps: int, flat: bool = True, draw=None):
    """``nsteps`` of (x, y) with temporal correlation, on the grid's
    device: the state evolves by the synthetic tendencies, under a diurnal
    insolation cycle (hour angle from the column longitudes), a slow
    'seasonal' solar modulation, flux forcing that follows the sun and
    evolving winds, so every channel varies in time per column. Returns
    the keeplev 4-tuple stacked over time ([T, B, ...] each), or with
    ``flat`` (x [T, B, nx], y [T, B, ny]). The draws: module docstring."""
    vset = V.get(cfg.vset_name)
    dt = getattr(torch, cfg.dtype)
    dev = grid.lat.device
    ncol = cfg.ncol
    if draw is None:
        draw = _default_draw(generator, dt)
    f32 = torch.float32
    lat = grid.lat[:ncol] if grid.ncol >= ncol \
        else _linspace(-88.0, 88.0, ncol, f32, dev)
    lon = grid.lon[:ncol] if grid.ncol >= ncol \
        else _linspace(0.0, 360.0, ncol, f32, dev, endpoint=False)
    coslat = torch.cos(torch.deg2rad(lat)).to(f32)
    lonrad = torch.deg2rad(lon).to(f32)
    # the angular rates rounded to float32 once, as JAX's weak-typed
    # Python scalars meet the float32 step counter
    omega_day = torch.tensor(2.0 * math.pi * C.DT_STEP / 86400.0, dtype=f32,
                             device=dev)
    omega_seas = torch.tensor(2.0 * math.pi / 2048.0, dtype=f32, device=dev)
    n = lambda key, like: draw(key, tuple(like.shape)).to(device=dev,
                                                          dtype=like.dtype)

    state = generate_state(None, cfg, grid,
                           draw=lambda key, shape: draw(("k0", key), shape))
    t = torch.zeros((), dtype=f32, device=dev)
    outs = []
    for step in range(nsteps):
        # time-varying boundary forcing BEFORE the physics so x and y see
        # the same instant
        mu = torch.clamp(coslat * torch.cos(lonrad + omega_day * t), 0.0, 1.0)
        seas = 1.0 + 0.1 * torch.sin(omega_seas * t)
        state = dict(state)
        state["pbuf_COSZRS"] = mu
        state["pbuf_SOLIN"] = 1360.0 * seas * torch.ones_like(mu)
        state["pbuf_LHFLX"] = (80.0 * coslat + 20.0) * (0.7 + 0.6 * mu)
        state["pbuf_SHFLX"] = (25.0 * coslat + 5.0) * (0.7 + 0.6 * mu)
        target = synthetic_physics(
            state, grid, None, cfg,
            draw=lambda j, shape, step=step: draw(("k1", step, j), shape))
        outs.append(pack_flat(state, target, vset) if flat
                    else pack_keeplev(state, target, vset))
        # advance the prognostic state by the tendencies (+ small noise)
        new = dict(state)
        new["state_t"] = state["state_t"] + C.DT_STEP * target["ptend_t"] \
            + 0.1 * n(("k2", step), state["state_t"])
        new["state_q0001"] = torch.clamp(
            state["state_q0001"] + C.DT_STEP * target["ptend_q0001"],
            min=1e-9)
        if "state_q0002" in state:
            new["state_q0002"] = torch.clamp(
                state["state_q0002"] + C.DT_STEP * target["ptend_q0002"],
                min=0)
            new["state_q0003"] = torch.clamp(
                state["state_q0003"] + C.DT_STEP * target["ptend_q0003"],
                min=0)
        # winds evolve too, so du/dv vary in time per column
        new["state_u"] = state["state_u"] + C.DT_STEP * target["ptend_u"] \
            + 2.0 * torch.sin(omega_day * t / 8.0) \
            * n(("k3", step), state["state_u"]) * 0.2 \
            + 0.3 * torch.cos(omega_seas * t)
        new["state_v"] = state["state_v"] + C.DT_STEP * target["ptend_v"] \
            + 0.1 * torch.sin(omega_day * t / 5.0)
        pmid = grid.mid_pressure(new["state_ps"])
        new["state_rh"] = thermo.specific_to_relative_humidity(
            new["state_q0001"], new["state_t"], pmid)
        if "state_qn" in state:
            new["state_qn"] = new["state_q0002"] + new["state_q0003"]
            new["liq_partition"] = thermo.liquid_fraction(new["state_t"])
        state, t = new, t + 1.0
    return tuple(torch.stack(a) for a in zip(*outs))
