"""The port's balanced-climate synthetic physics (``data/synthetic.py::
EquilibriumConfig``, ``equilibrium_forcing``, ``equilibrium_physics``,
``equilibrium_emulator``) against the JAX package's, on the CPU, held as
tests/test_equilibrium.py holds JAX but on ``Grid.synthetic`` (the grid
file is not in the repository): the forcing from JAX's own threefry draws
(fed through ``draw``: Philox cannot give them), the tendencies and
surface scalars of one state to 1e-5 of each field's scale, the water
budget's closure, the emulator contract against JAX's, and a coupled run
through ``HybridLoop`` that stays finite and bounded (float32
throughout)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu import constants as JC
from climsim_tpu.data import synthetic as JS
from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu.physics import thermo as JT
from climsim_tpu_torch import Grid
from climsim_tpu_torch.data import synthetic as TS
from climsim_tpu_torch.online import HostLoopConfig, HybridLoop
from torch_jit import jit_o0

NCOL, NLEV = 384, 60
RTOL = 1e-5


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _setup(seed=1):
    """Both grids, the forcing of PRNGKey(0) in both packages (JAX's
    draws replayed) and tests/test_equilibrium.py's initial state."""
    with jax.enable_x64(False):
        jg = JaxGrid.synthetic(NCOL, NLEV)
        key = jax.random.PRNGKey(0)
        jx = jit_o0(lambda k: JS.equilibrium_forcing(k, jg, NCOL), key)
        keys = jax.random.split(key, 4)
        draws = [np.asarray(jax.random.normal(k, (NCOL,), jnp.float32))
                 for k in keys]
    tg = Grid.synthetic(NCOL, NLEV)
    tx = TS.equilibrium_forcing(None, tg, NCOL,
                                draw=lambda i, s: torch.as_tensor(draws[i]))
    rng = np.random.default_rng(seed)
    coslat = np.cos(np.deg2rad(np.asarray(jg.lat)[:NCOL]))
    s = np.linspace(0, 1, NLEV)
    T = (205.0 + (235 + 62 * coslat[:, None] - 205.0) * s[None, :] ** 1.1
         + rng.normal(0, 2, (NCOL, NLEV))).astype(np.float32)
    with jax.enable_x64(False):
        qv = np.asarray(0.6 * JT.qsat(jnp.asarray(T),
                                      jg.mid_pressure(jx[:, 0])), np.float32)
    st = {"T": T, "qv": qv, "qc": np.full((NCOL, NLEV), 1e-6, np.float32),
          "qi": np.full((NCOL, NLEV), 1e-6, np.float32),
          "u": rng.normal(0, 5, (NCOL, NLEV)).astype(np.float32),
          "v": rng.normal(0, 2, (NCOL, NLEV)).astype(np.float32)}
    return jg, tg, np.asarray(jx), tx, st


def test_forcing_matches_jax():
    _, _, jx, tx, _ = _setup()
    assert tuple(tx.shape) == (NCOL, 24) and tx.dtype == torch.float32
    for c in range(24):
        np.testing.assert_allclose(tx[:, c].numpy(), jx[:, c], rtol=1e-6,
                                   atol=1e-6 * max(np.abs(jx[:, c]).max(),
                                                   1e-30), err_msg=str(c))
    # the default draws come from a torch.Generator: same seed, same data
    tg = Grid.synthetic(NCOL, NLEV)
    a = TS.equilibrium_forcing(torch.Generator().manual_seed(3), tg, NCOL)
    b = TS.equilibrium_forcing(torch.Generator().manual_seed(3), tg, NCOL)
    assert torch.equal(a, b) and torch.isfinite(a).all()


@pytest.mark.parametrize("cfg", [{}, dict(rain_eff=0.2, n_sfc_levels=3,
                                          v_wave=0.0)],
                         ids=["default", "other"])
def test_physics_matches_jax(cfg):
    """Tendencies and scalars of one state, in the ClimSim dataset's
    ranges (tests/test_equilibrium.py::test_tendency_magnitudes_match_
    climsim), with the default and another configuration."""
    jg, tg, jx, tx, st = _setup()
    fields = ("T", "qv", "qc", "qi", "u", "v")
    with jax.enable_x64(False):
        jpt, jsfc = jit_o0(
            lambda *a: JS.equilibrium_physics(*a, jg,
                                              JS.EquilibriumConfig(**cfg)),
            *(jnp.asarray(st[k]) for k in fields), jnp.asarray(jx))
    tpt, tsfc = TS.equilibrium_physics(
        *(torch.as_tensor(st[k]) for k in fields), tx, tg,
        TS.EquilibriumConfig(**cfg))
    assert tuple(tpt.shape) == (NCOL, NLEV, 6) and tuple(tsfc.shape) == (
        NCOL, 8)
    for c in range(6):
        assert _rel(tpt[..., c], jpt[..., c]) <= RTOL, c
    for c in range(8):
        assert _rel(tsfc[:, c], jsfc[:, c]) <= RTOL, c
    assert float(tpt[..., 0].abs().max()) < 5e-3
    assert float(tsfc[:, 3].min()) >= 0.0


def test_water_budget_closes():
    """Column (dqv + dqc + dqi) dp/g + precipitation mass flux - the
    delivered surface evaporation = 0 by construction."""
    _, tg, _, tx, st = _setup()
    cfg = TS.EquilibriumConfig()
    t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in st.items()}
    g64 = Grid.synthetic(NCOL, NLEV, dtype=torch.float64)
    x64 = tx.double()
    pt, sfc = TS.equilibrium_physics(t["T"], t["qv"], t["qc"], t["qi"],
                                     t["u"], t["v"], x64, g64, cfg)
    dp_g = g64.mass_weights(x64[:, 0])
    col = torch.sum(dp_g * (pt[..., 1] + pt[..., 2] + pt[..., 3]), dim=1)
    from climsim_tpu_torch.physics import thermo
    qs = thermo.qsat(t["T"], g64.mid_pressure(x64[:, 0]))
    nb = cfg.n_sfc_levels
    dry = torch.clamp(1.0 - t["qv"] / torch.clamp(qs, min=1e-8), 0, 1)
    m = dp_g[:, -nb:]
    e = torch.sum(m * dry[:, -nb:] * (x64[:, 3:4] / JC.LV)
                  / m.sum(1, keepdim=True), dim=1)
    resid = col + sfc[:, 3] * JC.RHO_H2O - e
    assert float(resid.abs().max()) < 1e-9 * float(e.abs().max())


def test_emulator_matches_jax_and_coupled_run_is_stable():
    """The emulator contract (x_main [B, L, 6], x_sfc [B, 24], memory) ->
    (tendencies, surface scalars, memory) against JAX's on one state, to
    RTOL of each field's scale; then the port's emulator in the hybrid
    loop (sphere FV, the water fixer), 64 coupled steps
    (tests/test_equilibrium.py runs JAX's 120 on the real grid): finite,
    bounded, water non-negative."""
    jg, tg, jx, tx, st = _setup()
    fields = ("T", "qv", "qc", "qi", "u", "v")
    x_main = np.stack([st[k] for k in fields], -1)
    mem = np.zeros((NCOL, 1, 1), np.float32)
    with jax.enable_x64(False):
        jpt, jsfc, jmem = jit_o0(JS.equilibrium_emulator(jg), x_main, jx,
                                 mem)
    tpt, tsfc, tmem = TS.equilibrium_emulator(tg)(
        torch.as_tensor(x_main), tx, torch.as_tensor(mem))
    for c in range(6):
        assert _rel(tpt[..., c], jpt[..., c]) <= RTOL, c
    for c in range(8):
        assert _rel(tsfc[:, c], jsfc[:, c]) <= RTOL, c
    assert torch.equal(tmem, torch.as_tensor(mem))
    kw = dict(scheme="fv", fix_water=True, geometry="sphere", nlat=16,
              nlon=24)
    tloop = HybridLoop(TS.equilibrium_emulator(tg), tg, HostLoopConfig(**kw),
                       device="cpu")
    tst = {k: torch.tensor(v) for k, v in st.items()}
    with torch.no_grad():
        tst, _, _ = tloop.rollout(tst, torch.zeros((NCOL, 1, 1)),
                                  tx.clone(), 64)
    for k, v in tst.items():
        assert torch.isfinite(v).all(), k
    assert 150.0 < float(tst["T"].min()) and float(tst["T"].max()) < 360.0
    assert float(tst["qv"].min()) >= 0.0
