"""The port's online hybrid loop against the JAX package's HybridLoop on the
CPU: proxy-grid mapping, spherical metric, fixers, a 3-step rollout of
the production configuration (sphere FV through the fused stencil, the
channel-major fused emulator, both fixers), and 3-step rollouts of the
other single-device configurations (flat geometry, semi-Lagrangian and
no transport, vertical advection, the batch-major contract with the scan
and the v3 and v4 fused emulators, a feature builder)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu.models import common as jcommon
from climsim_tpu.models.rnn import RNNAutoreg as JaxRNNAutoreg
from climsim_tpu.online import advection as jadv
from climsim_tpu.online.host_loop import (HostLoopConfig as JaxConfig,
                                          HybridLoop as JaxLoop)
from climsim_tpu_torch import Grid
from climsim_tpu_torch.models import F32, RNNAutoreg, from_flax_params
from climsim_tpu_torch.online import advection as tadv
from climsim_tpu_torch.online.host_loop import HostLoopConfig, HybridLoop

NLAT, NLON, NLEV = 4, 6, 8
NCOL = NLAT * NLON
XSCALE = np.array([250.0, 1e-3, 1e-5, 1e-5, 10.0, 10.0], np.float32)
YSCALE = np.array([1e-5, 1e-8, 1e-9, 1e-9, 1e-5, 1e-5], np.float32)
PROD = dict(nlat=NLAT, nlon=NLON, scheme="fv", geometry="sphere",
            use_pallas=True, fix_water=True, fix_energy=True,
            emulator_level_major=True)


def _state(seed=1):
    """bench.py's initial state, at the test's size."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return {
        "T": f32(rng.uniform(220, 300, (NCOL, NLEV))),
        "qv": f32(np.abs(rng.normal(1e-3, 3e-4, (NCOL, NLEV)))),
        "qc": f32(np.abs(rng.normal(1e-5, 3e-6, (NCOL, NLEV)))),
        "qi": f32(np.abs(rng.normal(1e-5, 3e-6, (NCOL, NLEV)))),
        "u": f32(rng.normal(0, 10, (NCOL, NLEV))),
        "v": f32(rng.normal(0, 3, (NCOL, NLEV))),
    }


def _x_sfc():
    rng = np.random.default_rng(2)
    xs = rng.normal(0, 1, (NCOL, 24)).astype(np.float32)
    xs[:, 0] = 1e5 + rng.normal(0, 500, NCOL)
    return xs


def test_grid_synthetic_matches_jax():
    jg, tg = JaxGrid.synthetic(NCOL, nlev=NLEV), Grid.synthetic(NCOL, NLEV)
    for k in ("lat", "lon", "area", "area_wgt", "hyai", "hybi", "hyam",
              "hybm"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                      np.asarray(getattr(jg, k)), err_msg=k)
    ps = _x_sfc()[:, 0]
    for fn in ("interface_pressure", "mid_pressure", "layer_thickness",
               "mass_weights"):
        np.testing.assert_allclose(
            getattr(tg, fn)(torch.as_tensor(ps)).numpy(),
            np.asarray(getattr(jg, fn)(jnp.asarray(ps))), rtol=1e-6,
            err_msg=fn)


def test_proxy_grid_and_metric_match_jax():
    rng = np.random.default_rng(4)
    lat = rng.uniform(-89, 89, NCOL).astype(np.float32)
    lon = rng.uniform(0, 360, NCOL).astype(np.float32)
    jg, js = jadv.build_proxy_grid(lat, lon, NLAT, NLON)
    tg, ts = tadv.build_proxy_grid(lat, lon, NLAT, NLON)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(ts, js)
    x = rng.normal(size=(NCOL, NLEV)).astype(np.float32)
    grid_t = tadv.to_grid(torch.as_tensor(x), torch.as_tensor(tg), NLAT, NLON)
    grid_j = jadv.to_grid(jnp.asarray(x), jnp.asarray(jg), NLAT, NLON)
    np.testing.assert_array_equal(grid_t.numpy(), np.asarray(grid_j))
    back = tadv.to_columns(grid_t, torch.as_tensor(ts))
    np.testing.assert_array_equal(back.numpy(), x)
    bands = np.sort(lat).reshape(NLAT, NLON).mean(1)
    jm = jadv.spherical_metric(bands, NLON, 1200.0)
    tm = tadv.spherical_metric(bands, NLON, 1200.0)
    for k in ("dtdx", "dtdy", "cf_fac", "wf", "wc", "cosc", "cell_w"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k),
                                      err_msg=k)


@pytest.mark.parametrize("weighted", [False, True])
def test_conservation_fixer_matches_jax(weighted):
    rng = np.random.default_rng(6)
    q_old = np.abs(rng.normal(1e-3, 3e-4, (NCOL, NLEV))).astype(np.float32)
    q_new = (q_old + rng.normal(0, 2e-4, q_old.shape)).astype(np.float32)
    w = rng.uniform(50, 150, q_old.shape).astype(np.float32) \
        if weighted else None
    got = tadv.conservation_fixer(
        torch.as_tensor(q_new), torch.as_tensor(q_old),
        None if w is None else torch.as_tensor(w))
    ref = jadv.conservation_fixer(jnp.asarray(q_new), jnp.asarray(q_old),
                                  None if w is None else jnp.asarray(w))
    assert (got >= 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0)


# the emulator arms the rollouts run, as RNNAutoreg flags: the channel-major
# v6 flagship and the batch-major arms
EMULATOR_ARMS = {
    "v6": dict(use_pallas=True, fuse_heads=True, fuse_init=True,
               level_major=True),
    "scan": {},
    "v3": dict(use_pallas=True, fuse_heads=True),
    "v4": dict(use_pallas=True, fuse_heads=True, fuse_init=True),
}


def _emulators(arm="v6"):
    """The JAX and the port emulator on the same flax parameters, wrapped
    as bench.py wraps them: normalise -> model -> scale, in the arm's
    layout (channel-major v6, or one of the batch-major arms)."""
    kw = dict(nx=6, nx_sfc=24, ny=6, ny_sfc=8, nneur=(16, 16), nh_mem=4,
              add_pres=False, **EMULATOR_ARMS[arm])
    if kw.get("level_major"):
        shapes = ((NLEV, 6, NCOL), (NLEV, 4, NCOL))
        col = lambda a: a[:, None]
    else:
        shapes = ((NCOL, NLEV, 6), (NCOL, NLEV, 4))
        col = lambda a: a
    jm = JaxRNNAutoreg(policy=jcommon.F32, **kw)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.ones(shapes[0], jnp.float32) * 0.1,
                     jnp.ones((NCOL, 24), jnp.float32) * 0.1,
                     jnp.zeros(shapes[1], jnp.float32))
    tm = RNNAutoreg(policy=F32, device="cpu", **kw)
    assert tm.arm == arm
    tm.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tm))
    jxs, jys = col(jnp.asarray(XSCALE)), col(jnp.asarray(YSCALE))
    txs, tys = col(torch.as_tensor(XSCALE)), col(torch.as_tensor(YSCALE))

    def jax_emulator(x_main_raw, x_sfc_raw, mem):
        out, out_sfc, mem = jm.apply(params, x_main_raw / jxs, x_sfc_raw, mem)
        return out * jys, out_sfc, mem

    def port_emulator(x_main_raw, x_sfc_raw, mem):
        out, out_sfc, mem = tm(x_main_raw / txs, x_sfc_raw, mem)
        return out * tys, out_sfc, mem

    return jax_emulator, port_emulator


def _rollouts(cfg: dict, arm="v6", builders=(None, None)):
    """3 coupled steps of the JAX loop and of the port's (plain versions)
    in the same configuration from the same state."""
    jax_emu, port_emu = _emulators(arm)
    level_major = cfg["emulator_level_major"]
    jg, tg = JaxGrid.synthetic(NCOL, nlev=NLEV), Grid.synthetic(NCOL, NLEV)
    jloop = JaxLoop(jax_emu, jg, JaxConfig(**cfg), feature_builder=builders[0])
    tloop = HybridLoop(port_emu, tg, HostLoopConfig(**cfg),
                       feature_builder=builders[1], device="cpu")
    st, xs = _state(), _x_sfc()
    mem0 = np.zeros((NLEV, 4, NCOL) if level_major else (NCOL, NLEV, 4),
                    np.float32)
    js, jmem, jd = jloop.rollout({k: jnp.asarray(v) for k, v in st.items()},
                                 jnp.asarray(mem0), jnp.asarray(xs), 3)
    with torch.no_grad():
        ts, tmem, td = tloop.rollout(
            {k: torch.as_tensor(v) for k, v in st.items()},
            torch.as_tensor(mem0), torch.as_tensor(xs), 3)
    return (js, jmem, jd), (ts, tmem, td)


def _assert_rollouts_agree(jax_run, port_run):
    """Tolerances: the state is float32 at ~250 K, and the energy fixer's
    shift (e_pre - e_post) / (cp sum w) cancels two moist-energy integrals
    of ~1e9 in f32, an absolute error of ~1e-5 K per step, hence atol 1e-4
    on T; the water fixer's ratio is a ratio of f32 sums (rtol 1e-5);
    energy_resid is a mean of f32 column sums of cancelling terms (rtol
    1e-4 of its scale)."""
    (js, jmem, jd), (ts, tmem, td) = jax_run, port_run
    tol = {"T": (1e-6, 1e-4), "u": (1e-5, 1e-5), "v": (1e-5, 1e-5)}
    for k in js:
        rtol, atol = tol.get(k, (1e-5, 1e-12))
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=rtol, atol=atol, err_msg=k)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), rtol=1e-5,
                               atol=1e-6)
    assert set(td) == set(jd)
    for k in ("mean_T", "energy_int", "precc", "sfc_fluxes"):
        if k in jd:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    if "energy_resid" in jd:
        er = np.asarray(jd["energy_resid"])
        np.testing.assert_allclose(td["energy_resid"].numpy(), er, rtol=0,
                                   atol=1e-4 * np.abs(er).max(),
                                   err_msg="energy_resid")
    assert td["mean_T"].shape == (3,)


def test_rollout_matches_jax_production_config():
    """3 coupled steps of the production configuration."""
    _assert_rollouts_agree(*_rollouts(PROD))


# the other single-device configurations; a flat raster of 100 km cells
# (Courant numbers ~0.1-0.4 at 10-30 m/s) and, for semi-Lagrangian
# transport on it, of 10 km cells, so that departures cross cells
NEW_CONFIGS = {
    "flat_fused": dict(PROD, geometry="flat", dx=1e5, dy=1e5),
    "flat_per_field": dict(PROD, geometry="flat", use_pallas=False,
                           dx=1e5, dy=1e5),
    "sl_sphere": dict(PROD, scheme="semi_lagrangian"),
    "sl_flat": dict(PROD, scheme="semi_lagrangian", geometry="flat",
                    dx=1e4, dy=1e4),
    "vertical_sphere": dict(PROD, vertical_advection=True),
    "vertical_flat": dict(PROD, geometry="flat", vertical_advection=True,
                          dx=1e5, dy=1e5),
    "no_transport": dict(PROD, scheme="none", vertical_advection=True),
}


@pytest.mark.parametrize("name", list(NEW_CONFIGS))
def test_rollout_matches_jax_ported_configs(name):
    """3 coupled steps of each configuration with the channel-major
    flagship, as the production test."""
    _assert_rollouts_agree(*_rollouts(NEW_CONFIGS[name]))


def test_rollout_matches_jax_batch_major_scan():
    """The batch-major contract (x_main [B, L, 6], ptend[:, :, j]) with
    the scan emulator, sphere FV per field."""
    cfg = dict(PROD, emulator_level_major=False, use_pallas=False)
    _assert_rollouts_agree(*_rollouts(cfg, arm="scan"))


@pytest.mark.parametrize("arm", ["v3", "v4"])
def test_rollout_matches_jax_batch_major_fused(arm):
    """The batch-major contract with the v3 and v4 fused emulators (kernels
    B9 and B10 on the card), the production transport (the fused
    spherical stencil), at the batch-major scan case's tolerances:
    HybridLoop serves them unchanged."""
    cfg = dict(PROD, emulator_level_major=False)
    _assert_rollouts_agree(*_rollouts(cfg, arm=arm))


def test_rollout_matches_jax_feature_builder():
    """A caller's feature builder: total water in channel 1, the surface
    pressure raised by 1%, channel-major."""
    def builder(xp):
        def build(state, x_sfc_raw):
            fields = (state["T"], state["qv"] + state["qc"] + state["qi"],
                      state["qc"], state["qi"], state["u"], state["v"])
            x_sfc = xp.concatenate([x_sfc_raw[:, :1] * 1.01,
                                    x_sfc_raw[:, 1:]], 1)
            return xp.stack([f.T for f in fields], 1), x_sfc
        return build
    _assert_rollouts_agree(*_rollouts(PROD, builders=(builder(jnp),
                                                      builder(torch))))


def test_fused_and_per_field_transport_agree():
    """advect_all through the fused stencil wrapper == per-field advect
    (both plain on the CPU)."""
    tg = Grid.synthetic(NCOL, NLEV)
    st = {k: torch.as_tensor(v) for k, v in _state().items()}
    fused = HybridLoop(None, tg, HostLoopConfig(**PROD), device="cpu")
    per = HybridLoop(None, tg, HostLoopConfig(**{**PROD, "use_pallas": False}),
                     device="cpu")
    a = fused.advect_all(st, st["u"], st["v"])
    b = per.advect_all(st, st["u"], st["v"])
    for k in st:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-6)


def test_unported_configs_raise():
    """The configurations that waited for this port now build (their
    rollouts are held against JAX above); only names outside the JAX
    configuration's choices are refused."""
    tg = Grid.synthetic(NCOL, NLEV)
    for over in ({"geometry": "flat"}, {"scheme": "semi_lagrangian"},
                 {"scheme": "none"}, {"vertical_advection": True},
                 {"emulator_level_major": False}):
        loop = HybridLoop(None, tg, HostLoopConfig(**{**PROD, **over}),
                          device="cpu")
        assert (loop.metric is None) == (loop.cfg.geometry == "flat")
    for over in ({"geometry": "torus"}, {"scheme": "spectral"}):
        with pytest.raises(ValueError):
            HybridLoop(None, tg, HostLoopConfig(**{**PROD, **over}),
                       device="cpu")
