"""The port's physics-constrained emulator (``RadiationModule``,
``PhysicalRNNAutoreg`` in the ``conf/autoreg_physrnn.yaml`` configuration
with either trunk, and its evaluation by ``RolloutTrainer`` with the raw
state) against the JAX package's, on the CPU, on flax parameters carried
across by ``from_flax_params``. The yaml sets no ``use_pallas``, so the
reference CLI builds its model with the scan trunk (two ``RNNLayer``
sweeps, ``rnn_up``/``rnn_down``; cli/train_rollout.py:294); the fused
trunk (``use_pallas=True``, kernel B7 on the card) is the same model with
another parameter tree.

The JAX side runs with 64-bit types off (``jax.enable_x64(False)``): the
suite's conftest turns them on, and the radiation's ``jnp.ones`` would
then lift the SW solver to float64, while both packages compute it in
float32 by default.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu.models.phys_rad import RadiationModule as JaxRadiation
from climsim_tpu.models.phys_rnn import PhysicalRNNAutoreg as JaxPhys
from climsim_tpu.train.rollout import (RolloutConfig as JaxConfig,
                                       RolloutTrainer as JaxTrainer)
from climsim_tpu_torch import Grid
from climsim_tpu_torch.models import (BF16, PhysicalRNNAutoreg,
                                      RadiationModule, from_flax_params)
from climsim_tpu_torch.ops import (adding_sw_fast, fused_bigru_lbh,
                                   lw_solver_noscat_fast)
from climsim_tpu_torch.train import (RolloutConfig, RolloutTrainer,
                                     phys_apply, phys_mem_shape)

L, NX, NX_SFC, NY, NY_SFC = 60, 15, 24, 5, 8
YS = dict(yscale_t=1e5, yscale_qv=1e8, yscale_qn=1e8, yscale_precc=1e7)
_g = JaxGrid.synthetic(4, L)
_tt = lambda a: tuple(float(x) for x in np.asarray(a))
HY = dict(hyai=_tt(_g.hyai), hybi=_tt(_g.hybi), hyam=_tt(_g.hyam),
          hybm=_tt(_g.hybm))
# conf/autoreg_physrnn.yaml's options at narrow widths, with the fused
# trunk; the yaml's own model is SCAN
FUSED = dict(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=(32, 32),
            nh_mem=8, nreg=8, store_precip=True, ice_sedimentation=True,
            use_physrad=True, use_mcica=True, use_tc=False,
            use_qv_variability=True, learned_cloud_optics=False, ng_lw=8,
            ng_sw=8, use_pallas=True, pallas_acc32=True, sp_mean=9.8e4,
            sp_div=1.0, **HY, **YS)
# the model the reference CLI builds from the yaml (use_pallas unset):
# the scan trunk, which also allows unequal widths
SCAN = dict(FUSED, use_pallas=False)
SCAN_TRUNKS = {"scan": SCAN, "scan-unequal": dict(SCAN, nneur=(32, 24))}
# every output and the memory to this share of its largest magnitude: the
# same float32 arithmetic up to summation order through 100 recurrent
# levels, 120 radiation levels and the decode, which grows with the width
# (measured: 3e-6 at nneur 32, 2.9e-5 at the yaml's 128)
RTOL = 1e-4


def _inputs(B, seed=0, nh_mem=8):
    """Normalized inputs, memory with a stored-precip pool, and the raw
    state in physical ranges (T 200-300 K, small positive q), as
    tests/test_phys_rnn.py makes them."""
    rng = np.random.default_rng(seed)
    xm = rng.normal(0, 1, (B, L, NX)).astype(np.float32)
    xs = rng.normal(0, 1, (B, NX_SFC)).astype(np.float32)
    mem = np.abs(rng.normal(0, 0.1, (B, L - 10, nh_mem + 1))).astype(
        np.float32)
    xd = np.zeros((B, L, 6), np.float32)
    xd[:, :, 0] = rng.uniform(200, 300, (B, L))
    xd[:, :, 2] = np.abs(rng.normal(0, 1e-5, (B, L)))
    xd[:, :, 3] = np.abs(rng.normal(0, 1e-5, (B, L)))
    xd[:, :, -1] = np.abs(rng.normal(1e-3, 3e-4, (B, L)))
    return xm, xs, mem, xd


def _pair(B=12, base=FUSED, **over):
    kw = {**base, **over}
    a = _inputs(B, nh_mem=kw["nh_mem"])
    with jax.enable_x64(False):
        jm = JaxPhys(**kw)
        params = jm.init(jax.random.PRNGKey(1), *map(jnp.asarray, a))
    tm = PhysicalRNNAutoreg(**kw, device="cpu")
    tm.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tm))
    return jm, params, tm, a


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _forward_parity(jm, params, tm, a, y_true=None):
    with jax.enable_x64(False):
        jy = None if y_true is None else jnp.asarray(y_true)
        want = jm.apply(params, *map(jnp.asarray, a), jy)
    ty = None if y_true is None else torch.as_tensor(y_true)
    with torch.no_grad():
        got = tm(*map(torch.as_tensor, a), ty)
    for g, w in zip(got[:3], want[:3]):
        assert tuple(g.shape) == w.shape
        assert torch.isfinite(g).all()
        assert _rel(g, w) <= RTOL, _rel(g, w)
    for k, w in want[3].items():
        assert _rel(got[3][k], w) <= RTOL, (k, _rel(got[3][k], w))
    return got


def test_from_flax_params_covers_the_phys_tree():
    """Every leaf of the flax tree of the fused-trunk model (the Dense
    layers, bigru_fused, the radiation's gas-optics MLPs, scalars and
    spectral weights) maps onto one port parameter with its shape."""
    jm, params, tm, _ = _pair()
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    names = {".".join(str(k.key) for k in path) for path, _ in flat}
    assert names == set(tm.state_dict())
    for key in ("bigru_fused.whh_up", "radiation.gas_lw.planck.kernel",
                "radiation.gas_sw.sigma", "radiation.ssa_gas",
                "mlp_precip_release.kernel", "mlp_sed_qn_crm.bias"):
        assert key in names


def test_physical_rnn_matches_jax_yaml_config():
    """The yaml configuration (McICA, qv variability, stored precip, ice
    sedimentation, updated state for radiation) with either trunk, the
    yaml's scan and the fused one: outputs, memory and every aux field
    against the flax model."""
    for base in (SCAN, FUSED):
        _forward_parity(*_pair(base=base))


def test_physical_rnn_matches_jax_yaml_widths():
    """The yaml's own widths (nneur 128/128, nh_mem 16) on 4 columns, with
    either trunk."""
    for base in (SCAN, FUSED):
        _forward_parity(*_pair(B=4, base=base, nneur=(128, 128),
                               nh_mem=16))


def test_physical_rnn_teacher_forced_radiation():
    """y_true replaces the model's tendencies in the state the radiation
    sees (models_phys.py:1722-1741), and so changes the outputs."""
    jm, params, tm, a = _pair()
    y = np.random.default_rng(9).normal(0, 1, (12, L, NY)).astype(
        np.float32)
    forced = _forward_parity(jm, params, tm, a, y)
    with torch.no_grad():
        free = tm(*map(torch.as_tensor, a))
    assert not torch.equal(forced[0], free[0])


@pytest.mark.parametrize("over", [
    dict(use_mcica=False, use_qv_variability=False),
    dict(update_states_for_rad=False, store_precip=False),
    dict(pred_subgrid_temp=False, ice_sedimentation=False,
         use_clear_sky_region=False),
    dict(pred_subgrid_liq_frac=True, condense_supersaturated=True,
         add_pres=True, allow_extra_heating=True),
], ids=["grid-mean-clouds", "no-update-no-store", "no-subgrid-temp",
        "liq-frac-supersat-pres"])
def test_physical_rnn_options_match_jax(over):
    _forward_parity(*_pair(B=6, **over))


@pytest.mark.parametrize("trunk", list(SCAN_TRUNKS))
def test_scan_trunk_loads_the_flax_tree(trunk):
    """The scan trunk's flax tree (rnn_up/rnn_down with input_proj and
    cell/hh, no bigru_fused) maps onto the port's parameters one to one;
    with unequal widths the heads take the down sweep's."""
    _, params, tm, _ = _pair(base=SCAN_TRUNKS[trunk])
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    names = {".".join(str(k.key) for k in path) for path, _ in flat}
    assert names == set(tm.state_dict())
    assert {"rnn_up.input_proj.kernel", "rnn_up.cell.hh.kernel",
            "rnn_down.input_proj.bias", "rnn_down.cell.hh.bias"} <= names
    assert not any(n.startswith("bigru_fused") for n in names)
    nh2 = SCAN_TRUNKS[trunk]["nneur"][1]
    assert tm.mlp_latent.kernel.shape[0] == nh2
    assert tm.mlp_toa1.kernel.shape[1] == nh2


@pytest.mark.parametrize("trunk", list(SCAN_TRUNKS))
def test_scan_trunk_matches_jax(trunk):
    """The yaml's model with the scan trunk, equal and unequal widths:
    outputs, memory and every aux field, free-running and with y_true."""
    jm, params, tm, a = _pair(base=SCAN_TRUNKS[trunk])
    _forward_parity(jm, params, tm, a)
    y = np.random.default_rng(9).normal(0, 1, (12, L, NY)).astype(
        np.float32)
    _forward_parity(jm, params, tm, a, y)


def test_fused_trunk_needs_equal_widths():
    """As in JAX, the fused trunk refuses unequal widths (its parameter
    tree differs, so no silent fallback to the scan trunk)."""
    with pytest.raises(ValueError, match="nneur"):
        PhysicalRNNAutoreg(**{**FUSED, "nneur": (32, 24)}, device="cpu")


def test_radiation_module_matches_jax():
    """RadiationModule alone, grid-mean clouds and McICA paths with the
    two-pass water vapor (no generator: the passes are averaged, as JAX
    without a 'qvvar' rng)."""
    B = 8
    rng = np.random.default_rng(3)
    f = lambda *s, lo=0.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)
    plev = np.sort(f(B, L + 1, lo=50.0, hi=1.0e5), 1)
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])
    tlay = f(B, L, lo=190.0, hi=310.0)
    gases = {"o3": np.full((B, L), 2e-6, np.float32),
             "ch4": np.full((B, L), 9.7e-7, np.float32),
             "n2o": np.full((B, L), 4.8e-7, np.float32),
             "h2o": f(B, L, hi=0.02), "h2o_a": f(B, L, hi=0.02),
             "h2o_b": f(B, L, hi=0.02)}
    clouds = {"lwp": f(B, L, hi=50.0), "iwp": f(B, L, hi=20.0),
              "lwp_sw_g": f(B, L, 8, hi=50.0), "iwp_sw_g": f(B, L, 8, hi=20.0),
              "lwp_lw_g": f(B, L, 4, hi=50.0), "iwp_lw_g": f(B, L, 4, hi=20.0),
              "landfrac": f(B), "icefrac": f(B), "snowh": f(B, hi=0.2)}
    sfc = {"coszrs": f(B), "solin": f(B, hi=1360.0),
           "lwup": f(B, lo=250.0, hi=500.0), "aldif": f(B), "aldir": f(B),
           "asdif": f(B), "asdir": f(B)}
    for drop in ((), ("lwp_sw_g", "iwp_sw_g", "lwp_lw_g", "iwp_lw_g",
                      "h2o_a", "h2o_b")):
        g_ = {k: v for k, v in gases.items() if k not in drop}
        c_ = {k: v for k, v in clouds.items() if k not in drop}
        j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
        t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
        with jax.enable_x64(False):
            jr = JaxRadiation(ng_lw=4, ng_sw=8)
            args = (jnp.asarray(tlay), jnp.asarray(play), jnp.asarray(plev),
                    j(g_), j(c_), j(sfc))
            params = jr.init(jax.random.PRNGKey(2), *args)
            jh, js = jr.apply(params, *args)
        tr = RadiationModule(ng_lw=4, ng_sw=8)
        tr.load_state_dict(from_flax_params(
            jax.tree_util.tree_map(np.asarray, params), tr))
        with torch.no_grad():
            th, ts = tr(torch.as_tensor(tlay), torch.as_tensor(play),
                        torch.as_tensor(plev), t(g_), t(c_), t(sfc))
        assert _rel(th, jh) <= RTOL, _rel(th, jh)
        for k in js:
            assert _rel(ts[k], js[k]) <= RTOL, (k, _rel(ts[k], js[k]))


def test_qv_variability_with_a_generator():
    """With a torch.Generator each SW g-point takes one of the two vapor
    passes at random (a Bernoulli mask; JAX's bits differ, so this is held
    to the two deterministic extremes, not to JAX): the same generator
    seed gives the same outputs, and the outputs differ from the averaged
    passes."""
    _, _, tm, a = _pair(B=6)
    x = list(map(torch.as_tensor, a))
    with torch.no_grad():
        avg = tm(*x)[0]
        r1 = tm(*x, generator=torch.Generator().manual_seed(5))[0]
        r2 = tm(*x, generator=torch.Generator().manual_seed(5))[0]
    assert torch.equal(r1, r2) and not torch.equal(r1, avg)


def _chunk(T, B, seed=4):
    rng = np.random.default_rng(seed)
    xm, xs, _, xd = zip(*[_inputs(B, seed=seed * 100 + t) for t in range(T)])
    return {"x_lev": np.stack(xm), "x_sfc": np.stack(xs),
            "y_lev": rng.normal(0, 0.3, (T, B, L, NY)).astype(np.float32),
            "y_sfc": rng.normal(0, 0.3, (T, B, NY_SFC)).astype(np.float32),
            "sp": np.full((T, B), 1e5, np.float32),
            "x_lev_raw": np.stack(xd)}


def test_evaluate_window_matches_jax():
    """RolloutTrainer.run_epoch(train=False) with pass_x_raw on one chunk
    of two W 3 windows (the yaml schedule's last), memory carried from
    zero: the loss and the memory against the JAX trainer with the same
    parameters, as cli/train_rollout.py wires the physics model (here with
    the fused trunk)."""
    _evaluate_window_parity(FUSED)


@pytest.mark.parametrize("trunk", list(SCAN_TRUNKS))
def test_evaluate_window_scan_trunk_matches_jax(trunk):
    """test_evaluate_window_matches_jax with the yaml's scan trunk, equal
    and unequal widths."""
    _evaluate_window_parity(SCAN_TRUNKS[trunk])


def _evaluate_window_parity(base):
    jm, params, tm, _ = _pair(B=6, base=base)
    chunk = _chunk(6, 6)
    nh = base["nh_mem"]
    with jax.enable_x64(False):
        jt = JaxTrainer(
            jm, JaxConfig(rollout_schedule={0: 3}, pass_x_raw=True,
                          pass_y_true=True), np.asarray(HY["hyai"]),
            np.asarray(HY["hybi"]),
            apply_fn=lambda p, xl, xs, m, xr, yt=None: jm.apply(
                p, xl, xs, m, xr, yt),
            mem_shape=lambda B, nlev: (B, 50, nh + 1))
        _, _, jmem, jrec = jt.run_epoch(params, None, None, [chunk], 0,
                                        train=False)
    tt = RolloutTrainer(tm, RolloutConfig(rollout_schedule={0: 3},
                                          pass_x_raw=True, pass_y_true=True),
                        HY["hyai"], HY["hybi"], apply_fn=phys_apply,
                        mem_shape=phys_mem_shape(tm), device="cpu")
    b7, b11, b12 = (fused_bigru_lbh.launches, adding_sw_fast.launches,
                    lw_solver_noscat_fast.launches)
    tmem, trec = tt.run_epoch(None, [chunk], 0, train=False)
    assert (fused_bigru_lbh.launches, adding_sw_fast.launches,
            lw_solver_noscat_fast.launches) == (b7, b11, b12)
    assert trec["updates"] == 2 and tmem.shape == (6, 50, nh + 1)
    assert trec["loss"] == pytest.approx(jrec["loss"], rel=RTOL)
    assert _rel(tmem, jmem) <= RTOL


def test_y_true_reaches_the_model_only_in_training():
    """pass_y_true: the window's y_lev goes to apply_fn as y_true in
    updates, never in evaluation; x_lev_raw goes in both."""
    _, _, tm, _ = _pair(B=4)
    seen = []

    def apply(model, xl, xs, mem, xr, yt=None):
        seen.append((xr is not None, yt is not None))
        return phys_apply(model, xl, xs, mem, xr, yt)

    tr = RolloutTrainer(tm, RolloutConfig(rollout_schedule={0: 2},
                                          pass_x_raw=True, pass_y_true=True),
                        HY["hyai"], HY["hybi"], apply_fn=apply,
                        mem_shape=phys_mem_shape(tm), device="cpu")
    chunk = _chunk(2, 4, seed=5)
    tr.run_epoch(None, [chunk], 0, train=False)
    assert seen == [(True, False)] * 2
    seen.clear()
    _, rec = tr.run_epoch(None, [chunk], 0, train=True)
    assert seen == [(True, True)] * 2 and np.isfinite(rec["loss"])


@pytest.mark.parametrize("over", [
    dict(use_physrad=False), dict(use_tc=True),
    dict(learned_cloud_optics=True), dict(policy=BF16)])
def test_other_options_run(over):
    """The options that raised before ROADMAP A.11 was ported now build
    and give finite outputs of the contract's shapes (against JAX:
    test_torch_phys_options.py)."""
    tm = PhysicalRNNAutoreg(**{**FUSED, **over}, device="cpu")
    with torch.no_grad():
        out, out_sfc, mem, _ = tm(*map(torch.as_tensor, _inputs(3)))
    assert out.shape == (3, L, NY) and out_sfc.shape == (3, NY_SFC)
    assert mem.shape == (3, L - 10, FUSED["nh_mem"] + 1)
    for a in (out, out_sfc, mem):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()


def test_radiation_options_build():
    """learned_cloud_optics, map_bands and use_tc, which raised before,
    build their parameters (against JAX: test_torch_radiation_tc.py)."""
    names = {flag: set(RadiationModule(**{flag: True}).state_dict())
             for flag in ("learned_cloud_optics", "map_bands", "use_tc")}
    assert {"cld_lw.kernel", "cld_sw1.bias", "cld_sw2.kernel"} \
        <= names["learned_cloud_optics"]
    assert {"band_expand_kernel", "band_expand_bias"} <= names["map_bands"]
    assert names["use_tc"] == set(RadiationModule().state_dict())


def test_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PhysicalRNNAutoreg(**SCAN)


def test_grid_synthetic_coefficients_match():
    """The hybrid coefficients both packages take from Grid.synthetic."""
    g = Grid.synthetic(4, L)
    for k in ("hyai", "hybi", "hyam", "hybm"):
        np.testing.assert_allclose(getattr(g, k).numpy(), HY[k], rtol=1e-6)
