"""The port's physics helpers of the physics-constrained model (saturation
thermodynamics, E3SM cloud optics, the radiation helpers and the McICA
stratified sampling) against the JAX package's, on the CPU, in float32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models import rnn as jrnn
from climsim_tpu.physics import cloud_optics as JCO
from climsim_tpu.physics import radiation as JR
from climsim_tpu.physics import thermo as JT
from climsim_tpu_torch.models import rnn as trnn
from climsim_tpu_torch.physics import cloud_optics as CO
from climsim_tpu_torch.physics import radiation as R
from climsim_tpu_torch.physics import thermo as T

RNG = np.random.default_rng(0)
TEMP = RNG.uniform(150.0, 320.0, (7, 60)).astype(np.float32)
PRES = RNG.uniform(1e3, 1.05e5, (7, 60)).astype(np.float32)
Q = np.abs(RNG.normal(3e-3, 2e-3, (7, 60))).astype(np.float32)


def _same(got, want, rtol=2e-6, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _tj(*arrays):
    return ([torch.as_tensor(a) for a in arrays],
            [jnp.asarray(a, jnp.float32) for a in arrays])


@pytest.mark.parametrize("name", ["eliq", "eice", "esat", "liquid_fraction",
                                  "snow_fraction", "esat_cc"])
def test_thermo_of_temperature(name):
    (t,), (j,) = _tj(TEMP)
    _same(getattr(T, name)(t), getattr(JT, name)(j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["qsat", "specific_to_relative_humidity",
                                  "relative_to_specific_humidity",
                                  "specific_to_relative_humidity_cc"])
def test_thermo_moisture(name):
    (t, p, q), (jt, jp, jq) = _tj(TEMP, PRES, Q)
    args_t = (t, p) if name == "qsat" else (q, t, p)
    args_j = (jt, jp) if name == "qsat" else (jq, jt, jp)
    _same(getattr(T, name)(*args_t), getattr(JT, name)(*args_j), rtol=2e-5)
    if name == "specific_to_relative_humidity_cc":
        _same(T.specific_to_relative_humidity_cc(q, t, p, True),
              JT.specific_to_relative_humidity_cc(jq, jt, jp, True),
              rtol=2e-5, atol=1e-12)


def test_temperature_scalings():
    (t,), (j,) = _tj(TEMP)
    _same(trnn.temperature_scaling(t), jrnn.temperature_scaling(j))
    _same(trnn.temperature_scaling_precip(t),
          jrnn.temperature_scaling_precip(j))


def test_effective_radii():
    """reitab indexes the table where JAX takes a one-hot product: the same
    entries, so the same values (temperatures across the whole table and
    beyond both ends)."""
    t = np.linspace(100.0, 400.0, 7 * 60).reshape(7, 60).astype(np.float32)
    (tt, land, ice, snow), (jt, jl, ji, js) = _tj(
        t, RNG.uniform(0, 1, (7, 1)).astype(np.float32),
        RNG.uniform(0, 1, (7, 1)).astype(np.float32),
        RNG.uniform(0, 0.2, (7, 1)).astype(np.float32))
    _same(CO.reitab(tt), JCO.reitab(jt), rtol=1e-6)
    _same(CO.reltab(tt, land, ice, snow), JCO.reltab(jt, jl, ji, js))


@pytest.mark.parametrize("ng", [4, 8, 16])
def test_band_optics(ng):
    np.testing.assert_array_equal(CO._band_expand(CO._LIQ, ng),
                                  JCO._band_expand(JCO._LIQ, ng))
    (rel, rei), (jrel, jrei) = _tj(
        RNG.uniform(2.0, 20.0, (5, 60)).astype(np.float32),
        RNG.uniform(5.0, 150.0, (5, 60)).astype(np.float32))
    for got, want in ((CO.slingo_liq_optics_sw(rel, ng),
                       JCO.slingo_liq_optics_sw(jrel, ng)),
                      (CO.ec_ice_optics_sw(rei, ng),
                       JCO.ec_ice_optics_sw(jrei, ng))):
        for g, w in zip(got, want):
            _same(g, w)


def test_cloud_optics_sw_and_mcica():
    """Grid-mean and per-g-point (McICA) cloud optics, with clear layers
    (zero paths) where combine_optics takes its eps branch."""
    B, L, ng = 5, 60, 8
    lwp = np.abs(RNG.normal(0, 20, (B, L))).astype(np.float32)
    lwp[:, :10] = 0.0
    iwp = np.abs(RNG.normal(0, 5, (B, L))).astype(np.float32)
    lwp_g = np.abs(RNG.normal(0, 20, (B, L, ng))).astype(np.float32)
    iwp_g = np.abs(RNG.normal(0, 5, (B, L, ng))).astype(np.float32)
    sfc = [RNG.uniform(0, 1, (B, 1)).astype(np.float32) for _ in range(3)]
    t = TEMP[:B]
    (tl, ti, tt, tlg, tig, *ts), (jl, ji, jt, jlg, jig, *js) = _tj(
        lwp, iwp, t, lwp_g, iwp_g, *sfc)
    for g, w in zip(CO.cloud_optics_sw(tl, ti, tt, *ts, ng),
                    JCO.cloud_optics_sw(jl, ji, jt, *js, ng)):
        _same(g, w, rtol=1e-5, atol=1e-7)
    for g, w in zip(CO.cloud_optics_sw_mcica(tlg, tig, tt, *ts),
                    JCO.cloud_optics_sw_mcica(jlg, jig, jt, *js)):
        _same(g, w, rtol=1e-5, atol=1e-7)


def _column():
    B, L = 6, 60
    plev = np.sort(RNG.uniform(100.0, 1.0e5, (B, L + 1)), 1).astype(
        np.float32)
    play = (0.5 * (plev[:, 1:] + plev[:, :-1])).astype(np.float32)
    return plev, play, TEMP[:B]


def test_radiation_helpers():
    plev, play, tlay = _column()
    (tp, tq, tt), (jp, jq, jt) = _tj(plev, play, tlay)
    tlev = R.interpolate_tlev(tt, tq, tp)
    _same(tlev, JR.interpolate_tlev(jt, jq, jp), rtol=2e-5)
    _same(R.outgoing_lw(tlev), JR.outgoing_lw(jnp.asarray(tlev.numpy())))
    od = np.abs(RNG.normal(0.5, 0.4, (6, 60, 8))).astype(np.float32)
    top, bot = (np.abs(RNG.normal(50, 10, (6, 60, 8))).astype(np.float32)
                for _ in "tb")
    (a, b, c), (ja, jb, jc) = _tj(top, bot, od)
    for g, w in zip(R.reftrans_lw(a, b, c), JR.reftrans_lw(ja, jb, jc)):
        _same(g, w, rtol=1e-5, atol=1e-7)
    flux = RNG.normal(0, 300, (6, 61)).astype(np.float32)
    dp = (plev[:, 1:] - plev[:, :-1]).astype(np.float32)
    (f, d), (jf, jd) = _tj(flux, dp)
    _same(R.heating_rate(f, d), JR.heating_rate(jf, jd), rtol=1e-5)


def test_two_stream_coefficients():
    """Meador-Weaver coefficients across optical depths, single-scattering
    albedos and sun angles, including k*mu0 near 1 (the eps branch).
    ref_dir and trans_dir_diff are differences of nearly equal terms over
    1 - (k mu0)^2, which cancels digits where k mu0 is close to 1: the
    coefficients (all in [0, 1]) agree to 1e-5 absolute."""
    B, L, ng = 6, 60, 8
    mu0 = RNG.uniform(1e-3, 1.0, (B, 1, 1)).astype(np.float32)
    od = np.exp(RNG.uniform(-8, 3, (B, L, ng))).astype(np.float32)
    ssa = RNG.uniform(1e-6, 0.999999, (B, L, ng)).astype(np.float32)
    g = RNG.uniform(0.0, 0.95, (B, L, ng)).astype(np.float32)
    (a, b, c, d), (ja, jb, jc, jd) = _tj(mu0, od, ssa, g)
    for got, want in zip(R.calc_ref_trans_sw(a, b, c, d),
                         JR.calc_ref_trans_sw(ja, jb, jc, jd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


# deliberate ties: equal fractions, zero-area regions, p*G on integers
TIES = [
    [0.25, 0.25, 0.25, 0.25, 0.0, 0.0],
    [0.5, 0.5, 0.0, 0.0, 0.0, 0.0],
    [0.125, 0.375, 0.0, 0.125, 0.375, 0.0],
    [1 / 3, 1 / 3, 1 / 3, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
    [1 / 6] * 6,
    [0.1, 0.2, 0.1, 0.2, 0.2, 0.2],
]


@pytest.mark.parametrize("G", [4, 6, 8, 16])
def test_stratified_sample_ties(G):
    """Largest-remainder apportionment picks the same states as JAX on
    ties (stable sorts: the lower state index wins), and on random
    fractions."""
    p = np.concatenate([np.asarray(TIES, np.float32),
                        RNG.dirichlet(np.ones(6), 25).astype(np.float32)])
    got = R.stratified_sample(torch.as_tensor(p), G)
    want = JR.stratified_sample(jnp.asarray(p), G)
    assert got.dtype == torch.int32 and got.shape == (p.shape[0], G)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    counts = torch.nn.functional.one_hot(got.long(), 6).sum(1)
    assert (counts.sum(1) == G).all()


def test_stratified_sample_tie_order():
    """Four equal states and 6 points: each gets 1.5, so the two extra
    points go to the first two states."""
    p = torch.tensor([[0.25, 0.25, 0.25, 0.25]])
    assert R.stratified_sample(p, 6).tolist() == [[0, 0, 1, 1, 2, 3]]


def test_take_small_axis_is_nan_safe():
    """Lanes that are not selected may be non-finite; the gather never
    reads them (torch.where, not a one-hot product)."""
    x = RNG.normal(0, 1, (5, 7, 6)).astype(np.float32)
    x[..., 5] = np.nan
    x[..., 4] = np.inf
    idx = RNG.integers(0, 4, (5, 7, 8)).astype(np.int32)
    got = R.take_small_axis(torch.as_tensor(x), torch.as_tensor(idx))
    want = JR.take_small_axis(jnp.asarray(x), jnp.asarray(idx))
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tripleclouds_runs():
    """calc_overlap_matrices and adding_sw_tc, which raised before
    TripleClouds was ported, run and give JAX's numbers (against JAX in
    detail: test_torch_radiation_tc.py)."""
    f = np.full((2, 3, 4), 0.25, np.float32)
    op = np.full((2, 2), 0.5, np.float32)
    v = R.calc_overlap_matrices(torch.as_tensor(f), torch.as_tensor(op))
    _same(v, JR.calc_overlap_matrices(jnp.asarray(f), jnp.asarray(op)),
          atol=1e-7)
    ones = np.full((2, 4), 0.5, np.float32)
    lay = np.full((2, 3, 4), 0.3, np.float32)
    args = (ones, ones, ones, lay, lay, lay, lay, lay, v.numpy())
    for g, w in zip(R.adding_sw_tc(*map(torch.as_tensor, args)),
                    JR.adding_sw_tc(*map(jnp.asarray, args))):
        _same(g, w, rtol=1e-6)
