"""The port's raw-units online wrapper (``export/wrapper.py``) against the
JAX package's ``OnlineWrapper`` on carried flax parameters, on the CPU:
the scan, v2, v3 and v4 arms, every ``WrapperConfig`` branch, NaN, Inf
and broken-SNOWHICE inputs, ``flat_output``'s 368-feature layout, and the
inputs it refuses.

Tolerance: rtol 1e-5 with an absolute floor of 1e-6 of each output
channel's scale (max |x| over the array), in float32: the two run the
same arithmetic up to summation order and the ulps of XLA's and ATen's
transcendentals, through 2 x 60 recurrent levels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.data import LevelNormalizer as JNorm
from climsim_tpu.export import OnlineWrapper as JWrapper
from climsim_tpu.export import WrapperConfig as JConfig
from climsim_tpu.export import flat_output as jflat
from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu.models import rnn as jrnn
from climsim_tpu_torch.data import LevelNormalizer
from climsim_tpu_torch.export import OnlineWrapper, WrapperConfig, flat_output
from climsim_tpu_torch.models import RNNAutoreg, from_flax_params

B, L, NX, NX_SFC, NY_SFC, NH_MEM = 5, 60, 15, 24, 8, 4
NNEUR = (16, 16)
_G = JaxGrid.synthetic(4, nlev=L)
PRES = dict(add_pres=True, hyam=tuple(np.asarray(_G.hyam).tolist()),
            hybm=tuple(np.asarray(_G.hybm).tolist()), sp_mean=9.8e4,
            sp_div=1e3)
ARMS = {"scan": {}, "v2": dict(use_pallas=True),
        "v3": dict(use_pallas=True, fuse_heads=True),
        "v4": dict(use_pallas=True, fuse_heads=True, fuse_init=True)}


def _ny(cfg: dict) -> int:
    return 5 if cfg.get("mp_mode", 1) == 1 and cfg.get("mp_constraint",
                                                       True) else 6


def raw_inputs(seed=0):
    """Raw-unit state of realistic magnitudes: T, RH, qc, qi, u, v, then
    forcings and previous tendencies of order one."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, L, NX))
    x[..., 0] = rng.uniform(220, 300, (B, L))
    x[..., 1] = rng.uniform(0, 1.4, (B, L))
    x[..., 2:4] = np.abs(rng.normal(0, 1e-5, (B, L, 2)))
    x[..., 4:6] = rng.normal(0, 10, (B, L, 2))
    xs = np.abs(rng.normal(0.5, 0.2, (B, NX_SFC)))
    xs[:, 0] = rng.uniform(9.6e4, 1.03e5, B)
    mem = rng.normal(0, 0.5, (B, L, NH_MEM))
    return [a.astype(np.float32) for a in (x, xs, mem)]


def norm_arrays(ny, seed=1):
    """Per-level input normalization and realistic output scales."""
    rng = np.random.default_rng(seed)
    x, xs, _ = raw_inputs(seed)
    mean_lev = x.mean(0)
    div_lev = x.std(0) * 3 + 1e-3
    mean_lev[:, 2:4], div_lev[:, 2:4] = 0.0, 1.0    # after the transform
    mean_sfc, div_sfc = xs.mean(0), xs.std(0) * 3 + 1e-3
    scale_lev = np.array([[1e4, 1e7, 1e7, 1e4, 1e4, 1e4][:ny]], np.float64)
    if ny == 6:
        scale_lev[0, 3] = 1.0          # the fraction of modes -1 and -2
    scale_sfc = rng.uniform(0.5, 2.0, NY_SFC)
    arrays = (mean_lev, div_lev, mean_sfc, div_sfc, scale_lev, scale_sfc)
    return [np.asarray(a, np.float32) for a in arrays]


def lambdas(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.uniform(1e3, 1e5, L).astype(np.float32) for _ in range(3)]


def build(arm="scan", ny=5, pres=True, **cfg):
    """JAX's and the port's wrappers over the same weights and norms."""
    flags = dict(ARMS[arm], **(PRES if pres else dict(add_pres=False)))
    kw = dict(nx=NX, nx_sfc=NX_SFC, ny=ny, ny_sfc=NY_SFC, nneur=NNEUR,
              nh_mem=NH_MEM, **flags)
    jm = jrnn.RNNAutoreg(**kw)
    x, xs, mem = raw_inputs()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                     jnp.asarray(xs), jnp.asarray(mem))
    tm = RNNAutoreg(device="cpu", **kw)
    tm.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tm))
    na, lbd = norm_arrays(ny), lambdas()
    jw = JWrapper(jm, params, JNorm(*[jnp.asarray(a) for a in na]),
                  *lbd, JConfig(**cfg))
    tw = OnlineWrapper(tm, LevelNormalizer(*[torch.tensor(a) for a in na]),
                       *lbd, WrapperConfig(**cfg))
    return jw, tw


def run_both(jw, tw, arrays):
    jout = jw.jitted()(*[jnp.asarray(a) for a in arrays])
    with torch.no_grad():
        tout = tw(*[torch.tensor(a) for a in arrays])
    return [np.asarray(a) for a in jout], [t.numpy() for t in tout]


def assert_close(tout, jout, label):
    for t, j, name in zip(tout, jout, ("out", "out_sfc", "mem")):
        assert t.shape == j.shape, (label, name)
        assert np.isfinite(t).all(), (label, name)
        scale = np.abs(j).reshape(-1, j.shape[-1]).max(0)
        err = np.abs(t - j)
        bad = err > 1e-5 * np.abs(j) + 1e-6 * scale
        assert not bad.any(), (label, name, float(err.max()),
                               float(scale.max()))


@pytest.mark.parametrize("arm", list(ARMS))
def test_wrapper_arm_matches_jax(arm):
    jw, tw = build(arm)
    assert tw.model.arm == arm
    jout, tout = run_both(jw, tw, raw_inputs(3))
    assert tout[0].shape == (B, L, 6)
    assert_close(tout, jout, arm)


BRANCHES = {
    "mp0": dict(mp_mode=0),
    "mp1": dict(mp_mode=1),
    "mp-1": dict(mp_mode=-1),
    "mp-2": dict(mp_mode=-2),
    "v5": dict(v5_input=True),
    "v5_qinput_prune": dict(v5_input=True, qinput_prune=True),
    "v4_qinput_prune": dict(qinput_prune=True, qinput_prune_lev=20),
    "no_rh_prune": dict(rh_prune=False),
    "no_snowhice_fix": dict(snowhice_fix=False),
    "clip_dyn_phy": dict(clip_dyn=0.3, clip_phy=0.2, phy_slice=(12, 15)),
    "no_mp_constraint": dict(mp_constraint=False),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_wrapper_config_branch_matches_jax(branch):
    cfg = BRANCHES[branch]
    jw, tw = build("scan", ny=_ny(cfg), pres=False, **cfg)
    jout, tout = run_both(jw, tw, raw_inputs(4))
    assert_close(tout, jout, branch)


def test_preprocess_matches_jax_and_clips():
    cfg = dict(clip_dyn=0.3, clip_phy=0.2, phy_slice=(12, 15),
               qinput_prune=True)
    jw, tw = build("scan", pres=False, **cfg)
    x, xs, _ = raw_inputs(5)
    jx, js = jw.preprocess(jnp.asarray(x), jnp.asarray(xs))
    tx, ts = tw.preprocess(torch.tensor(x), torch.tensor(xs))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-7)
    t = tx.numpy()
    assert (t[..., 1] >= 0).all() and (t[..., 1] <= 1.2).all()
    assert np.abs(t[..., 6:12]).max() <= 0.3
    assert np.abs(t[..., 12:15]).max() <= 0.2
    assert (t[:, :15, 2] == 0).all()
    # the raw inputs are left as they were
    np.testing.assert_array_equal(x, raw_inputs(5)[0])


def test_nan_inf_and_broken_snowhice():
    """As tests/test_rnn.py::test_online_wrapper_contract: a NaN and an Inf
    level input and SNOWHICE = 1e12 give finite outputs equal to JAX's."""
    jw, tw = build("scan")
    x, xs, mem = raw_inputs(6)
    x[0, 0, 5] = np.nan
    x[2, 7, 8] = np.inf
    xs[1, 15] = 1e12
    jout, tout = run_both(jw, tw, (x, xs, mem))
    assert_close(tout, jout, "nan/inf")
    with torch.no_grad():
        _, ts = tw.preprocess(torch.tensor(x), torch.tensor(xs))
    np.testing.assert_allclose(ts[1, 15].item(),
                               (-1.0 - tw.mean_sfc[15].item())
                               / tw.div_sfc[15].item(), rtol=1e-6)


def test_flat_output_layout():
    rng = np.random.default_rng(7)
    out = rng.normal(0, 1, (B, L, 6)).astype(np.float32)
    sfc = rng.normal(0, 1, (B, 8)).astype(np.float32)
    flat = flat_output(torch.tensor(out), torch.tensor(sfc)).numpy()
    assert flat.shape == (B, 368)
    np.testing.assert_array_equal(flat, np.asarray(jflat(jnp.asarray(out),
                                                         jnp.asarray(sfc))))
    # ptend_t block first, NETSW at 360
    np.testing.assert_array_equal(flat[:, :60], out[:, :, 0])
    np.testing.assert_array_equal(flat[:, 360], sfc[:, 0])


def test_wrapper_refusals():
    _, tw = build("scan")
    x, xs, mem = [torch.tensor(a) for a in raw_inputs()]
    # the AR(1) signature needs a stochastic model with rho > 0 (JAX's
    # wrapper fails unpacking the deterministic model's 3 outputs)
    with pytest.raises(ValueError, match="stochastic"):
        tw(x, xs, mem, eps_prev=torch.zeros_like(mem))
    lm = RNNAutoreg(nx=NX, nx_sfc=NX_SFC, ny=5, ny_sfc=NY_SFC, nneur=NNEUR,
                    nh_mem=NH_MEM, add_pres=False, use_pallas=True,
                    fuse_heads=True, fuse_init=True, level_major=True,
                    device="cpu")
    na = norm_arrays(5)
    with pytest.raises(ValueError, match="level_major"):
        OnlineWrapper(lm, LevelNormalizer(*[torch.tensor(a) for a in na]),
                      *lambdas())


@pytest.mark.parametrize("vertical", [True, False])
def test_stochastic_wrapper_matches_jax(vertical, tmp_path):
    """The AR(1) signature (x, xs, mem, eps_prev, noise) -> (out, out_sfc,
    mem, eps) against JAX's (x, xs, mem, eps_prev, noise_key), JAX's draw
    for the key fed in as the noise tensor; without eps_prev both are
    deterministic and return 3 outputs; the exported step (the tensor
    form) gives the eager step's outputs."""
    from climsim_tpu_torch.export import load_step
    from climsim_tpu_torch.export.serialize import export_wrapper
    kw = dict(nx=NX, nx_sfc=NX_SFC, ny=5, ny_sfc=NY_SFC, nneur=NNEUR,
              nh_mem=NH_MEM, add_stochastic_layer=True, ar_noise_rho=0.8,
              ar_noise_vertical=vertical, **PRES)
    jm = jrnn.RNNAutoreg(**kw)
    x, xs, mem = raw_inputs()
    ja = [jnp.asarray(a) for a in (x, xs, mem)]
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "noise": jax.random.PRNGKey(1)}, *ja,
                     deterministic=False)
    tm = RNNAutoreg(device="cpu", **kw)
    tm.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tm))
    na, lbd = norm_arrays(5), lambdas()
    jw = JWrapper(jm, params, JNorm(*[jnp.asarray(a) for a in na]), *lbd,
                  JConfig())
    tw = OnlineWrapper(tm, LevelNormalizer(*[torch.tensor(a) for a in na]),
                       *lbd, WrapperConfig())
    key = jax.random.PRNGKey(5)
    # JAX's draw for the key: the model's eps output without eps_prev
    xn, xsn = jw.preprocess(*ja[:2])
    fresh = np.array(jm.apply(params, xn, xsn, ja[2], deterministic=False,
                              rngs={"noise": key})[3])
    assert fresh.shape == tm.noise_shape(B, L)
    eps_prev = np.random.default_rng(4).normal(0, 1, fresh.shape).astype(
        np.float32)
    jout = jw(*ja, eps_prev=jnp.asarray(eps_prev), noise_key=key)
    t = [torch.tensor(a) for a in (x, xs, mem)]
    with torch.no_grad():
        tout = tw(*t, torch.tensor(eps_prev), torch.tensor(fresh))
    assert len(tout) == len(jout) == 4
    assert_close([a.numpy() for a in tout[:3]], [np.asarray(a)
                                                 for a in jout[:3]], "ar1")
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                               rtol=1e-5, atol=1e-6)
    jdet = jw(*ja)
    with torch.no_grad():
        tdet = tw(*t)
    assert len(tdet) == len(jdet) == 3
    assert_close([a.numpy() for a in tdet], [np.asarray(a) for a in jdet],
                 "deterministic")
    path = str(tmp_path / "stoch.pt2")
    assert export_wrapper(tw, B, L, NX, NX_SFC, NH_MEM, path) > 0
    step = load_step(path)
    with torch.no_grad():
        got = step(*t, torch.tensor(eps_prev), torch.tensor(fresh))
    for a, b in zip(got, tout):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
