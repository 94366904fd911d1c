"""The port's stochastic cells (``sgru``, ``slstm``), ``RNNLayer(noise=
True)`` and ``RNNAutoreg`` with the stochastic third layer against the JAX
package on the CPU, in float32, on the same flax parameters and the same
noise. JAX draws with threefry and the port with Philox, so the streams
cannot match: JAX's draw for a key is read from a twin of the model with
``ar_noise_rho > 0`` and no ``eps_prev`` (it returns the fresh draw as
its fourth output) and fed to the port through ``noise=``. Tolerance:
1e-5 relative (plus 1e-6 absolute) at L <= 12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models import cells as jcells
from climsim_tpu.models import rnn as jrnn
from climsim_tpu_torch.models import RNNAutoreg, from_flax_params
from climsim_tpu_torch.models import cells as tcells

NX, NX_SFC, NY, NY_SFC = 6, 24, 6, 8
NH_MEM, L, B = 4, 10, 7
RTOL, ATOL = 1e-5, 1e-6


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port(module, params):
    module.load_state_dict(from_flax_params(_tree(params), module))
    return module


@pytest.mark.parametrize("kind", ["sgru", "slstm"])
def test_cell_matches_jax(kind):
    H, nxp = 12, 5
    rng = np.random.default_rng(3)
    width = 3 if kind == "sgru" else 5
    xp = rng.normal(0, 1, (B, width * H)).astype(np.float32)
    eps = rng.normal(0, 1, (B, H)).astype(np.float32)
    h = rng.normal(0, 0.5, (B, H)).astype(np.float32)
    c = rng.normal(0, 0.5, (B, H)).astype(np.float32)
    jcell = jcells.CELL_TYPES[kind](H)
    carry = (jnp.asarray(h), jnp.asarray(c)) if kind == "slstm" \
        else jnp.asarray(h)
    params = jcell.init(jax.random.PRNGKey(nxp), carry,
                        (jnp.asarray(xp), jnp.asarray(eps)))
    jcarry, jy = jcell.apply(params, carry, (jnp.asarray(xp),
                                             jnp.asarray(eps)))
    cls = tcells.CELLS[kind][0]
    tcell = _port(cls(H, torch.float32), params)
    t = torch.from_numpy
    with torch.no_grad():
        got = tcell((t(h), t(c)) if kind == "slstm" else t(h), t(xp), t(eps))
    if kind == "slstm":
        close(got[0], jcarry[0], "h")
        close(got[1], jcarry[1], "c")
        close(got[0], jy, "y")
    else:
        close(got, jcarry, "h")


@pytest.mark.parametrize("kind", ["sgru", "slstm"])
@pytest.mark.parametrize("reverse", [False, True])
def test_noise_layer_matches_jax(kind, reverse):
    H, nx = 12, 9
    rng = np.random.default_rng(5)
    xs = rng.normal(0, 1, (B, L, nx)).astype(np.float32)
    eps = rng.normal(0, 1, (L, B, H)).astype(np.float32)
    h0 = rng.normal(0, 0.5, (B, H)).astype(np.float32)
    c0 = np.zeros_like(h0)
    jl = jcells.RNNLayer(H, kind, reverse=reverse, noise=True)
    carry = (jnp.asarray(h0), jnp.asarray(c0)) if kind == "slstm" \
        else jnp.asarray(h0)
    params = jl.init(jax.random.PRNGKey(1), jnp.asarray(xs), carry,
                     jnp.asarray(eps))
    jys, jcarry = jl.apply(params, jnp.asarray(xs), carry, jnp.asarray(eps))
    tl = _port(tcells.RNNLayer(nx, H, kind, reverse=reverse, noise=True),
               params)
    t = torch.from_numpy
    with torch.no_grad():
        ys, tcarry = tl(t(xs), (t(h0), t(c0)) if kind == "slstm" else t(h0),
                        t(eps))
    close(ys, jys, "ys")
    if kind == "slstm":
        close(tcarry[0], jcarry[0], "h")
        close(tcarry[1], jcarry[1], "c")
    else:
        close(tcarry, jcarry, "h")


def test_noise_layer_refuses_mismatch():
    with pytest.raises(ValueError, match="noise"):
        tcells.RNNLayer(4, 8, "sgru")
    with pytest.raises(ValueError, match="noise"):
        tcells.RNNLayer(4, 8, "gru", noise=True)
    with pytest.raises(ValueError, match="noise"):
        tcells.RNNLayer(4, 8, "sln_lstm")
    layer = tcells.RNNLayer(4, 8, "sgru", noise=True)
    with pytest.raises(ValueError, match="eps"):
        layer(torch.zeros(2, 3, 4), torch.zeros(2, 8))


CASES = {
    "sgru": dict(),
    "slstm": dict(stochastic_cell="slstm"),
    "sgru_shared_noise": dict(ar_noise_vertical=False),
    "sgru_three_widths": dict(nneur=(16, 12, 10)),
}


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    xm = rng.normal(0, 1, (B, L, NX)).astype(np.float32)
    xs = rng.normal(0, 1, (B, NX_SFC)).astype(np.float32)
    mem = rng.normal(0, 0.5, (B, L, NH_MEM)).astype(np.float32)
    return xm, xs, mem


def _kw(case, rho):
    kw = dict(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=(16, 16),
              nh_mem=NH_MEM, add_pres=False, add_stochastic_layer=True,
              ar_noise_rho=rho)
    kw.update(CASES[case])
    return kw


def jax_draw(kw, params, arrays, key):
    """JAX's fresh draw for ``key``: the rho > 0 twin with no eps_prev
    returns it as eps_out."""
    twin = jrnn.RNNAutoreg(**{**kw, "ar_noise_rho": 0.5})
    return np.array(twin.apply(params, *[jnp.asarray(a) for a in arrays],
                               deterministic=False,
                               rngs={"noise": key})[3])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("rho", [0.0, 0.9])
def test_stochastic_model_matches_jax(case, rho):
    """Deterministic (zero noise), stochastic with JAX's draw fed in, and
    (rho > 0) stochastic from an eps_prev: every output against JAX's,
    the weights carried by from_flax_params, the model on the scan
    trunk even with use_pallas."""
    kw = _kw(case, rho)
    arrays = _inputs()
    jm = jrnn.RNNAutoreg(**kw)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "noise": jax.random.PRNGKey(1)},
                     *[jnp.asarray(a) for a in arrays], deterministic=False)
    tm = RNNAutoreg(device="cpu", use_pallas=True, **kw)
    assert tm.arm == "scan"
    tm.load_state_dict(from_flax_params(_tree(params), tm))
    t = [torch.from_numpy(a) for a in arrays]
    ja = [jnp.asarray(a) for a in arrays]
    key = jax.random.PRNGKey(7)
    fresh = jax_draw(kw, params, arrays, key)
    assert fresh.shape == tm.noise_shape(B, L)
    eps_prev = np.random.default_rng(2).normal(
        0, 1, fresh.shape).astype(np.float32)
    runs = [(dict(), dict())]
    runs.append((dict(deterministic=False, rngs={"noise": key}),
                 dict(deterministic=False, noise=torch.from_numpy(fresh))))
    if rho > 0:
        runs.append((dict(deterministic=False, rngs={"noise": key},
                          eps_prev=jnp.asarray(eps_prev)),
                     dict(deterministic=False, noise=torch.from_numpy(fresh),
                          eps_prev=torch.from_numpy(eps_prev))))
    for jkw, tkw in runs:
        jout = jm.apply(params, *ja, **jkw)
        with torch.no_grad():
            tout = tm(*t, **tkw)
        assert len(tout) == len(jout) == (4 if rho > 0 else 3)
        for name, j, g in zip(("out", "out_sfc", "new_mem", "eps"), jout,
                              tout):
            if j is None:
                assert g is None, name
                continue
            assert tuple(g.shape) == tuple(j.shape), name
            close(g, j, f"{case} rho {rho} {tkw.keys()} {name}")


def test_generator_noise_is_reproducible_and_required():
    """A torch.Generator seam: the same seed gives the same step, another
    seed another; a stochastic call with no noise raises (nothing is
    drawn from the global RNG); a wrong-shape draw raises."""
    kw = _kw("sgru", 0.5)
    tm = RNNAutoreg(device="cpu", **kw)
    t = [torch.from_numpy(a) for a in _inputs()]
    run = lambda s: tm(*t, deterministic=False,
                       noise=torch.Generator().manual_seed(s))
    with torch.no_grad():
        a, b, c = run(3), run(3), run(4)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert not torch.equal(a[0], c[0])
        with pytest.raises(ValueError, match="noise"):
            tm(*t, deterministic=False)
        with pytest.raises(ValueError, match="noise shape"):
            tm(*t, deterministic=False, noise=torch.zeros(1, B, 16))
        # deterministic: eps_prev passes through untouched
        eps_prev = torch.ones(tm.noise_shape(B, L))
        assert tm(*t, eps_prev=eps_prev)[3] is eps_prev


def test_stochastic_options():
    kw = _kw("sgru", 0.0)
    with pytest.raises(ValueError, match="sln_lstm"):
        RNNAutoreg(device="cpu", **{**kw, "stochastic_cell": "sln_lstm"})
    with pytest.raises(ValueError, match="stochastic cell"):
        RNNAutoreg(device="cpu", **{**kw, "stochastic_cell": "gru"})
    with pytest.raises(ValueError, match="level_major"):
        RNNAutoreg(device="cpu", use_pallas=True, fuse_heads=True,
                   level_major=True, **kw)
    tm = RNNAutoreg(device="cpu", **kw)
    keys = set(tm.state_dict())
    for k in ("rnn_stoch.input_proj.kernel", "rnn_stoch.input_proj.bias",
              "rnn_stoch.cell.encoder.kernel", "rnn_stoch.cell.zh.kernel"):
        assert k in keys, k
    assert "rnn_stoch.cell.encoder.bias" not in keys
    slstm = RNNAutoreg(device="cpu", **{**kw, "stochastic_cell": "slstm"})
    assert "rnn_stoch.cell.hh.kernel" in set(slstm.state_dict())
    assert "rnn_stoch.cell.hh.bias" not in set(slstm.state_dict())
