"""The port's RNNAutoreg (flagship channel-major fused configuration)
against the JAX package's RNNAutoreg on the same flax parameters, on the
CPU, and the flax-parameter converter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models import common as jcommon
from climsim_tpu.models.rnn import RNNAutoreg as JaxRNNAutoreg
from climsim_tpu_torch.models import common as tcommon
from climsim_tpu_torch.models import RNNAutoreg, from_flax_params

NX, NX_SFC, NY, NY_SFC = 6, 24, 6, 8
NNEUR, NH_MEM, L, B = (16, 16), 4, 8, 12
FLAGS = dict(level_major=True, fuse_heads=True, fuse_init=True,
             use_pallas=True, add_pres=False, output_prune=True)


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    xm = rng.normal(0, 1, (L, NX, B)).astype(np.float32)
    xs = rng.normal(0, 1, (B, NX_SFC)).astype(np.float32)
    mem = rng.normal(0, 0.5, (L, NH_MEM, B)).astype(np.float32)
    return xm, xs, mem


def _models(policy_name):
    jm = JaxRNNAutoreg(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC,
                       nneur=NNEUR, nh_mem=NH_MEM,
                       policy=getattr(jcommon, policy_name), **FLAGS)
    xm, xs, mem = _inputs()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(xm),
                     jnp.asarray(xs), jnp.asarray(mem))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tm = RNNAutoreg(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=NNEUR,
                    nh_mem=NH_MEM, policy=getattr(tcommon, policy_name),
                    device="cpu", **FLAGS)
    tm.load_state_dict(from_flax_params(tree, tm))
    return jm, params, tm, tree


def _run_both(policy_name):
    jm, params, tm, _ = _models(policy_name)
    xm, xs, mem = _inputs()
    jout = jm.apply(params, jnp.asarray(xm), jnp.asarray(xs), jnp.asarray(mem))
    with torch.no_grad():
        tout = tm(torch.as_tensor(xm), torch.as_tensor(xs),
                  torch.as_tensor(mem))
    return [np.asarray(a) for a in jout], [t.numpy() for t in tout]


def test_rnn_autoreg_matches_jax_f32():
    """F32 policy: the same arithmetic as the JAX composition up to
    summation order."""
    jout, tout = _run_both("F32")
    for j, t, name in zip(jout, tout, ("out", "out_sfc", "new_mem")):
        assert j.shape == t.shape, name
        assert t.dtype == np.float32
        np.testing.assert_allclose(t, j, rtol=2e-5, atol=2e-6, err_msg=name)


def test_rnn_autoreg_matches_jax_bf16():
    """BF16 policy: activations, projections and heads are stored in
    bfloat16 at slightly different places (the JAX composition keeps the
    down-sweep projection in f32, the kernel and its plain version round
    it), so the outputs agree to a few bf16 ulps of their scale (measured:
    one ulp)."""
    jout, tout = _run_both("BF16")
    for j, t, name in zip(jout, tout, ("out", "out_sfc", "new_mem")):
        scale = max(np.abs(j).max(), 1.0)
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-2 * scale,
                                   err_msg=name)


def test_output_prune_zeroes_top_levels():
    _, tout = _run_both("F32")
    out = tout[0]
    assert np.all(out[:min(12, L), 1:, :] == 0.0)
    assert np.any(out[:, 0, :] != 0.0)


def test_from_flax_params_rejects_wrong_trees():
    _, _, tm, tree = _models("F32")
    sd = from_flax_params(tree, tm)          # "params" at the top
    sd2 = from_flax_params(tree["params"], tm)   # already stripped
    assert sd.keys() == sd2.keys() == tm.state_dict().keys()
    bad = jax.tree_util.tree_map(lambda a: a, tree["params"])
    del bad["mlp_toa1"]
    with pytest.raises(ValueError, match="missing"):
        from_flax_params(bad, tm)
    bad = jax.tree_util.tree_map(lambda a: a, tree["params"])
    bad["mlp_extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="extra"):
        from_flax_params(bad, tm)
    bad = jax.tree_util.tree_map(lambda a: a, tree["params"])
    bad["bigru_fused"]["whh_up"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="whh_up"):
        from_flax_params(bad, tm)


def test_unported_options_raise():
    """No option is left to port: the stochastic LayerNorm LSTM raises
    ValueError naming the JAX lines where JAX's model fails with it; a
    channel-major model without the fused heads is refused as JAX refuses
    it, and so is a channel-major stochastic model (JAX's stochastic model
    turns the fused heads off). The batch-major fused heads
    (level_major=False with fuse_heads) build as the v4 and v3 arms; the
    stochastic layer, with the same flags, batch-major, builds the scan
    arm."""
    base = dict(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=NNEUR,
                nh_mem=NH_MEM, device="cpu", **FLAGS)
    with pytest.raises(ValueError, match="rnn.py:312-313"):
        RNNAutoreg(**{**base, "level_major": False,
                      "add_stochastic_layer": True,
                      "stochastic_cell": "sln_lstm"})
    with pytest.raises(ValueError, match="level_major"):
        RNNAutoreg(**{**base, "fuse_heads": False})
    with pytest.raises(ValueError, match="level_major"):
        RNNAutoreg(**{**base, "add_stochastic_layer": True})
    assert RNNAutoreg(**{**base, "level_major": False,
                         "add_stochastic_layer": True}).arm == "scan"
    for over, arm in (({"level_major": False}, "v4"),
                      ({"level_major": False, "fuse_init": False}, "v3")):
        assert RNNAutoreg(**{**base, **over}).arm == arm


def test_seeded_init_is_reproducible():
    kw = dict(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=NNEUR,
              nh_mem=NH_MEM, device="cpu", **FLAGS)
    a, b = RNNAutoreg(seed=3, **kw), RNNAutoreg(seed=3, **kw)
    c = RNNAutoreg(seed=4, **kw)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
        if k.endswith(("kernel", "w_init", "win1", "whh_up")):
            assert not torch.equal(va, vc), k
