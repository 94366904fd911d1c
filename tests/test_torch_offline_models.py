"""The port's offline baselines (``climsim_tpu_torch/models/{mlp,ed,cnn}.py``)
against the JAX package's on the same flax parameters, carried across by
``from_flax_params``, on the CPU: forwards and parameter gradients (of
the output against a fixed random cotangent) at rtol 1e-5 in f32, with
an absolute floor of 1e-6 of each array's largest magnitude (summation
order differs between XLA and torch; values near zero carry no relative
precision). BF16 runs to 2e-2 of the output's scale: both packages round
every product's inputs and every activation to bf16 (8 bits), so a
rounding that differs by one ulp in one layer carries through the next.
JAX runs with x64 off, as the CLIs run it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu import variables as JV
from climsim_tpu.models import cnn as jcnn
from climsim_tpu.models import common as jcommon
from climsim_tpu.models import ed as jed
from climsim_tpu.models import mlp as jmlp
from climsim_tpu_torch import variables as V
from climsim_tpu_torch.models import (CNN, ED, MLP, common, from_flax_params,
                                      input_prune_mask, mlp_for,
                                      output_prune_mask,
                                      reshape_input_for_cnn,
                                      reshape_target_from_cnn)

B = 24


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=1e-5, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def run_both(jmodel, tmodel, x, seed=3, **jkw):
    """Forward and the gradients of sum(out * ct) from the same flax
    parameters: (jax out, port out, jax grads flat, port grads)."""
    with jax.enable_x64(False):
        params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x[:2]))
        tmodel.load_state_dict(from_flax_params(
            jax.tree_util.tree_map(np.asarray, params), tmodel))
        jout = jmodel.apply(params, jnp.asarray(x), **jkw)
        ct = np.random.default_rng(seed).normal(
            0, 1, jout.shape).astype(np.float32)
        jgrad = jax.grad(lambda p: jnp.sum(
            jmodel.apply(p, jnp.asarray(x), **jkw).astype(jnp.float32)
            * ct))(params)["params"]
    tout = tmodel(torch.as_tensor(x))
    (tout.float() * torch.as_tensor(ct)).sum().backward()
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
    walk(jgrad, "")
    tgrad = {n: p.grad.numpy() for n, p in tmodel.named_parameters()}
    return np.asarray(jout), tout.detach().float().numpy(), flat, tgrad


def inputs(n_in, seed=7):
    return np.random.default_rng(seed).normal(0, 1, (B, n_in)) \
        .astype(np.float32)


@pytest.mark.parametrize("activation", ["relu", "elu", "gelu", "leakyrelu"])
@pytest.mark.parametrize("prune", [False, True])
def test_mlp_matches_jax_f32(activation, prune):
    """Every activation (flax's gelu is the tanh approximation), with and
    without the output prune mask, on the v1 contract."""
    vs, jvs = V.get("v1"), JV.get("v1")
    mask = jmlp.output_prune_mask(jvs) if prune else None
    jm = jmlp.MLP(features=(32, 24), out_dim=jvs.target_feature_len,
                  activation=activation,
                  prune_mask=None if mask is None else tuple(mask))
    tm = MLP(vs.input_feature_len, (32, 24), vs.target_feature_len,
             activation=activation,
             prune_mask=output_prune_mask(vs) if prune else None,
             device="cpu")
    jo, to, jg, tg = run_both(jm, tm, inputs(vs.input_feature_len))
    close(to, jo, err_msg="out")
    assert set(jg) == set(tg)
    for k in jg:
        close(tg[k], jg[k], err_msg=k)
    if prune:
        assert np.all(to[:, mask == 0] == 0)


def test_mlp_matches_jax_bf16():
    """The BF16 policy: bf16 products and activations, f32 outputs."""
    vs, jvs = V.get("v1"), JV.get("v1")
    jm = jmlp.mlp_for(jvs, features=(32, 24), policy=jcommon.BF16)
    tm = mlp_for(vs, features=(32, 24), policy=common.BF16, device="cpu")
    jo, to, _, _ = run_both(jm, tm, inputs(vs.input_feature_len))
    assert to.dtype == np.float32
    np.testing.assert_allclose(to, jo, rtol=0,
                               atol=2e-2 * np.abs(jo).max())


def test_mlp_for_and_masks_match_jax():
    """mlp_for's widths and the static masks of every mode, for v1 and
    the expanded sets."""
    for name in ("v1", "v4", "v5"):
        vs, jvs = V.get(name), JV.get(name)
        np.testing.assert_array_equal(output_prune_mask(vs),
                                      jmlp.output_prune_mask(jvs))
        for mode in ("decouple_cloud", "aggressive", "qinput"):
            for kw in ({}, {"strato_lev_qinput": 20, "strato_lev_tinput": 5}):
                np.testing.assert_array_equal(
                    input_prune_mask(vs, mode, **kw),
                    jmlp.input_prune_mask(jvs, mode, **kw))
    with pytest.raises(ValueError):
        input_prune_mask(V.get("v1"), "nope")
    m = mlp_for(V.get("v1"), device="cpu")
    assert m.features == (768, 640, 512, 640, 640)
    assert m.head.kernel.shape == (640, 128)


def test_ed_matches_jax_f32():
    vs = V.get("v1")
    jm = jed.ED(out_dim=vs.target_feature_len, latent_dim=5,
                intermediate_dim=64)
    tm = ED(vs.input_feature_len, vs.target_feature_len, 5, 64,
            device="cpu")
    jo, to, jg, tg = run_both(jm, tm, inputs(vs.input_feature_len))
    close(to, jo, err_msg="out")
    assert set(jg) == set(tg)
    for k in jg:
        close(tg[k], jg[k], err_msg=k)


def test_cnn_matches_jax_f32():
    """Depth 2, 16 channels, flat v1 in and out: the deterministic
    forward (as both trainers call it) and its gradients."""
    vs = V.get("v1")
    jm = jcnn.CNN(depth=2, channels=16)
    tm = CNN(depth=2, channels=16, device="cpu")
    jo, to, jg, tg = run_both(jm, tm, inputs(vs.input_feature_len))
    assert to.shape == (B, 128)
    close(to, jo, err_msg="out")
    assert set(jg) == set(tg)
    for k in jg:
        close(tg[k], jg[k], err_msg=k)


def test_cnn_reshapes_and_dropout():
    """The flat <-> image reshapes equal JAX's; dropout acts only with
    deterministic=False, whatever module.training says."""
    x = inputs(124)
    y = np.random.default_rng(2).normal(0, 1, (B, 60, 10)).astype(np.float32)
    with jax.enable_x64(False):
        np.testing.assert_array_equal(
            reshape_input_for_cnn(torch.as_tensor(x)).numpy(),
            np.asarray(jcnn.reshape_input_for_cnn(jnp.asarray(x))))
        close(reshape_target_from_cnn(torch.as_tensor(y)).numpy(),
              jcnn.reshape_target_from_cnn(jnp.asarray(y)))
    tm = CNN(depth=1, channels=8, device="cpu").train()
    xt = torch.as_tensor(x)
    with torch.no_grad():
        assert torch.equal(tm(xt), tm(xt))
        torch.manual_seed(0)
        assert not torch.equal(tm(xt, deterministic=False), tm(xt))


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_conv_matches_flax_same_padding(k):
    """The port's convolution (one GEMM of the k level-shifted copies)
    against flax's channels-last nn.Conv(padding="SAME"), odd and even k
    (SAME pads (k - 1) // 2 levels above)."""
    import flax.linen as fnn
    from climsim_tpu_torch.models.cnn import Conv
    x = np.random.default_rng(k).normal(0, 1, (B, 60, 7)).astype(np.float32)
    conv = fnn.Conv(5, (k,), padding="SAME")
    with jax.enable_x64(False):
        params = conv.init(jax.random.PRNGKey(k), jnp.asarray(x))
        want = conv.apply(params, jnp.asarray(x))
    tm = Conv(7, 5, k, torch.float32)
    tm.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tm))
    close(tm(torch.as_tensor(x)).detach().numpy(), want)
