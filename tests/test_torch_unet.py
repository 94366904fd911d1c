"""The port's ClimSim-Online U-Net and cloud classifier
(``climsim_tpu_torch/models/unet.py``) against the JAX package's
(``climsim_tpu/models/unet.py``) on the same flax parameters, on the CPU
in float32, at a narrow width (16 channels, 1 block a level): forwards
and parameter gradients of sum(out x a fixed random cotangent) at rtol
1e-5 with an absolute floor of 1e-5 (outputs) and 5e-5 (gradients) of
each array's largest magnitude (some 20 convolutions, group norms and
attentions deep, each summing in another order in XLA and torch). The
zero-initialized convolutions would make a fresh model's output 0, so
every parameter is redrawn at random before both run. JAX runs with x64 off, as its CLI does."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from climsim_tpu.models import unet as junet
from climsim_tpu_torch import variables as V
from climsim_tpu_torch.models import (ClimsimUNetClassifier, classifier_loss,
                                      cloud_class_labels, from_flax_params,
                                      unet_v4, unet_v5)
from climsim_tpu_torch.train import FitConfig
from climsim_tpu_torch.train.loop import make_optimizer, zero_missing_grads_
from test_torch_stochastic_models import flat

B = 6
# the gradients' floor: the backward runs twice as deep as the forward
# (about 40 summing layers); up to 1.04e-5 of an array's scale was seen
GRAD_FLOOR = 5e-5
NARROW = dict(model_channels=16, num_blocks=1)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, err_msg="", floor=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=floor * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def flat_input(nvp, nvs, seed=1):
    """[B, nvp x 60 + nvs + 1]: normal profiles and scalars, and location
    indices in 1..384 (one outside, clipped)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, nvp * 60 + nvs + 1)).astype(np.float32)
    x[:, -1] = rng.integers(1, 385, B)
    x[0, -1] = 400.0
    return x


def random_params(jmodel, x, seed=2, frozen=("skipconv",)):
    """A parameter tree of ``jmodel``'s shapes (``jax.eval_shape`` of its
    init) drawn at random: normal(1, 0.2) for the group norms' scales,
    normal(0, 0.2) for the rest; the leaves whose path holds one of
    ``frozen`` are the identity convolutions' initial values."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(x[:2]))

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        if any(f in key for f in frozen):
            return (jnp.eye(a.shape[-1], dtype=jnp.float32)[None]
                    if "kernel" in key else jnp.zeros(a.shape, jnp.float32))
        mean = 1.0 if "scale" in key else 0.0
        return jnp.asarray(rng.normal(mean, 0.2, a.shape), jnp.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_out_and_grad(jmodel, params, x, loss=None):
    """JAX's output and the gradient of sum(out x ct) (or of ``loss(out)``)
    in one jitted call (flax op by op takes a minute at these sizes);
    returns (out, grads, ct)."""
    xj = jnp.asarray(x)
    shape = jax.eval_shape(jmodel.apply, params, xj).shape
    ct = np.random.default_rng(5).normal(0, 1, shape).astype(np.float32)
    loss = loss or (lambda out: jnp.sum(out * ct))

    @jax.jit
    def run(p):
        out, vjp = jax.vjp(lambda q: jmodel.apply(q, xj), p)
        return out, vjp(jax.grad(loss)(out))[0], loss(out)
    out, grads, value = run(params)
    return np.asarray(out), grads, ct, value


def run_both(jmodel, tmodel, x, frozen=("skipconv",)):
    """(jax out, port out, jax grads by the port's names, port grads):
    the same random parameters in both, gradients of sum(out x ct)."""
    with jax.enable_x64(False):
        params = random_params(jmodel, x, frozen=frozen)
        jout, jgrad, ct, _ = jax_out_and_grad(jmodel, params, x)
    tmodel.load_state_dict(from_flax_params(params, tmodel))
    tout = tmodel(torch.as_tensor(x))
    (tout * torch.as_tensor(ct)).sum().backward()
    zero_missing_grads_(tmodel.parameters())
    return (jout, tout, flat(jgrad),
            {n: p.grad for n, p in tmodel.named_parameters()})


CASES = {
    "v4": (junet.unet_v4, unet_v4, (25, 24), {}),
    "v4_loc_skipconv": (junet.unet_v4, unet_v4, (25, 24),
                        dict(loc_embedding=True, skip_conv=True,
                             channel_mult=(1, 2))),
    "v5_noprune_prev2d": (junet.unet_v5, unet_v5, (22, 24),
                          dict(output_prune=False, prev_2d=True,
                               channel_mult=(1, 2), attn_resolutions=(32,))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_unet_forward_and_grads(case):
    jfn, tfn, (nvp, nvs), kw = CASES[case]
    x = flat_input(nvp, nvs)
    frozen = () if kw.get("skip_conv") else ("skipconv",)
    jout, tout, jg, tg = run_both(jfn(**NARROW, **kw),
                                  tfn(**NARROW, **kw, device="cpu"), x,
                                  frozen)
    assert tout.shape == jout.shape
    close(tout, jout, "output")
    assert set(tg) == set(jg)
    for n, g in tg.items():
        close(g, jg[n], n, GRAD_FLOOR)
    # the frozen identities and, without the embedding, every row of
    # emb_loc but the first get no gradient in either
    for n in tg:
        if n.startswith("skipconv_") and not kw.get("skip_conv"):
            assert not tg[n].any() and not jg[n].any(), n
    if not kw.get("loc_embedding"):
        assert not tg["emb_loc"][1:].any() and tg["emb_loc"][0].any()


def test_unet_prune_and_dropout():
    """The pruned outputs are exactly 0 (the top 12 levels of every
    profile but the first); dropout acts only with deterministic=False,
    whatever ``module.training`` says."""
    x = torch.as_tensor(flat_input(25, 24))
    torch.manual_seed(0)
    m = unet_v4(**NARROW, device="cpu")
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.1 * torch.randn_like(p))
        m.train()
        a, b = m(x), m(x)
        c = m(x, deterministic=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    y = a.reshape(B, -1)[:, :6 * 60].reshape(B, 6, 60)
    assert not y[:, 1:, :12].any() and y[:, 0, :12].all()


def test_frozen_identity_under_adamw_matches_jax():
    """optimizer.name=adamw with weight decay: one step shrinks the
    frozen identity convolutions and the untouched rows of emb_loc by
    (1 - lr wd), in JAX (optax.adamw on their zero gradient) and in the
    port (torch's AdamW on the zero gradient the trainer gives them)."""
    lr, wd = 1e-2, 0.5
    x = flat_input(25, 24)
    jm = junet.unet_v4(**NARROW, channel_mult=(1, 2))
    tm = unet_v4(**NARROW, channel_mult=(1, 2), device="cpu")
    with jax.enable_x64(False):
        params = random_params(jm, x)
        _, g, _, _ = jax_out_and_grad(jm, params, x, lambda out: jnp.sum(
            jnp.square(out - 1.0)))
        tx = optax.adamw(lr, weight_decay=wd)
        new = optax.apply_updates(params, tx.update(g, tx.init(params),
                                                    params)[0])
    tm.load_state_dict(from_flax_params(params, tm))
    opt = make_optimizer(FitConfig(lr=lr, optimizer="adamw",
                                   weight_decay=wd), tm.parameters())
    torch.sum(torch.square(tm(torch.as_tensor(x)) - 1.0)).backward()
    zero_missing_grads_(tm.parameters())
    opt.step()
    want = flat(new)
    got = dict(tm.named_parameters())
    n_frozen = 0
    for n in got:
        if n.startswith("skipconv_"):
            close(got[n], want[n], n)
            n_frozen += 1
    assert n_frozen == 2 * tm.n_skips
    eye = torch.eye(16)[None] * (1 - lr * wd)
    close(got["skipconv_0.kernel"], eye.numpy())
    close(got["emb_loc"][1:], want["emb_loc"][1:])


def test_classifier_logits_labels_and_loss():
    inl = V.get("v5").inputs
    nvp, nvs = inl.n_lev_vars, inl.n_sfc_vars
    x = flat_input(nvp, nvs, seed=3)
    kw = dict(model_channels=16, num_blocks=1, channel_mult=(1, 2))
    jm = junet.ClimsimUNetClassifier(num_vars_profile=nvp,
                                     num_vars_scalar=nvs, **kw)
    tm = ClimsimUNetClassifier(nvp, nvs, **kw, device="cpu")
    rng = np.random.default_rng(4)
    q = np.abs(rng.normal(0, 2e-9, (B, 60))).astype(np.float32)
    dq = (rng.normal(0, 1e-11, (B, 60))
          * rng.integers(0, 2, (B, 60))).astype(np.float32)
    with jax.enable_x64(False):
        params = random_params(jm, x)
        jl = np.asarray(junet.cloud_class_labels(jnp.asarray(q),
                                                 jnp.asarray(dq)))
        logits, jg, _, jloss = jax_out_and_grad(
            jm, params, x, lambda out: junet.classifier_loss(
                out, jnp.asarray(jl[:, None])))
    tl = cloud_class_labels(torch.as_tensor(q), torch.as_tensor(dq))
    assert np.array_equal(tl.numpy(), jl)
    assert set(np.unique(jl)) == {0, 1, 2}
    tm.load_state_dict(from_flax_params(params, tm))
    tlogits = tm(torch.as_tensor(x))
    assert tlogits.shape == (B, 1, 3, 60)
    close(tlogits, logits)
    loss = classifier_loss(tlogits, tl[:, None])
    loss.backward()
    close(loss, jloss)
    zero_missing_grads_(tm.parameters())
    want = flat(jg)
    for n, p in tm.named_parameters():
        close(p.grad, want[n], n, GRAD_FLOOR)
