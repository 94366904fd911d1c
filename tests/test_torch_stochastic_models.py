"""The port's stochastic offline models (``climsim_tpu_torch/models/{hsr,
cvae,rpn}.py``) against the JAX package's on the same flax parameters,
carried across by ``from_flax_params``, on the CPU in float32: forwards,
losses and parameter gradients at rtol 1e-5 with an absolute floor of
1e-6 of each array's largest magnitude (XLA and torch sum in other
orders; the port's LayerNorm is written to flax's formula, so no wider
tolerance is needed for it). The samplers are fed JAX's own threefry
draws (torch's generators cannot draw them). JAX runs with x64 off, as
its CLI does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models import cvae as jcvae
from climsim_tpu.models import hsr as jhsr
from climsim_tpu.models import rpn as jrpn
from climsim_tpu_torch.models import (CVAE, HSR, RPNEnsemble, cvae_loss,
                                      cvae_samples, from_flax_params,
                                      hsr_nll, hsr_sample)
from climsim_tpu_torch.models.norm import GroupNorm, LayerNorm
from climsim_tpu_torch.train.loop import zero_missing_grads_

B, NX, NY = 24, 11, 9


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=1e-5, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def flat(tree, prefix=""):
    """A flax tree's leaves by the port's names (``params`` levels
    dropped, as ``from_flax_params`` drops them)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix if k == "params" else f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def data(seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, NX)).astype(np.float32),
            rng.normal(0, 1, (B, NY)).astype(np.float32))


def compare_grads(jgrads, model):
    """The port's gradients, with the zero JAX gives a parameter the loss
    does not reach (HSR's log-precision tower in the warm phase, the RPN
    priors), against JAX's."""
    zero_missing_grads_(model.parameters())
    want = flat(jgrads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n, g in got.items():
        close(g, want[n], err_msg=n)


@pytest.mark.parametrize("shape,axes", [((B, 37), None), ((4, 16, 24), 6)])
def test_norms_match_flax(shape, axes):
    """LayerNorm over the last axis and GroupNorm over [B, L, C] on
    inputs of mean 2 (E[x²] − E[x]² then cancels a fifth of its digits,
    as flax's does), with random scale and bias."""
    import flax.linen as fnn
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 1, shape) + 2).astype(np.float32)
    jm = fnn.LayerNorm() if axes is None else fnn.GroupNorm(
        num_groups=axes, epsilon=1e-6)
    tm = LayerNorm(shape[-1]) if axes is None else GroupNorm(axes, shape[-1])
    with jax.enable_x64(False):
        p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
        p = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(1, 0.3, a.shape), jnp.float32), p)
        want = jm.apply(p, jnp.asarray(x))
    tm.load_state_dict(from_flax_params(p, tm))
    close(tm(torch.as_tensor(x)), want)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("warm", [True, False])
def test_hsr_forward_loss_and_grads(layers, warm):
    x, y = data()
    jm = jhsr.HSR(out_dim=NY, hidden=32, layers=layers)
    tm = HSR(NX, NY, hidden=32, layers=layers, device="cpu")
    with jax.enable_x64(False):
        params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:2]))
        jmean, jlp = jm.apply(params, jnp.asarray(x))

        def loss(p):
            m, lp = jm.apply(p, jnp.asarray(x))
            return jhsr.hsr_nll(m, lp, jnp.asarray(y), warm=warm)
        jl, jg = jax.value_and_grad(loss)(params)
    tm.load_state_dict(from_flax_params(params, tm))
    mean, lp = tm(torch.as_tensor(x))
    close(mean, jmean)
    close(lp, jlp)
    tl = hsr_nll(mean, lp, torch.as_tensor(y), warm=warm)
    tl.backward()
    close(tl, jl)
    compare_grads(jg["params"], tm)


def test_hsr_sample_with_jax_draws():
    x, _ = data()
    S = 5
    jm = jhsr.HSR(out_dim=NY, hidden=32)
    tm = HSR(NX, NY, hidden=32, device="cpu")
    key = jax.random.PRNGKey(4)
    with jax.enable_x64(False):
        params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:2]))
        want = jhsr.hsr_sample(params, jm, jnp.asarray(x), key, S)
        eps = jax.random.normal(key, (B, NY, S), jnp.float32)
    tm.load_state_dict(from_flax_params(params, tm))
    with torch.no_grad():
        got = hsr_sample(tm, torch.as_tensor(x), S,
                         noise=torch.as_tensor(np.asarray(eps)))
    assert got.shape == (B, NY, S)
    close(got, want)


@pytest.mark.parametrize("beta", [1.0, 0.25])
def test_cvae_forward_loss_and_grads(beta):
    x, y = data()
    jm = jcvae.CVAE(out_dim=NY, latent_dim=4, hidden=32, layers=2)
    tm = CVAE(NX, NY, latent_dim=4, hidden=32, layers=2, device="cpu")
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(False):
        params = jm.init(jax.random.PRNGKey(1), jnp.asarray(y[:2]),
                         jnp.asarray(x[:2]), key)
        jmean, jstd, jkl = jm.apply(params, jnp.asarray(y), jnp.asarray(x),
                                    key)
        jl, jg = jax.value_and_grad(lambda p: jcvae.cvae_loss(
            jm, p, jnp.asarray(y), jnp.asarray(x), key, beta=beta))(params)
        eps = jax.random.normal(key, (B, 4), jnp.float32)
    tm.load_state_dict(from_flax_params(params, tm))
    eps = torch.as_tensor(np.asarray(eps))
    mean, std, kl = tm(torch.as_tensor(y), torch.as_tensor(x), eps)
    close(mean, jmean)
    close(std, jstd)
    close(kl, jkl)
    tl = cvae_loss(tm, torch.as_tensor(y), torch.as_tensor(x), eps, beta)
    tl.backward()
    close(tl, jl)
    compare_grads(jg["params"], tm)


def test_cvae_samples_with_jax_draws():
    x, y = data()
    S = 6
    jm = jcvae.CVAE(out_dim=NY, latent_dim=4, hidden=32, layers=1)
    tm = CVAE(NX, NY, latent_dim=4, hidden=32, layers=1, device="cpu")
    key = jax.random.PRNGKey(6)
    with jax.enable_x64(False):
        params = jm.init(jax.random.PRNGKey(1), jnp.asarray(y[:2]),
                         jnp.asarray(x[:2]), key)
        want = jcvae.cvae_samples(jm, params, jnp.asarray(x), key, S)
        det = jm.apply(params, jnp.asarray(x), key, False,
                       method=jcvae.CVAE.sample)
        zs, es = [], []
        for k in jax.random.split(key, S):
            kz, ke = jax.random.split(k)
            zs.append(np.asarray(jax.random.normal(kz, (B, 4), jnp.float32)))
            es.append(np.asarray(jax.random.normal(ke, (B, NY), jnp.float32)))
    tm.load_state_dict(from_flax_params(params, tm))
    with torch.no_grad():
        got = cvae_samples(tm, torch.as_tensor(x), S, noise=(
            torch.as_tensor(np.stack(zs)), torch.as_tensor(np.stack(es))))
        close(tm.sample(torch.as_tensor(x), random=False), det)
        one = tm.sample(torch.as_tensor(x), noise=(torch.as_tensor(zs[0]),
                                                   torch.as_tensor(es[0])))
    assert got.shape == (B, NY, S)
    close(got, want)
    close(one, np.asarray(want)[..., 0])


def test_rpn_members_forward_loss_and_grads():
    """4 members of (16, 16): apply [M, B, ny], the mean, the samples
    [B, ny, M], the loss and the nets' gradients as JAX's; the priors'
    gradients are exactly 0 in both, and one Adam step leaves the priors
    exactly as they were and moves every net."""
    x, y = data()
    M = 4
    ens = jrpn.RPNEnsemble(out_dim=NY, features=(16, 16), num_members=M)
    tm = RPNEnsemble(NX, NY, features=(16, 16), num_members=M, device="cpu")
    with jax.enable_x64(False):
        params = ens.init(jax.random.PRNGKey(2), jnp.asarray(x[:2]))
        japply = ens.apply(params, jnp.asarray(x))
        jmean = ens.apply_mean(params, jnp.asarray(x))
        jsamp = ens.samples(params, jnp.asarray(x))
        jl, jg = jax.value_and_grad(ens.loss)(params, jnp.asarray(x),
                                              jnp.asarray(y))
    assert all(np.all(np.asarray(v) == 0) for v in flat(jg["prior"]).values())
    tm.load_state_dict(from_flax_params(params, tm))
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    with torch.no_grad():
        close(tm.apply(xt), japply)
        close(tm.apply_mean(xt), jmean)
        close(tm.samples(xt), jsamp)
    tl = tm.loss(xt, yt)
    tl.backward()
    close(tl, jl)
    compare_grads(jg, tm)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    torch.optim.Adam(tm.parameters(), lr=1e-3).step()
    for n, p in tm.named_parameters():
        if n.startswith("prior."):
            assert torch.equal(p, before[n]), n
        else:
            assert not torch.equal(p, before[n]), n


def test_rpn_member_block():
    tm = RPNEnsemble(NX, NY, features=(8,), num_members=4, device="cpu")
    x, _ = data()
    with torch.no_grad():
        full = tm(torch.as_tensor(x))
        block = tm.member_block(2, 4)(torch.as_tensor(x))
    assert torch.equal(block, full[2:4])
