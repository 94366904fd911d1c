"""The port's probabilistic scores (``train/probabilistic.py``) and their
gradients against the JAX package's on seeded ensembles of 2 to 8
members, in float32: values and gradients (with respect to the ensemble
and the observation) to 1e-6 relative, plus 1e-6 of the largest
gradient's scale where a gradient entry is near zero."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.train import probabilistic as JP
from climsim_tpu_torch.train import probabilistic as TP

SCORES = {
    "crps_sample_sorted": (dict(), dict(beta=1.3)),
    "crps_kernel": (dict(), dict(fair=False), dict(beta=0.7)),
    "crps_almost_fair": (dict(), dict(alpha=0.5, beta=1.2)),
    "spread_skill_ratio": (dict(),),
    "variogram_score": (dict(), dict(p=1.0, max_pairs=3)),
    "energy_score": (dict(),),
    "dawid_sebastiani": (dict(),),
}
MULTIVARIATE = ("variogram_score", "energy_score")
CASES = [(name, i) for name, kws in SCORES.items() for i in range(len(kws))]


def _data(name, M, seed):
    rng = np.random.default_rng(seed)
    shape = (5, 11) if name in MULTIVARIATE else (5, 4, 3)
    ens = rng.normal(0, 1, (M,) + shape).astype(np.float32)
    obs = rng.normal(0.2, 1.1, shape).astype(np.float32)
    return ens, obs


@pytest.mark.parametrize("M", [2, 3, 5, 8])
@pytest.mark.parametrize("name,i", CASES)
def test_score_and_gradient_match_jax(name, i, M):
    kw = SCORES[name][i]
    ens, obs = _data(name, M, seed=M * 10 + i)
    jfn = lambda e, o: getattr(JP, name)(e, o, **kw)
    jval, (jge, jgo) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(ens), jnp.asarray(obs))
    te = torch.tensor(ens, requires_grad=True)
    to = torch.tensor(obs, requires_grad=True)
    tval = getattr(TP, name)(te, to, **kw)
    tval.backward()
    assert tval.dtype == torch.float32
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-6,
                               atol=1e-7)
    for got, want in ((te.grad, jge), (to.grad, jgo)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
