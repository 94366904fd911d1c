"""The port's cloud-condensate transforms (``physics/transforms.py``) and
the microphysics split ``models/rnn.py::postprocess_mp`` against the JAX
package's on the same float32 numpy inputs, on the CPU.

Tolerances: the transforms are a few elementwise float32 operations, so
rtol 1e-6 (an ulp or two of exp/log1p/sqrt, which XLA's and ATen's CPU
kernels may round differently). ``postprocess_mp``'s dqliq and dqice are
differences of nearly equal numbers divided by DT, so they are held to
1e-5 of each output channel's scale (max |x| over the array), not
elementwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models import rnn as jrnn
from climsim_tpu.physics import transforms as jtr
from climsim_tpu_torch.models import rnn as trnn
from climsim_tpu_torch.physics import transforms as ttr

B, L = 6, 60


def _q(rng, shape, scale=1e-5):
    return np.abs(rng.normal(0, scale, shape)).astype(np.float32)


def _lbd(rng):
    return rng.uniform(1e3, 1e5, L).astype(np.float32)


def _close(t, j, rtol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=0)


def test_cloud_exp_transform_and_inverse():
    rng = np.random.default_rng(0)
    q, lbd = _q(rng, (B, L)), _lbd(rng)
    y = ttr.cloud_exp_transform(torch.tensor(q), torch.tensor(lbd))
    _close(y, jtr.cloud_exp_transform(jnp.asarray(q), jnp.asarray(lbd)))
    # the inverse, also past the clip at y -> 1 and below 0
    yy = np.concatenate([y.numpy(), np.array([[1.0] * L, [-0.1] * L],
                                             np.float32)])
    _close(ttr.cloud_exp_inverse(torch.tensor(yy), torch.tensor(lbd)),
           jtr.cloud_exp_inverse(jnp.asarray(yy), jnp.asarray(lbd)))
    back = ttr.cloud_exp_inverse(y, torch.tensor(lbd))
    np.testing.assert_allclose(back.numpy(), q, rtol=1e-3, atol=1e-9)


def test_fourth_root_transforms():
    rng = np.random.default_rng(1)
    q = _q(rng, (B, L, 3))
    _close(ttr.cloud_sqrt_transform(torch.tensor(q)),
           jtr.cloud_sqrt_transform(jnp.asarray(q)))
    y = rng.normal(0, 1e-3, (B, L, 4)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    _close(ttr.signed_sqrt_scale(torch.tensor(y), torch.tensor(scale)),
           jtr.signed_sqrt_scale(jnp.asarray(y), jnp.asarray(scale)))


def test_v4_to_v5_inputs():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (B, L, 9)).astype(np.float32)
    x[..., 2:4] = _q(rng, (B, L, 2))
    T = rng.uniform(230, 290, (B, L)).astype(np.float32)
    lbd = _lbd(rng)
    xt = torch.tensor(x)
    got = ttr.v4_to_v5_inputs(xt, torch.tensor(T), torch.tensor(lbd))
    _close(got, jtr.v4_to_v5_inputs(jnp.asarray(x), jnp.asarray(T),
                                    jnp.asarray(lbd)))
    # a new tensor: the input is left as it was
    assert np.array_equal(xt.numpy(), x)


def _mp_inputs(mode, seed=3):
    rng = np.random.default_rng(seed)
    ny = 5 if mode == 1 else 6
    out = rng.normal(0, 1, (B, L, ny)).astype(np.float32)
    out_sfc = rng.normal(0, 1, (B, 8)).astype(np.float32)
    if mode in (-1, -2):
        out[..., 3] = rng.uniform(0, 1, (B, L))       # a predicted fraction
    if mode == -2:
        out[..., 2] = rng.uniform(0, 1, (B, L))       # cloud-water fraction
    x = rng.normal(0, 1, (B, L, 7)).astype(np.float32)
    x[..., 0] = rng.uniform(220, 300, (B, L))         # T around the ramp
    x[..., 2:4] = _q(rng, (B, L, 2))
    x[..., -1] = _q(rng, (B, L), 1e-3)                # qv for mode -2
    # realistic output scales: tendencies of 1e-5 K/s and 1e-8 kg/kg/s,
    # so dq * DT meets q_old (the cancellation in dqliq, dqice)
    ysl = np.array([[1e4, 1e7, 1e7, 1e4, 1e4, 1e4][:ny]], np.float32)
    if mode in (-1, -2):
        ysl[0, 3] = 1.0
    if mode == -2:
        ysl[0, 2] = 1.0
    yss = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    return out, out_sfc, x, ysl[None], yss


@pytest.mark.parametrize("mode", [0, 1, -1, -2])
def test_postprocess_mp_matches_jax(mode):
    arrays = _mp_inputs(mode)
    jo, js = jrnn.postprocess_mp(*[jnp.asarray(a) for a in arrays],
                                 mp_mode=mode)
    to, ts = trnn.postprocess_mp(*[torch.tensor(a) for a in arrays],
                                 mp_mode=mode)
    jo, js = np.asarray(jo), np.asarray(js)
    assert to.shape == jo.shape == (B, L, 6)
    scale = np.abs(jo).max(axis=(0, 1))
    assert np.all(np.abs(to.numpy() - jo) <= 1e-5 * scale), mode
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6)


def test_postprocess_mp_constants_and_clamp():
    assert trnn.DT == jrnn.DT == 1200.0
    assert trnn.INV_DT == jrnn.INV_DT
    # mode -1 clamps the predicted fraction to +-0.2 of the T-diagnosed one
    out, out_sfc, x, ysl, yss = _mp_inputs(-1, seed=4)
    out[..., 0] = 0.0                  # T_new = T_old
    out[..., 3] = 1.0                  # predict all liquid
    x[..., 0] = 253.16                 # diagnosed fraction 0
    o, _ = trnn.postprocess_mp(*[torch.tensor(a) for a in
                                 (out, out_sfc, x, ysl, yss)], mp_mode=-1)
    qn_new = x[..., 2] + x[..., 3] + out[..., 2] / ysl[0, 0, 2] * 1200.0
    dqliq = (0.2 * qn_new - x[..., 2]) / 1200.0
    np.testing.assert_allclose(o[..., 2].numpy(), dqliq, rtol=1e-4,
                               atol=1e-12)
