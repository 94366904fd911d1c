"""The port's v2 level-major fused BiGRU (plain version of kernel B7 and
its differentiable wrapper) against the JAX package's Pallas kernel in
interpret mode and its scan reference, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops.pallas_rnn import _bigru_reference_lbh, fused_bigru_lbh \
    as jax_fused_bigru_lbh
from climsim_tpu_torch.models.cells import FusedBiGRULayer
from climsim_tpu_torch.ops import bigru_reference_lbh, fused_bigru_lbh

L, H = 24, 16


def _inputs(B, seed=0):
    """xp [L, B, 3H], h0s [B, H], weights [H, 3H], biases [3H] at scale
    0.3, as tests/test_pallas.py makes them."""
    rng = np.random.default_rng(seed)
    shapes = [(L, B, 3 * H), (B, H), (B, H), (H, 3 * H), (3 * H,),
              (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,)]
    return [(0.3 * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def _port(arrays, dtype=torch.float32):
    return [torch.as_tensor(a).to(dtype) for a in arrays]


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, jnp.float32).astype(dtype) for a in arrays]


@pytest.mark.parametrize("B,block", [(16, 8), (20, 8)])
def test_plain_matches_pallas_interpret_f32(B, block):
    """f32, and a ragged batch (20 columns in tiles of 8, which the Pallas
    wrapper pads): the same arithmetic, so agreement to summation order
    over 2 x 24 recurrent levels (tolerance as tests/test_pallas.py)."""
    a = _inputs(B)
    down, lasth = bigru_reference_lbh(*_port(a))
    jd, jl = jax_fused_bigru_lbh(*_jax(a), block, True, True)
    np.testing.assert_allclose(down.numpy(), np.asarray(jd), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lasth.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=1e-6)


@pytest.mark.parametrize("B", [16, 20])
def test_plain_matches_scan_reference_f32(B):
    a = _inputs(B, seed=1)
    down, lasth = bigru_reference_lbh(*_port(a))
    jd, jl = _bigru_reference_lbh(*_jax(a))
    np.testing.assert_allclose(down.numpy(), np.asarray(jd), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lasth.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=1e-6)


@pytest.mark.parametrize("B", [16, 20])
def test_plain_matches_jax_bf16(B):
    """bf16 storage (xp, weights, the up and down states in bf16, f32
    carries and gates): both round at the same points, so they agree to a
    few bf16 ulps; atol 2e-2 on states of order 1 (one ulp at 1 is
    7.8e-3), against both the Pallas program and the scan reference."""
    a = _inputs(B, seed=2)
    down, lasth = bigru_reference_lbh(*_port(a, torch.bfloat16))
    assert down.dtype == torch.bfloat16 and lasth.dtype == torch.bfloat16
    for jd, jl in (jax_fused_bigru_lbh(*_jax(a, jnp.bfloat16), 8, True,
                                       True),
                   _bigru_reference_lbh(*_jax(a, jnp.bfloat16))):
        np.testing.assert_allclose(down.float().numpy(),
                                   np.asarray(jd, np.float32), rtol=0,
                                   atol=2e-2)
        np.testing.assert_allclose(lasth.float().numpy(),
                                   np.asarray(jl, np.float32), rtol=0,
                                   atol=2e-2)


def test_cpu_wrapper_takes_plain_path():
    """A CPU tensor runs the plain version and launches nothing."""
    a = _port(_inputs(16))
    before = fused_bigru_lbh.launches
    down, lasth = fused_bigru_lbh(*a)
    ref_d, ref_l = bigru_reference_lbh(*a)
    assert fused_bigru_lbh.launches == before == 0
    torch.testing.assert_close(down, ref_d, rtol=0, atol=0)
    torch.testing.assert_close(lasth, ref_l, rtol=0, atol=0)
    assert down.shape == (L, 16, H) and lasth.shape == (16, H)


def test_autograd_matches_jax_vjp():
    """The wrapper's CPU backward (the plain version of B8): the
    gradients of all nine inputs agree with jax.vjp of the scan reference
    (what the Pallas op's custom VJP does off the TPU) to 1e-4 of each
    gradient's scale (f32 summation order through 48 levels of BPTT)."""
    a = _inputs(20, seed=3)
    rng = np.random.default_rng(4)
    g_down = rng.standard_normal((L, 20, H)).astype(np.float32)
    g_last = rng.standard_normal((20, H)).astype(np.float32)
    x = [t.requires_grad_(True) for t in _port(a)]
    down, lasth = fused_bigru_lbh(*x)
    torch.autograd.backward((down, lasth), (torch.as_tensor(g_down),
                                            torch.as_tensor(g_last)))
    _, vjp = jax.vjp(_bigru_reference_lbh, *_jax(a))
    want = vjp((jnp.asarray(g_down), jnp.asarray(g_last)))
    for i, (t, w) in enumerate(zip(x, want)):
        w = np.asarray(w)
        err = np.abs(t.grad.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-4, (i, err)


def test_wrapper_backward_only_what_is_needed():
    """Only the inputs that require gradients get one (the others None)."""
    a = _port(_inputs(8, seed=5))
    a[0].requires_grad_(True)
    down, lasth = fused_bigru_lbh(*a)
    (down.sum() + lasth.sum()).backward()
    assert a[0].grad is not None and a[0].grad.shape == a[0].shape
    assert all(t.grad is None for t in a[1:])


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides"])
def test_wrapper_rejects_what_the_kernel_would(bad):
    """The wrapper validates on every device, so a CPU run catches an
    argument the CUDA kernel would refuse."""
    a = _port(_inputs(8))
    if bad == "dtype":
        a[3] = a[3].double()
    elif bad == "shape":
        a[5] = a[5][:, :-1]
    else:
        a[0] = a[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        fused_bigru_lbh(*a)


def _layer_pair(nx, dtype_j=jnp.float32):
    from climsim_tpu.models.cells import FusedBiGRULayer as JaxLayer
    from climsim_tpu_torch.models import from_flax_params
    B = 12
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (B, L, nx)).astype(np.float32)
    h0u = rng.normal(0, 0.5, (B, H)).astype(np.float32)
    h0d = rng.normal(0, 0.5, (B, H)).astype(np.float32)
    jl = JaxLayer(H)
    params = jl.init(jax.random.PRNGKey(0), *_jax([x, h0u, h0d], dtype_j))
    tl = FusedBiGRULayer(nx, H)
    tl.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tl))
    return jl, params, tl, (x, h0u, h0d)


def test_fused_layer_matches_jax():
    """FusedBiGRULayer with flax's parameters: the hoisted projection
    (torch.matmul) and the fused sweeps against the flax layer (which runs
    the scan reference off the TPU), f32."""
    jl, params, tl, (x, h0u, h0d) = _layer_pair(10)
    jd, jlast = jl.apply(params, *_jax([x, h0u, h0d]))
    with torch.no_grad():
        down, lasth = tl(*_port([x, h0u, h0d]))
    assert down.shape == (12, L, H)
    np.testing.assert_allclose(down.numpy(), np.asarray(jd), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(lasth.numpy(), np.asarray(jlast), rtol=2e-5,
                               atol=2e-6)


