"""The port's v6 fused emulator forward (plain PyTorch version of the
CUDA kernel) against the JAX package's Pallas kernel in interpret mode and
against its batch-major composition, on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops.pallas_rnn import (_bigru_heads_init_cm_pallas,
                                        _heads_init_cm_compose, _hoist_nb)
from climsim_tpu_torch.ops.pallas_rnn import (bigru_heads_init_cm_reference,
                                              fused_bigru_heads_init_cm)

# L = 20 makes the Pallas kernel's hoisted projections run in 2 chunks
L, NF, NM_IN, H, NM, NY = 20, 6, 8, 16, 8, 6


def _inputs(B, seed=3):
    rng = np.random.default_rng(seed)
    shapes = [(L, NF, B), (L, NM_IN, B), (H, B), (H, B),
              (H, NF), (H, 1), (3 * H, H), (3 * H, NM_IN), (3 * H, 1),
              (3 * H, H), (3 * H, 1), (3 * H, H), (3 * H, 1),
              (3 * H, H), (3 * H, 1), (NM, H), (NM, 1), (NY, NM), (NY, 1)]
    return [(0.25 * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def _port(arrays, dtype):
    return [torch.as_tensor(a).to(dtype) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a, jnp.float32).astype(dtype) for a in arrays]


def test_hoist_chunks():
    assert L // _hoist_nb(L) == 2


@pytest.mark.parametrize("B,block", [(16, 16), (144, 128)])
def test_plain_matches_pallas_interpret_f32(B, block):
    """f32: the plain version does the kernel's arithmetic, so it agrees
    with the Pallas program to summation order (tolerance as
    test_pallas.py's v6 interpret test)."""
    a = _inputs(B)
    om, lh = bigru_heads_init_cm_reference(*_port(a, torch.float32))
    jom, jlh = _bigru_heads_init_cm_pallas(*_jax(a, jnp.float32), block,
                                           True, True)
    np.testing.assert_allclose(om.numpy(), np.asarray(jom), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(lh.numpy(), np.asarray(jlh), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("B", [16, 144])
def test_plain_matches_compose_f32(B):
    a = _inputs(B)
    om, lh = bigru_heads_init_cm_reference(*_port(a, torch.float32))
    jom, jlh = _heads_init_cm_compose(*_jax(a, jnp.float32), None, False,
                                      True, False)
    np.testing.assert_allclose(om.numpy(), np.asarray(jom), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(lh.numpy(), np.asarray(jlh), rtol=2e-5,
                               atol=2e-6)


def test_plain_matches_pallas_interpret_bf16():
    """bf16: both store xi, the projections, the up stream and the heads
    in bf16 but round at slightly different places (the Pallas kernel
    evaluates tanh in bf16 arithmetic), so they agree to a few bf16 ulps:
    atol 2e-2 on outputs of order 1 (one bf16 ulp at 1 is 7.8e-3;
    measured: one ulp)."""
    a = _inputs(144)
    om, lh = bigru_heads_init_cm_reference(*_port(a, torch.bfloat16))
    assert om.dtype == torch.bfloat16 and lh.dtype == torch.bfloat16
    jom, jlh = _bigru_heads_init_cm_pallas(*_jax(a, jnp.bfloat16), 128,
                                           True, True)
    np.testing.assert_allclose(om.float().numpy(),
                               np.asarray(jom, np.float32), atol=2e-2,
                               rtol=0)
    np.testing.assert_allclose(lh.float().numpy(),
                               np.asarray(jlh, np.float32), atol=2e-2,
                               rtol=0)


def test_cpu_wrapper_takes_plain_path():
    """A CPU tensor runs the plain version and launches nothing."""
    a = _port(_inputs(16), torch.float32)
    before = fused_bigru_heads_init_cm.launches
    om, lh = fused_bigru_heads_init_cm(*a)
    ref_om, ref_lh = bigru_heads_init_cm_reference(*a)
    assert fused_bigru_heads_init_cm.launches == before == 0
    torch.testing.assert_close(om, ref_om, rtol=0, atol=0)
    torch.testing.assert_close(lh, ref_lh, rtol=0, atol=0)
    assert om.shape == (L, NM + NY, 16) and lh.shape == (H, 16)



@pytest.mark.parametrize("bad", ["dtype", "shape", "strides"])
def test_wrapper_rejects_what_the_kernel_would(bad):
    """The wrapper validates on every device, so a CPU run catches an
    argument the CUDA kernel would refuse."""
    a = _port(_inputs(16), torch.float32)
    if bad == "dtype":
        a[6] = a[6].double()
    elif bad == "shape":
        a[9] = a[9][:, :-1]
    else:
        a[1] = a[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        fused_bigru_heads_init_cm(*a)
