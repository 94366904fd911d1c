"""The port's v6 fused emulator backward on the CPU: the plain version of
the channel-major backward kernel against the JAX package's Pallas kernel
in interpret mode, and autograd through the port's differentiable
``fused_bigru_heads_init_cm`` against ``jax.grad`` of the JAX one (both of
its kernels in interpret mode) and against autograd of the plain
forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops.pallas_rnn import (_bigru_heads_cm_bwd_pallas,
                                        fused_bigru_heads_init_cm as jfused)
from climsim_tpu_torch.ops.pallas_rnn import (bigru_heads_cm_bwd,
                                              bigru_heads_cm_bwd_reference,
                                              bigru_heads_init_cm_reference,
                                              fused_bigru_heads_init_cm)

# the JAX suite's small v6 shapes (test_pallas.py::_make_heads_init_cm)
L, NF, NM_IN, H, NM, NY = 12, 7, 4, 16, 8, 6
NAMES = ("feat", "mem_in", "h0_up", "h0_dn", "winit_t", "binit", "win1h_t",
         "win1m_t", "bin1", "whh_up_t", "bhh_up", "win2_t", "bin2",
         "whh_dn_t", "bhh_dn", "wlat_t", "blat", "wout_t", "bout")
BWD_OUT = ("dx", "dmem", "dh0u", "dh0d") + tuple(
    f"d{n}" for n in NAMES[6:])
# the JAX suite's tolerance for its backward kernels (test_pallas.py:565)
RTOL, ATOL = 3e-4, 2e-5


def _fwd_inputs(B, seed=7):
    rng = np.random.default_rng(seed)
    shapes = [(L, NF, B), (L, NM_IN, B), (H, B), (H, B), (H, NF), (H, 1),
              (3 * H, H), (3 * H, NM_IN), (3 * H, 1), (3 * H, H),
              (3 * H, 1), (3 * H, H), (3 * H, 1), (3 * H, H), (3 * H, 1),
              (NM, H), (NM, 1), (NY, NM), (NY, 1)]
    return [(0.25 * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def _bwd_inputs(B, seed=9):
    """The backward kernel's residuals (x = a tanh stream [L, H, B]) and
    the cotangents of (outmem, lasth)."""
    a = _fwd_inputs(B, seed)
    rng = np.random.default_rng(seed + 1)
    x = np.tanh(rng.standard_normal((L, H, B))).astype(np.float32)
    res = [x] + a[1:4] + a[6:]
    d_outmem = rng.standard_normal((L, NM + NY, B)).astype(np.float32)
    d_lasth = rng.standard_normal((H, B)).astype(np.float32)
    return res, d_outmem, d_lasth


def _t(arrays, dtype=torch.float32):
    return [torch.as_tensor(a).to(dtype) for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, jnp.float32).astype(dtype) for a in arrays]


def _loss(om, h):
    return (om.float() ** 2).sum() + (h.float() ** 2).sum()


def _port_grads(arrays, dtype, fn=fused_bigru_heads_init_cm):
    a = [t.requires_grad_(True) for t in _t(arrays, dtype)]
    _loss(*fn(*a)).backward()
    return [t.grad.float().numpy() for t in a]


def _jax_grads(arrays, dtype):
    def loss(args):
        om, h = jfused(*args, None, True, True)
        return (jnp.sum(om.astype(jnp.float32) ** 2)
                + jnp.sum(h.astype(jnp.float32) ** 2))
    return [np.asarray(g, np.float32)
            for g in jax.grad(loss)(tuple(_j(arrays, dtype)))]


@pytest.mark.parametrize("B", [16, 20])
def test_plain_bwd_matches_pallas_interpret(B):
    """All 17 outputs of the plain version against the Pallas backward
    kernel (interpret mode; B 20 is ragged against its 128-lane tile, so
    its pad lanes must add nothing to the weight gradients)."""
    res, dom, dlh = _bwd_inputs(B)
    got = bigru_heads_cm_bwd_reference(_t(res), *_t([dom, dlh]))
    want = _bigru_heads_cm_bwd_pallas(_j(res), *_j([dom, dlh]),
                                      interpret=True)
    assert len(got) == len(want) == 17
    for g, w, name in zip(got, want, BWD_OUT):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"B={B} {name}")


def test_cpu_bwd_wrapper_takes_plain_path():
    """A CPU tensor runs the plain version and launches nothing."""
    res, dom, dlh = _bwd_inputs(16)
    args = (_t(res), *_t([dom, dlh]))
    before = bigru_heads_cm_bwd.launches
    got = bigru_heads_cm_bwd(*args)
    want = bigru_heads_cm_bwd_reference(*args)
    assert bigru_heads_cm_bwd.launches == before == 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("B", [16, 20])
def test_autograd_matches_jax_grad(B):
    """torch.autograd through the port's Function (plain forward, plain
    backward) against jax.grad of the JAX custom_vjp with both Pallas
    kernels in interpret mode, for all 19 inputs."""
    a = _fwd_inputs(B)
    got = _port_grads(a, torch.float32)
    want = _jax_grads(a, jnp.float32)
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"B={B} d{name}")


def test_autograd_matches_autograd_of_plain_forward():
    """The hand-written BPTT against torch.autograd of the plain forward:
    an independent derivation of the same gradients. In f32 the forward's
    roundings are identities, so only summation order differs."""
    a = _fwd_inputs(20)
    got = _port_grads(a, torch.float32)
    want = _port_grads(a, torch.float32, bigru_heads_init_cm_reference)
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{name}")


def test_autograd_bf16_within_bf16_rounding():
    """bf16: the port and the JAX package store h, the gates, the
    streams and the gradients in bf16 at the same points but evaluate
    some of them in a different order, so each gradient may differ from
    JAX's bf16 gradient by at most 4x JAX's own bf16-vs-f32 difference of
    that gradient, plus 1e-3 of its scale for gradients whose bf16 error
    happens to be tiny."""
    a = _fwd_inputs(20)
    got = _port_grads(a, torch.bfloat16)
    want = _jax_grads(a, jnp.bfloat16)
    ref32 = _jax_grads(a, jnp.float32)
    for g, w, r, name in zip(got, want, ref32, NAMES):
        assert np.all(np.isfinite(g)), name
        own = np.abs(w - r).max()
        err = np.abs(g - w).max()
        assert err <= 4.0 * own + 1e-3 * np.abs(r).max(), \
            f"d{name}: {err:.3e} > 4 x {own:.3e}"


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides", "cotangent"])
def test_bwd_wrapper_rejects_what_the_kernel_would(bad):
    """The backward wrapper validates on every device, so a CPU run
    catches an argument the CUDA kernel would refuse."""
    res, dom, dlh = _bwd_inputs(16)
    res, (dom, dlh) = _t(res), _t([dom, dlh])
    if bad == "dtype":
        res[4] = res[4].to(torch.bfloat16)
    elif bad == "shape":
        res[7] = res[7][:, :-1]
    elif bad == "strides":
        res[0] = res[0].transpose(1, 2).contiguous().transpose(1, 2)
    else:
        dlh = dlh.t().contiguous().t()
    with pytest.raises(ValueError):
        bigru_heads_cm_bwd(res, dom, dlh)
