"""The port's v5 fused emulator forward (plain PyTorch version of the CUDA
kernel B4) against the JAX package's Pallas kernel in interpret mode, with
the projections hoisted and not, and autograd through the port's
differentiable ``fused_bigru_heads_cm`` against ``jax.grad`` of the JAX
op, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops.pallas_rnn import (_bigru_heads_cm_pallas,
                                        _heads_cm_compose,
                                        fused_bigru_heads_cm as jfused)
from climsim_tpu_torch.ops.pallas_rnn import (bigru_heads_cm_bwd,
                                              bigru_heads_cm_reference,
                                              fused_bigru_heads_cm)

# the JAX suite's small v5 shapes (test_pallas.py::_make_heads_cm); L 12
# runs the hoisted Pallas body in one block of 12 levels
L, CH, NM_IN, H, NM, NY = 12, 10, 4, 16, 8, 6
NAMES = ("x", "mem_in", "h0_up", "h0_dn", "win1h_t", "win1m_t", "bin1",
         "whh_up_t", "bhh_up", "win2_t", "bin2", "whh_dn_t", "bhh_dn",
         "wlat_t", "blat", "wout_t", "bout")


def _inputs(B, nm_in=NM_IN, seed=5):
    rng = np.random.default_rng(seed)
    shapes = [(L, CH, B), (L, nm_in, B), (H, B), (H, B), (3 * H, CH),
              (3 * H, nm_in), (3 * H, 1), (3 * H, H), (3 * H, 1),
              (3 * H, H), (3 * H, 1), (3 * H, H), (3 * H, 1), (NM, H),
              (NM, 1), (NY, NM), (NY, 1)]
    a = [(0.25 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    a[0] = np.tanh(4 * a[0])           # an initial-MLP stream
    return a


def _t(arrays, dtype=torch.float32):
    return [torch.as_tensor(a).to(dtype) for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, jnp.float32).astype(dtype) for a in arrays]


@pytest.mark.parametrize("hoist", [False, True])
@pytest.mark.parametrize("B,block", [(16, 16), (144, 128)])
def test_plain_matches_pallas_interpret_f32(B, block, hoist):
    """f32, B 144 ragged against the 128-lane tile: the plain version does
    the kernel's arithmetic, so it agrees with the Pallas program to
    summation order (tolerance as test_pallas.py's v5 test)."""
    a = _inputs(B)
    om, lh = bigru_heads_cm_reference(*_t(a), hoist_proj=hoist)
    jom, jlh = _bigru_heads_cm_pallas(*_j(a), block, True, True, hoist)
    np.testing.assert_allclose(om.numpy(), np.asarray(jom), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(lh.numpy(), np.asarray(jlh), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("hoist", [False, True])
def test_plain_matches_pallas_interpret_bf16(hoist):
    """bf16: both store the up stream, the heads and (hoisted) the
    projections in bf16, but the Pallas kernel evaluates its gates in f32
    from bf16 operands in another order, so each output may differ from
    the Pallas one by 4x the Pallas kernel's own bf16-vs-f32 difference
    (plus 1e-3 of the output's scale)."""
    a = _inputs(144)
    om, lh = bigru_heads_cm_reference(*_t(a, torch.bfloat16),
                                      hoist_proj=hoist)
    assert om.dtype == torch.bfloat16 and lh.dtype == torch.bfloat16
    want = _bigru_heads_cm_pallas(*_j(a, jnp.bfloat16), 128, True, True,
                                  hoist)
    want32 = _bigru_heads_cm_pallas(*_j(a), 128, True, True, hoist)
    for g, w, w32 in zip((om, lh), want, want32):
        w, w32 = np.asarray(w, np.float32), np.asarray(w32)
        own = np.abs(w - w32).max()
        err = np.abs(g.float().numpy() - w).max()
        assert err <= 4.0 * own + 1e-3 * np.abs(w32).max(), (err, own)


def test_hoisting_changes_only_bf16_rounding():
    """In f32 the two variants are the same function; in bf16 the hoisted
    one rounds its projections, so they differ."""
    a = _inputs(16)
    f = [bigru_heads_cm_reference(*_t(a), hoist_proj=h)[0] for h in (0, 1)]
    torch.testing.assert_close(f[0], f[1], rtol=0, atol=0)
    b = [bigru_heads_cm_reference(*_t(a, torch.bfloat16), hoist_proj=h)[0]
         for h in (0, 1)]
    assert not torch.equal(b[0], b[1])


def test_plain_matches_compose_zero_memory():
    """nm_in = 0 (the layer without memory): the plain version against
    the JAX composition (the Pallas program needs a memory input)."""
    a = _inputs(16, nm_in=0)
    om, lh = bigru_heads_cm_reference(*_t(a))
    jom, jlh = _heads_cm_compose(*_j(a), None, False, True, False)
    np.testing.assert_allclose(om.numpy(), np.asarray(jom), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(lh.numpy(), np.asarray(jlh), rtol=2e-5,
                               atol=2e-6)


def test_cpu_wrapper_takes_plain_path():
    """A CPU tensor runs the plain version and launches nothing."""
    a = _t(_inputs(16))
    before = fused_bigru_heads_cm.launches
    for hoist in (False, True):
        om, lh = fused_bigru_heads_cm(*a, hoist_proj=hoist)
        ref_om, ref_lh = bigru_heads_cm_reference(*a, hoist_proj=hoist)
        torch.testing.assert_close(om, ref_om, rtol=0, atol=0)
        torch.testing.assert_close(lh, ref_lh, rtol=0, atol=0)
    assert fused_bigru_heads_cm.launches == before == 0
    assert om.shape == (L, NM + NY, 16) and lh.shape == (H, 16)


def _port_grads(arrays, dtype=torch.float32, hoist=True):
    a = [t.requires_grad_(True) for t in _t(arrays, dtype)]
    om, lh = fused_bigru_heads_cm(*a, hoist_proj=hoist)
    ((om.float() ** 2).sum() + (lh.float() ** 2).sum()).backward()
    return [t.grad.float().numpy() for t in a]


def _jax_grads(arrays, interpret=True, dtype=jnp.float32):
    def loss(args):
        om, h = jfused(*args, None, interpret, True, True)
        return (jnp.sum(om.astype(jnp.float32) ** 2)
                + jnp.sum(h.astype(jnp.float32) ** 2))
    return [np.asarray(g, np.float32)
            for g in jax.grad(loss)(tuple(_j(arrays, dtype)))]


@pytest.mark.parametrize("B", [16, 20])
@pytest.mark.parametrize("hoist", [False, True])
def test_autograd_matches_jax_grad(B, hoist):
    """torch.autograd through the port's Function (plain forward; backward
    = B3's plain version on the forward's arguments) against jax.grad of
    the JAX custom_vjp with both Pallas kernels in interpret mode, for all
    17 inputs (rtol 2e-4 as test_pallas.py's v5 gradient test). Both
    backwards replay in f32, so the hoisting of the forward does not
    enter."""
    a = _inputs(B)
    got = _port_grads(a, hoist=hoist)
    want = _jax_grads(a)
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-5,
                                   err_msg=f"B={B} d{name}")


def test_autograd_zero_memory_matches_jax_grad():
    """nm_in = 0: the backward differentiates the plain version, as JAX's
    differentiates its composition."""
    a = _inputs(16, nm_in=0)
    got = _port_grads(a)
    want = _jax_grads(a, interpret=False)
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-5,
                                   err_msg=f"d{name}")


def test_autograd_uses_the_backward_wrapper():
    """With memory the gradients come from bigru_heads_cm_bwd (B3's
    wrapper) on the forward's arguments; on the CPU it launches nothing."""
    a = _t(_inputs(16))
    om, lh = fused_bigru_heads_cm(*[t.requires_grad_(True) for t in a])
    dom, dlh = torch.ones_like(om), torch.ones_like(lh)
    got = torch.autograd.grad((om, lh), a, (dom, dlh))
    want = bigru_heads_cm_bwd([t.detach() for t in a], dom, dlh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert bigru_heads_cm_bwd.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides"])
def test_wrapper_rejects_what_the_kernel_would(bad):
    """The wrapper validates on every device, so a CPU run catches an
    argument the CUDA kernel would refuse."""
    a = _t(_inputs(16))
    if bad == "dtype":
        a[4] = a[4].double()
    elif bad == "shape":
        a[7] = a[7][:, :-1]
    else:
        a[0] = a[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        fused_bigru_heads_cm(*a)
