"""The port's v2 level-major BiGRU backward (plain version of kernel B8,
its wrapper ``bigru_bwd_lbh`` and the autograd backward of
``fused_bigru_lbh``) against the JAX package's hand-written backward
kernel in interpret mode and ``jax.vjp`` of its scan reference, on the
CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops.pallas_rnn import (_bigru_bwd_pallas_lbh,
                                        _bigru_reference_lbh)
from climsim_tpu_torch.ops import (bigru_bwd_lbh, bigru_bwd_reference_lbh,
                                   fused_bigru_lbh)

L, H = 24, 16
NAMES = ("d_xp", "dh0_up", "dh0_dn", "dwhh_up", "dbhh_up", "dwin2", "dbin2",
         "dwhh_dn", "dbhh_dn")


def _inputs(B, seed=0):
    """The residuals (xp [L, B, 3H], h0s [B, H], weights [H, 3H], biases
    [3H] at scale 0.3, as tests/test_pallas.py makes them) and the
    cotangents of (down, last_h)."""
    rng = np.random.default_rng(seed)
    shapes = [(L, B, 3 * H), (B, H), (B, H), (H, 3 * H), (3 * H,),
              (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,), (L, B, H),
              (B, H)]
    a = [(0.3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    return a[:9], a[9], a[10]


def _port(res, dd, dl, dtype=torch.float32):
    t = lambda x: torch.as_tensor(x).to(dtype)
    return [t(x) for x in res], t(dd), t(dl)


def _jax(res, dd, dl, dtype=jnp.float32):
    j = lambda x: jnp.asarray(x, jnp.float32).astype(dtype)
    return [j(x) for x in res], j(dd), j(dl)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("B", [16, 20])
def test_plain_matches_pallas_interpret_f32(B):
    """f32, and a ragged batch (20 columns, which the Pallas wrapper pads to
    its 16-row tiles): the same arithmetic phase by phase, so each of the
    nine outputs agrees to 1e-5 of its scale (summation order over 2 x 24
    levels of BPTT and the L x B weight-gradient sums)."""
    a = _inputs(B)
    got = bigru_bwd_reference_lbh(*_port(*a))
    want = _bigru_bwd_pallas_lbh(*_jax(*a), None, True)
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == w.shape, name
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))


@pytest.mark.parametrize("B", [16, 20])
def test_plain_matches_jax_vjp(B):
    """Against jax.vjp of the scan reference (what the custom VJP does off
    the TPU): the same function differentiated by XLA, in another order of
    summation, to 1e-5 of each gradient's scale."""
    res, dd, dl = _inputs(B, seed=1)
    got = bigru_bwd_reference_lbh(*_port(res, dd, dl))
    jr, jdd, jdl = _jax(res, dd, dl)
    _, vjp = jax.vjp(_bigru_reference_lbh, *jr)
    want = vjp((jdd, jdl))
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))


def test_plain_matches_jax_bf16():
    """bf16 storage (xp, weights, the replayed states and gates, d_xp and
    the weight gradients in bf16; f32 carries and sums): both round at the
    same points, so each output may differ from the Pallas kernel's by a
    few bf16 ulps of its largest value: 2e-2 of each output's scale (one
    ulp is 2^-8 = 3.9e-3 of a value)."""
    a = _inputs(20, seed=2)
    got = bigru_bwd_reference_lbh(*_port(*a, torch.bfloat16))
    want = _bigru_bwd_pallas_lbh(*_jax(*a, jnp.bfloat16), None, True)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.bfloat16, name
        assert _rel(g.float(), np.asarray(w, np.float32)) <= 2e-2, \
            (name, _rel(g.float(), np.asarray(w, np.float32)))


def test_wrapper_takes_plain_path_on_cpu():
    """A CPU tensor runs the plain version and launches nothing."""
    res, dd, dl = _port(*_inputs(16, seed=3))
    before = bigru_bwd_lbh.launches
    got = bigru_bwd_lbh(res, dd, dl)
    want = bigru_bwd_reference_lbh(res, dd, dl)
    assert bigru_bwd_lbh.launches == before == 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_autograd_backward_is_b8():
    """The autograd backward of ``fused_bigru_lbh`` is ``bigru_bwd_lbh`` on
    every device: on the CPU its gradients are the plain B8's, bit for
    bit."""
    res, dd, dl = _port(*_inputs(20, seed=4))
    x = [t.clone().requires_grad_(True) for t in res]
    torch.autograd.backward(fused_bigru_lbh(*x), (dd, dl))
    for name, t, w in zip(NAMES, x, bigru_bwd_reference_lbh(res, dd, dl)):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides",
                                 "cotangent-dtype", "cotangent-shape"])
def test_wrapper_rejects_what_the_kernel_would(bad):
    """The wrapper validates on every device, so a CPU run catches an
    argument the CUDA kernel would refuse."""
    res, dd, dl = _port(*_inputs(8, seed=5))
    if bad == "dtype":
        res[3] = res[3].double()
    elif bad == "shape":
        res[5] = res[5][:, :-1]
    elif bad == "strides":
        res[0] = res[0].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "cotangent-dtype":
        dd = dd.to(torch.bfloat16)
    else:
        dl = dl[:, :-1]
    with pytest.raises(ValueError):
        bigru_bwd_lbh(res, dd, dl)
