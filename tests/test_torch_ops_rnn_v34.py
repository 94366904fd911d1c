"""The port's batch-major v3 and v4 fused emulator forwards (plain PyTorch
versions of the CUDA kernels B9 and B10) against the JAX package's Pallas
kernels in interpret mode, autograd through the port's differentiable
``fused_bigru_heads_lbh`` / ``fused_bigru_heads_init_lbh`` against
``jax.grad`` of the JAX ops, and the batch-major v2 wrapper
``fused_bigru`` and the ``PallasBiGRU`` op against JAX's, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops.pallas_rnn import PallasBiGRU as JPallasBiGRU
from climsim_tpu.ops.pallas_rnn import (_bigru_heads_init_pallas_lbh,
                                        _bigru_heads_pallas_lbh,
                                        fused_bigru as jfused_bigru,
                                        fused_bigru_heads_init_lbh as jv4,
                                        fused_bigru_heads_lbh as jv3)
from climsim_tpu_torch.ops import (PallasBiGRU, bigru_heads_init_lbh_reference,
                                   bigru_heads_lbh_reference, fused_bigru,
                                   fused_bigru_heads_init_lbh,
                                   fused_bigru_heads_lbh, fused_bigru_lbh)

# small shapes after test_pallas.py's _make_heads / _make_heads_init
L, NX, NF, NMI, H, NM, NY = 20, 26, 26, 8, 32, 8, 6
V3_NAMES = ("x", "h0_up", "h0_dn", "win1", "bin1", "whh_up", "bhh_up",
            "win2", "bin2", "whh_dn", "bhh_dn", "wlat", "blat", "wout",
            "bout")
V4_NAMES = ("feat", "mem_in", "h0_up", "h0_dn", "w_init", "b_init") \
    + V3_NAMES[3:]


def _shapes(B, init):
    w = [(H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,),
         (H, NM), (NM,), (NM, NY), (NY,)]
    if init:
        return [(L, B, NF), (L, B, NMI), (B, H), (B, H), (NF, H), (H,),
                (H + NMI, 3 * H), (3 * H,)] + w
    return [(L, B, NX), (B, H), (B, H), (NX, 3 * H), (3 * H,)] + w


def _inputs(B, init=False, seed=3):
    rng = np.random.default_rng(seed)
    return [(0.25 * rng.standard_normal(s)).astype(np.float32)
            for s in _shapes(B, init)]


def _t(arrays, dtype=torch.float32):
    return [torch.as_tensor(a).to(dtype) for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, jnp.float32).astype(dtype) for a in arrays]


PLAIN = {False: (bigru_heads_lbh_reference, _bigru_heads_pallas_lbh),
         True: (bigru_heads_init_lbh_reference, _bigru_heads_init_pallas_lbh)}


@pytest.mark.parametrize("init", [False, True], ids=["v3", "v4"])
@pytest.mark.parametrize("B", [16, 20])
def test_plain_matches_pallas_interpret_f32(B, init):
    """f32, B 20 ragged against the 8-column tile: the plain version does
    the TPU body's arithmetic (projections f32, up states and heads
    rounded to the input type), so it agrees with the Pallas program to
    summation order (tolerance as test_pallas.py's v3/v4 tests)."""
    a = _inputs(B, init)
    ref, pallas = PLAIN[init]
    got = ref(*_t(a))
    want = pallas(*_j(a), 8, True, True)
    for g, w, name in zip(got, want, ("out", "mem", "lasth")):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-6, err_msg=f"B={B} {name}")


@pytest.mark.parametrize("init", [False, True], ids=["v3", "v4"])
def test_plain_matches_pallas_interpret_bf16(init):
    """bf16: both store the up states, the memory and the outputs in bf16,
    but the Pallas kernel evaluates its gates from bf16 operands in
    another order (and, for v4, its bf16 tanh as 2 sigmoid(2x) - 1 in
    bf16), so each output may differ from the Pallas one by 4x the Pallas
    kernel's own bf16-vs-f32 difference, plus 1e-3 of the output's
    scale."""
    a = _inputs(20, init)
    ref, pallas = PLAIN[init]
    got = ref(*_t(a, torch.bfloat16))
    want = pallas(*_j(a, jnp.bfloat16), 8, True, True)
    want32 = pallas(*_j(a), 8, True, True)
    for g, w, w32 in zip(got, want, want32):
        assert g.dtype == torch.bfloat16
        w, w32 = np.asarray(w, np.float32), np.asarray(w32)
        own = np.abs(w - w32).max()
        err = np.abs(g.float().numpy() - w).max()
        assert err <= 4.0 * own + 1e-3 * np.abs(w32).max(), (err, own)


def test_v4_is_v3_on_the_initial_mlp_stream():
    """In f32, B10's plain version is B9's on x = [tanh(feat w_init +
    b_init) || mem_in] with the same weights: the split up projection
    changes only the order of summation."""
    a = _t(_inputs(16, init=True))
    feat, mem_in, h0u, h0d, w_init, b_init = a[:6]
    x = torch.cat([torch.tanh(feat @ w_init + b_init), mem_in], dim=-1)
    got = bigru_heads_init_lbh_reference(*a)
    want = bigru_heads_lbh_reference(x, h0u, h0d, *a[6:])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("init", [False, True], ids=["v3", "v4"])
def test_cpu_wrapper_takes_plain_path(init):
    """A CPU tensor runs the plain version and launches nothing."""
    a = _t(_inputs(16, init))
    op = fused_bigru_heads_init_lbh if init else fused_bigru_heads_lbh
    before = op.launches
    got = op(*a)
    want = PLAIN[init][0](*a)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert op.launches == before == 0
    assert tuple(got[0].shape) == (L, 16, NY)
    assert tuple(got[1].shape) == (L, 16, NM)
    assert tuple(got[2].shape) == (16, H)


def _port_grads(arrays, init, dtype=torch.float32):
    a = [t.requires_grad_(True) for t in _t(arrays, dtype)]
    op = fused_bigru_heads_init_lbh if init else fused_bigru_heads_lbh
    out, mem, lasth = op(*a)
    sum(((t.float() ** 2).sum() for t in (out, mem, lasth))).backward()
    return [t.grad.float().numpy() for t in a]


def _jax_grads(arrays, init):
    op = jv4 if init else jv3

    def loss(args):
        o, m, h = op(*args, None, True, True)
        return jnp.sum(o ** 2) + jnp.sum(m ** 2) + jnp.sum(h ** 2)
    return [np.asarray(g) for g in jax.grad(loss)(tuple(_j(arrays)))]


@pytest.mark.parametrize("init", [False, True], ids=["v3", "v4"])
@pytest.mark.parametrize("B", [16, 20])
def test_autograd_matches_jax_grad(B, init):
    """torch.autograd through the port's Function (plain forward; backward
    = autograd of the composition over fused_bigru_lbh, whose backward is
    B8's plain version on the CPU) against jax.grad of the JAX custom_vjp
    with the forward kernel in interpret mode, for every input (rtol 2e-4
    as test_pallas.py's v3/v4 gradient tests)."""
    a = _inputs(B, init)
    got = _port_grads(a, init)
    want = _jax_grads(a, init)
    for g, w, name in zip(got, want, V4_NAMES if init else V3_NAMES):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-5,
                                   err_msg=f"B={B} d{name}")


@pytest.mark.parametrize("init", [False, True], ids=["v3", "v4"])
def test_autograd_runs_the_v2_pair(init):
    """The backward replays through fused_bigru_lbh (B7 and B8 on the
    card); on the CPU it launches nothing, and a bf16 gradient is finite
    and within bf16 rounding of the f32 one."""
    a = _inputs(20, init)
    before = fused_bigru_lbh.launches
    g32 = _port_grads(a, init)
    g16 = _port_grads(a, init, torch.bfloat16)
    assert fused_bigru_lbh.launches == before == 0
    for x, y in zip(g16, g32):
        assert np.all(np.isfinite(x))
        assert np.abs(x - y).max() <= 0.05 * np.abs(y).max() + 1e-6


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides"])
@pytest.mark.parametrize("init", [False, True], ids=["v3", "v4"])
def test_wrapper_rejects_what_the_kernel_would(bad, init):
    """The wrapper validates on every device, so a CPU run catches an
    argument the CUDA kernel would refuse."""
    a = _t(_inputs(16, init))
    op = fused_bigru_heads_init_lbh if init else fused_bigru_heads_lbh
    if bad == "dtype":
        a[-3] = a[-3].double()
    elif bad == "shape":
        a[-4] = a[-4][:, :-1]
    else:
        a[0] = a[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        op(*a)


def _v2_inputs(B, seed=9):
    rng = np.random.default_rng(seed)
    shapes = [(B, L, 3 * H), (B, H), (B, H), (H, 3 * H), (3 * H,),
              (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,)]
    return [(0.3 * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


@pytest.mark.parametrize("B", [16, 20])
def test_fused_bigru_matches_jax(B):
    """The batch-major v2 wrapper against JAX's (Pallas in interpret mode,
    8-column tiles, ragged at 20): summation order only."""
    a = _v2_inputs(B)
    got = fused_bigru(*_t(a))
    want = jfused_bigru(*_j(a), 8, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-6)


def test_pallas_bigru_matches_jax():
    """PallasBiGRU.apply on one parameter set against JAX's (kernel in
    interpret mode) and its plain path; init_params draws JAX's shapes and
    glorot scale from a torch.Generator."""
    rng = np.random.default_rng(10)
    nx, B = 12, 20
    p = PallasBiGRU.init_params(torch.Generator().manual_seed(0), nx, H)
    jp = JPallasBiGRU.init_params(jax.random.PRNGKey(0), nx, H)
    assert {k: tuple(v.shape) for k, v in p.items()} \
        == {k: v.shape for k, v in jp.items()}
    for k in ("win1", "whh_up"):
        np.testing.assert_allclose(p[k].std().item(),
                                   float(jnp.std(jp[k])), rtol=0.1)
    x, h0u, h0d = (rng.normal(0, 0.5, s).astype(np.float32)
                   for s in ((B, L, nx), (B, H), (B, H)))
    pn = {k: v.numpy() for k, v in p.items()}
    want = JPallasBiGRU.apply({k: jnp.asarray(v) for k, v in pn.items()},
                              *map(jnp.asarray, (x, h0u, h0d)),
                              use_pallas=True, block_b=8, interpret=True)
    t = lambda a: torch.as_tensor(a)
    for use_pallas in (True, False):
        got = PallasBiGRU.apply(p, t(x), t(h0u), t(h0d),
                                use_pallas=use_pallas)
        assert tuple(got[0].shape) == (B, L, H)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                       atol=2e-6)
