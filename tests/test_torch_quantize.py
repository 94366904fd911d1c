"""The port's int8 serving path (``export/quantize.py``) against the JAX
package's on the CPU: the quantized weights, the int8 product, the int8
forward of the scan-arm emulator on carried flax parameters, and JAX's
own accuracy gates (tests/test_infra.py::test_quantized_forward_accuracy)
held against the port's float32 forward.

Tolerances: ``quantize_params`` gives the same int8 values (one division
and one round-half-to-even of the same float32 numbers) and scales to
rtol 1e-6; ``qdot`` is an exact int32 product rescaled by the same
float32 operations, rtol 1e-6. The forward's activations are quantized
again at every level from values that XLA and ATen compute to an ulp or
two apart (sigmoid, tanh), and a value within an ulp of a rounding
boundary can then land on the other int8 step: one element's int8 moves
by 1, about 0.8% of that tensor's scale, and the recurrence carries it
on. Seeds 3 and 5 give equal outputs; seed 7 has such a flip. So the
int8 forwards are held to each other at 5% of each output's scale, and
to 2% in relative RMS."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.export import quantize as jq
from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu.models import rnn as jrnn
from climsim_tpu_torch.export import quantize as tq
from climsim_tpu_torch.models import RNNAutoreg, from_flax_params

B, L, NX, NX_SFC, NH_MEM = 32, 60, 15, 24, 8
_G = JaxGrid.synthetic(4, nlev=L)
KW = dict(nx=NX, nx_sfc=NX_SFC, ny=6, ny_sfc=8, nneur=(64, 64),
          nh_mem=NH_MEM, hyam=tuple(np.asarray(_G.hyam).tolist()),
          hybm=tuple(np.asarray(_G.hybm).tolist()), sp_mean=9.8e4,
          sp_div=1e4)


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, s, shape).astype(np.float32) for s, shape in
            ((1.0, (B, L, NX)), (1.0, (B, NX_SFC)), (0.3, (B, L, NH_MEM)))]


@pytest.fixture(scope="module")
def models():
    jm = jrnn.RNNAutoreg(**KW)
    arrays = inputs()
    params = jm.init(jax.random.key(0), *[jnp.asarray(a) for a in arrays])
    tm = RNNAutoreg(device="cpu", **KW)
    tm.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tm))
    return jm, params, tm


def test_quantize_params_matches_jax(models):
    _, params, tm = models
    want = jq.quantize_params(params)["params"]
    got = tq.quantize_params(tq.param_tree(tm))
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        keys = [k.key for k in path]
        node = got
        for k in keys:
            node = node[k]
        if keys[-1] == "q":
            assert node.dtype == torch.int8
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
            n += 1
        else:
            np.testing.assert_allclose(node.numpy(), np.asarray(leaf),
                                       rtol=1e-6)
    assert n == 10     # every Dense kernel of the scan arm


@pytest.mark.parametrize("shape", [(B, L, 79), (B, 2), (5, 64)])
def test_qdot_matches_jax(shape):
    """Batched, K = 2 (the TOA MLP) and M < 17: the zero padding that the
    card's int8 GEMM needs changes nothing."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, shape).astype(np.float32)
    k = rng.normal(0, 0.2, (shape[-1], 48)).astype(np.float32)
    bias = rng.normal(0, 0.1, 48).astype(np.float32)
    jk = jq.quantize_params({"kernel": jnp.asarray(k)})["kernel"]
    tk = tq.quantize_params({"kernel": torch.tensor(k)})["kernel"]
    want = np.asarray(jq.qdot(jnp.asarray(x), jk, jnp.asarray(bias)))
    got = tq.qdot(torch.tensor(x), tk, torch.tensor(bias)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_int_mm_padding_is_exact():
    rng = np.random.default_rng(2)
    a = torch.tensor(rng.integers(-127, 128, (3, 5)), dtype=torch.int8)
    b = torch.tensor(rng.integers(-127, 128, (5, 7)), dtype=torch.int8)
    assert torch.equal(tq._int_mm(a, b), a.int() @ b.int())


@pytest.mark.parametrize("seed", [3, 7])
def test_quant_forward_matches_jax(models, seed):
    jm, params, tm = models
    arrays = inputs(seed)
    want = jax.jit(jq.QuantGRUForward(jm, params))(
        *[jnp.asarray(a) for a in arrays])
    got = tq.QuantGRUForward(tm)(*[torch.tensor(a) for a in arrays])
    for g, w, name in zip(got, want, ("out", "out_sfc", "mem")):
        g, w = g.numpy(), np.asarray(w)
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 0.05 * scale, name
        rel = np.sqrt(np.mean((g - w) ** 2)) / np.sqrt(np.mean(w ** 2))
        assert rel < 0.02, (name, rel)


def test_quant_forward_accuracy_gates(models):
    """JAX's gates, against the port's float32 forward: relative RMS
    below 0.05 and correlation above 0.99."""
    _, _, tm = models
    arrays = [torch.tensor(a) for a in inputs()]
    with torch.no_grad():
        ref = tm(*arrays)
    got = tq.QuantGRUForward(tm)(*arrays)
    for a, b in zip(got, ref):
        a, b = a.numpy().ravel(), b.numpy().ravel()
        rel = np.sqrt(np.mean((a - b) ** 2)) \
            / max(np.sqrt(np.mean(b ** 2)), 1e-12)
        corr = np.corrcoef(a, b)[0, 1]
        assert rel < 0.05, rel
        assert corr > 0.99, corr


def test_quant_forward_takes_the_scan_arm():
    v2 = RNNAutoreg(device="cpu", use_pallas=True, **KW)
    with pytest.raises(ValueError, match="scan"):
        tq.QuantGRUForward(v2)


def test_quant_forward_accuracy_at_yaml_widths_matches_jax():
    """At conf/autoreg_gru.yaml's widths (nneur 192/192, nh_mem 16, ny 5)
    the int8 forward's accuracy against its own float32 forward is the
    same in both packages, to 1e-3 in relative RMS and 1e-4 in
    correlation: what the card measures there is the reference
    algorithm's accuracy (JAX's test sets its 0.05 relative-RMS gate at
    nneur 64; at 192 the error sits near it). The correlation gate
    holds."""
    kw = dict(KW, ny=5, nneur=(192, 192), nh_mem=16)
    rng = np.random.default_rng(11)
    arrays = [rng.normal(0, s, shape).astype(np.float32) for s, shape in
              ((1.0, (B, L, NX)), (1.0, (B, NX_SFC)), (0.3, (B, L, 16)))]
    jm = jrnn.RNNAutoreg(**kw)
    params = jm.init(jax.random.key(0), *[jnp.asarray(a) for a in arrays])
    tm = RNNAutoreg(device="cpu", **kw)
    tm.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tm))

    def acc(got, ref):
        res = []
        for a, b in zip(got, ref):
            a = np.asarray(a, np.float64).ravel()
            b = np.asarray(b, np.float64).ravel()
            res.append((np.sqrt(np.mean((a - b) ** 2))
                        / np.sqrt(np.mean(b ** 2)), np.corrcoef(a, b)[0, 1]))
        return res

    ja = acc(jax.jit(jq.QuantGRUForward(jm, params))(
        *[jnp.asarray(a) for a in arrays]),
        jm.apply(params, *[jnp.asarray(a) for a in arrays]))
    targs = [torch.tensor(a) for a in arrays]
    with torch.no_grad():
        ta = acc([t.numpy() for t in tq.QuantGRUForward(tm)(*targs)],
                 [t.numpy() for t in tm(*targs)])
    for (tr, tc), (jr, jc) in zip(ta, ja):
        assert abs(tr - jr) < 1e-3 and abs(tc - jc) < 1e-4, (tr, jr, tc, jc)
        assert tc > 0.99
