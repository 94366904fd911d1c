"""The port's RNNAutoreg with the options of ROADMAP A.12 (the LSTM,
LayerNorm-LSTM and SRU scan trunks, the QRNN trunk, separate radiation
and memory None, on the scan and the v2 trunks) against the JAX package's
on the same flax parameters and inputs, on the CPU: float32 to 1e-5
relative (plus 1e-6 absolute); under the BF16 policy within 4x JAX's own
bf16-vs-f32 distance plus 1e-3 of the output's scale, as
test_torch_model_arms.py holds the bf16 arms (XLA and torch round bf16
elementwise chains at different places). Where JAX's model fails (the
LayerNorm cells under bf16, the stochastic LayerNorm LSTM in any policy)
the port fails the same way."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models import common as jcommon
from climsim_tpu.models import rnn as jrnn
from climsim_tpu_torch.models import RNNAutoreg, from_flax_params
from climsim_tpu_torch.models import common as tcommon

NX, NX_SFC, NY, NY_SFC = 6, 24, 6, 8
NNEUR, NH_MEM, L, B = (16, 16), 4, 14, 8
# separate radiation: the gases are level channels 12:15, and the CRM and
# its memory cover the bottom L_CRM levels
NX_RAD, L_CRM = 16, 10
CASES = {
    "lstm": dict(cell="lstm"),
    "ln_lstm": dict(cell="ln_lstm"),
    "sru": dict(cell="sru"),
    "qrnn": dict(cell="qrnn"),
    "separate_radiation": dict(separate_radiation=True),
    "separate_radiation_v2": dict(separate_radiation=True, use_pallas=True),
    "no_memory": dict(use_memory=False),
    "no_memory_v2": dict(use_memory=False, use_pallas=True),
    "no_memory_lstm_mem_is_rnn": dict(use_memory=False, cell="lstm",
                                      nh_mem=16),
}
ARM = {"qrnn": "qrnn", "separate_radiation_v2": "v2", "no_memory_v2": "v2"}
BF16_FAILS = ("ln_lstm", "sru")


def _kw(flags):
    kw = dict(nx=NX_RAD if flags.get("separate_radiation") else NX,
              nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=NNEUR,
              nh_mem=NH_MEM, add_pres=False)
    kw.update(flags)
    return kw


def _inputs(flags, seed=7):
    rng = np.random.default_rng(seed)
    kw = _kw(flags)
    Lm = L_CRM if flags.get("separate_radiation") else L
    return [rng.normal(0, s, shape).astype(np.float32) for s, shape in
            ((1.0, (B, L, kw["nx"])), (1.0, (B, NX_SFC)),
             (0.5, (B, Lm, kw["nh_mem"])))]


def random_params(shapes, seed):
    """A flax tree of the structure and shapes ``shapes`` (from
    ``jax.eval_shape`` of an init, which compiles nothing) with random
    leaves at init-like scales, none at a value that would hide a
    misplaced parameter: weights normal / sqrt(fan-in), LayerNorm scales
    1 + 0.1 normal, biases 0.1 normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(a.shape)
        if len(a.shape) >= 2:
            z = z / np.sqrt(np.prod(a.shape[:-1]))
        elif name == "scale":
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        return jnp.asarray(z, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _params(case):
    """The case's flax parameters (float32 leaves, whatever the policy):
    JAX's init structure with random leaves, one tree per case, shared by
    its tests."""
    flags = CASES[case]
    jm = jrnn.RNNAutoreg(**_kw(flags))
    return random_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        *[jnp.asarray(a) for a in _inputs(flags)]), 1)


def _jax_out(case, policy, params):
    """JAX's model of the case under ``policy`` on ``params``, jitted."""
    flags = CASES[case]
    jm = jrnn.RNNAutoreg(policy=getattr(jcommon, policy), **_kw(flags))
    out = jax.jit(jm.apply)(params, *[jnp.asarray(a) for a in
                                      _inputs(flags)])
    return [np.asarray(a, np.float32) for a in out]


def _port_out(case, policy, params):
    flags = CASES[case]
    tm = RNNAutoreg(policy=getattr(tcommon, policy), device="cpu",
                    **_kw(flags))
    tm.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tm))
    with torch.no_grad():
        out = tm(*[torch.as_tensor(a) for a in _inputs(flags)])
    return tm, [t.float().numpy() for t in out]


@pytest.mark.parametrize("case", list(CASES))
def test_option_matches_jax_f32(case):
    """Every output (out, out_sfc, the new or passed-through memory) to
    1e-5 relative; the trunk is the one JAX's flags select."""
    flags = CASES[case]
    params = _params(case)
    tm, tout = _port_out(case, "F32", params)
    assert tm.arm == ARM.get(case, "scan")
    jout = _jax_out(case, "F32", params)
    for j, t, name in zip(jout, tout, ("out", "out_sfc", "new_mem")):
        assert j.shape == t.shape, name
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{case} {name}")
    if not flags.get("use_memory", True):
        np.testing.assert_array_equal(tout[2], _inputs(flags)[2])


@pytest.mark.parametrize("case", [c for c in CASES if c not in BF16_FAILS])
def test_option_matches_jax_bf16(case):
    params = _params(case)
    _, tout = _port_out(case, "BF16", params)
    jout = _jax_out(case, "BF16", params)
    j32 = _jax_out(case, "F32", params)
    for j, t, r, name in zip(jout, tout, j32, ("out", "out_sfc", "new_mem")):
        assert np.all(np.isfinite(t)), name
        own = np.abs(j - r).max()
        err = np.abs(t - j).max()
        assert err <= 4.0 * own + 1e-3 * np.abs(r).max(), \
            f"{case} {name}: {err:.3e} > 4 x {own:.3e}"


@pytest.mark.parametrize("case", BF16_FAILS)
def test_layer_norm_cells_fail_under_bf16_as_jax(case):
    """The LayerNorms return float32 for the bf16 carry: JAX's scan
    refuses the carry's change of type at init, and the port at
    construction."""
    flags = CASES[case]
    arrays = _inputs(flags)
    jm = jrnn.RNNAutoreg(policy=jcommon.BF16, **_kw(flags))
    with pytest.raises(TypeError, match="carry"):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       *[jnp.asarray(a) for a in arrays])
    with pytest.raises(TypeError, match="carry"):
        RNNAutoreg(policy=tcommon.BF16, device="cpu", **_kw(flags))


def test_sln_lstm_fails_where_jax_fails():
    """JAX's model cannot run the stochastic LayerNorm LSTM: its init
    fails unpacking the bare-array carry. The port refuses it at
    construction, naming those lines."""
    flags = dict(add_stochastic_layer=True, stochastic_cell="sln_lstm")
    arrays = _inputs({})
    jm = jrnn.RNNAutoreg(**_kw(flags))
    with pytest.raises(ValueError, match="unpack"):
        jm.init({"params": jax.random.PRNGKey(0),
                 "noise": jax.random.PRNGKey(1)},
                *[jnp.asarray(a) for a in arrays], deterministic=False)
    with pytest.raises(ValueError, match="cells.py:119"):
        RNNAutoreg(device="cpu", **_kw(flags))


def test_option_gradients_match_jax():
    """The LSTM trunk with memory None: the gradients of a loss of every
    output with respect to every parameter (the cell states' Dense layers
    included), to 1e-5 of each gradient's scale."""
    case = "no_memory_lstm_mem_is_rnn"
    flags, params = CASES[case], _params(case)
    jm = jrnn.RNNAutoreg(**_kw(flags))
    arrays = _inputs(flags)

    def loss(p):
        return sum(jnp.sum(o ** 2) for o in jm.apply(
            p, *[jnp.asarray(a) for a in arrays]))

    jg = jax.jit(jax.grad(loss))(params)
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            key = prefix + k
            if hasattr(v, "items"):
                walk(v, prefix if k == "params" else key + ".")
            else:
                flat[key] = np.asarray(v)

    walk(jg)
    tm = RNNAutoreg(device="cpu", **_kw(flags))
    tm.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tm))
    sum(o.square().sum() for o in tm(*[torch.as_tensor(a)
                                       for a in arrays])).backward()
    for name, p in tm.named_parameters():
        want = flat[name]
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=1e-5,
            atol=1e-5 * float(np.abs(want).max(initial=0.0)) + 1e-7,
            err_msg=name)
