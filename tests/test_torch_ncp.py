"""The port's NCP wirings and CfC (liquid) networks
(``climsim_tpu_torch/models/ncp.py``) against the JAX package's
(``climsim_tpu/models/ncp.py``) on the CPU: the wirings bit-equal for the
same seed, the cells and the sequence model on the same flax parameters
(carried across by ``from_flax_params``) on the same numpy inputs, their
outputs within 1e-6 (cells) and the sequence model's outputs and
parameter gradients within 1e-5 of each array's scale (summation order
differs between XLA and torch). JAX runs with x64 off, in float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models import ncp as jncp
from climsim_tpu_torch.models import from_flax_params
from climsim_tpu_torch.models.convert import _flatten
from climsim_tpu_torch.models import ncp


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, tol, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, err_msg
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), \
        f"{err_msg}: error {err:.3e}, scale {np.abs(want).max():.3e}"


def normal(seed, *shape, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape) \
        .astype(np.float32)


def load(tmodel, params):
    tmodel.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tmodel))
    return tmodel


# ------------------------------------------------------------ wirings


@pytest.mark.parametrize("seed", [22222, 7])
def test_ncp_wiring_bit_equal(seed):
    kw = dict(inter_neurons=12, command_neurons=8, motor_neurons=4,
              sensory_fanout=4, inter_fanout=4,
              recurrent_command_synapses=6, motor_fanin=4, seed=seed)
    ours, ref = ncp.NCP(**kw), jncp.NCP(**kw)
    ours.build(10)
    ref.build(10)
    np.testing.assert_array_equal(ours.adjacency_matrix,
                                  ref.adjacency_matrix)
    np.testing.assert_array_equal(ours.sensory_adjacency_matrix,
                                  ref.sensory_adjacency_matrix)
    assert ours.adjacency_matrix.dtype == ref.adjacency_matrix.dtype
    assert [ours.get_type_of_neuron(i) for i in range(ours.units)] \
        == [ref.get_type_of_neuron(i) for i in range(ref.units)]


def test_autoncp_wiring_bit_equal():
    ours, ref = ncp.AutoNCP(28, 6, 0.5, seed=3), jncp.AutoNCP(28, 6, 0.5,
                                                             seed=3)
    ours.build(9)
    ref.build(9)
    np.testing.assert_array_equal(ours.adjacency_matrix,
                                  ref.adjacency_matrix)
    np.testing.assert_array_equal(ours.sensory_adjacency_matrix,
                                  ref.sensory_adjacency_matrix)
    assert ours.synapse_count == ref.synapse_count
    assert ours.sensory_synapse_count == ref.sensory_synapse_count
    for layer in range(3):
        assert ours.get_neurons_of_layer(layer) \
            == ref.get_neurons_of_layer(layer)


def test_wiring_config_roundtrip():
    w = ncp.AutoNCP(20, 4, seed=1)
    w.build(5)
    cfg = w.get_config()
    assert cfg == jncp.Wiring.from_config(cfg).get_config()
    w2 = ncp.Wiring.from_config(cfg)
    np.testing.assert_array_equal(w.adjacency_matrix, w2.adjacency_matrix)
    np.testing.assert_array_equal(w.sensory_adjacency_matrix,
                                  w2.sensory_adjacency_matrix)
    assert w2.input_dim == 5 and w2.output_dim == 4


def test_wiring_rejects_bad_synapses():
    w = ncp.Wiring(4)
    with pytest.raises(ValueError):
        w.add_synapse(0, 4, 1)
    with pytest.raises(ValueError):
        w.add_synapse(0, 1, 0)
    with pytest.raises(ValueError):
        w.add_sensory_synapse(0, 1, 1)
    with pytest.raises(ValueError):
        ncp.AutoNCP(8, 6)


# ------------------------------------------------------------ cells

B, NX, H = 5, 7, 16
TS = {"scalar": 0.7, "b": np.linspace(0.2, 1.5, B).astype(np.float32),
      "b1": np.linspace(0.2, 1.5, B).astype(np.float32)[:, None]}


@pytest.mark.parametrize("mode", ["default", "pure", "no_gate"])
@pytest.mark.parametrize("ts", list(TS))
def test_cfc_cell_matches_jax(mode, ts):
    x, h = normal(0, B, NX), normal(1, B, H, scale=0.5)
    jcell = jncp.CfCCell(hidden_size=H, mode=mode, backbone_units=24)
    with jax.enable_x64(False):
        p = jcell.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(h))
        if mode == "pure":
            # w_tau starts at 0 and A at 1: move them off their init
            p["params"]["w_tau"] = jnp.asarray(normal(2, 1, H))
            p["params"]["A"] = jnp.asarray(1 + normal(3, 1, H, scale=0.2))
        want, want_h = jcell.apply(p, jnp.asarray(x), jnp.asarray(h),
                                   jnp.asarray(TS[ts]))
    cell = load(ncp.CfCCell(NX, H, mode=mode, backbone_units=24,
                            device="cpu"), p)
    got, got_h = cell(torch.as_tensor(x), torch.as_tensor(h),
                      torch.as_tensor(TS[ts]) if ts != "scalar"
                      else TS[ts])
    close(got.detach(), want, 1e-6, f"{mode} {ts}")
    close(got_h.detach(), want_h, 1e-6, f"{mode} {ts}")


def test_cfc_cell_tree_and_init():
    """The port's tree is flax's, and its initialisers flax's in law:
    zeros for biases and w_tau, ones for A."""
    for mode in ("default", "pure"):
        jcell = jncp.CfCCell(hidden_size=H, mode=mode, backbone_layers=2)
        with jax.enable_x64(False):
            shapes = jax.eval_shape(jcell.init, jax.random.PRNGKey(0),
                                    jnp.zeros((B, NX)), jnp.zeros((B, H)))
        flat = {k: v.shape for k, v in _flatten(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
        cell = ncp.CfCCell(NX, H, mode=mode, backbone_layers=2,
                           device="cpu", seed=4)
        assert {k: tuple(v.shape) for k, v in cell.state_dict().items()} \
            == {k: tuple(v) for k, v in flat.items()}
        sd = cell.state_dict()
        for k, v in sd.items():
            if k.endswith("bias") or k == "w_tau":
                assert torch.count_nonzero(v) == 0, k
        if mode == "pure":
            assert torch.equal(sd["A"], torch.ones(1, H))
        k = sd["backbone0.kernel"]
        std = float(k.std())
        assert abs(std - (1 / (NX + H)) ** 0.5) < 0.15 * std
        assert float(k.abs().max()) <= 2 * (1 / (NX + H)) ** 0.5 / 0.8796


@pytest.mark.parametrize("activation", ["gelu", "silu", "relu", "tanh"])
def test_cfc_cell_backbone_activations(activation):
    x, h = normal(5, B, NX), normal(6, B, H)
    jcell = jncp.CfCCell(hidden_size=H, backbone_activation=activation)
    with jax.enable_x64(False):
        p = jcell.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(h))
        want, _ = jcell.apply(p, jnp.asarray(x), jnp.asarray(h))
    cell = load(ncp.CfCCell(NX, H, backbone_activation=activation,
                            device="cpu"), p)
    got, _ = cell(torch.as_tensor(x), torch.as_tensor(h))
    close(got.detach(), want, 1e-6, activation)


def _wired_pair(seed=5, units=24, out=4, nin=6, mode="default"):
    jw, tw = jncp.AutoNCP(units, out, seed=seed), ncp.AutoNCP(units, out,
                                                              seed=seed)
    jcell = jncp.WiredCfCCell.from_wiring(jw, input_size=nin, mode=mode)
    cell = ncp.WiredCfCCell.from_wiring(tw, input_size=nin, mode=mode,
                                        device="cpu")
    return jcell, cell


@pytest.mark.parametrize("mode", ["default", "pure"])
def test_wired_cell_matches_jax(mode):
    jcell, cell = _wired_pair(mode=mode)
    assert cell.layer_sizes == jcell.layer_sizes
    for m, jm in zip(cell.layer_masks, jcell.layer_masks):
        np.testing.assert_array_equal(m, np.asarray(jm, np.float32))
    x, h = normal(7, 3, 6), normal(8, 3, cell.state_size)
    with jax.enable_x64(False):
        p = jcell.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(h))
        want, want_h = jcell.apply(p, jnp.asarray(x), jnp.asarray(h), 0.5)
    load(cell, p)
    assert not any("mask" in k for k in cell.state_dict())
    got, got_h = cell(torch.as_tensor(x), torch.as_tensor(h), 0.5)
    assert got.shape == (3, cell.output_dim)
    close(got.detach(), want, 1e-6, mode)
    close(got_h.detach(), want_h, 1e-6, mode)


def test_wired_cell_respects_sparsity():
    """Zeroed synapses carry no gradient: d loss / d masked-out kernel
    entry is exactly zero, as in JAX's test_wired_cell_respects_sparsity."""
    _, cell = _wired_pair()
    x = torch.ones(2, 6)
    h = torch.ones(2, cell.state_size)
    out, nh = cell(x, h)
    (out.pow(2).sum() + nh.pow(2).sum()).backward()
    for i, mask in enumerate(cell.layer_masks):
        g = getattr(cell, f"layer_{i}").ff1_kernel.grad.numpy()
        assert np.all(g[mask == 0] == 0.0), i
        assert np.any(g[mask == 1] != 0.0), i


# ------------------------------------------------------------ sequences

BS, T, NXS = 4, 6, 5
CASES = {
    "dense_mixed_proj": dict(kw=dict(units=12, proj_size=3,
                                     mixed_memory=True, backbone_units=16)),
    "dense_last_timespans": dict(kw=dict(units=10, return_sequences=False,
                                         backbone_layers=2,
                                         backbone_units=8),
                                 timespans=True),
    "dense_gelu_pure": dict(kw=dict(units=8, activation="gelu",
                                    mode="pure", backbone_units=12)),
    "wired": dict(wired=(20, 3), kw=dict(proj_size=2)),
    "wired_mixed_last": dict(wired=(18, 4), kw=dict(mixed_memory=True,
                                                    return_sequences=False),
                             timespans=True),
}


def _models(case):
    c = CASES[case]
    if "wired" in c:
        units, out = c["wired"]
        jm = jncp.CfC.wired(jncp.AutoNCP(units, out, seed=9), NXS,
                            **c["kw"])
        tm = ncp.CfC.wired(ncp.AutoNCP(units, out, seed=9), NXS,
                           device="cpu", **c["kw"])
    else:
        jm = jncp.CfC(**c["kw"])
        tm = ncp.CfC(NXS, device="cpu", **c["kw"])
    return jm, tm


@pytest.mark.parametrize("case", list(CASES))
def test_cfc_matches_jax(case):
    jm, tm = _models(case)
    x = normal(10, BS, T, NXS)
    ts = np.random.default_rng(11).uniform(0.3, 2.0, (BS, T)) \
        .astype(np.float32) if CASES[case].get("timespans") else None
    jts = None if ts is None else jnp.asarray(ts)
    with jax.enable_x64(False):
        p = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
        (want, want_state) = jm.apply(p, jnp.asarray(x), timespans=jts)
        ct = normal(12, *want.shape)
        jgrad = jax.jit(jax.grad(lambda p: jnp.sum(
            jm.apply(p, jnp.asarray(x), timespans=jts)[0] * ct)))(p)
    load(tm, p)
    got, state = tm(torch.as_tensor(x), timespans=None if ts is None
                    else torch.as_tensor(ts))
    close(got.detach(), want, 1e-5, case)
    if tm.mixed_memory:
        close(state[0].detach(), want_state[0], 1e-5, case)
        close(state[1].detach(), want_state[1], 1e-5, case)
    else:
        close(state.detach(), want_state, 1e-5, case)
    (got * torch.as_tensor(ct)).sum().backward()
    flat = _flatten(
        jax.tree_util.tree_map(np.asarray, jgrad))
    for name, prm in tm.named_parameters():
        close(prm.grad.numpy(), flat[name], 1e-5, f"{case} {name}")


def test_cfc_given_state_and_entry_device():
    """A given (h, c) carries through; the model defaults to the card."""
    jm, tm = _models("dense_mixed_proj")
    x = normal(13, BS, T, NXS)
    h0, c0 = normal(14, BS, 12, scale=0.3), normal(15, BS, 12, scale=0.3)
    with jax.enable_x64(False):
        p = jm.init(jax.random.PRNGKey(4), jnp.asarray(x))
        want, _ = jm.apply(p, jnp.asarray(x),
                           (jnp.asarray(h0), jnp.asarray(c0)))
    load(tm, p)
    got, _ = tm(torch.as_tensor(x), (torch.as_tensor(h0),
                                     torch.as_tensor(c0)))
    close(got.detach(), want, 1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ncp.CfC(NXS, 8)


def test_cfc_sequence_and_training():
    """Dense CfC with mixed memory and a projection fits a toy sequence
    regression with Adam: the loss halves in 40 steps, as JAX's
    tests/test_ncp.py::test_cfc_sequence_and_training."""
    x = torch.as_tensor(normal(2, 8, 12, 5))
    y = torch.cumsum(x[..., :2], dim=1)
    m = ncp.CfC(5, 24, proj_size=2, mixed_memory=True, backbone_units=32,
                device="cpu")
    outs, (h, c) = m(x)
    assert outs.shape == (8, 12, 2) and h.shape == (8, 24)
    opt = torch.optim.Adam(m.parameters(), lr=1e-2)
    losses = []
    for _ in range(40):
        loss = torch.mean((m(x)[0] - y) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.5 * losses[0]
