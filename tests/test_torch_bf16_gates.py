"""The GRU forwards' bf16-gate mode (``acc32=False``: the hidden state
carried in bf16 and every gate operation rounded to bf16, the TPU bodies'
``acc = x_ref.dtype``) on the CPU, where each wrapper runs its kernel's
plain version:

* the five plain versions (B1, B4 in both ``hoist_proj`` bodies, B7, B9
  and B10) against the JAX package's Pallas kernels in interpret mode with
  ``acc32=False``, at bf16 and L 8, to the bit: XLA on the CPU rounds
  every bf16 operation of the typed sigmoid and tanh (checked op by op),
  as the plain versions do, and B1's and B10's initial MLP takes the typed
  tanh too;
* the float32-gate mode's one departure: B1 and B10 there take the
  initial MLP's tanh in float32, rounded once, where the TPU bodies take
  the typed bf16 tanh in both modes (ROADMAP C). Fed JAX's own ``xi``,
  the float32-gate B1 and B10 agree with Pallas to the bit; with their own
  they differ by at most 2e-2 (measured 7.8e-3, one bf16 ulp, at L 8);
* with float32 inputs ``acc32=False`` is the float32 computation: the
  same bits;
* the gradients under ``acc32=False`` are those under ``acc32=True`` to
  the bit (the backward linearises the float32-gate forward from the
  saved inputs in both modes, as JAX's does);
* ``RNNAutoreg(pallas_acc32=False)`` in the v2-v6 arms against JAX's model
  with the same flag (whose CPU path runs its compositions' float32
  gates) within 4x JAX's own bf16-vs-f32 distance plus 1e-3 of scale;
* a v4 ``OnlineWrapper`` over a ``pallas_acc32=False`` model exports with
  the mode in its op's arguments and reloads equal to the eager step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models import common as jcommon
from climsim_tpu.models import rnn as jrnn
from climsim_tpu.ops import pallas_rnn as J
from climsim_tpu_torch.models import BF16, RNNAutoreg, from_flax_params
from climsim_tpu_torch.models import common as tcommon
from climsim_tpu_torch.models.cells import FusedBiGRULayer
from climsim_tpu_torch.ops import pallas_rnn as P

from test_torch_rnn_a12 import random_params

L, H, B = 8, 16, 16
NF, NMI, NM, NY, CH, NX = 6, 8, 8, 6, 16, 26
BF, JB = torch.bfloat16, jnp.bfloat16


def _gen(shapes, seed):
    rng = np.random.default_rng(seed)
    return [(0.25 * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


_W_LBH = [(H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,),
          (H, NM), (NM,), (NM, NY), (NY,)]
_W_CM = [(3 * H, 1), (3 * H, H), (3 * H, 1), (3 * H, H), (3 * H, 1),
         (3 * H, H), (3 * H, 1), (NM, H), (NM, 1), (NY, NM), (NY, 1)]
# per kind: (shapes, plain version, Pallas body with its static args after
# the arrays, the plain version's keyword arguments)
KINDS = {
    "b1": ([(L, NF, B), (L, NMI, B), (H, B), (H, B), (H, NF), (H, 1),
            (3 * H, H), (3 * H, NMI)] + _W_CM,
           P.bigru_heads_init_cm_reference,
           lambda a: J._bigru_heads_init_cm_pallas(*a, 16, True, False), {}),
    "b4": ([(L, CH, B), (L, NMI, B), (H, B), (H, B), (3 * H, CH),
            (3 * H, NMI)] + _W_CM, P.bigru_heads_cm_reference,
           lambda a: J._bigru_heads_cm_pallas(*a, 16, True, False, True), {}),
    "b4_unhoisted": (None, P.bigru_heads_cm_reference,
                     lambda a: J._bigru_heads_cm_pallas(*a, 16, True, False,
                                                        False),
                     {"hoist_proj": False}),
    "b7": ([(L, B, 3 * H), (B, H), (B, H), (H, 3 * H), (3 * H,), (H, 3 * H),
            (3 * H,), (H, 3 * H), (3 * H,)], P.bigru_reference_lbh,
           lambda a: J._bigru_pallas_lbh(*a, 16, True, False), {}),
    "b9": ([(L, B, NX), (B, H), (B, H), (NX, 3 * H), (3 * H,)] + _W_LBH,
           P.bigru_heads_lbh_reference,
           lambda a: J._bigru_heads_pallas_lbh(*a, 16, True, False), {}),
    "b10": ([(L, B, NF), (L, B, NMI), (B, H), (B, H), (NF, H), (H,),
             (H + NMI, 3 * H), (3 * H,)] + _W_LBH,
            P.bigru_heads_init_lbh_reference,
            lambda a: J._bigru_heads_init_pallas_lbh(*a, 16, True, False),
            {}),
}
KINDS["b4_unhoisted"] = (KINDS["b4"][0],) + KINDS["b4_unhoisted"][1:]
WRAPPERS = {"b1": P.fused_bigru_heads_init_cm, "b4": P.fused_bigru_heads_cm,
            "b7": P.fused_bigru_lbh, "b9": P.fused_bigru_heads_lbh,
            "b10": P.fused_bigru_heads_init_lbh}


def _case(kind, seed=3):
    shapes, plain, pallas, kw = KINDS[kind]
    return _gen(shapes, seed), plain, pallas, kw


def _t(a, dt=BF):
    return [torch.as_tensor(x).to(dt) for x in a]


def _j(a, dt=JB):
    return [jnp.asarray(x).astype(dt) for x in a]


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                      np.float32)


@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_matches_pallas_interpret(kind):
    a, plain, pallas, kw = _case(kind)
    got = plain(*_t(a), acc32=False, **kw)
    want = pallas(_j(a))
    for g, w in zip(got, want):
        assert g.dtype == BF and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_np(g), _np(w))


def _jax_xi(feat, winit, binit, cm):
    """JAX's bf16 initial-MLP stream: the typed tanh of the bf16-rounded
    pre-activation, as the v6 and v4 bodies evaluate it."""
    f = jnp.float32
    if cm:
        pre = jnp.einsum("hf,lfb->lhb", winit.astype(f), feat.astype(f)) \
            + binit.astype(f)[None]
    else:
        pre = jnp.einsum("lbf,fh->lbh", feat.astype(f), winit.astype(f)) \
            + binit.astype(f)
    return J._tanh_typed(pre.astype(JB))


@pytest.mark.parametrize("kind", ["b1", "b10"])
def test_f32_gate_init_kernels_depart_in_xi_alone(kind):
    """acc32=True at bf16: B1's and B10's sweeps and heads, fed JAX's own
    initial-MLP stream, agree with JAX's B1 and B10 to the bit; with the
    port's (the float32 tanh, rounded once) they stay within 2e-2."""
    a, plain, _, _ = _case(kind)
    cm = kind == "b1"
    pallas = (J._bigru_heads_init_cm_pallas if cm
              else J._bigru_heads_init_pallas_lbh)
    ja, ta = _j(a), _t(a)
    want = pallas(*ja, 16, True, True)
    xi = torch.tensor(np.asarray(
        _jax_xi(ja[0], ja[4], ja[5], cm).astype(jnp.float32))).to(BF)
    if cm:
        got = P.bigru_heads_cm_reference(xi, *ta[1:4], *ta[6:],
                                         hoist_proj=True)
    else:
        win1 = ta[6].float()
        got = P._heads_sweeps_lbh(
            lambda l: xi[l].float() @ win1[:H] + ta[1][l].float() @ win1[H:]
            + ta[7].float(), L, BF, ta[2], ta[3], *ta[8:])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    for g, w in zip(plain(*ta), want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=2e-2)


@pytest.mark.parametrize("kind", ["b1", "b4", "b7", "b9", "b10"])
def test_f32_inputs_give_the_same_bits(kind):
    """A float32 input's gates are float32 in both modes: the plain
    version, and the wrapper (its op on the CPU), give equal bits."""
    a, plain, _, kw = _case(kind)
    ta = _t(a, torch.float32)
    for fn in (plain, WRAPPERS[kind]):
        with torch.no_grad():
            x, y = fn(*ta, acc32=True, **kw), fn(*ta, acc32=False, **kw)
        for u, v in zip(x, y):
            assert torch.equal(u, v)


@pytest.mark.parametrize("kind", ["b1", "b4", "b7", "b9", "b10"])
def test_gradients_are_the_f32_gate_ones(kind):
    """The bf16 forward differs between the modes, the gradients (of one
    set of cotangents) do not, to the bit."""
    a, _, _, _ = _case(kind)
    fn = WRAPPERS[kind]
    outs, grads = [], []
    for acc32 in (True, False):
        ta = [t.requires_grad_(True) for t in _t(a)]
        out = fn(*ta, acc32=acc32)
        g = torch.Generator().manual_seed(9)
        cts = [torch.randn(o.shape, generator=g).to(o.dtype) for o in out]
        torch.autograd.backward(out, cts)
        outs.append([o.detach() for o in out])
        grads.append([t.grad for t in ta])
    assert not torch.equal(outs[0][0], outs[1][0])
    for x, y in zip(*grads):
        assert torch.equal(x, y)


def test_fused_layer_takes_the_mode():
    """FusedBiGRULayer(acc32=False) builds and runs B7's bf16 gates; with
    float32 inputs it is the acc32=True layer's computation."""
    g = torch.Generator().manual_seed(2)
    t16, t32 = FusedBiGRULayer(10, H, acc32=False, generator=g), \
        FusedBiGRULayer(10, H)
    t32.load_state_dict(t16.state_dict())
    x, h0, h1 = torch.randn(B, L, 10), torch.randn(B, H), torch.randn(B, H)
    with torch.no_grad():
        for u, v in zip(t16(x, h0, h1), t32(x, h0, h1)):
            assert torch.equal(u, v)
        got = t16(x.to(BF), h0, h1)
        xp = torch.matmul(x.to(BF).transpose(0, 1), t16.win1.to(BF)) \
            + t16.bin1.to(BF)
        want = P.bigru_reference_lbh(
            xp, h0.to(BF), h1.to(BF), *[getattr(t16, k).to(BF) for k in (
                "whh_up", "bhh_up", "win2", "bin2", "whh_dn", "bhh_dn")],
            acc32=False)
    assert torch.equal(got[0], want[0].transpose(0, 1))
    assert torch.equal(got[1], want[1])


NXM, NX_SFC, NYM, NY_SFC = 6, 24, 6, 8
V5 = dict(use_pallas=True, fuse_heads=True, level_major=True, add_pres=False)
ARMS = {"v6": dict(V5, fuse_init=True), "v5": V5,
        "v4": dict(use_pallas=True, fuse_heads=True, fuse_init=True,
                   add_pres=False),
        "v3": dict(use_pallas=True, fuse_heads=True, add_pres=False),
        "v2": dict(use_pallas=True, add_pres=False)}


@pytest.mark.parametrize("arm", list(ARMS))
def test_model_arm_matches_jax(arm):
    """RNNAutoreg(pallas_acc32=False, BF16) in each fused arm: its outputs
    differ from the acc32=True model's on the same weights (the mode is
    on) and stay within 4x JAX's own bf16-vs-f32 distance, plus 1e-3 of
    scale, of JAX's model with the same flag."""
    flags = ARMS[arm]
    kw = dict(nx=NXM, nx_sfc=NX_SFC, ny=NYM, ny_sfc=NY_SFC, nneur=(16, 16),
              nh_mem=4, pallas_acc32=False, **flags)
    lm = flags.get("level_major", False)
    rng = np.random.default_rng(11)
    arrays = [rng.normal(0, s, sh).astype(np.float32) for s, sh in (
        (1.0, (12, NXM, B) if lm else (B, 12, NXM)), (1.0, (B, NX_SFC)),
        (0.5, (12, 4, B) if lm else (B, 12, 4)))]
    ja = [jnp.asarray(x) for x in arrays]
    jm = jrnn.RNNAutoreg(policy=jcommon.BF16, **kw)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          *ja), 0)
    tree = jax.tree_util.tree_map(np.asarray, params)
    jout = [_np(o) for o in jax.jit(jm.apply)(params, *ja)]
    j32 = [_np(o) for o in jax.jit(jrnn.RNNAutoreg(
        policy=jcommon.F32, **kw).apply)(params, *ja)]
    ta = [torch.as_tensor(x) for x in arrays]
    outs = []
    for acc32 in (False, True):
        tm = RNNAutoreg(policy=tcommon.BF16, device="cpu",
                        **{**kw, "pallas_acc32": acc32})
        assert tm.arm == arm
        tm.load_state_dict(from_flax_params(tree, tm))
        with torch.no_grad():
            outs.append([_np(o) for o in tm(*ta)])
    assert not np.array_equal(outs[0][0], outs[1][0])
    for t, j, r, name in zip(outs[0], jout, j32, ("out", "out_sfc",
                                                  "new_mem")):
        own = np.abs(j - r).max()
        err = np.abs(t - j).max()
        assert err <= 4.0 * own + 1e-3 * np.abs(r).max(), \
            f"{arm} {name}: {err:.3e} > 4 x {own:.3e}"


def test_export_carries_the_mode(tmp_path):
    """A v4 OnlineWrapper over a pallas_acc32=False bf16 model exports with
    acc32=False in its climsim:: node's arguments and reloads equal to the
    eager step, which differs from the acc32=True model's."""
    from climsim_tpu_torch.data import LevelNormalizer
    from climsim_tpu_torch.export import (OnlineWrapper, WrapperConfig,
                                          export_wrapper, load_step)
    from climsim_tpu_torch.ops import library
    Lw, nx, nxs, nm, Bw = 60, 15, 24, 4, 6
    norm = LevelNormalizer(torch.zeros(1, nx), torch.ones(1, nx),
                           torch.zeros(nxs), torch.ones(nxs),
                           torch.full((1, 5), 1e3), torch.ones(8))
    lbd = np.full(Lw, 1e4, np.float32)
    wrappers = {}
    for acc32 in (False, True):
        model = RNNAutoreg(nx=nx, nx_sfc=nxs, ny=5, ny_sfc=8, nneur=(16, 16),
                           nh_mem=nm, add_pres=False, use_pallas=True,
                           fuse_heads=True, fuse_init=True, policy=BF16,
                           pallas_acc32=acc32, device="cpu")
        wrappers[acc32] = OnlineWrapper(model, norm, lbd, lbd, lbd,
                                        WrapperConfig(mp_mode=1))
    wrappers[True].model.load_state_dict(wrappers[False].model.state_dict())
    path = str(tmp_path / "v4_bf16_gates.pt2")
    export_wrapper(wrappers[False], Bw, Lw, nx, nxs, nm, path)
    program = torch.export.load(path)
    nodes = [n for n in program.graph.nodes
             if str(n.target) in library.exported_ops(program.graph)]
    assert [str(n.target) for n in nodes] == \
        ["climsim.fused_bigru_heads_init_lbh.default"]
    assert nodes[0].args[0] is False
    rng = np.random.default_rng(1)
    x = np.abs(rng.normal(0.5, 0.2, (Bw, Lw, nx)))
    x[..., 0] = rng.uniform(220, 300, (Bw, Lw))
    arrays = [torch.as_tensor(a.astype(np.float32)) for a in (
        x, np.abs(rng.normal(0.5, 0.2, (Bw, nxs))),
        rng.normal(0, 0.5, (Bw, Lw, nm)))]
    with torch.no_grad():
        got = load_step(path)(*arrays)
        eager = wrappers[False](*arrays)
        f32_gates = wrappers[True](*arrays)
    for g, w in zip(got, eager):
        assert torch.equal(g, w)
    assert not all(torch.equal(g, w) for g, w in zip(got, f32_gates))
