"""The port's other recurrent cells and blocks (the LSTM, the LayerNorm
LSTM, the stochastic LayerNorm LSTM, the SRU, the GLU and the QRNN)
against the JAX package's on the CPU in float32, on the same flax
parameters (carried across by ``from_flax_params``) and inputs: each
cell's step, each cell through ``RNNLayer`` in both directions, the GLU
in both forms and the QRNN in its causal and centred, forward and
reverse, sigmoid and tanh, sequential and prefix forms; outputs and the
gradients of a loss of them with respect to every input and parameter.
Tolerance 1e-5 relative at L 10, H 12, plus 1e-6 absolute on outputs and
1e-5 of the tensor's largest magnitude on gradients (a gradient summed
over many terms can cancel to near zero, where float32's summation order
alone moves it by more than 1e-5 of itself); the QRNN's prefix form
associates its sums as JAX's own does not, within the same tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models import cells as jcells
from climsim_tpu_torch.models import from_flax_params
from climsim_tpu_torch.models import cells as tcells

from test_torch_rnn_a12 import random_params

L, B, H, NX = 10, 6, 12, 9
RTOL, ATOL = 1e-5, 1e-6


def close(got, want, what=""):
    want = np.asarray(want, np.float32)
    atol = ATOL if not what.startswith("d/d") \
        else RTOL * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=RTOL, atol=max(atol, ATOL), err_msg=what)


def _port(module, params):
    tree = jax.tree_util.tree_map(np.asarray, params)
    module.load_state_dict(from_flax_params(tree, module))
    return module


def _init(module, seed, *args):
    """The module's flax parameters with random leaves (``random_params``:
    its init's structure, traced and not compiled)."""
    return random_params(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                        *args), seed)


def _grads_jax(fn, params, *args):
    """Outputs of fn(params, *args) and the gradients of sum(out**2) (over
    every output) with respect to params and args, in one jitted call (a
    tenth of the eager backward's time)."""
    def loss(p, *a):
        out = fn(p, *a)
        return sum(jnp.sum(o.astype(jnp.float32) ** 2)
                   for o in jax.tree_util.tree_leaves(out)), out
    (_, out), g = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(args) + 1)), has_aux=True))(
            params, *args)
    return out, g


def _grads_torch(module, *args):
    args = [jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=True), a)
        for a in args]
    out = module(*args)
    leaves = jax.tree_util.tree_leaves(
        out, is_leaf=lambda t: isinstance(t, torch.Tensor))
    sum(o.float().square().sum() for o in leaves).backward()
    grads = [jax.tree_util.tree_map(
        lambda t: t.grad, a, is_leaf=lambda t: isinstance(t, torch.Tensor))
        for a in args]
    return out, grads


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = prefix + k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix if k == "params" else key + "."))
        else:
            out[key] = v
    return out


def _rng_inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.7, s).astype(np.float32) for s in shapes]


# the cells with their carries and the width of their projection
CELL_CASES = {"lstm": (4, True, False), "ln_lstm": (4, True, False),
              "sru": (3, False, False), "sln_lstm": (4, True, True)}


@pytest.mark.parametrize("kind", list(CELL_CASES))
def test_cell_step_matches_jax(kind):
    """One step of each cell, its output and new carry, and the gradients
    with respect to the carry, the projection (and the raw input or the
    noise) and every parameter."""
    width, tup, noisy = CELL_CASES[kind]
    E = 5
    xp, h, c, x, eps = _rng_inputs(3, (B, width * H), (B, H), (B, H),
                                   (B, H), (B, E))
    carry = (jnp.asarray(h), jnp.asarray(c)) if tup else jnp.asarray(c)
    kw = {"eps_size": E} if kind == "sln_lstm" else {}
    jcell = jcells.CELL_TYPES[kind](H, **kw)
    inp = (jnp.asarray(xp), jnp.asarray(eps if noisy else x)) \
        if noisy or kind == "sru" else jnp.asarray(xp)
    params = _init(jcell, 2, carry, inp)
    jout, jgrads = _grads_jax(
        lambda p, cr, i: jcell.apply(p, cr, i), params, carry, inp)
    cls = tcells.CELLS[kind][0]
    tcell = _port(cls(H, torch.float32, **kw), params)

    def module(cr, i):
        # flax returns (carry, y); the port's cells return the carry, its
        # h being y, and SRU (carry, y)
        new = tcell(cr, *i) if isinstance(i, tuple) else tcell(cr, i)
        return new if kind == "sru" else (new, new[0])

    tout, tgrads = _grads_torch(module, carry, inp)
    jcarry, jy = jout
    for a, b in zip(jax.tree_util.tree_leaves(
            tout[0], is_leaf=lambda t: isinstance(t, torch.Tensor)),
            jax.tree_util.tree_leaves(jcarry)):
        close(a.detach(), b, "carry")
    close(tout[1].detach(), jy, "y")
    jp = _flat(jgrads[0])
    for name, p in tcell.named_parameters():
        close(p.grad, jp[name], f"d/d {name}")
    for jg, tg in zip(jgrads[1:], tgrads):
        for a, b in zip(jax.tree_util.tree_leaves(jg),
                        jax.tree_util.tree_leaves(
                            tg, is_leaf=lambda t: isinstance(t,
                                                             torch.Tensor))):
            close(b, a, "d/d input")


@pytest.mark.parametrize("kind,reverse", [("lstm", False), ("ln_lstm", True),
                                          ("sru", False), ("sru", True),
                                          ("sln_lstm", True)])
def test_rnn_layer_matches_jax(kind, reverse):
    """Each cell through RNNLayer over L levels, in one direction or the
    other (SRU in both: reversed at nx == H, where its highway takes the
    raw input), outputs, final carry and every gradient."""
    width, tup, noisy = CELL_CASES[kind]
    E = 5
    nx = H if kind == "sru" and reverse else NX
    xs, h0, c0, eps = _rng_inputs(5, (B, L, nx), (B, H), (B, H), (L, B, E))
    carry = (jnp.asarray(h0), jnp.asarray(c0)) if tup else jnp.asarray(h0)
    jl = jcells.RNNLayer(H, kind, reverse=reverse, noise=noisy, eps_size=E)
    args = (jnp.asarray(xs), carry) + ((jnp.asarray(eps),) if noisy else ())
    params = _init(jl, 4, *args)
    jout, jgrads = _grads_jax(lambda p, *a: jl.apply(p, *a), params, *args)
    tl = _port(tcells.RNNLayer(nx, H, kind, reverse=reverse, noise=noisy,
                               eps_size=E), params)
    tout, tgrads = _grads_torch(tl, *args)
    close(tout[0].detach(), jout[0], "ys")
    for a, b in zip(jax.tree_util.tree_leaves(
            tout[1], is_leaf=lambda t: isinstance(t, torch.Tensor)),
            jax.tree_util.tree_leaves(jout[1])):
        close(a.detach(), b, "carry")
    jp = _flat(jgrads[0])
    for name, p in tl.named_parameters():
        close(p.grad, jp[name], f"d/d {name}")
    for jg, tg in zip(jgrads[1:], tgrads):
        for a, b in zip(jax.tree_util.tree_leaves(jg),
                        jax.tree_util.tree_leaves(
                            tg, is_leaf=lambda t: isinstance(t,
                                                             torch.Tensor))):
            close(b, a, "d/d input")


def test_layer_norm_cells_refuse_bf16_as_jax_scan():
    """Under bf16 the LayerNorms' float32 results change the carry's type:
    JAX's scan raises TypeError, and the port's RNNLayer at construction."""
    for kind in ("ln_lstm", "sru"):
        tup = CELL_CASES[kind][1]
        with pytest.raises(TypeError, match="carry"):
            tcells.RNNLayer(NX, H, kind, dtype=torch.bfloat16)
        jl = jcells.RNNLayer(H, kind, dtype=jnp.bfloat16)
        jh = jnp.zeros((B, H))
        with pytest.raises(TypeError, match="carry"):
            jax.eval_shape(jl.init, jax.random.PRNGKey(0),
                           jnp.zeros((B, L, NX)), (jh, jh) if tup else jh)


@pytest.mark.parametrize("block,layernorm", [(False, True), (True, False),
                                             (True, True)])
def test_glu_matches_jax(block, layernorm):
    """The GLU as the gate alone and as the block, with and without its
    LayerNorm over the level and feature axes together."""
    (x,) = _rng_inputs(7, (B, L, H))
    jg = jcells.GLU(H, block=block, layernorm=layernorm)
    params = _init(jg, 8, jnp.asarray(x))
    jout, jgrads = _grads_jax(lambda p, a: jg.apply(p, a), params,
                              jnp.asarray(x))
    tg = _port(tcells.GLU(H, block=block, layernorm=layernorm, levels=L),
               params)
    tout, tgrads = _grads_torch(tg, jnp.asarray(x))
    close(tout.detach(), jout, "out")
    jp = _flat(jgrads[0])
    for name, p in tg.named_parameters():
        close(p.grad, jp[name], f"d/d {name}")
    close(tgrads[0], jgrads[1], "d/d x")


QRNN_CASES = [dict(), dict(reverse=True), dict(causal=False, kernel=3),
              dict(z_activation="tanh"), dict(assoc=True),
              dict(assoc=True, reverse=True)]


@pytest.mark.parametrize("kw", QRNN_CASES,
                         ids=["causal", "reverse", "centred_kernel3", "tanh",
                              "assoc", "assoc_reverse"])
def test_qrnn_matches_jax(kw):
    """QRNNLayer with a given and (causal case) a zero initial state:
    h, c_last and every gradient."""
    xs, c0 = _rng_inputs(9, (B, L, NX), (B, H))
    jq = jcells.QRNNLayer(H, **kw)
    args = (jnp.asarray(xs), jnp.asarray(c0))
    params = _init(jq, 10, *args)
    jout, jgrads = _grads_jax(lambda p, *a: jq.apply(p, *a), params, *args)
    tq = _port(tcells.QRNNLayer(NX, H, **kw), params)
    tout, tgrads = _grads_torch(tq, *args)
    close(tout[0].detach(), jout[0], "h")
    close(tout[1].detach(), jout[1], "c_last")
    jp = _flat(jgrads[0])
    for name, p in tq.named_parameters():
        close(p.grad, jp[name], f"d/d {name}")
    close(tgrads[0], jgrads[1], "d/d x")
    close(tgrads[1], jgrads[2], "d/d c0")
    if not kw:
        jz = jq.apply(params, jnp.asarray(xs))
        with torch.no_grad():
            tz = tq(torch.tensor(xs))
        close(tz[0], jz[0], "h, zero state")
