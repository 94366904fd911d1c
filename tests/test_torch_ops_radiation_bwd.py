"""The port's radiation-solver backwards (plain versions of kernels B13 and
B14, their wrappers ``adding_sw_bwd`` and ``lw_solver_noscat_bwd``, and the
autograd backwards of ``adding_sw_fast`` and ``lw_solver_noscat_fast``)
against the JAX package's hand-written backward kernels in interpret mode
and ``jax.vjp`` of its scan solvers, on the CPU, in float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops import pallas_radiation as JPR
from climsim_tpu.physics import radiation as JR
from climsim_tpu_torch.ops import (adding_sw_bwd, adding_sw_bwd_reference,
                                   adding_sw_fast, lw_solver_noscat_bwd,
                                   lw_solver_noscat_bwd_reference,
                                   lw_solver_noscat_fast)

NLEV = 60


def _sw_inputs(B, ng, seed=0):
    """Optical properties through the JAX package's two-stream
    coefficients (float32), surface albedos and TOA flux, as
    tests/test_torch_ops_radiation.py makes them."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.array(a, np.float32)
    mu0 = f(rng.uniform(0.2, 1.0, (B, 1, 1)))
    od = f(rng.uniform(0.01, 2.0, (B, NLEV, ng)))
    ssa = f(rng.uniform(0.3, 0.999, (B, NLEV, ng)))
    g = f(rng.uniform(0.0, 0.8, (B, NLEV, ng)))
    layers = JR.calc_ref_trans_sw(*(jnp.asarray(a) for a in (mu0, od, ssa,
                                                             g)))
    sfc = [f(rng.uniform(100, 1300, (B, ng))),
           f(rng.uniform(0.05, 0.8, (B, ng))),
           f(rng.uniform(0.05, 0.8, (B, ng)))]
    return sfc + [f(a) for a in layers]


def _lw_inputs(B, ng, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda a: np.array(a, np.float32)
    pt, pb = (f(np.abs(rng.normal(50, 10, (B, NLEV, ng)))) for _ in "tb")
    od = f(np.abs(rng.normal(0.3, 0.1, (B, NLEV, ng))))
    sup, sdn, trans = JR.reftrans_lw(*(jnp.asarray(a) for a in (pt, pb, od)))
    return [f(trans), f(sdn), f(sup),
            f(np.abs(rng.normal(400, 20, (B, ng)))),
            f(rng.uniform(0.9, 1.0, (B, ng)))]


SOLVERS = {
    "sw": (_sw_inputs, 3, adding_sw_bwd, adding_sw_bwd_reference,
           adding_sw_fast, JR.adding_sw, JPR.adding_sw_bwd_fused),
    "lw": (_lw_inputs, 2, lw_solver_noscat_bwd,
           lw_solver_noscat_bwd_reference, lw_solver_noscat_fast,
           JR.lw_solver_noscat, JPR.lw_solver_noscat_bwd_fused),
}


def _case(solver, B, ng, seed):
    """The solver's inputs and seeded cotangents [B, nlev+1, ng], numpy."""
    make, n_out = SOLVERS[solver][:2]
    args = make(B, ng, seed=seed)
    rng = np.random.default_rng(seed + 10)
    cts = [rng.standard_normal((B, NLEV + 1, ng)).astype(np.float32)
           for _ in range(n_out)]
    return args, cts


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def _close(got, want, rtol):
    """Each gradient to ``rtol`` of its largest magnitude."""
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, i
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= rtol, (i, err)


@pytest.mark.parametrize("solver", ["sw", "lw"])
@pytest.mark.parametrize("B,ng", [(40, 8), (6, 4)])
def test_plain_matches_jax_kernel_and_vjp(solver, B, ng):
    """The plain backward against the JAX package's backward kernel in
    interpret mode (the same arithmetic, level by level) and against
    jax.vjp of its scan solver (the same function differentiated by XLA):
    every gradient to 2e-6 of its scale (float32 rounding through 120
    dependent levels and the SW sweeps' divisions)."""
    args, cts = _case(solver, B, ng, seed=2)
    plain, ref, kern = (SOLVERS[solver][i] for i in (3, 5, 6))
    got = plain(_t(args), _t(cts))
    _close(got, kern(_j(args), _j(cts), block_b=16, interpret=True), 2e-6)
    _, vjp = jax.vjp(ref, *_j(args))
    _close(got, vjp(tuple(_j(cts))), 2e-6)


@pytest.mark.parametrize("solver", ["sw", "lw"])
def test_wrapper_takes_plain_path_on_cpu(solver):
    """A CPU tensor runs the plain version and launches nothing."""
    args, cts = _case(solver, 8, 8, seed=3)
    wrap, plain = SOLVERS[solver][2:4]
    before = wrap.launches
    got = wrap(_t(args), _t(cts))
    assert wrap.launches == before == 0
    for g, w in zip(got, plain(_t(args), _t(cts))):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("solver", ["sw", "lw"])
def test_autograd_backward_is_the_bwd_wrapper(solver):
    """The autograd backward of the forward wrapper is the backward
    wrapper on every device: on the CPU the gradients are the plain
    backward's, bit for bit, with None for an input that needs none."""
    args, cts = _case(solver, 10, 4, seed=4)
    plain, fast = SOLVERS[solver][3], SOLVERS[solver][4]
    x = [t.requires_grad_(i > 0) for i, t in enumerate(_t(args))]
    torch.autograd.backward(fast(*x), _t(cts))
    assert x[0].grad is None
    for i, (t, w) in enumerate(zip(x, plain(_t(args), _t(cts)))):
        if i > 0:
            torch.testing.assert_close(t.grad, w, rtol=0, atol=0)


@pytest.mark.parametrize("solver", ["sw", "lw"])
@pytest.mark.parametrize("bad", ["dtype", "shape", "cotangent"])
def test_wrapper_rejects_what_the_kernel_would(solver, bad):
    args, cts = (_t(a) for a in _case(solver, 4, 4, seed=5))
    if bad == "dtype":
        args[1] = args[1].double()
    elif bad == "shape":
        args[3] = args[3][:, :-1]
    else:
        cts[0] = cts[0][:, :-1]
    with pytest.raises(ValueError):
        SOLVERS[solver][2](args, cts)
