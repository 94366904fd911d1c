"""The port's radiation solvers (plain versions of kernels B11 and B12, and
their differentiable wrappers) against the JAX package's scan solvers and
its Pallas kernels in interpret mode, on the CPU, in float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops import pallas_radiation as JPR
from climsim_tpu.physics import radiation as JR
from climsim_tpu_torch.ops import adding_sw_fast, lw_solver_noscat_fast
from climsim_tpu_torch.physics import radiation as R

NLEV = 60


def _sw_inputs(B, ng, seed=0):
    """Optical properties through the JAX package's two-stream
    coefficients (float32), surface albedos and TOA flux."""
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


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def _close(got, want, rtol):
    """Each output to ``rtol`` of its largest magnitude."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= rtol, err


@pytest.mark.parametrize("B,ng", [(40, 8), (6, 4)])
def test_sw_plain_matches_jax_scan_and_pallas(B, ng):
    """adding_sw (conservative form) against the JAX scan solver and the
    Pallas kernel in interpret mode: the same arithmetic through 120
    divisions, so 2e-6 of each flux's scale."""
    a = _sw_inputs(B, ng)
    got = R.adding_sw(*_t(a))
    _close(got, JR.adding_sw(*_j(a)), 2e-6)
    _close(got, JPR.adding_sw_fused(*_j(a), block_b=16, interpret=True),
           2e-6)


@pytest.mark.parametrize("B,ng", [(40, 8), (6, 4)])
def test_lw_plain_matches_jax_scan_and_pallas(B, ng):
    a = _lw_inputs(B, ng)
    got = R.lw_solver_noscat(*_t(a))
    _close(got, JR.lw_solver_noscat(*_j(a)), 2e-6)
    _close(got, JPR.lw_solver_noscat_fused(*_j(a), block_b=16,
                                           interpret=True), 2e-6)


def test_wrappers_take_plain_path_on_cpu():
    """A CPU tensor runs the plain versions and launches nothing."""
    sw, lw = _t(_sw_inputs(8, 8)), _t(_lw_inputs(8, 8))
    b11, b12 = adding_sw_fast.launches, lw_solver_noscat_fast.launches
    for got, want in ((adding_sw_fast(*sw), R.adding_sw(*sw)),
                      (lw_solver_noscat_fast(*lw), R.lw_solver_noscat(*lw))):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
            assert g.shape[1] == NLEV + 1
    assert (adding_sw_fast.launches, lw_solver_noscat_fast.launches) \
        == (b11, b12) == (0, 0)


@pytest.mark.parametrize("solver", ["sw", "lw"])
def test_autograd_matches_jax_vjp(solver):
    """The wrappers' CPU backward (the plain versions of B13 and B14):
    every input's gradient agrees with jax.vjp of the scan solver (what the
    custom VJP does off the TPU) to 1e-5 of its scale."""
    if solver == "sw":
        a, fast, ref = _sw_inputs(10, 4, seed=2), adding_sw_fast, \
            JR.adding_sw
    else:
        a, fast, ref = _lw_inputs(10, 4, seed=3), lw_solver_noscat_fast, \
            JR.lw_solver_noscat
    x = [t.requires_grad_(True) for t in _t(a)]
    outs = fast(*x)
    rng = np.random.default_rng(7)
    cts = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    torch.autograd.backward(outs, [torch.as_tensor(c) for c in cts])
    _, vjp = jax.vjp(ref, *_j(a))
    want = vjp(tuple(jnp.asarray(c) for c in cts))
    _close([t.grad for t in x], want, 1e-5)


@pytest.mark.parametrize("solver", ["sw", "lw"])
@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_wrappers_reject_what_the_kernel_would(solver, bad):
    a = _t(_sw_inputs(4, 4) if solver == "sw" else _lw_inputs(4, 4))
    if bad == "dtype":
        a[1] = a[1].double()
    else:
        a[3] = a[3][:, :-1]
    fast = adding_sw_fast if solver == "sw" else lw_solver_noscat_fast
    with pytest.raises(ValueError):
        fast(*a)
