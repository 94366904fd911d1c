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


def _sw_inputs(B, ng, seed=0, nlev=NLEV):
    """Optical properties through the JAX package's two-stream
    coefficients (float32), surface albedos and TOA flux, as
    tests/test_torch_ops_radiation.py makes them."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.array(a, np.float32)
    mu0 = f(rng.uniform(0.2, 1.0, (B, 1, 1)))
    od = f(rng.uniform(0.01, 2.0, (B, nlev, ng)))
    ssa = f(rng.uniform(0.3, 0.999, (B, nlev, ng)))
    g = f(rng.uniform(0.0, 0.8, (B, nlev, ng)))
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


# ------------------------------------------------ B13's second design


def _two_pass(args, cts):
    """csrc/adding_sw_bwd.cu's two passes, level by level in torch: pass 1
    (descending) replays the up sweep and runs the down sweep backward one
    level behind it, parking alb[j+1], albdir[j+1] and the carries (gdiff,
    gdir) at each layer; pass 2 (ascending) replays the down sweep and
    runs the up sweep backward, adding the down sweep's terms, so each
    gradient is formed once. Returns the eight gradients."""
    toa, ad, adir, R, T, rd, tdd, tdir = args
    dfup, dfdiff, dfdir = cts
    nlev = R.shape[1]
    park = [None] * nlev
    alb, albdir = ad, adir
    gdir = dfdir[:, nlev] + dfup[:, nlev] * albdir
    gdiff = dfdiff[:, nlev] + dfup[:, nlev] * alb
    for j in range(nlev - 1, -1, -1):
        Rj, Tj, tdj, tddj = R[:, j], T[:, j], tdir[:, j], tdd[:, j]
        park[j] = (alb, albdir, gdiff, gdir)
        inv = 1.0 / (1.0 - alb * Rj)
        adir0 = rd[:, j] + (tdj * albdir + tddj * alb) * Tj * inv
        alb0 = Rj + Tj * Tj * alb * inv
        dN = gdiff / (1.0 - Rj * alb)
        K = tdj * albdir * Rj + tddj
        gdir, gdiff = (gdir * tdj + dN * K + dfdir[:, j] + dfup[:, j] * adir0,
                       dN * Tj + dfdiff[:, j] + dfup[:, j] * alb0)
        alb, albdir = alb0, adir0
    dtoa = gdir
    fdir, fdiff = toa, torch.zeros_like(toa)
    ga, gd = dfup[:, 0] * fdiff, dfup[:, 0] * fdir
    out = [[None] * nlev for _ in range(5)]       # dR, dT, drd, dtdd, dtdir
    for j in range(nlev):
        Rj, Tj, tdj, tddj = R[:, j], T[:, j], tdir[:, j], tdd[:, j]
        A1, Adir1, gdiff, gdir = park[j]
        denom = 1.0 - Rj * A1
        K = tdj * Adir1 * Rj + tddj
        fdiff1 = (Tj * fdiff + fdir * K) / denom
        fdir1 = fdir * tdj
        dN = gdiff / denom
        galb1 = dfup[:, j + 1] * fdiff1 + gdiff * fdiff1 * Rj / denom
        galbdir1 = dfup[:, j + 1] * fdir1 + dN * fdir * tdj * Rj
        inv = 1.0 / (1.0 - A1 * Rj)
        M = tdj * Adir1 + tddj * A1
        TAinv = Tj * A1 * inv
        out[0][j] = (dN * fdir * tdj * Adir1 + gdiff * fdiff1 * A1 / denom
                     + ga * (1.0 + TAinv * TAinv)
                     + gd * M * Tj * A1 * inv * inv)
        out[1][j] = dN * fdiff + (ga * 2.0 * Tj * A1 * inv + gd * M * inv)
        out[2][j] = gd
        out[3][j] = dN * fdir + gd * A1 * Tj * inv
        out[4][j] = (gdir * fdir + dN * fdir * Adir1 * Rj
                     + gd * Adir1 * Tj * inv)
        Tinv = Tj * inv
        ga, gd = (ga * Tj * Tinv * inv
                  + gd * (tddj * Tinv + M * Tinv * Rj * inv) + galb1,
                  gd * tdj * Tinv + galbdir1)
        fdiff, fdir = fdiff1, fdir1
    lay = lambda xs: torch.stack(xs, dim=1)
    return (dtoa, ga, gd) + tuple(lay(o) for o in out)


def _sw_case(B, nlev, ng, seed):
    """SW inputs of nlev layers (the JAX package's two-stream
    coefficients) and seeded cotangents, numpy."""
    args = _sw_inputs(B, ng, seed=seed, nlev=nlev)
    rng = np.random.default_rng(seed + 10)
    cts = [rng.standard_normal((B, nlev + 1, ng)).astype(np.float32)
           for _ in range(3)]
    return args, cts


# B 13 columns x 8 g-points: 104 items, not a multiple of the kernel's
# 32-item block; nlev 13 and 50 are not multiples of its 4-level chunk
@pytest.mark.parametrize("B,nlev,ng", [(13, 13, 8), (40, 60, 8),
                                       (7, 50, 3)])
def test_two_pass_order_is_the_plain_backward(B, nlev, ng):
    """The kernel's reordering (the down sweep backward inside the up
    sweep's replay, the down sweep's replay inside the up sweep backward,
    each gradient formed once) computes the plain backward: every
    gradient to 2e-6 of its scale (float32 rounding of the rearranged
    sums)."""
    args, cts = _sw_case(B, nlev, ng, seed=6)
    _close(_two_pass(_t(args), _t(cts)),
           [g.numpy() for g in adding_sw_bwd_reference(_t(args), _t(cts))],
           2e-6)


@pytest.mark.parametrize("B,nlev,ng", [(13, 13, 8), (7, 50, 3)])
def test_plain_matches_jax_kernel_at_the_kernels_edges(B, nlev, ng):
    """At the shapes B13's design treats specially (a ragged last block of
    items, nlev not a multiple of the level chunk, ng other than 8) the
    plain backward agrees with the JAX package's backward kernel in
    interpret mode, every gradient to 2e-6 of its scale."""
    args, cts = _sw_case(B, nlev, ng, seed=7)
    got = adding_sw_bwd_reference(_t(args), _t(cts))
    _close(got, JPR.adding_sw_bwd_fused(_j(args), _j(cts), block_b=8,
                                        interpret=True), 2e-6)


@pytest.mark.parametrize("B,nlev,ng,blocks,smem", [
    (21600, 60, 8, 5400, 7680), (13, 13, 8, 4, 2048), (7, 50, 3, 1, 6656),
    (1, 1816, 8, 1, 232448)])
def test_sw_bwd_geometry(B, nlev, ng, blocks, smem):
    """B13's launch: one warp of 32 items a block (the last one ragged),
    4 parked floats an item for every chunk of 4 levels in shared memory
    (7.5 KB at the physics model's nlev 60; nlev 13 and 50 end in a
    ragged chunk), up to nlev 1,816."""
    from climsim_tpu_torch.ops import sw_bwd_geometry
    assert sw_bwd_geometry(B, nlev, ng) == (blocks, 32, smem)


def test_sw_bwd_refuses_what_its_shared_memory_cannot_park():
    from climsim_tpu_torch.ops import sw_bwd_geometry
    with pytest.raises(ValueError, match="shared memory"):
        sw_bwd_geometry(1, 1817, 8)
