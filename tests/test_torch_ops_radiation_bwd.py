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
                                   lw_solver_noscat_fast, rad_design)
from test_torch_ops_radiation import _stage

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


def _lw_inputs(B, ng, seed=1, nlev=NLEV):
    rng = np.random.default_rng(seed)
    f = lambda a: np.array(a, np.float32)
    pt, pb = (f(np.abs(rng.normal(50, 10, (B, nlev, ng)))) for _ in "tb")
    od = f(np.abs(rng.normal(0.3, 0.1, (B, nlev, ng))))
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


# ------------------------------------------------ B14's staged design


# (B, nlev, ng) -> rad_design("b14", ...) on 132 SMs, the shapes of
# test_rad_design_b11: the staged ring where ng % 4 == 0 and one column
# fits, else the first design
@pytest.mark.parametrize("shape,want", [
    ((21600, 60, 8), dict(design="staged", C=4, threads=32, smem=55040,
                          blocks=528)),
    ((1003, 50, 8), dict(design="staged", C=4, threads=32, smem=47360,
                         blocks=251)),
    ((21600, 60, 16), dict(design="staged", C=4, threads=64, smem=109952,
                           blocks=264)),
    ((1000, 128, 8), dict(design="staged", C=4, threads=32, smem=115968,
                          blocks=132)),
    ((1000, 500, 8), dict(design="staged", C=2, threads=32, smem=224704,
                          blocks=132)),
    ((1000, 1000, 8), dict(design="staged", C=1, threads=32, smem=224416,
                           blocks=132)),
    ((1000, 60, 6), dict(design="first", C=None, threads=256, smem=0,
                         blocks=24)),
    ((10, 4000, 8), dict(design="first", C=None, threads=256, smem=0,
                         blocks=1))])
def test_rad_design_b14(shape, want):
    """B14's design from the shape alone: the staged ring (3 layer, 2
    half-level and 2 surface arrays a column; C 4, halved until the tile
    fits) or the first design."""
    assert rad_design("b14", *shape) == want


def _folded_lw_bwd(args, cts, C, K):
    """B14's two passes, tile by tile in torch on the ring's stage layout
    (csrc/lw_noscat_bwd.cu): pass 1 ascending carries (fdn, g), g the up
    backward's carry, which needs dfup and trans only, and writes dsup_j =
    g_j; it parks (fdn[j], g_j) at the top of every chunk of K levels (K 1:
    the staged design's replay of every level; K 4: B13's chunked schedule,
    measured slower on the card). Pass 2 descending, chunk by chunk, re-runs pass 1 over the
    chunk from its park, then walks (fup, h) down, writing dsdn_j = h_j
    and dtrans_j = g_j fup[j+1] + h_j fdn[j] once each."""
    trans, sdn, sup, ssfc, emis = args
    dfdn, dfup = cts
    B, nlev, ng = trans.shape
    grads = ([torch.empty((B, nlev, ng)) for _ in range(3)]
             + [torch.empty((B, ng)) for _ in range(2)])
    staged = [ssfc, emis, trans, sdn, sup, dfdn, dfup]
    kinds = ["sfc"] * 2 + ["lay"] * 3 + ["half"] * 2
    for tile in range(-(-B // C)):
        st, lay, cols = _stage("b14", staged, tile, C, nlev, ng, kinds)
        t = torch.arange(cols * ng)
        c, g = t // ng, t % ng
        at = lambda a, j: lay["lay0"] + (a * C + c) * lay["str_lay"] + g \
            + j * ng
        ath = lambda a, j: lay["half0"] + (a * C + c) * lay["str_half"] \
            + g + j * ng
        b = tile * C + c
        f, gu = torch.zeros(cols * ng), st[ath(1, 0)]
        park = {}
        for j in range(nlev):
            if j % K == 0:
                park[j // K] = (f, gu)
            grads[2][b, j, g] = gu
            tj = st[at(0, j)]
            gu = st[ath(1, j + 1)] + gu * tj
            f = tj * f + st[at(1, j)]
        e, s = st[C * ng + t], st[t]
        grads[4][b, g] = gu * (s - f)
        grads[3][b, g] = gu * e
        u = e * s + (1.0 - e) * f
        h = st[ath(0, nlev)] + gu * (1.0 - e)
        for ch in range(-(-nlev // K) - 1, -1, -1):
            f, gu = park[ch]
            F, G = {}, {}
            for j in range(ch * K, min(nlev, ch * K + K)):
                F[j], G[j] = f, gu
                tj = st[at(0, j)]
                gu = st[ath(1, j + 1)] + gu * tj
                f = tj * f + st[at(1, j)]
            for j in range(min(nlev, ch * K + K) - 1, ch * K - 1, -1):
                grads[0][b, j, g] = G[j] * u + h * F[j]
                grads[1][b, j, g] = h
                tj = st[at(0, j)]
                u = tj * u + st[at(2, j)]
                h = st[ath(0, j)] + h * tj
    for x in grads:
        assert not torch.isnan(x).any()
    return tuple(grads)


def _lw_case(B, nlev, ng, seed):
    args = _lw_inputs(B, ng, seed=seed, nlev=nlev)
    rng = np.random.default_rng(seed + 10)
    cts = [rng.standard_normal((B, nlev + 1, ng)).astype(np.float32)
           for _ in range(2)]
    return args, cts


# B 13 with C 4: a ragged last tile of one column; nlev 13 and 50 (ragged
# last chunk of 4 levels); ng 4 (the fewest g-points the ring takes) and 16
@pytest.mark.parametrize("B,nlev,ng,C", [(13, 13, 8, 4), (6, 50, 4, 4),
                                         (5, 60, 16, 2), (9, 60, 8, 8)])
@pytest.mark.parametrize("K", [1, 4])
def test_folded_lw_bwd_is_the_plain_backward(B, nlev, ng, C, K):
    """The folding of B14's four sweeps into two passes (the up backward's
    carry beside the replay of fdn, the replay of fup beside the down
    backward), on the ring's stage layout, with pass 1 parked at every
    level (the staged design) or every 4 levels and re-run (B13's chunked
    schedule), computes the plain backward and the JAX package's backward
    kernel in interpret mode: every gradient to 2e-6 of its scale."""
    args, cts = _lw_case(B, nlev, ng, seed=12)
    got = _folded_lw_bwd(_t(args), _t(cts), C, K)
    _close(got, [w.numpy() for w in
                 lw_solver_noscat_bwd_reference(_t(args), _t(cts))], 2e-6)
    _close(got, JPR.lw_solver_noscat_bwd_fused(_j(args), _j(cts), block_b=8,
                                               interpret=True), 2e-6)
