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
from climsim_tpu_torch.ops import (adding_sw_fast, lw_solver_noscat_fast,
                                   rad_design)
from climsim_tpu_torch.ops.pallas_radiation import (rad_tile_layout,
                                                    rad_tile_smem)
from climsim_tpu_torch.physics import radiation as R

NLEV = 60


def _sw_inputs(B, ng, seed=0, nlev=NLEV):
    """Optical properties through the JAX package's two-stream
    coefficients (float32), surface albedos and TOA flux."""
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


# ------------------------------------------------ B11's staged design


# (B, nlev, ng) -> rad_design("b11", ...) on 132 SMs: the physics path's
# shape, a ragged batch at 50 levels, PhysRad's ng 16 (two warps of items),
# nlev 128 (one CTA a SM), nlev 500 and 1000 (the tile halved to 2 and 1
# columns), ng 6 (not a multiple of 4: the first design) and a column
# whose stage fits no block (the first design)
@pytest.mark.parametrize("shape,want", [
    ((21600, 60, 8), dict(design="staged", C=4, threads=32, smem=55168,
                          blocks=528)),
    ((1003, 50, 8), dict(design="staged", C=4, threads=32, smem=47488,
                         blocks=251)),
    ((21600, 60, 16), dict(design="staged", C=4, threads=64, smem=110208,
                           blocks=264)),
    ((1000, 128, 8), dict(design="staged", C=4, threads=32, smem=116096,
                          blocks=132)),
    ((1000, 500, 8), dict(design="staged", C=2, threads=32, smem=224768,
                          blocks=132)),
    ((1000, 1000, 8), dict(design="staged", C=1, threads=32, smem=224448,
                           blocks=132)),
    ((1000, 60, 6), dict(design="first", C=None, threads=256, smem=0,
                         blocks=24)),
    ((10, 4000, 8), dict(design="first", C=None, threads=256, smem=0,
                         blocks=1))])
def test_rad_design_b11(shape, want):
    """B11's design from the shape alone: the staged tile (C 4 columns,
    halved until the tile fits; 128 bytes of barrier, the stage and the
    replay of (nlev+1) pairs an item; as many CTAs a SM as its 233,472
    bytes hold, at most one a tile) where ng % 4 == 0 and one column fits
    232,448 bytes, else the first design (256 items a block)."""
    assert rad_design("b11", *shape) == want


def test_rad_design_b11_refuses_what_the_ring_cannot_take():
    """Unaligned tensors, or ng not a multiple of 4, run the first design;
    the shared memory is the stage's floats and the replay's pairs beside
    128 bytes of barrier; an unknown kernel raises."""
    assert rad_design("b11", 21600, 60, 8, aligned=False)["design"] == \
        "first"
    assert rad_design("b11", 21600, 60, 12)["design"] == "staged"
    assert rad_design("b11", 21600, 60, 10)["design"] == "first"
    stage = rad_tile_layout("b11", 60, 8, 4)["stage"]
    assert rad_tile_smem("b11", 60, 8, 4) == 128 + 4 * stage + 8 * 61 * 32
    with pytest.raises(ValueError):
        rad_design("b12", 21600, 60, 8)


def _stage(kind, arrays, tile, C, nlev, ng, kinds):
    """A stage of the ring as csrc/rad_tile.cuh's copy_tile() fills it: a flat
    float32 buffer, NaN where no copy lands, each column of a layer or
    half-level array copied to its padded stride (rad_tile_layout), each
    surface array's tile span copied whole. ``kinds`` gives "sfc", "lay"
    or "half" for each array, surface arrays first."""
    lay = rad_tile_layout(kind, nlev, ng, C)
    st = torch.full((lay["stage"],), float("nan"))
    B = arrays[0].shape[0]
    cols = range(tile * C, min(B, tile * C + C))
    n = {"sfc": 0, "lay": 0, "half": 0}
    for a, k in zip(arrays, kinds):
        i = n[k]
        n[k] += 1
        if k == "sfc":
            src = a[tile * C:tile * C + len(cols)].reshape(-1)
            st[i * C * ng:i * C * ng + src.numel()] = src
            continue
        base, stride = ((lay["lay0"], lay["str_lay"]) if k == "lay"
                        else (lay["half0"], lay["str_half"]))
        for c, b in enumerate(cols):
            o = base + (i * C + c) * stride
            st[o:o + a[b].numel()] = a[b].reshape(-1)
    return st, lay, len(cols)


def _staged_sw(args, C):
    """csrc/adding_sw.cu's staged kernel, tile by tile in torch: each tile
    staged as the ring lays it out, every item t = c ng + g reading level j
    of a layer array at lay0 + (a C + c) str_lay + g + j ng; the up sweep
    writes K_j over tdd_j and 1 / (1 - alb R_j) over R_j, parks the albedo
    pairs, and the down sweep multiplies by that reciprocal where the plain
    version divides."""
    B, nlev, ng = args[3].shape
    outs = [torch.empty((B, nlev + 1, ng)) for _ in range(3)]
    kinds = ["sfc"] * 3 + ["lay"] * 5
    for tile in range(-(-B // C)):
        st, lay, cols = _stage("b11", args, tile, C, nlev, ng, kinds)
        t = torch.arange(cols * ng)
        c, g = t // ng, t % ng
        at = lambda a, j: lay["lay0"] + (a * C + c) * lay["str_lay"] + g \
            + j * ng
        sfc = lambda a: st[a * C * ng + t]
        alb, albdir = sfc(1), sfc(2)
        rep = [None] * (nlev + 1)
        rep[nlev] = (alb, albdir)
        for j in range(nlev - 1, -1, -1):
            Rj, Tj, tddj, tdj = (st[at(a, j)] for a in (0, 1, 3, 4))
            inv = 1.0 / (1.0 - alb * Rj)
            st[at(3, j)] = tdj * albdir * Rj + tddj
            st[at(0, j)] = inv
            albdir = st[at(2, j)] + (tdj * albdir + tddj * alb) * Tj * inv
            alb = Rj + Tj * Tj * alb * inv
            rep[j] = (alb, albdir)
        fdir, fdiff = sfc(0), torch.zeros(cols * ng)
        b = tile * C + c
        outs[0][b, 0, g] = fdir * albdir
        outs[1][b, 0, g] = fdiff
        outs[2][b, 0, g] = fdir
        for j in range(nlev):
            a1, ad1 = rep[j + 1]
            num = st[at(1, j)] * fdiff + fdir * st[at(3, j)]
            fdiff = num * st[at(0, j)]
            fdir = fdir * st[at(4, j)]
            outs[0][b, j + 1, g] = fdir * ad1 + fdiff * a1
            outs[1][b, j + 1, g] = fdiff
            outs[2][b, j + 1, g] = fdir
        assert not torch.isnan(outs[0][b]).any()
    return outs


# B 13 with C 4: a ragged last tile of one column; nlev 13 and 50; ng 4
# (the fewest g-points the ring takes) and 16 (PhysRad's default)
@pytest.mark.parametrize("B,nlev,ng,C", [(13, 13, 8, 4), (6, 50, 4, 4),
                                         (5, 60, 16, 2), (9, 60, 8, 8)])
def test_staged_sw_order_is_the_plain_forward(B, nlev, ng, C):
    """The staged kernel's layout and order (stage per column at padded
    strides, K and the reciprocal left in the stage by the up sweep, the
    down sweep's division as a product with that reciprocal) compute the
    plain forward and the JAX package's Pallas kernel in interpret mode:
    every flux to 2e-6 of its scale (the rearranged roundings through 120
    levels)."""
    a = _sw_inputs(B, ng, seed=11, nlev=nlev)
    got = _staged_sw(_t(a), C)
    _close(got, [w.numpy() for w in R.adding_sw(*_t(a))], 2e-6)
    _close(got, JPR.adding_sw_fused(*_j(a), block_b=8, interpret=True),
           2e-6)
