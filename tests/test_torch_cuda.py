"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA device and nvcc and skip without them. This file
imports neither JAX nor the JAX package, so on a machine with a card and
no JAX it runs on its own, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

``chip_smoke.py`` runs the same comparisons at the main path's full shapes.
"""
import numpy as np
import pytest
import torch

from climsim_tpu_torch.online.advection import spherical_metric
from climsim_tpu_torch.ops import (bigru_heads_cm_bwd,
                                   bigru_heads_cm_bwd_reference,
                                   bigru_heads_init_cm_reference,
                                   fused_bigru_heads_init_cm,
                                   fv_advect_tracers_sphere,
                                   fv_tracers_sphere_reference)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _b1_inputs(L, H, B, dtype, device, seed=3, nm_in=8):
    nf, nm, ny = 6, 8, 6
    rng = np.random.default_rng(seed)
    shapes = [(L, nf, B), (L, nm_in, B), (H, B), (H, B),
              (H, nf), (H, 1), (3 * H, H), (3 * H, nm_in), (3 * H, 1),
              (3 * H, H), (3 * H, 1), (3 * H, H), (3 * H, 1),
              (3 * H, H), (3 * H, 1), (nm, H), (nm, 1), (ny, nm), (ny, 1)]
    return [torch.as_tensor(0.25 * rng.standard_normal(s), dtype=dtype,
                            device=device) for s in shapes]


# (H, nm_in): the tensor-core tiling's widths, and widths it pads (H 20
# to 32, nm_in 5 to 16)
WIDTHS = [(16, 8), (20, 5)]
# B = 1, below one 64-column tile, ragged against it, and two tiles
EDGES = [1, 40, 150, 144]


@pytest.mark.cuda
@pytest.mark.parametrize("H,nm_in", WIDTHS)
@pytest.mark.parametrize("B", [16] + EDGES)
def test_b1_kernel_matches_plain_f32(cuda, B, H, nm_in):
    """f32, ragged B: summation order only (tolerance as the CPU parity
    tests of the plain version against JAX)."""
    a = _b1_inputs(20, H, B, torch.float32, cuda, nm_in=nm_in)
    before = fused_bigru_heads_init_cm.launches
    with torch.no_grad():
        om, lh = fused_bigru_heads_init_cm(*a)
        ref_om, ref_lh = bigru_heads_init_cm_reference(*a)
    assert fused_bigru_heads_init_cm.launches == before + 1
    torch.testing.assert_close(om, ref_om, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(lh, ref_lh, rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("H,nm_in", WIDTHS)
@pytest.mark.parametrize("B", EDGES)
def test_b1_kernel_matches_plain_bf16(cuda, B, H, nm_in):
    """bf16 (the tensor-core design, at the edges of its tiling): both
    round at the same points; a one-ulp flip of an output of order 1 is
    7.8e-3, so atol 2e-2 allows two."""
    a = _b1_inputs(20, H, B, torch.bfloat16, cuda, nm_in=nm_in)
    with torch.no_grad():
        om, lh = fused_bigru_heads_init_cm(*a)
        ref_om, ref_lh = bigru_heads_init_cm_reference(*a)
    torch.testing.assert_close(om.float(), ref_om.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lh.float(), ref_lh.float(), rtol=0, atol=2e-2)


def _b3_inputs(L, H, B, dtype, device, seed=4, nm_in=8, CH=None):
    """Residuals of the backward (x a tanh stream [L, CH, B], CH = H by
    default) and the cotangents of (outmem, lasth)."""
    nm, ny = 8, 6
    CH = H if CH is None else CH
    rng = np.random.default_rng(seed)
    shapes = [(L, CH, B), (L, nm_in, B), (H, B), (H, B), (3 * H, CH),
              (3 * H, nm_in), (3 * H, 1), (3 * H, H), (3 * H, 1),
              (3 * H, H), (3 * H, 1), (3 * H, H), (3 * H, 1), (nm, H),
              (nm, 1), (ny, nm), (ny, 1), (L, nm + ny, B), (H, B)]
    t = [torch.as_tensor(0.25 * rng.standard_normal(s), dtype=torch.float32)
         for s in shapes]
    t[0] = torch.tanh(4 * t[0])
    t = [a.to(device, dtype) for a in t]
    return t[:17], t[17], t[18]


def _rel_err(got, want):
    """Largest |got - want| over one output, relative to its magnitude."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


# (H, nm_in, CH): B3's widths, and widths the tensor-core tiling pads
B3_WIDTHS = [(16, 8, 16), (20, 5, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,nm_in,CH", B3_WIDTHS)
@pytest.mark.parametrize("B", [16] + EDGES)
def test_b3_kernel_matches_plain_f32(cuda, B, H, nm_in, CH):
    """f32, ragged B (150 is not a multiple of the 32-column tile): every
    one of the 17 outputs to 1e-4 of its largest magnitude (summation
    order over 2 x 20 recurrent levels and the L x B gradient sums)."""
    res, dom, dlh = _b3_inputs(20, H, B, torch.float32, cuda, nm_in=nm_in,
                               CH=CH)
    before = bigru_heads_cm_bwd.launches
    got = bigru_heads_cm_bwd(res, dom, dlh)
    want = bigru_heads_cm_bwd_reference(res, dom, dlh)
    assert bigru_heads_cm_bwd.launches == before + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        assert _rel_err(g, w) <= 1e-4, (i, _rel_err(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("H,nm_in,CH", B3_WIDTHS)
@pytest.mark.parametrize("B", EDGES)
def test_b3_kernel_matches_plain_bf16(cuda, B, H, nm_in, CH):
    """bf16 (the tensor-core design, at the edges of its tiling): kernel
    and plain version store h, the gates and the outputs in bf16 at the
    same points; each output may differ from the plain version by 4x the
    plain version's own bf16-vs-f32 error."""
    res, dom, dlh = _b3_inputs(20, H, B, torch.bfloat16, cuda, nm_in=nm_in,
                               CH=CH)
    got = bigru_heads_cm_bwd(res, dom, dlh)
    want = bigru_heads_cm_bwd_reference(res, dom, dlh)
    want32 = bigru_heads_cm_bwd_reference([a.float() for a in res],
                                          dom.float(), dlh.float())
    for i, (g, w, w32) in enumerate(zip(got, want, want32)):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        own = (w.float() - w32).abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 4 * own + 1e-3 * w32.abs().max().item(), (i, err, own)


@pytest.mark.cuda
@pytest.mark.parametrize("H,nm_in,CH", B3_WIDTHS)
def test_b3_bf16_is_deterministic(cuda, H, nm_in, CH):
    """Two bf16 B3 calls on the same inputs are bit-identical: no gradient
    sum uses atomics (fixed split-K partials and fixed tile order)."""
    res, dom, dlh = _b3_inputs(20, H, 150, torch.bfloat16, cuda,
                               nm_in=nm_in, CH=CH)
    first = bigru_heads_cm_bwd(res, dom, dlh)
    second = bigru_heads_cm_bwd(res, dom, dlh)
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), i


@pytest.mark.cuda
def test_cudacore_designs_match_tensor_core_bf16(cuda):
    """The CUDA-core bf16 designs that chip_smoke.py times against the
    tensor-core ones agree with them to the bf16 tolerance: 4x the plain
    version's own bf16-vs-f32 error (plus 1e-3 of the scale, as B3's
    check)."""
    from climsim_tpu_torch.ops.pallas_rnn import (
        cudacore_bigru_heads_cm_bwd, cudacore_bigru_heads_init_cm)
    a = _b1_inputs(20, 16, 150, torch.bfloat16, cuda)
    res, dom, dlh = _b3_inputs(20, 16, 150, torch.bfloat16, cuda)
    b1, b3 = fused_bigru_heads_init_cm.launches, bigru_heads_cm_bwd.launches
    with torch.no_grad():
        pairs = [(cudacore_bigru_heads_init_cm(*a),
                  fused_bigru_heads_init_cm(*a),
                  bigru_heads_init_cm_reference(*a),
                  bigru_heads_init_cm_reference(*(t.float() for t in a)))]
    pairs.append((cudacore_bigru_heads_cm_bwd(res, dom, dlh),
                  bigru_heads_cm_bwd(res, dom, dlh),
                  bigru_heads_cm_bwd_reference(res, dom, dlh),
                  bigru_heads_cm_bwd_reference(
                      [t.float() for t in res], dom.float(), dlh.float())))
    # only the wrappers count: the CUDA-core twins launch uncounted
    assert (fused_bigru_heads_init_cm.launches,
            bigru_heads_cm_bwd.launches) == (b1 + 1, b3 + 1)
    for old, new, w, w32 in pairs:
        for i, (o, n, p, p32) in enumerate(zip(old, new, w, w32)):
            own = (p.float() - p32.float()).abs().max().item()
            err = (o.float() - n.float()).abs().max().item()
            assert err <= 4 * own + 1e-3 * p32.float().abs().max().item(), \
                (i, err, own)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_on_card_matches_cpu(cuda, dtype):
    """Gradients of all 19 inputs through the differentiable
    fused_bigru_heads_init_cm: B1 forward and B3 backward on the card
    against the plain versions on the CPU. f32 to 1e-4 of each gradient's
    scale; bf16 to 4x the CPU's own bf16-vs-f32 difference."""
    a = _b1_inputs(20, 16, 150, torch.float32, "cpu")

    def grads(dev, dt):
        x = [t.to(dev, dt, copy=True).requires_grad_(True) for t in a]
        om, lh = fused_bigru_heads_init_cm(*x)
        ((om.float() ** 2).sum() + (lh.float() ** 2).sum()).backward()
        return [t.grad.float().cpu() for t in x]

    b1, b3 = fused_bigru_heads_init_cm.launches, bigru_heads_cm_bwd.launches
    card = grads(cuda, dtype)
    assert fused_bigru_heads_init_cm.launches == b1 + 1
    assert bigru_heads_cm_bwd.launches == b3 + 1
    cpu = grads("cpu", dtype)
    cpu32 = grads("cpu", torch.float32)
    for i, (g, w, w32) in enumerate(zip(card, cpu, cpu32)):
        if dtype == torch.float32:
            assert _rel_err(g, w) <= 1e-4, (i, _rel_err(g, w))
        else:
            own = (w - w32).abs().max().item()
            err = (g - w).abs().max().item()
            assert err <= 4 * own + 1e-3 * w32.abs().max().item(), \
                (i, err, own)


@pytest.mark.cuda
def test_trainer_update_on_card(cuda):
    """One RolloutTrainer update (W 2, remat) of a small flagship-shaped
    model on the card: B1 launches twice per step (forward and the
    recompute), B3 once; the loss and the gradients agree with the same
    update on the CPU (f32: 1e-4 of each gradient's scale)."""
    from climsim_tpu_torch.models import F32, RNNAutoreg
    from climsim_tpu_torch.train import (RolloutConfig, RolloutTrainer,
                                         channel_major_apply)
    L, B, W = 12, 40, 2
    rng = np.random.default_rng(5)
    r = lambda *s: rng.normal(0, 0.3, s).astype(np.float32)
    chunk = {"x_lev": r(W, B, L, 6), "x_sfc": r(W, B, 24),
             "y_lev": r(W, B, L, 6), "y_sfc": r(W, B, 8),
             "sp": np.full((W, B), 1e5, np.float32)}
    hy = np.linspace(0.0, 1.0, L + 1).astype(np.float32)
    results = {}
    for dev in (cuda, torch.device("cpu")):
        model = RNNAutoreg(nx=6, nx_sfc=24, ny=6, ny_sfc=8, nneur=(16, 16),
                           nh_mem=4, add_pres=False, policy=F32,
                           use_pallas=True, fuse_heads=True, fuse_init=True,
                           level_major=True, device=dev, seed=1)
        cfg = RolloutConfig(rollout_schedule={0: W}, loss="mse", lr=1e-4,
                            remat=True)
        tr = RolloutTrainer(model, cfg, hy, hy,
                            apply_fn=channel_major_apply, device=dev)
        fused_bigru_heads_init_cm.launches = 0
        bigru_heads_cm_bwd.launches = 0
        mem, rec = tr.run_epoch(None, [chunk], epoch=0)
        launches = (fused_bigru_heads_init_cm.launches,
                    bigru_heads_cm_bwd.launches)
        assert launches == ((2 * W, W) if dev.type == "cuda" else (0, 0))
        assert rec["updates"] == 1 and np.isfinite(rec["loss"])
        results[dev.type] = (rec["loss"], {n: p.grad.cpu() for n, p in
                                           model.named_parameters()})
    (lc, gc), (lp, gp) = results["cuda"], results["cpu"]
    assert lc == pytest.approx(lp, rel=1e-5)
    for n in gp:
        assert _rel_err(gc[n], gp[n]) <= 1e-4, n


@pytest.mark.cuda
def test_b2_kernel_matches_plain(cuda):
    """nvcc contracts a*b+c into FMAs, so the kernel and the plain version
    differ by a few ulps on fields of order 1; winds clip some Courant
    numbers."""
    rng = np.random.default_rng(5)
    nlat, nlon = 16, 24
    m = spherical_metric(np.linspace(-85.0, 85.0, nlat), nlon, 1200.0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    qs = t(rng.normal(1, 0.3, (3, 4, nlat, nlon)))
    u = t(rng.normal(0, 150, (4, nlat, nlon)))
    v = t(rng.normal(0, 700, (4, nlat, nlon)))
    before = fv_advect_tracers_sphere.launches
    with torch.no_grad():
        got = fv_advect_tracers_sphere(qs, u, v, m)
        ref = fv_tracers_sphere_reference(qs, u, v, m)
    assert fv_advect_tracers_sphere.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_b2_backward_matches_plain(cuda):
    """The kernel's autograd backward differentiates the plain version."""
    rng = np.random.default_rng(6)
    nlat, nlon = 16, 24
    m = spherical_metric(np.linspace(-85.0, 85.0, nlat), nlon, 1200.0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    qs, u, v = (t(rng.normal(1, 0.3, (2, 3, nlat, nlon))),
                t(rng.normal(0, 20, (3, nlat, nlon))),
                t(rng.normal(0, 20, (3, nlat, nlon))))
    q1 = qs.clone().requires_grad_(True)
    q2 = qs.clone().requires_grad_(True)
    fv_advect_tracers_sphere(q1, u, v, m).square().sum().backward()
    fv_tracers_sphere_reference(q2, u, v, m).square().sum().backward()
    torch.testing.assert_close(q1.grad, q2.grad, rtol=1e-4, atol=1e-5)


def _b7_inputs(L, H, B, dtype, device, seed=7):
    rng = np.random.default_rng(seed)
    shapes = [(L, B, 3 * H), (B, H), (B, H), (H, 3 * H), (3 * H,),
              (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,)]
    return [torch.as_tensor(0.3 * rng.standard_normal(s), dtype=dtype,
                            device=device) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 150])
def test_b7_kernel_matches_plain_f32(cuda, B):
    """f32, ragged B (150 is not a multiple of the 32-column tile):
    summation order only through 2 x 24 recurrent levels."""
    from climsim_tpu_torch.ops import bigru_reference_lbh, fused_bigru_lbh
    a = _b7_inputs(24, 32, B, torch.float32, cuda)
    before = fused_bigru_lbh.launches
    with torch.no_grad():
        got = fused_bigru_lbh(*a)
        want = bigru_reference_lbh(*a)
    assert fused_bigru_lbh.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_b7_kernel_matches_plain_bf16(cuda):
    """bf16: 4x the plain version's own bf16-vs-f32 error, as for B1."""
    from climsim_tpu_torch.ops import bigru_reference_lbh, fused_bigru_lbh
    a = _b7_inputs(24, 32, 150, torch.bfloat16, cuda)
    with torch.no_grad():
        got = fused_bigru_lbh(*a)
        want = bigru_reference_lbh(*a)
        want32 = bigru_reference_lbh(*(t.float() for t in a))
    for g, w, w32 in zip(got, want, want32):
        assert g.dtype == torch.bfloat16
        own = (w.float() - w32).abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= 4 * own


def _b8_inputs(L, H, B, dtype, device, seed=7):
    """The residuals of the v2 backward (as _b7_inputs) and the cotangents
    of (down, last_h)."""
    a = _b7_inputs(L, H, B, torch.float32, device, seed)
    rng = np.random.default_rng(seed + 1)
    ct = [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                          device=device) for s in ((L, B, H), (B, H))]
    return [t.to(dtype) for t in a], ct[0].to(dtype), ct[1].to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 150])
def test_b8_kernel_matches_plain_f32(cuda, B):
    """f32, ragged B (150 is not a multiple of the 32-column tile): each
    of the nine outputs to 2e-5 of its scale (summation order over 2 x 24
    levels of BPTT and the L x B gradient sums)."""
    from climsim_tpu_torch.ops import bigru_bwd_lbh, bigru_bwd_reference_lbh
    res, dd, dl = _b8_inputs(24, 32, B, torch.float32, cuda)
    before = bigru_bwd_lbh.launches
    got = bigru_bwd_lbh(res, dd, dl)
    want = bigru_bwd_reference_lbh(res, dd, dl)
    assert bigru_bwd_lbh.launches == before + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        assert _rel_err(g, w) <= 2e-5, (i, _rel_err(g, w))


@pytest.mark.cuda
def test_b8_kernel_matches_plain_bf16(cuda):
    """bf16: each output may differ from the plain version by 4x the plain
    version's own bf16-vs-f32 error, plus 1e-3 of its scale."""
    from climsim_tpu_torch.ops import bigru_bwd_lbh, bigru_bwd_reference_lbh
    res, dd, dl = _b8_inputs(24, 32, 150, torch.bfloat16, cuda)
    got = bigru_bwd_lbh(res, dd, dl)
    want = bigru_bwd_reference_lbh(res, dd, dl)
    want32 = bigru_bwd_reference_lbh([a.float() for a in res], dd.float(),
                                     dl.float())
    for i, (g, w, w32) in enumerate(zip(got, want, want32)):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        own = (w.float() - w32).abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 4 * own + 1e-3 * w32.abs().max().item(), (i, err, own)


@pytest.mark.cuda
def test_b7_autograd_launches_b8(cuda):
    """The v2 layer's gradients on the card: B7 forward and B8 backward,
    one launch each, against autograd of the same inputs on the CPU (f32,
    1e-4 of each gradient's scale)."""
    from climsim_tpu_torch.ops import bigru_bwd_lbh, fused_bigru_lbh
    a = _b7_inputs(12, 32, 40, torch.float32, "cpu")

    def grads(dev):
        x = [t.to(dev, copy=True).requires_grad_(True) for t in a]
        down, lasth = fused_bigru_lbh(*x)
        ((down ** 2).sum() + (lasth ** 2).sum()).backward()
        return [t.grad.cpu() for t in x]

    b7, b8 = fused_bigru_lbh.launches, bigru_bwd_lbh.launches
    card = grads(cuda)
    assert (fused_bigru_lbh.launches, bigru_bwd_lbh.launches) == (b7 + 1,
                                                                   b8 + 1)
    for i, (g, w) in enumerate(zip(card, grads("cpu"))):
        assert _rel_err(g, w) <= 1e-4, (i, _rel_err(g, w))


def _radiation_inputs(device, B=150, nlev=60, ng=8, seed=8):
    from climsim_tpu_torch.physics import radiation as R
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    lay = (B, nlev, ng)
    sw = (t(rng.uniform(0, 1300, (B, ng))), t(rng.uniform(0.05, 0.8, (B, ng))),
          t(rng.uniform(0.05, 0.8, (B, ng)))) + R.calc_ref_trans_sw(
        t(rng.uniform(0.05, 1, (B, 1, 1))), t(np.exp(rng.uniform(-6, 4, lay))),
        t(rng.uniform(0.3, 0.999, lay)), t(rng.uniform(0, 0.85, lay)))
    lw = R.reftrans_lw(t(rng.uniform(1, 60, lay)), t(rng.uniform(1, 60, lay)),
                       t(np.exp(rng.uniform(-6, 3, lay))))
    lw = (lw[2], lw[1], lw[0], t(rng.uniform(10, 60, (B, ng))),
          t(rng.uniform(0.9, 1.0, (B, ng))))
    return sw, lw


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["sw", "lw"])
def test_radiation_kernels_match_plain(cuda, solver):
    """B11 and B12 against their plain versions: each flux to 1e-5 of its
    scale (FMA contraction through 60-level recurrences)."""
    from climsim_tpu_torch.ops import adding_sw_fast, lw_solver_noscat_fast
    from climsim_tpu_torch.physics.radiation import (adding_sw,
                                                     lw_solver_noscat)
    sw, lw = _radiation_inputs(cuda)
    kern, ref, args = ((adding_sw_fast, adding_sw, sw) if solver == "sw"
                       else (lw_solver_noscat_fast, lw_solver_noscat, lw))
    before = kern.launches
    with torch.no_grad():
        got, want = kern(*args), ref(*args)
    assert kern.launches == before + 1
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 1e-5


@pytest.mark.cuda
def test_phys_model_on_card_matches_cpu(cuda):
    """A small PhysicalRNNAutoreg (yaml options, nneur 32) on the card
    (B7, B11, B12) against the same seeded model on the CPU: 1e-4 of each
    output's scale, with every McICA index the same on both."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.models import PhysicalRNNAutoreg
    g = Grid.synthetic(4, 60)
    tt = lambda a: tuple(a.tolist())
    kw = dict(nx=15, nx_sfc=24, nneur=(32, 32), nh_mem=8, use_physrad=True,
              use_mcica=True, use_qv_variability=True, use_pallas=True,
              hyai=tt(g.hyai), hybi=tt(g.hybi), hyam=tt(g.hyam),
              hybm=tt(g.hybm), sp_mean=9.8e4, yscale_t=1e5, yscale_qv=1e8,
              yscale_qn=1e8, yscale_precc=1e7)
    rng = np.random.default_rng(9)
    B = 40
    xd = np.zeros((B, 60, 6), np.float32)
    xd[..., 0] = rng.uniform(200, 300, (B, 60))
    xd[..., 5] = np.abs(rng.normal(1e-3, 3e-4, (B, 60)))
    xd[..., 2] = np.abs(rng.normal(0, 1e-5, (B, 60)))
    args = [rng.normal(0, 1, (B, 60, 15)), rng.normal(0, 1, (B, 24)),
            np.abs(rng.normal(0, 0.1, (B, 50, 9))), xd]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        m = PhysicalRNNAutoreg(**kw, device=dev)
        with torch.no_grad():
            outs[dev.type] = [t.cpu() for t in m(*[torch.as_tensor(
                np.asarray(a, np.float32), device=dev) for a in args])[:3]]
    for c, p in zip(outs["cuda"], outs["cpu"]):
        assert _rel_err(c, p) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["sw", "lw"])
def test_radiation_bwd_kernels_match_plain(cuda, solver):
    """B13 and B14 against their plain versions: each gradient to 1e-5 of
    its scale (FMA contraction through the replay and both backward
    sweeps); one launch each."""
    from climsim_tpu_torch.ops import (adding_sw_bwd, adding_sw_bwd_reference,
                                       lw_solver_noscat_bwd,
                                       lw_solver_noscat_bwd_reference)
    sw, lw = _radiation_inputs(cuda)
    kern, ref, args = ((adding_sw_bwd, adding_sw_bwd_reference, sw)
                       if solver == "sw" else
                       (lw_solver_noscat_bwd, lw_solver_noscat_bwd_reference,
                        lw))
    g = torch.Generator(device=cuda).manual_seed(3)
    B, nlev, ng = args[3].shape if solver == "sw" else args[0].shape
    cts = [torch.randn((B, nlev + 1, ng), generator=g, device=cuda)
           for _ in range(3 if solver == "sw" else 2)]
    before = kern.launches
    got, want = kern(args, cts), ref(args, cts)
    assert kern.launches == before + 1
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all(), i
        assert _rel_err(a, b) <= 1e-5, (i, _rel_err(a, b))


@pytest.mark.cuda
def test_phys_update_on_card_matches_cpu(cuda):
    """One W 2 training update of a small PhysicalRNNAutoreg (yaml
    options, nneur 32) with the yaml's loss on the card (B7, B8, B11-B14,
    each launched W times) against the same update on the CPU: the loss to
    1e-5, and every gradient to 1e-4 of its scale (f32 order of summation).
    The precipitation scale 1e12 keeps the stored pools under their cap,
    so that every gradient is a real one (tests/test_torch_phys_train.py)."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.models import PhysicalRNNAutoreg
    from climsim_tpu_torch.ops import (adding_sw_bwd, adding_sw_fast,
                                       bigru_bwd_lbh, fused_bigru_lbh,
                                       lw_solver_noscat_bwd,
                                       lw_solver_noscat_fast)
    from climsim_tpu_torch.train import (RolloutConfig, RolloutTrainer,
                                         phys_apply, phys_mem_shape)
    g = Grid.synthetic(4, 60)
    tt = lambda a: tuple(a.tolist())
    kw = dict(nx=15, nx_sfc=24, nneur=(32, 32), nh_mem=8, use_physrad=True,
              use_mcica=True, use_qv_variability=True, use_pallas=True,
              hyai=tt(g.hyai), hybi=tt(g.hybi), hyam=tt(g.hyam),
              hybm=tt(g.hybm), sp_mean=9.8e4, yscale_t=1e5, yscale_qv=1e8,
              yscale_qn=1e8, yscale_precc=1e12)
    W, B = 2, 40
    rng = np.random.default_rng(10)
    xd = np.zeros((W, B, 60, 6), np.float32)
    xd[..., 0] = rng.uniform(200, 300, (W, B, 60))
    xd[..., 5] = np.abs(rng.normal(1e-3, 3e-4, (W, B, 60)))
    xd[..., 2] = np.abs(rng.normal(0, 1e-5, (W, B, 60)))
    n = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    chunk = {"x_lev": n(W, B, 60, 15), "x_sfc": n(W, B, 24),
             "y_lev": 0.3 * n(W, B, 60, 5), "y_sfc": 0.3 * n(W, B, 8),
             "sp": np.full((W, B), 1e5, np.float32), "x_lev_raw": xd}
    cfg = RolloutConfig(rollout_schedule={0: W}, loss="huber", lr=5e-4,
                        w_energy=5e-6, w_water=3e7, pass_x_raw=True,
                        pass_y_true=True)
    wrappers = (fused_bigru_lbh, bigru_bwd_lbh, adding_sw_fast,
                lw_solver_noscat_fast, adding_sw_bwd, lw_solver_noscat_bwd)

    def update(dev):
        m = PhysicalRNNAutoreg(**kw, device=dev)
        tr = RolloutTrainer(m, cfg, g.hyai.numpy(), g.hybi.numpy(),
                            yscale_lev=np.array([1e5, 1e8, 1e8, 1e5, 1e5],
                                                np.float32)[None, None],
                            yscale_sca=np.array([1e-2, 1e-2, 1e12, 1e12,
                                                 1e-2, 1e-2, 1e-2, 1e-2],
                                                np.float32),
                            apply_fn=phys_apply, mem_shape=phys_mem_shape(m),
                            device=dev)
        before = [w.launches for w in wrappers]
        _, rec = tr.run_epoch(None, [chunk], 0)
        launches = [w.launches - b for w, b in zip(wrappers, before)]
        return rec["loss"], launches, {k: p.grad.cpu()
                                       for k, p in m.named_parameters()}

    lc, nc, gc = update(cuda)
    lp, np_, gp = update("cpu")
    assert nc == [W] * 6 and np_ == [0] * 6
    assert np.isfinite(lc) and lc == pytest.approx(lp, rel=1e-5)
    for k in gp:
        assert _rel_err(gc[k], gp[k]) <= 1e-4, (k, _rel_err(gc[k], gp[k]))


def _b4_inputs(L, H, B, dtype, device, nm_in=8, seed=11):
    """B4's arguments: a tanh stream x [L, H, B] (the initial MLP's
    output) and the v5 weights."""
    res, _, _ = _b3_inputs(L, H, B, torch.float32, "cpu", seed)
    res = list(res)
    if nm_in != res[1].shape[1]:
        g = torch.Generator().manual_seed(seed)
        res[1] = 0.25 * torch.randn((L, nm_in, B), generator=g)
        res[5] = 0.25 * torch.randn((3 * H, nm_in), generator=g)
    return [t.to(device, dtype) for t in res]


@pytest.mark.cuda
@pytest.mark.parametrize("hoist", [False, True])
@pytest.mark.parametrize("B", [16, 150])
def test_b4_kernel_matches_plain_f32(cuda, B, hoist):
    """f32, ragged B: summation order only (tolerance as B1's)."""
    from climsim_tpu_torch.ops import (bigru_heads_cm_reference,
                                       fused_bigru_heads_cm)
    a = _b4_inputs(20, 16, B, torch.float32, cuda)
    before = fused_bigru_heads_cm.launches
    with torch.no_grad():
        got = fused_bigru_heads_cm(*a, hoist_proj=hoist)
        want = bigru_heads_cm_reference(*a, hoist_proj=hoist)
    assert fused_bigru_heads_cm.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("hoist", [False, True])
def test_b4_kernel_matches_plain_bf16(cuda, hoist):
    """bf16: 4x the plain version's own bf16-vs-f32 error, as for B1; the
    zero-width memory of the layer without memory runs too."""
    from climsim_tpu_torch.ops import (bigru_heads_cm_reference,
                                       fused_bigru_heads_cm)
    for nm_in in (8, 0):
        a = _b4_inputs(20, 16, 150, torch.bfloat16, cuda, nm_in)
        with torch.no_grad():
            got = fused_bigru_heads_cm(*a, hoist_proj=hoist)
            want = bigru_heads_cm_reference(*a, hoist_proj=hoist)
            want32 = bigru_heads_cm_reference(*(t.float() for t in a),
                                              hoist_proj=hoist)
        for g, w, w32 in zip(got, want, want32):
            assert g.dtype == torch.bfloat16
            own = (w.float() - w32).abs().max().item()
            assert (g.float() - w.float()).abs().max().item() <= 4 * own


@pytest.mark.cuda
def test_b4_autograd_launches_b3(cuda):
    """Gradients of all 17 inputs through fused_bigru_heads_cm on the card
    (B4 forward, B3 backward, one launch each) against the CPU (f32, 1e-4
    of each gradient's scale)."""
    from climsim_tpu_torch.ops import bigru_heads_cm_bwd, fused_bigru_heads_cm
    a = _b4_inputs(20, 16, 150, torch.float32, "cpu")

    def grads(dev):
        x = [t.to(dev, copy=True).requires_grad_(True) for t in a]
        om, lh = fused_bigru_heads_cm(*x)
        ((om ** 2).sum() + (lh ** 2).sum()).backward()
        return [t.grad.cpu() for t in x]

    b4, b3 = fused_bigru_heads_cm.launches, bigru_heads_cm_bwd.launches
    card = grads(cuda)
    assert (fused_bigru_heads_cm.launches, bigru_heads_cm_bwd.launches) \
        == (b4 + 1, b3 + 1)
    for i, (g, w) in enumerate(zip(card, grads("cpu"))):
        assert _rel_err(g, w) <= 1e-4, (i, _rel_err(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["tracers", "levels"])
def test_b5_b6_kernels_match_plain(cuda, op):
    """The flat stencil (B5 all tracers, B6 one field) against its plain
    version: FMA contraction only, a few ulps on fields of order 1; the
    backward differentiates the plain version."""
    from climsim_tpu_torch.ops import (fv_advect_levels, fv_advect_tracers,
                                       fv_tracers_reference)
    rng = np.random.default_rng(12)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    qs = t(rng.normal(1, 0.3, (3, 4, 16, 24)))
    u, v = t(rng.normal(0, 1, (4, 16, 24))), t(rng.normal(0, 1, (4, 16, 24)))
    kern = fv_advect_tracers if op == "tracers" else fv_advect_levels
    q = qs if op == "tracers" else qs[0].contiguous()
    before = kern.launches
    with torch.no_grad():
        got = kern(q, u, v, 0.4, 0.3)
    assert kern.launches == before + 1
    torch.testing.assert_close(got, fv_tracers_reference(q, u, v, 0.4, 0.3),
                               rtol=1e-5, atol=1e-5)
    q1, q2 = (q.clone().requires_grad_(True) for _ in range(2))
    kern(q1, u, v, 0.4, 0.3).square().sum().backward()
    fv_tracers_reference(q2, u, v, 0.4, 0.3).square().sum().backward()
    torch.testing.assert_close(q1.grad, q2.grad, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_b7_kernel_at_h192_bf16(cuda):
    """B7 at the flagship's width (H 192, 96 KB of shared memory per
    block), as the batch-major v2 arm runs it: bf16 to 4x the plain
    version's own bf16-vs-f32 error, f32 to summation order. The weights
    have the lecun-normal scale 1/sqrt(H) of the model's (at 0.3, H 192
    makes the recurrence chaotic, and summation order alone then moves
    the states by 6e-4)."""
    from climsim_tpu_torch.ops import bigru_reference_lbh, fused_bigru_lbh
    for dtype in (torch.float32, torch.bfloat16):
        a = _b7_inputs(24, 192, 150, torch.float32, cuda)
        for i in (3, 5, 7):
            a[i] = a[i] / (0.3 * np.sqrt(192))
        a = [t.to(dtype) for t in a]
        with torch.no_grad():
            got = fused_bigru_lbh(*a)
            want = bigru_reference_lbh(*a)
            want32 = bigru_reference_lbh(*(t.float() for t in a))
        for g, w, w32 in zip(got, want, want32):
            if dtype == torch.float32:
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
            else:
                own = (w.float() - w32).abs().max().item()
                assert (g.float() - w.float()).abs().max().item() <= 4 * own


def _b9_b10_inputs(init, L, H, B, dtype, device, seed=13):
    """B9's (or, with ``init``, B10's) arguments, batch-major: x [L, B, nx]
    (B10: feat [L, B, nf] and mem_in [L, B, nm_in]), h0s [B, H], weights
    [in, out] of scale 0.25 and flat biases."""
    nx, nf, nmi, nm, ny = 24, 6, 8, 8, 6
    w = [(H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,),
         (H, nm), (nm,), (nm, ny), (ny,)]
    if init:
        shapes = [(L, B, nf), (L, B, nmi), (B, H), (B, H), (nf, H), (H,),
                  (H + nmi, 3 * H), (3 * H,)] + w
    else:
        shapes = [(L, B, nx), (B, H), (B, H), (nx, 3 * H), (3 * H,)] + w
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(0.25 * rng.standard_normal(s), dtype=dtype,
                            device=device) for s in shapes]


def _b9_b10(init):
    from climsim_tpu_torch.ops import (bigru_heads_init_lbh_reference,
                                       bigru_heads_lbh_reference,
                                       fused_bigru_heads_init_lbh,
                                       fused_bigru_heads_lbh)
    if init:
        return fused_bigru_heads_init_lbh, bigru_heads_init_lbh_reference
    return fused_bigru_heads_lbh, bigru_heads_lbh_reference


@pytest.mark.cuda
@pytest.mark.parametrize("init", [False, True], ids=["b9", "b10"])
@pytest.mark.parametrize("B", [16, 150])
def test_b9_b10_kernels_match_plain_f32(cuda, B, init):
    """f32, ragged B (150 is not a multiple of the 32-column tile):
    summation order only (tolerance as B1's and B4's)."""
    kern, ref = _b9_b10(init)
    a = _b9_b10_inputs(init, 20, 16, B, torch.float32, cuda)
    before = kern.launches
    with torch.no_grad():
        got, want = kern(*a), ref(*a)
    assert kern.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("init", [False, True], ids=["b9", "b10"])
def test_b9_b10_kernels_match_plain_bf16(cuda, init):
    """bf16, ragged B: 4x the plain version's own bf16-vs-f32 error, as for
    B1 and B4; and at the arms' width H 192 (two blocks of ~101 KB of
    shared memory per SM) in f32 with lecun-scale recurrent weights."""
    kern, ref = _b9_b10(init)
    a = _b9_b10_inputs(init, 20, 16, 150, torch.bfloat16, cuda)
    with torch.no_grad():
        got, want = kern(*a), ref(*a)
        want32 = ref(*(t.float() for t in a))
    for g, w, w32 in zip(got, want, want32):
        assert g.dtype == torch.bfloat16
        own = (w.float() - w32).abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= 4 * own
    a = _b9_b10_inputs(init, 12, 192, 70, torch.float32, cuda)
    first_w = 6 if init else 3
    for i in range(first_w, first_w + 8, 2):
        a[i] = a[i] / (0.25 * np.sqrt(a[i].shape[0]))
    with torch.no_grad():
        for g, w in zip(kern(*a), ref(*a)):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("init", [False, True], ids=["b9", "b10"])
def test_b9_b10_autograd_launches_b7_b8(cuda, init):
    """Gradients of every input through the v3/v4 Function on the card: the
    forward launches B9/B10 once, the backward replays the composition with
    B7 and differentiates it with B8, once each; against the CPU (f32, 1e-4
    of each gradient's scale)."""
    from climsim_tpu_torch.ops import bigru_bwd_lbh, fused_bigru_lbh
    kern, _ = _b9_b10(init)
    a = _b9_b10_inputs(init, 20, 16, 150, torch.float32, "cpu")

    def grads(dev):
        x = [t.to(dev, copy=True).requires_grad_(True) for t in a]
        sum((o ** 2).sum() for o in kern(*x)).backward()
        return [t.grad.cpu() for t in x]

    counts = lambda: (kern.launches, fused_bigru_lbh.launches,
                      bigru_bwd_lbh.launches)
    before = counts()
    card = grads(cuda)
    assert counts() == tuple(n + 1 for n in before)
    for i, (g, w) in enumerate(zip(card, grads("cpu"))):
        assert _rel_err(g, w) <= 1e-4, (i, _rel_err(g, w))


@pytest.mark.cuda
def test_phys_scan_trunk_on_card_matches_cpu(cuda):
    """The physics model with the yaml's scan trunk (use_pallas=False,
    unequal widths) on the card: no B7 launch, B11 and B12 once each, the
    outputs to 1e-4 of their scale against the CPU."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.models import PhysicalRNNAutoreg
    from climsim_tpu_torch.ops import (adding_sw_fast, fused_bigru_lbh,
                                       lw_solver_noscat_fast)
    g = Grid.synthetic(4, 60)
    tt = lambda a: tuple(a.tolist())
    kw = dict(nx=15, nx_sfc=24, nneur=(32, 24), nh_mem=8, use_physrad=True,
              use_mcica=True, use_qv_variability=True, use_pallas=False,
              hyai=tt(g.hyai), hybi=tt(g.hybi), hyam=tt(g.hyam),
              hybm=tt(g.hybm), sp_mean=9.8e4, yscale_t=1e5, yscale_qv=1e8,
              yscale_qn=1e8, yscale_precc=1e7)
    rng = np.random.default_rng(9)
    B = 40
    xd = np.zeros((B, 60, 6), np.float32)
    xd[..., 0] = rng.uniform(200, 300, (B, 60))
    xd[..., 5] = np.abs(rng.normal(1e-3, 3e-4, (B, 60)))
    xd[..., 2] = np.abs(rng.normal(0, 1e-5, (B, 60)))
    args = [rng.normal(0, 1, (B, 60, 15)), rng.normal(0, 1, (B, 24)),
            np.abs(rng.normal(0, 0.1, (B, 50, 9))), xd]
    outs = {}
    wrappers = (fused_bigru_lbh, adding_sw_fast, lw_solver_noscat_fast)
    for dev in (cuda, torch.device("cpu")):
        m = PhysicalRNNAutoreg(**kw, device=dev)
        before = [w.launches for w in wrappers]
        with torch.no_grad():
            outs[dev.type] = [t.cpu() for t in m(*[torch.as_tensor(
                np.asarray(a, np.float32), device=dev) for a in args])[:3]]
        launched = [w.launches - b for w, b in zip(wrappers, before)]
        assert launched == ([0, 1, 1] if dev.type == "cuda" else [0, 0, 0])
    for c, p in zip(outs["cuda"], outs["cpu"]):
        assert _rel_err(c, p) <= 1e-4


# ---------------------------------------- B8 and B10 on tensor cores, and
# B1 and B3 past the width their weights stay resident at


def _bf16_holds(got, want, want32):
    """Each bf16 output within 4x the plain version's own bf16-vs-f32 error
    of the plain bf16 result, plus 1e-3 of its scale (as B3's check)."""
    for i, (g, w, w32) in enumerate(zip(got, want, want32)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, i
        assert torch.isfinite(g.float()).all(), i
        own = (w.float() - w32.float()).abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 4 * own + 1e-3 * w32.float().abs().max().item(), \
            (i, err, own)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [32, 20])
@pytest.mark.parametrize("B", EDGES)
def test_b8_tensor_core_bf16_at_the_edges(cuda, B, H):
    """B8 in bf16 (the tensor-core design) at the edges of its tiling (B 1,
    below one 64-column tile, ragged against it, two tiles; H 20 padded to
    32), per output against the plain version under the 4x gate."""
    from climsim_tpu_torch.ops import bigru_bwd_lbh, bigru_bwd_reference_lbh
    res, dd, dl = _b8_inputs(20, H, B, torch.bfloat16, cuda)
    before = bigru_bwd_lbh.launches
    got = bigru_bwd_lbh(res, dd, dl)
    assert bigru_bwd_lbh.launches == before + 1
    _bf16_holds(got, bigru_bwd_reference_lbh(res, dd, dl),
                bigru_bwd_reference_lbh([a.float() for a in res],
                                        dd.float(), dl.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [16, 20])
@pytest.mark.parametrize("B", EDGES)
def test_b10_tensor_core_bf16_at_the_edges(cuda, B, H):
    """B10 in bf16 (the tensor-core design) at the edges of its tiling (H
    16 and 20 padded to 32, memory 8 to 16), per output against the plain
    version under the 4x gate."""
    kern, ref = _b9_b10(True)
    a = _b9_b10_inputs(True, 20, H, B, torch.bfloat16, cuda)
    before = kern.launches
    with torch.no_grad():
        got = kern(*a)
        assert kern.launches == before + 1
        _bf16_holds(got, ref(*a), ref(*(t.float() for t in a)))
    assert all(g.is_contiguous() for g in got)


@pytest.mark.cuda
def test_b8_bf16_is_deterministic(cuda):
    """Two bf16 B8 calls on the same inputs are bit-identical: its weight
    and bias gradients are fixed-order sums, no atomics."""
    from climsim_tpu_torch.ops import bigru_bwd_lbh
    res, dd, dl = _b8_inputs(20, 20, 150, torch.bfloat16, cuda)
    first = bigru_bwd_lbh(res, dd, dl)
    second = bigru_bwd_lbh(res, dd, dl)
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), i


@pytest.mark.cuda
def test_cudacore_b8_b10_match_tensor_core_bf16(cuda):
    """The CUDA-core bf16 designs of B8 and B10 that chip_smoke.py times
    against the tensor-core ones agree with them under the same gate, and
    only the wrappers count launches."""
    from climsim_tpu_torch.ops import (bigru_bwd_lbh, bigru_bwd_reference_lbh,
                                       fused_bigru_heads_init_lbh)
    from climsim_tpu_torch.ops.pallas_rnn import (
        cudacore_bigru_bwd_lbh, cudacore_bigru_heads_init_lbh)
    _, ref10 = _b9_b10(True)
    res, dd, dl = _b8_inputs(20, 32, 150, torch.bfloat16, cuda)
    a = _b9_b10_inputs(True, 20, 32, 150, torch.bfloat16, cuda)
    counts = (bigru_bwd_lbh.launches, fused_bigru_heads_init_lbh.launches)
    with torch.no_grad():
        pairs = [(cudacore_bigru_heads_init_lbh(*a),
                  fused_bigru_heads_init_lbh(*a), ref10(*a),
                  ref10(*(t.float() for t in a)))]
    pairs.append((cudacore_bigru_bwd_lbh(res, dd, dl),
                  bigru_bwd_lbh(res, dd, dl),
                  bigru_bwd_reference_lbh(res, dd, dl),
                  bigru_bwd_reference_lbh([t.float() for t in res],
                                          dd.float(), dl.float())))
    assert (bigru_bwd_lbh.launches, fused_bigru_heads_init_lbh.launches) \
        == (counts[0] + 1, counts[1] + 1)
    for old, new, w, w32 in pairs:
        for i, (o, n, p, p32) in enumerate(zip(old, new, w, w32)):
            own = (p.float() - p32.float()).abs().max().item()
            err = (o.float() - n.float()).abs().max().item()
            assert err <= 4 * own + 1e-3 * p32.float().abs().max().item(), \
                (i, err, own)


def _lecun(t):
    """A [out, in] weight of _b1_inputs' scale 0.25 rescaled to
    1/sqrt(fan-in), so that the wide layers' gates do not saturate."""
    return t / (0.25 * np.sqrt(t.shape[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [384, 512])
def test_b1_b3_bf16_at_streamed_widths(cuda, H):
    """B1 and B3 in bf16 at H 384 and 512 (L 60, 1,000 columns), where the
    tensor-core design streams its weight slices through shared memory
    (the plan says so), against their plain versions under the 4x gate."""
    from climsim_tpu_torch.ops.pallas_rnn import mma_plan
    for kind in ("b1", "b3"):
        assert mma_plan(kind, H, H, 8, 8, 6, 6)["stream"]
    a = _b1_inputs(60, H, 1000, torch.float32, cuda)
    for i in (4, 6, 7, 9, 11, 13, 15):
        a[i] = _lecun(a[i])
    a16 = [t.bfloat16() for t in a]
    with torch.no_grad():
        _bf16_holds(fused_bigru_heads_init_cm(*a16),
                    bigru_heads_init_cm_reference(*a16),
                    bigru_heads_init_cm_reference(*(t.float() for t in a16)))
    res = [torch.tanh(a16[1].new_tensor(np.random.default_rng(2).standard_normal(
        (60, H, 1000)))), *a16[1:4], *a16[6:]]
    dom = a16[0].new_tensor(np.random.default_rng(3).standard_normal(
        (60, 14, 1000)))
    dlh = a16[0].new_tensor(np.random.default_rng(4).standard_normal(
        (H, 1000)))
    _bf16_holds(bigru_heads_cm_bwd(res, dom, dlh),
                bigru_heads_cm_bwd_reference(res, dom, dlh),
                bigru_heads_cm_bwd_reference([t.float() for t in res],
                                             dom.float(), dlh.float()))


@pytest.mark.cuda
def test_v4_trainer_update_on_card(cuda):
    """One RolloutTrainer update (W 2, remat) of a small v4 model on the
    card: B10 twice per step (forward and recompute), B7 and B8 once; f32
    (the CUDA-core designs) against the CPU to 1e-4 of each gradient's
    scale, bf16 (the tensor-core B8 and B10) with each gradient, the loss
    and the memory within 4x the CPU's own bf16-vs-f32 difference plus
    1e-3 of the scale."""
    from climsim_tpu_torch.models import BF16, F32, RNNAutoreg
    from climsim_tpu_torch.ops import (bigru_bwd_lbh, fused_bigru_heads_init_lbh,
                                       fused_bigru_lbh)
    from climsim_tpu_torch.train import RolloutConfig, RolloutTrainer
    L, B, W = 12, 40, 2
    rng = np.random.default_rng(6)
    r = lambda *s: rng.normal(0, 0.3, s).astype(np.float32)
    chunk = {"x_lev": r(W, B, L, 6), "x_sfc": r(W, B, 24),
             "y_lev": r(W, B, L, 6), "y_sfc": r(W, B, 8),
             "sp": np.full((W, B), 1e5, np.float32)}
    hy = np.linspace(0.0, 1.0, L + 1).astype(np.float32)
    wrappers = (fused_bigru_heads_init_lbh, fused_bigru_lbh, bigru_bwd_lbh)
    out = {}
    for name, policy in (("f32", F32), ("bf16", BF16)):
        for dev in (cuda, torch.device("cpu")):
            model = RNNAutoreg(nx=6, nx_sfc=24, ny=6, ny_sfc=8,
                               nneur=(32, 32), nh_mem=8, add_pres=False,
                               policy=policy, use_pallas=True,
                               fuse_heads=True, fuse_init=True, device=dev,
                               seed=1)
            assert model.arm == "v4"
            cfg = RolloutConfig(rollout_schedule={0: W}, loss="mse",
                                lr=1e-4, remat=True)
            tr = RolloutTrainer(model, cfg, hy, hy, device=dev)
            before = [w.launches for w in wrappers]
            mem, rec = tr.run_epoch(None, [chunk], epoch=0)
            launched = [w.launches - b for w, b in zip(wrappers, before)]
            assert launched == ([2 * W, W, W] if dev.type == "cuda"
                                else [0, 0, 0])
            assert rec["updates"] == 1 and np.isfinite(rec["loss"])
            out[name, dev.type] = [torch.tensor([rec["loss"]]),
                                   mem.float().cpu()] + [
                p.grad.float().cpu() for _, p in model.named_parameters()]
    for c, p in zip(out["f32", "cuda"], out["f32", "cpu"]):
        assert _rel_err(c, p) <= 1e-4
    for c, p, p32 in zip(out["bf16", "cuda"], out["bf16", "cpu"],
                         out["f32", "cpu"]):
        own = (p - p32).abs().max().item()
        err = (c - p).abs().max().item()
        assert err <= 4 * own + 1e-3 * p32.abs().max().item(), (err, own)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,H", [
    ("b8", 384), ("b8", 512), ("b10", 384), ("b10", 512),
    ("b1", 256), ("b1", 320), ("b3", 256), ("b3", 320),
    ("b8", 320), ("b10", 320),
    ("b1", 832), ("b3", 832), ("b8", 832), ("b10", 832), ("b8", 960),
    ("b7", 224), ("b7", 256), ("b7", 320), ("b7", 384), ("b7", 512),
    ("b7", 832), ("b9", 224), ("b9", 256), ("b9", 320), ("b9", 384),
    ("b9", 512), ("b9", 832)])
def test_bf16_tensor_core_at_the_plans_other_tilings(cuda, kind, H):
    """The plans the flagship's widths do not reach, on the card: B7-B10
    with streamed weights (H 384, 512), every kind on the resident tilings
    of clusters of 4 over 32-column tiles (B7, B9: H 224) and of clusters
    of 8 (H 256: 32-column tiles, H 320: 16) and on the streamed 16-column
    tiles at the widest H the plan promises (``MMA_H_MAX`` 832; B8 960),
    L 60, 1,000 columns, each output against the plain version under the
    4x gate."""
    from climsim_tpu_torch.ops import (bigru_bwd_lbh, bigru_bwd_reference_lbh)
    from climsim_tpu_torch.ops.pallas_rnn import mma_plan
    p = mma_plan(kind, H, H, 8, 8, 6, 6)
    assert p["stream"] == (H > 320) and (p["C"], p["BT"]) != (4, 64)
    g = torch.Generator(device=cuda).manual_seed(H)
    r = lambda *s: torch.randn(s, generator=g, device=cuda)
    if kind in ("b1", "b3"):
        a = _b1_inputs(60, H, 1000, torch.float32, cuda)
        for i in (4, 6, 7, 9, 11, 13, 15):
            a[i] = _lecun(a[i])
        a16 = [t.bfloat16() for t in a]
        if kind == "b1":
            with torch.no_grad():
                _bf16_holds(fused_bigru_heads_init_cm(*a16),
                            bigru_heads_init_cm_reference(*a16),
                            bigru_heads_init_cm_reference(
                                *(t.float() for t in a16)))
            return
        res = [torch.tanh(r(60, H, 1000)).bfloat16(), *a16[1:4], *a16[6:]]
        dom, dlh = r(60, 14, 1000).bfloat16(), r(H, 1000).bfloat16()
        _bf16_holds(bigru_heads_cm_bwd(res, dom, dlh),
                    bigru_heads_cm_bwd_reference(res, dom, dlh),
                    bigru_heads_cm_bwd_reference([t.float() for t in res],
                                                 dom.float(), dlh.float()))
        return
    if kind == "b7":
        from climsim_tpu_torch.ops import bigru_reference_lbh, fused_bigru_lbh
        a = _b7_inputs(60, H, 1000, torch.float32, cuda)
        for i in (3, 5, 7):
            a[i] = a[i] / (0.3 * np.sqrt(H))
        a16 = [t.bfloat16() for t in a]
        with torch.no_grad():
            _bf16_holds(fused_bigru_lbh(*a16), bigru_reference_lbh(*a16),
                        bigru_reference_lbh(*(t.float() for t in a16)))
        return
    if kind == "b8":
        res, dd, dl = _b8_inputs(60, H, 1000, torch.float32, cuda)
        for i in (3, 5, 7):
            res[i] = res[i] / (0.3 * np.sqrt(H))
        r16 = [t.bfloat16() for t in res]
        d16 = (dd.bfloat16(), dl.bfloat16())
        _bf16_holds(bigru_bwd_lbh(r16, *d16),
                    bigru_bwd_reference_lbh(r16, *d16),
                    bigru_bwd_reference_lbh([t.float() for t in r16],
                                            *(t.float() for t in d16)))
        return
    init = kind == "b10"
    kern, ref = _b9_b10(init)
    a = _b9_b10_inputs(init, 60, H, 1000, torch.float32, cuda)
    for i in ((4, 6, 8, 10, 12, 14) if init else (3, 5, 7, 9, 11, 13)):
        a[i] = a[i] / (0.25 * np.sqrt(a[i].shape[0]))
    a16 = [t.bfloat16() for t in a]
    with torch.no_grad():
        _bf16_holds(kern(*a16), ref(*a16), ref(*(t.float() for t in a16)))


# ------------------------------------------------ B7 and B9 on tensor cores


@pytest.mark.cuda
@pytest.mark.parametrize("H", [32, 20])
@pytest.mark.parametrize("B", EDGES)
def test_b7_tensor_core_bf16_at_the_edges(cuda, B, H):
    """B7 in bf16 (the tensor-core design) at the edges of its tiling (B 1,
    below one 64-column tile, ragged against it, two tiles; H 20 padded to
    32), down and last_h against the plain version under the 4x gate,
    with one launch counted."""
    from climsim_tpu_torch.ops import bigru_reference_lbh, fused_bigru_lbh
    a = _b7_inputs(20, H, B, torch.bfloat16, cuda)
    before = fused_bigru_lbh.launches
    with torch.no_grad():
        got = fused_bigru_lbh(*a)
        assert fused_bigru_lbh.launches == before + 1
        _bf16_holds(got, bigru_reference_lbh(*a),
                    bigru_reference_lbh(*(t.float() for t in a)))
    assert all(g.is_contiguous() for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [16, 20])
@pytest.mark.parametrize("B", EDGES)
def test_b9_tensor_core_bf16_at_the_edges(cuda, B, H):
    """B9 in bf16 (the tensor-core design) at the edges of its tiling (H
    16 and 20 padded to 32, x's width 24 to 32), per output against the
    plain version under the 4x gate."""
    kern, ref = _b9_b10(False)
    a = _b9_b10_inputs(False, 20, H, B, torch.bfloat16, cuda)
    before = kern.launches
    with torch.no_grad():
        got = kern(*a)
        assert kern.launches == before + 1
        _bf16_holds(got, ref(*a), ref(*(t.float() for t in a)))
    assert all(g.is_contiguous() for g in got)


@pytest.mark.cuda
def test_b7_b9_bf16_are_deterministic(cuda):
    """Two bf16 calls of B7 and of B9 on the same inputs are bit-identical
    (fixed-order sums, no atomics)."""
    from climsim_tpu_torch.ops import fused_bigru_lbh
    kern9, _ = _b9_b10(False)
    a7 = _b7_inputs(20, 32, 150, torch.bfloat16, cuda)
    a9 = _b9_b10_inputs(False, 20, 32, 150, torch.bfloat16, cuda)
    with torch.no_grad():
        for fn, a in ((fused_bigru_lbh, a7), (kern9, a9)):
            for i, (x, y) in enumerate(zip(fn(*a), fn(*a))):
                assert torch.equal(x, y), (fn.__name__, i)


@pytest.mark.cuda
def test_cudacore_b7_b9_match_tensor_core_bf16(cuda):
    """The CUDA-core bf16 designs of B7 and B9 that chip_smoke.py times
    against the tensor-core ones agree with them under the same gate, and
    only the wrappers count launches."""
    from climsim_tpu_torch.ops import bigru_reference_lbh, fused_bigru_lbh
    from climsim_tpu_torch.ops.pallas_rnn import (cudacore_bigru_heads_lbh,
                                                  cudacore_fused_bigru_lbh)
    kern9, ref9 = _b9_b10(False)
    a7 = _b7_inputs(20, 32, 150, torch.bfloat16, cuda)
    a9 = _b9_b10_inputs(False, 20, 32, 150, torch.bfloat16, cuda)
    counts = (fused_bigru_lbh.launches, kern9.launches)
    with torch.no_grad():
        pairs = [(cudacore_fused_bigru_lbh(*a7), fused_bigru_lbh(*a7),
                  bigru_reference_lbh(*a7),
                  bigru_reference_lbh(*(t.float() for t in a7))),
                 (cudacore_bigru_heads_lbh(*a9), kern9(*a9), ref9(*a9),
                  ref9(*(t.float() for t in a9)))]
    assert (fused_bigru_lbh.launches, kern9.launches) == \
        (counts[0] + 1, counts[1] + 1)
    for old, new, w, w32 in pairs:
        for i, (o, n, p, p32) in enumerate(zip(old, new, w, w32)):
            own = (p.float() - p32.float()).abs().max().item()
            err = (o.float() - n.float()).abs().max().item()
            assert err <= 4 * own + 1e-3 * p32.float().abs().max().item(), \
                (i, err, own)


@pytest.mark.cuda
def test_b7_through_fused_layer_and_b9_through_v3_model(cuda):
    """The callers reach the tensor-core designs in bf16: FusedBiGRULayer
    (the v2 arm's and the fused physics trunk's layer) launches B7 once a
    call, and the v3 RNNAutoreg B9 once a step; each output on the card
    against the same module on the CPU under the 4x gate."""
    from climsim_tpu_torch.models import BF16, F32, RNNAutoreg
    from climsim_tpu_torch.models.cells import FusedBiGRULayer
    from climsim_tpu_torch.ops import fused_bigru_heads_lbh, fused_bigru_lbh
    g = torch.Generator().manual_seed(5)
    layer = FusedBiGRULayer(24, 32, generator=g)
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.standard_normal((150, 20, 24)), dtype=torch.float32)
    h0 = torch.as_tensor(0.5 * rng.standard_normal((2, 150, 32)),
                         dtype=torch.float32)
    with torch.no_grad():
        want32 = layer(x, h0[0], h0[1])
        want = layer(x.bfloat16(), h0[0].bfloat16(), h0[1].bfloat16())
        layer.to(cuda)
        before = fused_bigru_lbh.launches
        got = layer(x.to(cuda, torch.bfloat16), h0[0].to(cuda),
                    h0[1].to(cuda))
        assert fused_bigru_lbh.launches == before + 1
    _bf16_holds([t.cpu() for t in got], want, want32)
    rng = np.random.default_rng(10)
    L, B = 12, 40
    xl = torch.as_tensor(rng.normal(0, 0.3, (B, L, 6)), dtype=torch.float32)
    xs = torch.as_tensor(rng.normal(0, 0.3, (B, 24)), dtype=torch.float32)
    mem = torch.zeros((B, L, 8))
    out = {}
    for name, policy in (("f32", F32), ("bf16", BF16)):
        for dev in (cuda, torch.device("cpu")):
            model = RNNAutoreg(nx=6, nx_sfc=24, ny=6, ny_sfc=8,
                               nneur=(32, 32), nh_mem=8, add_pres=False,
                               policy=policy, use_pallas=True,
                               fuse_heads=True, device=dev, seed=1)
            assert model.arm == "v3"
            before = fused_bigru_heads_lbh.launches
            with torch.no_grad():
                res = model(xl.to(dev), xs.to(dev), mem.to(dev))
            assert fused_bigru_heads_lbh.launches - before == \
                (1 if dev.type == "cuda" else 0)
            out[name, dev.type] = [t.float().cpu() for t in res]
    # the model's outputs are f32 (the policy's output type)
    for c, p, p32 in zip(out["bf16", "cuda"], out["bf16", "cpu"],
                         out["f32", "cpu"]):
        own = (p - p32).abs().max().item()
        err = (c - p).abs().max().item()
        assert err <= 4 * own + 1e-3 * p32.abs().max().item(), (err, own)


# ------------------------------------- B4 on tensor cores, B13 redesigned


def _b4_plan_inputs(L, H, B, nm_in, seed, CH=192):
    """B4's arguments at the v5 arm's widths (a tanh stream of CH rows,
    memory of nm_in rows, heads 16 + 6) with lecun-scale weights, f32."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g)
    lec = lambda o, i: r(o, i) / np.sqrt(i)
    a = [torch.tanh(r(L, CH, B)), 0.5 * r(L, nm_in, B), torch.tanh(r(H, B)),
         torch.tanh(r(H, B)), lec(3 * H, CH), lec(3 * H, max(nm_in, 1)),
         0.1 * r(3 * H, 1), lec(3 * H, H), 0.1 * r(3 * H, 1), lec(3 * H, H),
         0.1 * r(3 * H, 1), lec(3 * H, H), 0.1 * r(3 * H, 1), lec(16, H),
         0.1 * r(16, 1), lec(6, 16), 0.1 * r(6, 1)]
    a[5] = a[5][:, :nm_in].contiguous()
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("hoist", [True, False])
@pytest.mark.parametrize("B", [1000, 1001])
@pytest.mark.parametrize("H,nm_in", [(192, 16), (192, 0), (384, 16),
                                     (832, 16)])
def test_b4_tensor_core_bf16_at_every_plan(cuda, H, nm_in, B, hoist):
    """B4 in bf16 (the tensor-core design) at each plan: weights resident
    (H 192, with and without memory) and streamed (H 384, 32-column
    tiles; H 832, clusters of 8 over 16-column tiles), L 60; B 1,000 (a
    multiple of 8: the X tile's rows copied with cp.async, the last tile
    ragged) and 1,001 (rows not 16-byte aligned: copied element by
    element); projections rounded or not. Each output against the plain
    version under the 4x gate, one launch counted."""
    from climsim_tpu_torch.ops import (bigru_heads_cm_reference,
                                       fused_bigru_heads_cm)
    a16 = [t.to(cuda, torch.bfloat16)
           for t in _b4_plan_inputs(60, H, B, nm_in, seed=H + B)]
    before = fused_bigru_heads_cm.launches
    with torch.no_grad():
        got = fused_bigru_heads_cm(*a16, hoist_proj=hoist)
        assert fused_bigru_heads_cm.launches == before + 1
        _bf16_holds(got, bigru_heads_cm_reference(*a16, hoist_proj=hoist),
                    bigru_heads_cm_reference(*(t.float() for t in a16),
                                             hoist_proj=hoist))
    assert all(g.is_contiguous() for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("H,CH,nm_in", [(16, 16, 8), (20, 12, 5),
                                        (20, 12, 0)])
@pytest.mark.parametrize("B", EDGES)
def test_b4_tensor_core_bf16_at_the_edges(cuda, B, H, CH, nm_in):
    """B4 in bf16 at the edges of its tiling: B 1, below one 64-column
    tile, ragged against it, two tiles; H 20 padded to 32, the memory
    padded so that x's 12 or 16 rows and it fill whole k-steps (8 -> 16,
    5 -> 20, 0 -> 4); each output against the plain version under the 4x
    gate."""
    from climsim_tpu_torch.ops import (bigru_heads_cm_reference,
                                       fused_bigru_heads_cm)
    a = [t.to(cuda, torch.bfloat16)
         for t in _b4_plan_inputs(20, H, B, nm_in, seed=B, CH=CH)]
    with torch.no_grad():
        for hoist in (True, False):
            _bf16_holds(fused_bigru_heads_cm(*a, hoist_proj=hoist),
                        bigru_heads_cm_reference(*a, hoist_proj=hoist),
                        bigru_heads_cm_reference(*(t.float() for t in a),
                                                 hoist_proj=hoist))


@pytest.mark.cuda
def test_b4_bf16_is_deterministic_and_its_twin_agrees(cuda):
    """Two bf16 B4 calls are bit-identical (fixed-order sums); the
    CUDA-core bf16 design that chip_smoke.py times against it agrees with
    it under the 4x gate, and only the wrapper counts launches."""
    from climsim_tpu_torch.ops import (bigru_heads_cm_reference,
                                       fused_bigru_heads_cm)
    from climsim_tpu_torch.ops.pallas_rnn import cudacore_fused_bigru_heads_cm
    a = [t.to(cuda, torch.bfloat16)
         for t in _b4_plan_inputs(20, 32, 150, 8, seed=3, CH=24)]
    before = fused_bigru_heads_cm.launches
    with torch.no_grad():
        first = fused_bigru_heads_cm(*a)
        second = fused_bigru_heads_cm(*a)
        twin = cudacore_fused_bigru_heads_cm(*a)
        want = bigru_heads_cm_reference(*a)
        want32 = bigru_heads_cm_reference(*(t.float() for t in a))
    assert fused_bigru_heads_cm.launches == before + 2
    for i, (x, y) in enumerate(zip(first, second)):
        assert torch.equal(x, y), i
    for i, (o, n, p, p32) in enumerate(zip(twin, first, want, want32)):
        own = (p.float() - p32.float()).abs().max().item()
        err = (o.float() - n.float()).abs().max().item()
        assert err <= 4 * own + 1e-3 * p32.float().abs().max().item(), \
            (i, err, own)


@pytest.mark.cuda
def test_b4_through_the_v5_model(cuda):
    """The v5 RNNAutoreg (fuse_heads, level_major, no fuse_init) reaches
    the tensor-core B4 in bf16, one launch a step, and its outputs on the
    card hold against the same seeded model on the CPU under the 4x gate
    (the CPU's own bf16-vs-f32 difference)."""
    from climsim_tpu_torch.models import BF16, F32, RNNAutoreg
    from climsim_tpu_torch.ops import fused_bigru_heads_cm
    rng = np.random.default_rng(11)
    L, B = 12, 40
    xl = torch.as_tensor(rng.normal(0, 0.3, (L, 6, B)), dtype=torch.float32)
    xs = torch.as_tensor(rng.normal(0, 0.3, (B, 24)), dtype=torch.float32)
    mem = torch.as_tensor(rng.normal(0, 0.3, (L, 8, B)), dtype=torch.float32)
    out = {}
    for name, policy in (("f32", F32), ("bf16", BF16)):
        for dev in (cuda, torch.device("cpu")):
            model = RNNAutoreg(nx=6, nx_sfc=24, ny=6, ny_sfc=8,
                               nneur=(32, 32), nh_mem=8, add_pres=False,
                               policy=policy, use_pallas=True,
                               fuse_heads=True, level_major=True,
                               device=dev, seed=1)
            assert model.arm == "v5"
            before = fused_bigru_heads_cm.launches
            with torch.no_grad():
                res = model(xl.to(dev), xs.to(dev), mem.to(dev))
            assert fused_bigru_heads_cm.launches - before == \
                (1 if dev.type == "cuda" else 0)
            out[name, dev.type] = [t.float().cpu() for t in res]
    for c, p, p32 in zip(out["bf16", "cuda"], out["bf16", "cpu"],
                         out["f32", "cpu"]):
        own = (p - p32).abs().max().item()
        err = (c - p).abs().max().item()
        assert err <= 4 * own + 1e-3 * p32.abs().max().item(), (err, own)


@pytest.mark.cuda
@pytest.mark.parametrize("B,nlev,ng", [(21600, 60, 8), (1000, 50, 8),
                                       (13, 13, 8), (7, 50, 3),
                                       (40, 400, 8)])
def test_b13_matches_plain_at_its_shapes(cuda, B, nlev, ng):
    """B13 (two passes, pass 1's state parked every 4 levels in shared
    memory) against its plain version: the physics update's shape, a
    ragged 1,000 columns of 50 levels, a last block of items that is
    ragged (104 items), nlev not a multiple of the 4-level chunk (13, 50),
    ng 3, and nlev 400 (51,200 bytes of shared memory a block, past the
    48 KB default). Each gradient to 1e-5 of its scale, as
    check_radiation_bwd; one launch; no device scratch."""
    from climsim_tpu_torch.ops import adding_sw_bwd, adding_sw_bwd_reference
    sw, _ = _radiation_inputs(cuda, B=B, nlev=nlev, ng=ng, seed=B + nlev)
    g = torch.Generator(device=cuda).manual_seed(nlev)
    cts = [torch.randn((B, nlev + 1, ng), generator=g, device=cuda)
           for _ in range(3)]
    before = adding_sw_bwd.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = adding_sw_bwd(sw, cts)
    grads = sum(t.numel() for t in got) * 4
    # the gradients and the caching allocator's rounding, far below the
    # first design's [4, B, nlev+1, ng] scratch (168 MB at the first shape)
    assert torch.cuda.max_memory_allocated() - base <= grads + (8 << 20)
    assert adding_sw_bwd.launches == before + 1
    want = adding_sw_bwd_reference(sw, cts)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all(), i
        assert _rel_err(a, b) <= 1e-5, (i, _rel_err(a, b))


@pytest.mark.cuda
def test_b13_is_deterministic_and_its_first_design_agrees(cuda):
    """Two B13 calls are bit-identical; the first design (device scratch,
    four sweeps), which chip_smoke.py times against it, agrees with it to
    1e-5 of each gradient's scale and counts no launch."""
    from climsim_tpu_torch.ops import adding_sw_bwd
    from climsim_tpu_torch.ops.pallas_radiation import scratch_adding_sw_bwd
    sw, _ = _radiation_inputs(cuda, B=1000, nlev=60, ng=8, seed=21)
    g = torch.Generator(device=cuda).manual_seed(2)
    cts = [torch.randn((1000, 61, 8), generator=g, device=cuda)
           for _ in range(3)]
    before = adding_sw_bwd.launches
    first, second = adding_sw_bwd(sw, cts), adding_sw_bwd(sw, cts)
    old = scratch_adding_sw_bwd(sw, cts)
    assert adding_sw_bwd.launches == before + 2
    for i, (a, b, o) in enumerate(zip(first, second, old)):
        assert torch.equal(a, b), i
        assert _rel_err(o, a) <= 1e-5, (i, _rel_err(o, a))


# ------------------------------------------------------------------------
# the f32 cluster design of B7 and B8, and every GRU kind past the widths
# its earlier designs refused (the selector's CUDA-core choices)

def _lecun_km(t, scale):
    """A k-major [in, out] weight of the given scale rescaled to
    1/sqrt(fan-in)."""
    return t / (scale * np.sqrt(t.shape[0]))


def _v2_lecun(L, H, B, device, seed=7):
    """B8's residuals (B7's inputs) with lecun-scale weights, so that the
    gates stay of order 1 at any width, and the cotangents."""
    res, dd, dl = _b8_inputs(L, H, B, torch.float32, device, seed)
    for i in (3, 5, 7):
        res[i] = _lecun_km(res[i], 0.3)
    return res, dd, dl


@pytest.mark.cuda
@pytest.mark.parametrize("L,H,B", [(50, 128, 1000), (50, 128, 1001),
                                   (60, 192, 1000), (60, 192, 1001),
                                   (12, 20, 150), (12, 32, 1)])
def test_b7_b8_f32_cluster_design(cuda, L, H, B):
    """f32 B7 and B8 run the cluster FFMA design (the selector says so; one
    launch each) at the physics trunk's widths (L 50, H 128), the v2 arm's
    in f32 (L 60, H 192), a width the plan pads (H 20 to 32) and the
    ragged edges (B 1,001, 150, 1): B7 to 1e-5 + 1e-5 |x| and each of B8's
    nine outputs to 2e-5 of its scale against the plain versions, the
    gates check_b7 and check_b8 apply."""
    from climsim_tpu_torch.ops import (bigru_bwd_lbh, bigru_bwd_reference_lbh,
                                       bigru_reference_lbh, fused_bigru_lbh)
    res, dd, dl = _v2_lecun(L, H, B, cuda)
    b7, b8 = fused_bigru_lbh.launches, bigru_bwd_lbh.launches
    with torch.no_grad():
        got = fused_bigru_lbh(*res)
    assert fused_bigru_lbh.design == "f32_cluster"
    for g, w in zip(got, bigru_reference_lbh(*res)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    got8 = bigru_bwd_lbh(res, dd, dl)
    assert bigru_bwd_lbh.design == "f32_cluster"
    assert (fused_bigru_lbh.launches, bigru_bwd_lbh.launches) == (b7 + 1,
                                                                   b8 + 1)
    for i, (g, w) in enumerate(zip(got8, bigru_bwd_reference_lbh(res, dd,
                                                                  dl))):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        assert _rel_err(g, w) <= 2e-5, (i, _rel_err(g, w))


@pytest.mark.cuda
def test_b7_b8_f32_cluster_deterministic_and_twin(cuda):
    """Two calls of the f32 cluster design are bit-identical (fixed-order
    GEMM splits and tile sums, no atomics); the CUDA-core twin, which
    chip_smoke.py times against it and which counts no launch, agrees
    within the f32 gates."""
    from climsim_tpu_torch.ops import bigru_bwd_lbh, fused_bigru_lbh
    from climsim_tpu_torch.ops.pallas_rnn import (cudacore_bigru_bwd_lbh,
                                                  cudacore_fused_bigru_lbh)
    res, dd, dl = _v2_lecun(50, 128, 1000, cuda, seed=9)
    with torch.no_grad():
        f1, f2 = fused_bigru_lbh(*res), fused_bigru_lbh(*res)
    g1, g2 = bigru_bwd_lbh(res, dd, dl), bigru_bwd_lbh(res, dd, dl)
    before = (fused_bigru_lbh.launches, bigru_bwd_lbh.launches)
    with torch.no_grad():
        tw = cudacore_fused_bigru_lbh(*res)
    tw8 = cudacore_bigru_bwd_lbh(res, dd, dl)
    assert (fused_bigru_lbh.launches, bigru_bwd_lbh.launches) == before
    for a, b, t in zip(f1, f2, tw):
        assert torch.equal(a, b)
        torch.testing.assert_close(t, a, rtol=1e-5, atol=1e-5)
    for i, (a, b, t) in enumerate(zip(g1, g2, tw8)):
        assert torch.equal(a, b), i
        assert _rel_err(t, a) <= 2e-5, (i, _rel_err(t, a))


def _kind_case(kind, L, H, B, dtype, device):
    """(wrapper, plain, args) of one GRU kind at width H with lecun-scale
    weights: the forwards' arguments, or for B3 and B8 (res, cotangents)."""
    from climsim_tpu_torch.ops import (bigru_bwd_lbh, bigru_bwd_reference_lbh,
                                       bigru_reference_lbh,
                                       bigru_heads_cm_reference,
                                       fused_bigru_heads_cm, fused_bigru_lbh)
    if kind == "b1":
        a = _b1_inputs(L, H, B, torch.float32, device)
        for i in (4, 6, 7, 9, 11, 13, 15):
            a[i] = _lecun(a[i])
        return (fused_bigru_heads_init_cm, bigru_heads_init_cm_reference,
                [t.to(dtype) for t in a])
    if kind in ("b3", "b4"):
        res, dom, dlh = _b3_inputs(L, H, B, torch.float32, device)
        res = list(res)
        for i in (4, 5, 7, 9, 11, 13):
            res[i] = _lecun(res[i])
        res = [t.to(dtype) for t in res]
        if kind == "b4":
            return fused_bigru_heads_cm, bigru_heads_cm_reference, res
        return (bigru_heads_cm_bwd, bigru_heads_cm_bwd_reference,
                [res, dom.to(dtype), dlh.to(dtype)])
    if kind in ("b7", "b8"):
        res, dd, dl = _v2_lecun(L, H, B, device)
        res = [t.to(dtype) for t in res]
        if kind == "b7":
            return fused_bigru_lbh, bigru_reference_lbh, res
        return (bigru_bwd_lbh, bigru_bwd_reference_lbh,
                [res, dd.to(dtype), dl.to(dtype)])
    init = kind == "b10"
    a = _b9_b10_inputs(init, L, H, B, torch.float32, device)
    for i in range(len(a)):
        if a[i].dim() == 2 and i >= (4 if init else 3):
            a[i] = _lecun_km(a[i], 0.25)
    wrapper, plain = _b9_b10(init)
    return wrapper, plain, [t.to(dtype) for t in a]


# the widths of chip_smoke.py's width phase: bf16 H 840 and 968 (past the
# tensor-core plan at the flagship's other widths; at these tests' narrower
# memory and heads H 840 still has a plan, 968 has none for any kind), f32
# past the CUDA-core design's shared memory (H 384 and 512)
WIDE_CASES = [(k, torch.bfloat16, H) for k in
              ("b1", "b3", "b4", "b7", "b8", "b9", "b10")
              for H in (840, 968)] \
    + [(k, torch.float32, H) for k in
       ("b1", "b3", "b4", "b7", "b8", "b9", "b10") for H in (384, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype,H", WIDE_CASES)
def test_every_kind_at_the_width_phase_widths(cuda, kind, dtype, H):
    """Every GRU kind launches the design the selector names at these
    widths (one launch counted) and agrees with its plain version (L 6,
    150 columns): f32 forwards to 1e-5 + 1e-5 |x|, backwards to 2e-5 of
    each output's scale; bf16 within 4x the plain version's own
    bf16-vs-f32 error plus 1e-3 of its scale."""
    from climsim_tpu_torch.ops.pallas_rnn import gru_design
    wrapper, plain, args = _kind_case(kind, 6, H, 150, dtype, cuda)
    bwd = kind in ("b3", "b8")
    before = wrapper.launches
    with torch.no_grad():
        got = wrapper(*args)
        want = plain(*args)
    assert wrapper.launches == before + 1
    want_design = gru_design(
        kind, dtype, H, *{"b1": (H, 8, 8, 6, 6), "b3": (H, 8, 8, 6),
                          "b4": (H, 8, 8, 6), "b7": (), "b8": (),
                          "b9": (24, 0, 8, 6), "b10": (H, 8, 8, 6, 6)}[kind]
    )["design"]
    assert wrapper.design == want_design
    # past the tensor-core plan and past the CUDA-core tiles' shared
    # memory the tiles go to device scratch
    if H in (512, 968):
        assert want_design == "cudacore_scratch"
    if dtype == torch.bfloat16:
        f32 = ([[t.float() for t in args[0]], args[1].float(),
                args[2].float()] if bwd else [t.float() for t in args])
        with torch.no_grad():
            _bf16_holds(got, want, plain(*f32))
    elif bwd:
        for i, (g, w) in enumerate(zip(got, want)):
            assert _rel_err(g, w) <= 2e-5, (i, _rel_err(g, w))
    else:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------------
# B11 and B14: the staged tile ring, and the designs timed against it

# a ragged batch, nlev 50, PhysRad's ng 16, nlev 128, and ng 6 (which the
# ring does not take: the first design)
RAD_SHAPES = [(150, 60, 8), (1003, 50, 8), (40, 60, 16), (20, 128, 8),
              (30, 60, 6)]


def _rad_case(kind, device, B, nlev, ng, seed):
    """(wrapper call, plain call) of B11 (kind "b11") or B14 ("b14") on
    _radiation_inputs and seeded cotangents."""
    from climsim_tpu_torch.ops import (adding_sw_fast, lw_solver_noscat_bwd,
                                       lw_solver_noscat_bwd_reference)
    from climsim_tpu_torch.physics.radiation import adding_sw
    sw, lw = _radiation_inputs(device, B=B, nlev=nlev, ng=ng, seed=seed)
    if kind == "b11":
        return (lambda: adding_sw_fast(*sw), lambda: adding_sw(*sw),
                adding_sw_fast, sw, ())
    g = torch.Generator(device=device).manual_seed(seed)
    cts = [torch.randn((B, nlev + 1, ng), generator=g, device=device)
           for _ in range(2)]
    return (lambda: lw_solver_noscat_bwd(lw, cts),
            lambda: lw_solver_noscat_bwd_reference(lw, cts),
            lw_solver_noscat_bwd, lw, cts)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["b11", "b14"])
@pytest.mark.parametrize("B,nlev,ng", RAD_SHAPES)
def test_staged_radiation_kernels_match_plain(cuda, kind, B, nlev, ng):
    """B11 and B14 through their wrappers launch the design rad_design
    names (the staged ring, or at ng 6 the first design), record it as
    ``.design``, count one launch, agree with their plain versions to 1e-5
    of each output's scale (as chip_smoke.check_staged) and give the same
    bits twice."""
    from climsim_tpu_torch.ops import rad_design
    call, plain, wrapper, _, _ = _rad_case(kind, cuda, B, nlev, ng, B + ng)
    before = wrapper.launches
    with torch.no_grad():
        got, again, want = call(), call(), plain()
    assert wrapper.launches == before + 2
    assert wrapper.design == rad_design(kind, B, nlev, ng)["design"] \
        == ("first" if ng % 4 else "staged")
    for i, (a, b, w) in enumerate(zip(got, again, want)):
        assert torch.equal(a, b), i
        assert torch.isfinite(a).all(), i
        assert _rel_err(a, w) <= 1e-5, (i, _rel_err(a, w))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["b11", "b14"])
@pytest.mark.parametrize("B,nlev,ng", RAD_SHAPES[:4])
def test_staged_and_first_radiation_designs_agree(cuda, kind, B, nlev, ng):
    """At the same inputs, the staged design (through the wrapper) and the
    first design (which chip_smoke.py times against it) agree to 1e-5 of
    each output's scale, as each does with the plain version: B11's staged
    down sweep multiplies by the up sweep's reciprocal where the first
    design divides, so the two are not bit-identical. The first design
    counts no launch; unaligned tensors run it through the wrapper."""
    from climsim_tpu_torch.ops import pallas_radiation as prad
    call, _, wrapper, args, cts = _rad_case(kind, cuda, B, nlev, ng, 5)
    first = (lambda a: prad.first_adding_sw(*a)) if kind == "b11" else \
        (lambda a: prad.first_lw_solver_noscat_bwd(a, cts))
    with torch.no_grad():
        staged = call()
        assert wrapper.design == "staged"
        before = wrapper.launches
        old = first(args)
        assert wrapper.launches == before
        for i, (a, w) in enumerate(zip(staged, old)):
            assert _rel_err(a, w) <= 1e-5, (i, _rel_err(a, w))
        # a view 4 bytes past a 16-byte boundary: contiguous, not aligned
        shifted = []
        for a in args:
            buf = torch.empty(a.numel() + 1, device=cuda)
            shifted.append(buf[1:].view(a.shape).copy_(a))
        got = (prad.adding_sw_fast(*shifted) if kind == "b11"
               else prad.lw_solver_noscat_bwd(shifted, cts))
    assert wrapper.design == "first"
    assert wrapper.launches == before + 1
    for i, (a, w) in enumerate(zip(got, old)):
        assert torch.equal(a, w), i


# ------------------------------------------------------------------------
# B2, B5 and B6: the band tile, and the first designs timed against it

# (ntrac, L, nlat, nlon): a ragged last band (nlat 23: bands of 12 and
# 11), both pole clamps in one band (nlat 5), the 384-column grid, the
# main path's shape
FV_SHAPES = [(3, 4, 23, 24), (2, 3, 5, 16), (6, 4, 16, 24),
             (6, 60, 120, 180)]


def _fv_case(kind, device, ntrac, L, nlat, nlon, seed):
    """(wrapper, tile call, first-design call, plain call, tensors) of B2
    (kind "b2", ``ntrac`` tracers, winds that clip the Courant numbers in
    both sweeps), B5 ("b5", ``ntrac`` flat tracers, Courant numbers past
    1) or B6 ("b6", one field, the same winds) on seeded inputs."""
    from climsim_tpu_torch.ops import (first_fv_levels_flat,
                                       first_fv_tracers_flat,
                                       first_fv_tracers_sphere,
                                       fv_advect_levels, fv_advect_tracers,
                                       fv_tracers_reference)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    if kind == "b2":
        m = spherical_metric(np.linspace(-85.0, 85.0, nlat), nlon, 1200.0)
        args = (t(rng.normal(1, 0.3, (ntrac, L, nlat, nlon))),
                t(rng.normal(0, 150 * 24 / nlon, (L, nlat, nlon))),
                t(rng.normal(0, 700 * 16 / nlat, (L, nlat, nlon))))
        return (fv_advect_tracers_sphere,
                lambda a: fv_advect_tracers_sphere(*a, m),
                lambda a: first_fv_tracers_sphere(*a, m),
                lambda a: fv_tracers_sphere_reference(*a, m), args)
    if kind == "b5":
        args = (t(rng.normal(1, 0.3, (ntrac, L, nlat, nlon))),
                t(rng.normal(0, 1.5, (L, nlat, nlon))),
                t(rng.normal(0, 1.5, (L, nlat, nlon))))
        return (fv_advect_tracers, lambda a: fv_advect_tracers(*a, 0.4, 0.3),
                lambda a: first_fv_tracers_flat(*a, 0.4, 0.3),
                lambda a: fv_tracers_reference(*a, 0.4, 0.3), args)
    args = (t(rng.normal(1, 0.3, (L, nlat, nlon))),
            t(rng.normal(0, 1.5, (L, nlat, nlon))),
            t(rng.normal(0, 1.5, (L, nlat, nlon))))
    return (fv_advect_levels, lambda a: fv_advect_levels(*a, 0.4, 0.3),
            lambda a: first_fv_levels_flat(*a, 0.4, 0.3),
            lambda a: fv_tracers_reference(*a, 0.4, 0.3), args)


def _fv_kernel_smem(kind, ntrac, nlon, R):
    """The tile kernel's own shared memory (csrc's Geom::smem)."""
    import ctypes
    from climsim_tpu_torch.ops import _build
    src = "fv_tracers_sphere" if kind == "b2" else "fv_tracers_flat"
    entry = src + "_tile"
    fn = getattr(_build.load(src), entry + "_smem")
    fn.restype = ctypes.c_longlong
    return fn(ntrac, nlon, R)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["b2", "b6", "b5"])
@pytest.mark.parametrize("shape", FV_SHAPES)
def test_fv_tile_kernels_match_plain(cuda, kind, shape):
    """B2, B5 and B6 through their wrappers launch the design fv_design names
    (the band tile at these shapes), record it as ``.design``, count one
    launch a call, agree with their plain versions to 1e-5 + 1e-5*|x|
    (FMA contraction only, on fields of order 1), give the same bits
    twice, and ask for the shared memory fv_design computes."""
    from climsim_tpu_torch.ops import fv_design
    ntrac = shape[0] if kind != "b6" else 1
    wrapper, call, _, plain, args = _fv_case(kind, cuda, ntrac, *shape[1:],
                                             seed=sum(shape))
    before = wrapper.launches
    with torch.no_grad():
        got, again, want = call(args), call(args), plain(args)
    d = fv_design(kind, ntrac, *shape[1:],
                  sms=torch.cuda.get_device_properties(0)
                  .multi_processor_count)
    assert wrapper.launches == before + 2
    assert wrapper.design == d["design"] == "tile"
    assert torch.equal(got, again)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert _fv_kernel_smem(kind, ntrac, shape[3], d["R"]) == d["smem"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["b2", "b6", "b5"])
@pytest.mark.parametrize("shape", FV_SHAPES[:3])
def test_fv_tile_and_first_designs_agree(cuda, kind, shape):
    """At the same inputs the band tile (through the wrapper) and the
    first design (which chip_smoke.py times against it) agree within the
    gate 1e-5 + 1e-5*|x|; the first design counts no launch; an unaligned
    view runs the first design through the wrapper, to the bit."""
    ntrac = shape[0] if kind != "b6" else 1
    wrapper, call, first, _, args = _fv_case(kind, cuda, ntrac, *shape[1:],
                                             seed=7)
    with torch.no_grad():
        tile = call(args)
        assert wrapper.design == "tile"
        before = wrapper.launches
        old = first(args)
        assert wrapper.launches == before
        torch.testing.assert_close(tile, old, rtol=1e-5, atol=1e-5)
        # a view 4 bytes past a 16-byte boundary: contiguous, not aligned
        shifted = []
        for a in args:
            buf = torch.empty(a.numel() + 1, device=cuda)
            shifted.append(buf[1:].view(a.shape).copy_(a))
        got = call(shifted)
    assert wrapper.design == "first"
    assert wrapper.launches == before + 1
    assert torch.equal(got, old)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["b2", "b6", "b5"])
def test_fv_first_design_where_a_row_is_not_16_bytes(cuda, kind):
    """nlon 182 (a row of 728 bytes, no multiple of the bulk copy's 16):
    the wrapper runs the first design, within the gate of the plain
    version."""
    wrapper, call, _, plain, args = _fv_case(kind, cuda, 2, 3, 12, 182,
                                             seed=3)
    with torch.no_grad():
        got, want = call(args), plain(args)
    assert wrapper.design == "first"
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FV_SHAPES)
def test_b5_tracer_is_b6_on_that_field(cuda, shape):
    """B5's tile on tracer t runs the arithmetic of B6's tile on that field
    alone (one compiled kernel, the Flat form), so the two agree bit for
    bit at every shape, whatever their bands and groups."""
    from climsim_tpu_torch.ops import fv_advect_levels, fv_advect_tracers
    _, _, _, _, (qs, u, v) = _fv_case("b5", cuda, *shape, seed=11)
    with torch.no_grad():
        got = fv_advect_tracers(qs, u, v, 0.4, 0.3)
        assert fv_advect_tracers.design == "tile"
        for t in range(qs.shape[0]):
            one = fv_advect_levels(qs[t].contiguous(), u, v, 0.4, 0.3)
            assert fv_advect_levels.design == "tile"
            assert torch.equal(got[t], one), t


# ------------------------------------------------------------------------
# the coupled step's CLI on the card


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["fv", "semi_lagrangian", "none"])
def test_run_hybrid_cli_on_card_matches_cpu(cuda, tmp_path, scheme):
    """``cli/run_hybrid.py`` on the card (its default device) against
    ``--device cpu`` over 4 steps at nneur 32 on a 384-column grid file:
    no kernel launches (the CLI's scan emulator and per-field plain
    transport), finite fields, and tests/test_torch_run_hybrid.py's
    tolerances: T to 1e-4 K, the other fields to rtol 1e-5 plus 1e-5 of
    their largest change over the run, the diagnostics to 1e-5 / 1e-6."""
    from scipy.io import netcdf_file

    from climsim_tpu_torch import Grid, ops
    from climsim_tpu_torch.cli import run_hybrid as cli
    path = str(tmp_path / "grid.nc")
    g = Grid.synthetic(384, 60, dtype=torch.float64)
    with netcdf_file(path, "w") as f:
        for d, n in (("ncol", 384), ("lev", 60), ("ilev", 61)):
            f.createDimension(d, n)
        for k, d in (("lat", "ncol"), ("lon", "ncol"), ("area", "ncol"),
                     ("hyai", "ilev"), ("hybi", "ilev"), ("hyam", "lev"),
                     ("hybm", "lev")):
            f.createVariable(k, "d", (d,))[:] = getattr(g, k).numpy()
        f.createVariable("P0", "d", ())[...] = 1.0e5
    wrappers = [getattr(ops, n) for n in ops.__all__
                if hasattr(getattr(ops, n), "launches")]
    before = [w.launches for w in wrappers]
    outs = {}
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / f"{dev}.npz")
        args = ["--grid", path, "--steps", "4", "--nneur", "32", "--scheme",
                scheme, "--out", out] + (["--device", "cpu"]
                                         if dev == "cpu" else [])
        assert cli.main(args) == 0
        outs[dev] = np.load(out)
    assert [w.launches for w in wrappers] == before
    state, _ = cli.initial_state(Grid.from_file(path, device="cpu"),
                                 torch.Generator().manual_seed(0))
    card, host = outs["cuda"], outs["cpu"]
    assert sorted(card.files) == sorted(host.files)
    for k in cli.PROGNOSTIC:
        assert np.isfinite(card[k]).all(), k
        rtol, atol = {"T": (1e-6, 1e-4), "u": (1e-5, 1e-5),
                      "v": (1e-5, 1e-5)}.get(k, (1e-5, 1e-12))
        change = np.abs(host[k] - state[k].numpy()).max()
        np.testing.assert_allclose(card[k], host[k], rtol=rtol,
                                   atol=max(atol, 1e-5 * change), err_msg=k)
    for k in ("mean_T", "precc"):
        np.testing.assert_allclose(card[k], host[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.cuda
def test_prefetch_to_device_on_card(cuda):
    """data.loader.prefetch_to_device: items copied from pinned host memory
    on a side stream arrive on the card in order and equal, the consumer's
    stream waiting on each copy; an error in the source reaches the
    consumer."""
    import numpy as np
    from climsim_tpu_torch.data import prefetch_to_device
    items = [{"x": np.random.default_rng(i).standard_normal((64, 60, 15))
              .astype(np.float32), "t": (np.arange(i + 1),)}
             for i in range(5)]
    got = list(prefetch_to_device(iter(items), size=2, device=cuda))
    assert len(got) == 5
    for g, w in zip(got, items):
        assert g["x"].device.type == "cuda"
        assert torch.equal(g["x"].cpu(), torch.from_numpy(w["x"]))
        assert torch.equal(g["t"][0].cpu(), torch.from_numpy(w["t"][0]))

    def failing():
        yield np.zeros(3)
        raise ValueError("bad batch")
    it = prefetch_to_device(failing(), device=cuda)
    assert next(it).device.type == "cuda"
    with pytest.raises(ValueError, match="bad batch"):
        next(it)


@pytest.mark.cuda
def test_sharded_step_world_size_one_on_card(cuda):
    """sharded_hybrid_step on a one-rank NCCL group, the v4 arm (B10) in
    bf16 on 384 columns in the production configuration, with and without
    the overlap, against HybridLoop.coupled_step on the same inputs (the
    fields rtol 1e-5 / atol 1e-8, u and v atol 1e-5 of their largest
    magnitude, the memory atol 5e-7); B10 launches twice a step with the
    overlap (bulk and ghost rows), once without."""
    import torch.distributed as dist
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.models import BF16, RNNAutoreg
    from climsim_tpu_torch.online import (HostLoopConfig, HybridLoop,
                                          sharded_hybrid_step, to_grid)
    from climsim_tpu_torch.ops import fused_bigru_heads_init_lbh as b10
    from climsim_tpu_torch.parallel import init_distributed, make_mesh
    nlat, nlon, nlev = 16, 24, 60
    ncol = nlat * nlon
    model = RNNAutoreg(nx=6, nx_sfc=24, ny=6, ny_sfc=8, nneur=(192, 192),
                       nh_mem=16, add_pres=False, policy=BF16,
                       use_pallas=True, fuse_heads=True, fuse_init=True,
                       device=None)
    xs = torch.tensor([250.0, 1e-3, 1e-5, 1e-5, 10.0, 10.0], device=cuda)
    ys = torch.tensor([1e-5, 1e-8, 1e-9, 1e-9, 1e-5, 1e-5], device=cuda)

    def emulator(x, s, m):
        out, out_sfc, m = model(x / xs, s, m)
        return out * ys, out_sfc, m

    cfg = HostLoopConfig(nlat=nlat, nlon=nlon, scheme="fv",
                         geometry="sphere", fix_water=True, fix_energy=True)
    loop = HybridLoop(emulator, Grid.synthetic(ncol, nlev, device=cuda),
                      cfg, device=None)
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    state = {"T": t(rng.uniform(220, 300, (ncol, nlev))),
             "qv": t(np.abs(rng.normal(1e-3, 3e-4, (ncol, nlev)))),
             "qc": t(np.abs(rng.normal(1e-5, 3e-6, (ncol, nlev)))),
             "qi": t(np.abs(rng.normal(1e-5, 3e-6, (ncol, nlev)))),
             "u": t(rng.normal(0, 10, (ncol, nlev))),
             "v": t(rng.normal(0, 3, (ncol, nlev)))}
    mem = torch.zeros((ncol, nlev, 16), device=cuda)
    x_sfc = torch.cat([torch.full((ncol, 1), 1e5), torch.ones((ncol, 23))],
                      dim=1).to(cuda)
    init_distributed(device=None)
    try:
        mesh = make_mesh(1, axis="col")
        gi = loop.gather_idx
        tog = lambda a: to_grid(a, gi, nlat, nlon)
        with torch.no_grad():
            ref, ref_mem, ref_d = loop.coupled_step(state, mem, x_sfc)
            for overlap, launches in ((True, 2), (False, 1)):
                step = sharded_hybrid_step(loop, mesh, overlap=overlap)
                b10.launches = 0
                out, mem_new, diags = step({k: tog(v) for k, v in
                                            state.items()}, mem[gi],
                                           tog(x_sfc))
                assert b10.launches == launches, (overlap, b10.launches)
                for k, v in ref.items():
                    want = tog(v)
                    atol = (1e-5 * float(want.abs().max())
                            if k in ("u", "v") else 1e-8)
                    torch.testing.assert_close(out[k], want, rtol=1e-5,
                                               atol=atol)
                torch.testing.assert_close(mem_new, ref_mem[gi], rtol=1e-5,
                                           atol=5e-7)
                torch.testing.assert_close(diags["energy_int"],
                                           ref_d["energy_int"], rtol=1e-6,
                                           atol=0)
    finally:
        dist.destroy_process_group()


# C.2: the RNNAutoreg arms (flags on top of use_pallas, bf16, nneur 192)
# and whether each is channel-major
C2_ARMS = {"v6": dict(fuse_heads=True, fuse_init=True, level_major=True),
           "v5": dict(fuse_heads=True, level_major=True),
           "v4": dict(fuse_heads=True, fuse_init=True),
           "v3": dict(fuse_heads=True), "v2": {},
           "scan": dict(use_pallas=False)}


def _no_sync(fn):
    """fn() once to warm up, then again under set_sync_debug_mode
    ("error"), where a synchronizing CUDA operation raises."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("arm", list(C2_ARMS))
def test_coupled_step_has_no_host_sync(cuda, arm):
    """C.2: one coupled step of each arm (384 columns, the production
    configuration) and the arm's RNNAutoreg forward with no synchronizing
    CUDA operation: the TOA input is a view, no host index tensor."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.models import BF16, RNNAutoreg
    from climsim_tpu_torch.online import HostLoopConfig, HybridLoop
    nlat, nlon, nlev = 16, 24, 60
    ncol = nlat * nlon
    flags = {"use_pallas": True, **C2_ARMS[arm]}
    model = RNNAutoreg(nx=6, nx_sfc=24, ny=6, ny_sfc=8, nneur=(192, 192),
                       nh_mem=16, add_pres=False, policy=BF16, device=None,
                       **flags)
    assert model.arm == arm
    lm = model.level_major
    cfg = HostLoopConfig(nlat=nlat, nlon=nlon, scheme="fv",
                         geometry="sphere", fix_water=True, fix_energy=True,
                         emulator_level_major=lm)
    loop = HybridLoop(lambda x, s, m: model(x, s, m), Grid.synthetic(
        ncol, nlev, device=cuda), cfg, device=None)
    g = torch.Generator(device=cuda).manual_seed(2)
    r = lambda lo, hi: lo + (hi - lo) * torch.rand((ncol, nlev), generator=g,
                                                   device=cuda)
    state = {"T": r(220, 300), "qv": r(0, 2e-3), "qc": r(0, 1e-5),
             "qi": r(0, 1e-5), "u": r(-10, 10), "v": r(-3, 3)}
    mem = torch.zeros((nlev, 16, ncol) if lm else (ncol, nlev, 16),
                      device=cuda)
    x_sfc = torch.cat([torch.full((ncol, 1), 1e5), torch.ones((ncol, 23))],
                      dim=1).to(cuda)
    with torch.no_grad():
        _no_sync(lambda: loop.coupled_step(state, mem, x_sfc))
        xm = torch.randn(((nlev, 6, ncol) if lm else (ncol, nlev, 6)),
                         device=cuda)
        _no_sync(lambda: model(xm, x_sfc, mem))


@pytest.mark.cuda
def test_eager_wrapper_step_has_no_host_sync(cuda):
    """C.2: the raw-units wrapper's eager step (the v4 arm, bf16) with no
    synchronizing CUDA operation; and the stochastic wrapper's AR(1) step
    with its noise as a tensor."""
    from climsim_tpu_torch.data import LevelNormalizer
    from climsim_tpu_torch.export import OnlineWrapper
    from climsim_tpu_torch.models import BF16, RNNAutoreg
    B, L, nx = 384, 60, 15
    hy = tuple(np.linspace(0.0, 0.01, L))
    norm = LevelNormalizer(torch.zeros(L, nx, device=cuda),
                           torch.ones(L, nx, device=cuda),
                           torch.zeros(24, device=cuda),
                           torch.ones(24, device=cuda),
                           torch.ones(1, 5, device=cuda),
                           torch.ones(8, device=cuda))
    lbd = torch.full((L,), 1e4)
    x = torch.rand(B, L, nx, device=cuda)
    x[..., 0] += 250.0
    xs = torch.rand(B, 24, device=cuda)
    xs[:, 0] = 1e5
    for flags in (dict(use_pallas=True, fuse_heads=True, fuse_init=True,
                       policy=BF16),
                  dict(add_stochastic_layer=True, ar_noise_rho=0.9)):
        model = RNNAutoreg(nx=nx, nx_sfc=24, ny=5, ny_sfc=8,
                           nneur=(192, 192), nh_mem=16, add_pres=True,
                           hyam=hy, hybm=hy, sp_mean=1e5, sp_div=1e3,
                           device=None, **flags)
        w = OnlineWrapper(model, norm, lbd, lbd, lbd)
        mem = torch.zeros(B, L, 16, device=cuda)
        with torch.no_grad():
            if "add_stochastic_layer" in flags:
                eps = torch.zeros(model.noise_shape(B, L), device=cuda)
                noise = torch.randn(model.noise_shape(B, L), device=cuda)
                out = _no_sync(lambda: w(x, xs, mem, eps, noise))
                assert len(out) == 4 and torch.isfinite(out[3]).all()
            else:
                out = _no_sync(lambda: w(x, xs, mem))
        assert all(bool(torch.isfinite(t).all()) for t in out[:3])


@pytest.mark.cuda
def test_ensemble_update_on_card_launches_no_kernel(cuda):
    """A stochastic 4-member ensemble update (the srnn yaml's model at
    nneur 64, with use_pallas: the scan trunk all the same) on the card:
    no kernel of the port launches, the memory is [4, B, L, nm] and
    finite, and the default noise source draws on the card."""
    from climsim_tpu_torch import ops
    from climsim_tpu_torch.models import RNNAutoreg
    from climsim_tpu_torch.train import RolloutConfig, RolloutTrainer
    B, L, W = 64, 60, 2
    model = RNNAutoreg(nx=16, nx_sfc=24, ny=6, ny_sfc=8, nneur=(64, 64),
                       nh_mem=16, add_pres=False, add_stochastic_layer=True,
                       ar_noise_rho=0.95, use_pallas=True, device=None)
    assert model.arm == "scan"
    hy = np.linspace(0.0, 1.0, L + 1)
    tr = RolloutTrainer(model, RolloutConfig(ensemble_size=4, optimizer="soap",
                                             rollout_schedule={0: W}),
                        hy * 1e-3, hy, device=None)
    g = torch.Generator(device=cuda).manual_seed(0)
    rn = lambda *s: 0.3 * torch.randn(s, generator=g, device=cuda)
    window = {"x_lev": rn(W, B, L, 16), "x_sfc": rn(W, B, 24),
              "y_lev": rn(W, B, L, 6), "y_sfc": rn(W, B, 8),
              "sp": 1e5 + rn(W, B)}
    mem = tr.init(window)
    wrappers = [getattr(ops, n) for n in dir(ops)
                if hasattr(getattr(ops, n), "launches")]
    before = [w.launches for w in wrappers]
    for _ in range(2):
        mem, loss = tr.update(window, mem, None)
    assert [w.launches for w in wrappers] == before
    assert mem.shape == (4, B, L, 16) and torch.isfinite(mem).all()
    assert torch.isfinite(loss)


# ------------------------------------------------------------------------
# the offline CLI's stochastic stack, U-Net and classifier on the card


def _new_offline_models(device):
    """Each new offline model at a narrow width from one seed, and its
    loss: {name: (model, loss(model) on inputs moved to its device)}."""
    from climsim_tpu_torch import models as M
    g = torch.Generator().manual_seed(11)
    x1 = torch.randn(64, 124, generator=g)
    y1 = torch.randn(64, 128, generator=g)
    eps = torch.randn(64, 5, generator=g)
    xu = torch.randn(16, 25 * 60 + 25 + 1, generator=g)
    xu[:, -1] = torch.arange(16) * 20 + 1
    lab = torch.randint(0, 3, (16, 1, 60), generator=g)

    def on(m, *ts):
        dev = next(m.parameters()).device
        return [t.to(dev) for t in ts]
    return {
        "hsr": (M.HSR(124, 128, hidden=64, layers=2, device=device),
                lambda m: M.hsr_nll(*m(on(m, x1)[0]), on(m, y1)[0])),
        "cvae": (M.CVAE(124, 128, hidden=64, device=device),
                 lambda m: M.cvae_loss(m, *on(m, y1, x1, eps), 0.5)),
        "rpn": (M.RPNEnsemble(124, 128, features=(64, 64), num_members=4,
                              device=device),
                lambda m: m.loss(*on(m, x1, y1))),
        "unet": (M.unet_v4(num_vars_scalar=25, model_channels=16,
                           num_blocks=1, loc_embedding=True, device=device),
                 lambda m: torch.mean(torch.square(m(*on(m, xu)) - 0.1))),
        "classifier": (M.ClimsimUNetClassifier(
            25, 25, model_channels=16, num_blocks=1, channel_mult=(1, 2),
            device=device),
            lambda m: M.classifier_loss(m(*on(m, xu)), *on(m, lab))),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hsr", "cvae", "rpn", "unet",
                                  "classifier"])
def test_offline_model_on_card_matches_cpu(cuda, name):
    """The forward's loss and every parameter gradient on the card against
    the CPU from the same weights (perturbed at random, so the U-Nets'
    zero-initialized convolutions do not hide the path), f32 without
    TF32: loss to rtol 1e-5, gradients to 1e-4 of each array's scale."""
    from climsim_tpu_torch.train.loop import zero_missing_grads_
    cpu_model, loss_fn = _new_offline_models("cpu")[name]
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in cpu_model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    card_model = _new_offline_models(cuda)[name][0]
    card_model.load_state_dict(cpu_model.state_dict())
    grads = {}
    for tag, m in (("cpu", cpu_model), ("cuda", card_model)):
        loss = loss_fn(m)
        loss.backward()
        zero_missing_grads_(m.parameters())
        grads[tag] = (loss.item(), {n: p.grad.cpu()
                                    for n, p in m.named_parameters()})
    (lc, gc_), (lg, gg) = grads["cpu"], grads["cuda"]
    assert np.isfinite(lg) and abs(lg - lc) <= 1e-5 * abs(lc)
    for n, want in gc_.items():
        scale = float(want.abs().max()) or 1.0
        assert float((gg[n] - want).abs().max()) <= 1e-4 * scale, n


@pytest.mark.cuda
def test_rpn_batched_members_match_a_loop(cuda):
    """The ensemble's one batched product a layer against each member run
    alone (``member_block``) on the card."""
    from climsim_tpu_torch.models import RPNEnsemble
    ens = RPNEnsemble(124, 128, num_members=8, device=cuda)
    x = torch.randn(1536, 124, device=cuda)
    with torch.no_grad():
        full = ens(x)
        for m in range(8):
            one = ens.member_block(m, m + 1)(x)[0]
            err = float((one - full[m]).abs().max())
            assert err <= 1e-5 * float(full[m].abs().max()), (m, err)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [
    ["model.name=hsr", "model.hidden=64"],
    ["model.name=rpn", "model.features=[64,64]", "model.members=4"],
    ["model.name=cvae", "model.hidden=64"],
    ["vset=v4", "model.name=unet", "model.model_channels=16",
     "model.num_blocks=1"],
    ["vset=v5", "model.name=classifier", "batch_size=384",
     "model.model_channels=16", "model.num_blocks=1"],
    ["vset=v5", "model.name=classifier_gradout", "batch_size=384",
     "model.model_channels=16", "model.num_blocks=1",
     "optimizer.max_grad_norm=1.0"]])
def test_offline_new_arms_on_card(cuda, tmp_path, over, capsys):
    """Each new arm of ``cli/train_offline.py`` on the card (its default
    device), 2 epochs of 6 steps: exit 0, two finite records, and no
    kernel of the port launched (none of these paths is a Pallas kernel
    in JAX)."""
    import json
    import os

    from scipy.io import netcdf_file

    from climsim_tpu_torch import Grid, ops
    from climsim_tpu_torch.cli import train_offline as cli
    grid = str(tmp_path / "grid.nc")
    g = Grid.synthetic(384, 60, dtype=torch.float64)
    with netcdf_file(grid, "w") as f:
        for d, n in (("ncol", 384), ("lev", 60), ("ilev", 61)):
            f.createDimension(d, n)
        for k, d in (("lat", "ncol"), ("lon", "ncol"), ("area", "ncol"),
                     ("hyai", "ilev"), ("hybi", "ilev"), ("hyam", "lev"),
                     ("hybm", "lev")):
            f.createVariable(k, "d", (d,))[:] = getattr(g, k).numpy()
        f.createVariable("P0", "d", ())[...] = 1.0e5
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    wrappers = [getattr(ops, n) for n in dir(ops)
                if hasattr(getattr(ops, n), "launches")]
    before = [w.launches for w in wrappers]
    rc = cli.main([os.path.join(repo, "conf", "mlp_v1.yaml"),
                   f"grid_path={grid}", "data.steps=6", "epochs=2"] + over)
    assert rc == 0
    assert [w.launches for w in wrappers] == before
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"epoch"')]
    assert [r["epoch"] for r in recs] == [0, 1]
    assert all(np.isfinite(v) for r in recs for v in r.values())


# ------------------------------------------------------------------------
# the forwards' bf16-gate mode (acc32=False): every design the selector can
# choose for a bf16 input takes it

G16_KINDS = ["b1", "b4", "b4_unhoisted", "b7", "b9", "b10"]


def _g16_case(kind, L, H, B, device):
    """(wrapper, plain, args, kw) of a forward kind in bf16, kw the v5
    body's hoist_proj where the kind has it."""
    base = "b4" if kind.startswith("b4") else kind
    wrapper, plain, args = _kind_case(base, L, H, B, torch.bfloat16, device)
    kw = {"hoist_proj": False} if kind == "b4_unhoisted" else {}
    return wrapper, plain, args, kw


def _g16_holds(got, want16, want32):
    """Each output of a bf16-gate launch against the plain bf16-gate
    version (want16) and the plain float32-gate version on the same bf16
    inputs (want32): its mean distance from want16 at most half the
    modes' own mean distance and below its mean distance from want32 (a
    launch that ran float32 gates lands near want32 and fails), its
    largest difference as _bf16_holds holds it. The largest differences
    alone cannot tell the modes apart: a rounding that flips with the
    summation order travels as far as the modes' difference."""
    _bf16_holds(got, want16, want32)
    for i, (g, w, w32) in enumerate(zip(got, want16, want32)):
        g, w, w32 = g.float(), w.float(), w32.float()
        gap = (w - w32).abs().mean().item()
        m16 = (g - w).abs().mean().item()
        assert gap > 0, i
        assert m16 <= 0.5 * gap and m16 < (g - w32).abs().mean().item(), \
            (i, m16, gap)


def _g16_launch(kind, args, kw):
    """The kind's CUDA-core design in its bf16-gate instantiation, called
    directly (the selector picks it only past the tensor-core plan)."""
    from climsim_tpu_torch.ops import pallas_rnn as PR
    if kind == "b1":
        return PR._launch(args, PR._validate(args), g16=True)
    if kind.startswith("b4"):
        return PR._launch_cm(args, PR._validate_cm(args),
                             kw.get("hoist_proj", True), g16=True)
    if kind == "b7":
        return PR._launch_lbh(args, PR._validate_lbh(args), g16=True)
    init = kind == "b10"
    return PR._launch_heads_lbh(args, PR._validate_heads_lbh(args, init),
                                init, g16=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", G16_KINDS)
@pytest.mark.parametrize("H", [32, 968])
def test_bf16_gate_mode_matches_plain(cuda, kind, H):
    """acc32=False through the wrapper (H 32: the tensor-core design; H 968:
    the CUDA-core design with its tiles in device scratch), one launch
    counted and the design recorded with its gate mode, and at H 32 the
    CUDA-core design's shared-memory instantiation called directly: each
    against the plain bf16-gate version (L 12, 150 columns, ragged) by
    _g16_holds; both do the same bf16 operations, and differ by the f32
    summation order of the products."""
    wrapper, plain, args, kw = _g16_case(kind, 12 if H == 32 else 4, H, 150,
                                         cuda)
    before = wrapper.launches
    with torch.no_grad():
        got = wrapper(*args, acc32=False, **kw)
        want = plain(*args, acc32=False, **kw)
        want32 = plain(*args, acc32=True, **kw)
    assert wrapper.launches == before + 1
    base = "tensor_core" if H == 32 else "cudacore_scratch"
    assert wrapper.design == base + "+bf16_gates"
    _g16_holds(got, want, want32)
    if H == 32:
        with torch.no_grad():
            _g16_holds(_g16_launch(kind, args, kw), want, want32)


@pytest.mark.cuda
def test_bf16_gate_mode_is_its_own_and_deterministic(cuda):
    """The bf16-gate B1 differs from the float32-gate one (the mode really
    runs), gives the same bits twice, and B4's two hoist_proj bodies are
    one computation in this mode, as in the plain version."""
    from climsim_tpu_torch.ops import fused_bigru_heads_cm
    _, _, a1, _ = _g16_case("b1", 12, 32, 150, cuda)
    with torch.no_grad():
        g1 = fused_bigru_heads_init_cm(*a1, acc32=False)
        g2 = fused_bigru_heads_init_cm(*a1, acc32=False)
        f = fused_bigru_heads_init_cm(*a1)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))
    assert not torch.equal(g1[0], f[0])
    _, _, a4, _ = _g16_case("b4", 12, 32, 150, cuda)
    with torch.no_grad():
        h = fused_bigru_heads_cm(*a4, acc32=False)
        u = fused_bigru_heads_cm(*a4, acc32=False, hoist_proj=False)
    assert all(torch.equal(x, y) for x, y in zip(h, u))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["b1", "b4", "b7", "b10"])
def test_bf16_gate_mode_gradients_are_the_f32_gate_ones(cuda, kind):
    """The backward kernels linearise the float32-gate forward from the
    saved inputs in both modes (as JAX's do), so acc32=False gives the
    gradients of acc32=True to the bit."""
    wrapper, _, args, _ = _g16_case(kind, 12, 32, 150, cuda)
    g = torch.Generator(device=cuda)
    res = []
    for acc32 in (True, False):
        a = [t.detach().clone().requires_grad_(True) for t in args]
        outs = wrapper(*a, acc32=acc32)
        cts = [torch.randn(o.shape, generator=g.manual_seed(5 + i),
                           device=cuda).to(o.dtype)
               for i, o in enumerate(outs)]
        torch.autograd.backward(outs, cts)
        res.append([t.grad for t in a])
    for x, y in zip(*res):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


def _phys_small(device, **over):
    """conf/autoreg_physrnn.yaml's model narrow (nneur 16, nh_mem 8), with
    Grid.synthetic's coefficients; McICA off, so the card's and the CPU's
    discrete choices cannot part."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.models import BF16, F32, PhysicalRNNAutoreg
    g = Grid.synthetic(4, 60)
    tt = lambda a: tuple(a.tolist())
    kw = dict(nx=15, nx_sfc=24, ny=5, ny_sfc=8, nneur=(16, 16), nh_mem=8,
              nreg=6, use_physrad=True, ng_lw=8, ng_sw=8, hyai=tt(g.hyai),
              hybi=tt(g.hybi), hyam=tt(g.hyam), hybm=tt(g.hybm),
              sp_mean=9.8e4, sp_div=1e3, yscale_t=1e5, yscale_qv=1e8,
              yscale_qn=1e8, yscale_precc=1e12)
    kw.update(over)
    kw["policy"] = BF16 if kw.get("policy") == "bf16" else F32
    return PhysicalRNNAutoreg(**kw, device=device, seed=4)


def _phys_inputs(B, device, seed=5):
    rng = np.random.default_rng(seed)
    xd = np.zeros((B, 60, 6), np.float32)
    xd[..., 0] = rng.uniform(200, 300, (B, 60))
    xd[..., 2:4] = np.abs(rng.normal(0, 1e-5, (B, 60, 2)))
    xd[..., 5] = np.abs(rng.normal(1e-3, 3e-4, (B, 60)))
    arrays = (rng.normal(0, 1, (B, 60, 15)), rng.normal(0, 1, (B, 24)),
              np.abs(rng.normal(0, 0.1, (B, 50, 9))), xd)
    return [torch.as_tensor(np.asarray(a, np.float32), device=device)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("over", [
    dict(use_tc=True), dict(learned_cloud_optics=True),
    dict(use_physrad=False, use_pallas=True),
    dict(use_physrad=False, separate_radiation=True, use_pallas=True),
    dict(policy="bf16", use_pallas=True)],
    ids=["use_tc", "learned", "ml_radiation", "separate", "bf16"])
def test_phys_options_on_card_match_cpu(cuda, over):
    """The physics model's other options on the card (B7 for the fused
    trunk, B11/B12 with physical radiation but TripleClouds' SW) against
    the same model on the CPU: every output to 1e-4 of its scale, as
    chip_smoke.py's physics checks hold it."""
    from climsim_tpu_torch.ops import fused_bigru_lbh, lw_solver_noscat_fast
    tc, tp = _phys_small("cuda", **over), _phys_small("cpu", **over)
    b7, b12 = fused_bigru_lbh.launches, lw_solver_noscat_fast.launches
    with torch.no_grad():
        got = tc(*_phys_inputs(12, cuda))
        want = tp(*_phys_inputs(12, "cpu"))
    assert (fused_bigru_lbh.launches > b7) == bool(over.get("use_pallas"))
    assert (lw_solver_noscat_fast.launches > b12) == tc.use_physrad
    for g, w in zip(got[:3], want[:3]):
        e = ((g.cpu() - w).abs().max() / w.abs().max()).item()
        assert e <= 1e-4, e


@pytest.mark.cuda
def test_semi_online_update_on_card_matches_cpu(cuda):
    """One semi-online W 3 update of the v4 arm (f32, remat) on the card
    (B10, B7, B8) against the CPU's from the same weights, as chip_smoke.py
    holds the physics model's updates in lockstep: the loss to 1e-5; each
    parameter's gradient, in the norm of its difference, within 1e-4 of
    the CPU's norm plus 4x the movement of a witness (the CPU's weights
    times 1 + 1e-6 noise) plus 1e-6 of the whole gradient's norm; and
    Adam's first step on the card, from the gradient the card computed,
    within 1e-5 of (|w| + lr) of w - lr g / (|g| + eps)."""
    from climsim_tpu_torch.models import F32, RNNAutoreg
    from climsim_tpu_torch.ops import fused_bigru_heads_init_lbh
    from climsim_tpu_torch.train import RolloutConfig, RolloutTrainer
    rng = np.random.default_rng(6)
    T, B, L, lr = 3, 24, 60, 1e-3
    data = {"x_lev": rng.normal(0, 0.3, (T, B, L, 6)),
            "x_sfc": rng.normal(0, 0.3, (T, B, 24)),
            "y_lev": rng.normal(0, 0.3, (T, B, L, 6)),
            "y_sfc": rng.normal(0, 0.3, (T, B, 8)),
            "sp": np.full((T, B), 1e5),
            "x_lev_raw": np.abs(rng.normal(1.0, 0.1, (T, B, L, 6))),
            "y_lev_raw": rng.normal(0, 1e-4, (T, B, L, 6))}

    def trainer(dev, jitter=False):
        m = RNNAutoreg(nx=6, nx_sfc=24, ny=6, ny_sfc=8, nneur=(32, 32),
                       nh_mem=8, add_pres=False, use_pallas=True,
                       fuse_heads=True, fuse_init=True, policy=F32,
                       device=dev, seed=2)
        if jitter:
            g = torch.Generator().manual_seed(7)
            with torch.no_grad():
                for p in m.parameters():
                    p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=g))
        tr = RolloutTrainer(m, RolloutConfig(
            rollout_schedule={0: T}, loss="mse", lr=lr, remat=True,
            semi_online=True), np.linspace(1e-3, 0, L + 1),
            np.linspace(0, 1, L + 1), xmean_prog=np.zeros((1, 6)),
            xdiv_prog=np.ones((1, 6)), lbd_qc=np.full(L, 10.0),
            lbd_qi=np.full(L, 10.0), device=dev)
        window = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                  for k, v in data.items()}
        return m, tr, window, tr.init(window)

    def cpu_gradients(jitter):
        m, tr, window, mem = trainer("cpu", jitter)
        loss, _ = tr._window_loss(window, mem, None)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in m.named_parameters()}

    m, tr, window, mem = trainer("cuda")
    w0 = {n: p.detach().cpu().clone() for n, p in m.named_parameters()}
    seen = {}
    hook = tr.opt.register_step_pre_hook(lambda *_: seen.update(
        {n: p.grad.detach().cpu().clone()
         for n, p in m.named_parameters()}))
    before = fused_bigru_heads_init_lbh.launches
    _, loss = tr.update(window, mem, None)
    launches = fused_bigru_heads_init_lbh.launches - before
    hook.remove()
    assert launches == 2 * T, launches
    cpu_loss, cpu = cpu_gradients(False)
    _, witness = cpu_gradients(True)
    np.testing.assert_allclose(loss.item(), cpu_loss, rtol=1e-5)
    total = torch.sqrt(sum((g * g).sum() for g in cpu.values())).item()
    assert set(seen) == set(cpu)
    for n, g in cpu.items():
        err = (seen[n] - g).norm().item()
        bound = (1e-4 * g.norm().item() + 4 * (witness[n] - g).norm().item()
                 + 1e-6 * total)
        assert err <= bound, (n, err, bound)
    for n, p in m.named_parameters():
        g = seen[n]
        want = w0[n] - lr * g / (g.abs() + 1e-8)
        assert ((p.detach().cpu() - want).abs()
                <= 1e-5 * (w0[n].abs() + lr)).all(), n


# the bf16-gate step's card checks (ops/gates16.py): its special operands,
# and gates16.cuh's bound on the SFU exponential, 2.5 + 1.223 S |x| ulps
G16_SPECIALS = (0.0, -0.0, 1.0, -1.0, 2.0 ** -133, -2.0 ** -133,
                2.0 ** -126, 1.0 + 2.0 ** -7, 1.0 - 2.0 ** -8, 2.0 ** -9,
                44.0, -44.0, 88.0, -88.0, 1e30, -1e30)


@pytest.mark.cuda
def test_gates16_sigmoid_and_tanh_on_every_bf16_input(cuda):
    """The packed sigmoid and typed tanh give the accurate forms' bits
    (f32 operations rounded to bf16, IEEE expf and division) on all
    65,536 bf16 inputs, and the SFU exponential stays within the bound
    that the tie rule assumes."""
    from climsim_tpu_torch.ops import gates16
    x = gates16.all_bf16()
    out, slow, ulps = gates16.check_unary(x)
    assert gates16.same_bits(out[:, 0], out[:, 1]).all()
    assert gates16.same_bits(out[:, 2], out[:, 3]).all()
    ax = x.view(torch.bfloat16).float().abs()
    for S in (1, 2):
        e = ulps[:, S - 1]
        normal = e >= 0
        assert (e[normal] <= 2.5 + 1.223 * S * ax[normal]).all()
        assert 0 < int(slow[normal, S - 1].sum()) < 100


@pytest.mark.cuda
def test_gates16_step_on_seeded_operand_sets(cuda):
    """The packed step against the accurate one on 10^6 seeded operand
    sets, pairs of lanes as the kernels pack them: values of order 2^-12
    to 2^4, random finite bf16 bit patterns and special values."""
    from climsim_tpu_torch.ops import gates16
    rng = np.random.default_rng(24)
    n = 1_000_000

    def mix(shape):
        v = rng.standard_normal(shape) * np.exp2(rng.integers(-12, 5, shape))
        b = (rng.integers(0, 65536, shape, dtype=np.uint32)
             << 16).view(np.float32)
        with np.errstate(invalid="ignore"):
            b = np.where(np.isfinite(b), b, 0.0)
        sp = np.asarray(G16_SPECIALS)[rng.integers(0, len(G16_SPECIALS),
                                                   shape)]
        u = rng.random(shape)
        return np.where(u < 0.8, v, np.where(u < 0.9, b, sp)).astype(
            np.float32)

    sums = torch.from_numpy(mix((n, 6))).to(cuda)
    bf = torch.from_numpy(mix((n, 4))).to(cuda).to(torch.bfloat16).view(
        torch.int16).contiguous()
    out = gates16.check_step(sums, bf)
    assert gates16.same_bits(out[:, 0], out[:, 1]).all()
