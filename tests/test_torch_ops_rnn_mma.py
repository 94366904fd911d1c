"""The Python around the bf16 tensor-core design of B1, B3, B4 and B7-B10 on
the CPU: the tiling plan (resident or streamed weights), the
zero-padding of widths the tiling does not divide, and the packing of
weights into the cluster CTAs' slices, held against the plain versions
and against the JAX package's Pallas kernels in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops.pallas_rnn import (_bigru_bwd_pallas_lbh,
                                        _bigru_heads_cm_bwd_pallas,
                                        _bigru_heads_cm_pallas,
                                        _bigru_heads_init_cm_pallas,
                                        _bigru_heads_init_pallas_lbh,
                                        _bigru_heads_pallas_lbh,
                                        _bigru_pallas_lbh)
from climsim_tpu_torch.ops.pallas_rnn import (_SMEM_MAX, MMA_H_MAX,
                                              _mm, _pad_gates_last, _tmm,
                                              _unpad_gates_last,
                                              bigru_bwd_reference_lbh,
                                              bigru_heads_cm_bwd_reference,
                                              bigru_heads_cm_reference,
                                              bigru_heads_init_cm_reference,
                                              bigru_heads_init_lbh_reference,
                                              bigru_heads_lbh_reference,
                                              bigru_reference_lbh,
                                              mma_plan, pack_rows, pack_t,
                                              pad_cm_args,
                                              pad_heads_init_lbh,
                                              pad_heads_lbh,
                                              pad_init_args, pad_lbh_res,
                                              pad_res, unpack_rows, unpack_t,
                                              unpad_grads, unpad_lbh_grads)

# widths the tiling does not divide: H 20 -> 32, CH 12 -> 16, nm_in 5 -> 16
L, NF, NM_IN, H, CH, NM, NY = 12, 6, 5, 20, 12, 8, 6
C = 4
HP, CHP, NMIP = 32, 16, 16


def _fwd_inputs(B, seed=3):
    rng = np.random.default_rng(seed)
    shapes = [(L, NF, B), (L, NM_IN, B), (H, B), (H, B), (H, NF), (H, 1),
              (3 * H, H), (3 * H, NM_IN), (3 * H, 1), (3 * H, H),
              (3 * H, 1), (3 * H, H), (3 * H, 1), (3 * H, H), (3 * H, 1),
              (NM, H), (NM, 1), (NY, NM), (NY, 1)]
    return [(0.25 * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def _bwd_inputs(B, seed=9):
    """Residuals with a stream of CH rows (the v5 layer's layout), and the
    cotangents of (outmem, lasth)."""
    rng = np.random.default_rng(seed)
    shapes = [(L, CH, B), (L, NM_IN, B), (H, B), (H, B), (3 * H, CH),
              (3 * H, NM_IN), (3 * H, 1), (3 * H, H), (3 * H, 1),
              (3 * H, H), (3 * H, 1), (3 * H, H), (3 * H, 1), (NM, H),
              (NM, 1), (NY, NM), (NY, 1)]
    res = [(0.25 * rng.standard_normal(s)).astype(np.float32)
           for s in shapes]
    res[0] = np.tanh(4 * res[0])
    d_outmem = rng.standard_normal((L, NM + NY, B)).astype(np.float32)
    d_lasth = rng.standard_normal((H, B)).astype(np.float32)
    return res, d_outmem, d_lasth


def _t(arrays, dtype=torch.float32):
    return [torch.as_tensor(a).to(dtype) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


@pytest.mark.parametrize("kind", ["b1", "b3"])
def test_plan_at_flagship_shapes(kind):
    """The flagship (H 192, stream 192, memory 16, heads 16 + 6) takes
    the design's first choice, clusters of 4 CTAs over 64-column tiles,
    with the weights resident, inside the 227 KB a CTA may use, and needs
    no padding: the plan of the slice that brought the design in."""
    p = mma_plan(kind, 192, 192, 16, 16, 6, nf=6)
    assert (p["C"], p["BT"], p["H"], p["CH"], p["nm_in"]) == \
        (4, 64, 192, 192, 16)
    assert p["KXc"] == 56 and p["smem"] <= 232448 and not p["stream"]
    assert p["smem"] == {"b1": 229184, "b3": 228160}[kind]


@pytest.mark.parametrize("kind,H", [("b8", 192), ("b10", 192), ("b8", 128)])
def test_plan_resident_for_b8_b10(kind, H):
    """B8 at the v4 arm's H 192 and the physics trunk's H 128, and B10 at
    the v4 arm's widths (initial MLP 192, memory 16, heads 16 + 6), keep
    their weights resident in clusters of 4 CTAs over 64-column tiles."""
    p = mma_plan(kind, H, H, 16, 16, 6, nf=6)
    assert (p["C"], p["BT"], p["H"], p["stream"]) == (4, 64, H, False)
    assert p["smem"] <= _SMEM_MAX


@pytest.mark.parametrize("H", [384, 448, 512])
@pytest.mark.parametrize("kind", ["b1", "b3", "b8", "b10"])
def test_plan_streams_wide_widths(kind, H):
    """Past H 320 no CTA holds its weight slices next to the state and
    input tiles: the plan streams them through the ring, inside the
    227 KB a CTA may use, carrying the state in one pass."""
    p = mma_plan(kind, H, H, 16, 16, 6, nf=6)
    assert p["stream"] and p["smem"] <= _SMEM_MAX
    assert p["H"] % (8 * p["C"]) == 0 and p["H"] >= H
    assert p["H"] // p["C"] // 8 <= 12 // (p["BT"] // 16) * 2


def test_plan_pads_small_widths():
    p = mma_plan("b3", H, CH, NM_IN, NM, NY)
    assert (p["C"], p["H"], p["CH"], p["nm_in"]) == (C, HP, CHP, NMIP)
    assert p["KXc"] % 8 == 0 and p["KXc"] * p["C"] >= CHP + NMIP


def test_plan_refuses_what_no_tiling_holds():
    """Every kind has a plan up to MMA_H_MAX (832); one step past it, even
    16-column tiles over clusters of 8 with streamed weights leave no room
    for B1's, B3's and B10's state and input tiles, and mma_plan raises
    (the wrappers' selector, gru_design, then runs the CUDA-core design:
    tests/test_torch_ops_rnn_select.py)."""
    assert MMA_H_MAX == 832
    for kind in ("b1", "b3", "b8", "b10"):
        mma_plan(kind, MMA_H_MAX, MMA_H_MAX, 16, 16, 6, nf=6)
    for kind in ("b1", "b3", "b10"):
        with pytest.raises(ValueError, match="no tiling"):
            mma_plan(kind, MMA_H_MAX + 32, MMA_H_MAX + 32, 16, 16, 6, nf=6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padding_leaves_forward_unchanged(dtype):
    """The v6 plain version on the padded arguments gives the same outmem
    and the same real rows of lasth, and zero padded rows: padded hidden
    units start at 0 with zero weights, so r = z = 1/2, n = 0 and h stays
    0. Exact in f32 up to summation order over the added zero terms
    (tolerance 1e-6); in bf16 the same values are rounded at the same
    points (tolerance 0)."""
    a = _t(_fwd_inputs(24), dtype)
    om, lh = bigru_heads_init_cm_reference(*a)
    omp, lhp = bigru_heads_init_cm_reference(*pad_init_args(a, HP, NMIP))
    tol = 1e-6 if dtype == torch.float32 else 0.0
    torch.testing.assert_close(omp, om, rtol=tol, atol=tol)
    torch.testing.assert_close(lhp[:H], lh, rtol=tol, atol=tol)
    assert torch.count_nonzero(lhp[H:]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padding_leaves_gradients_unchanged(dtype):
    """All 17 outputs of the backward's plain version on padded residuals,
    cut back to the real widths, equal those on the real ones (f32 to
    1e-6 of each output's scale: summation order over added zeros; bf16
    to one bf16 ulp of each output's scale, 2**-8, where a sum over added
    zeros lands on the other side of a rounding), and every padded
    gradient row and column is exactly zero."""
    res, dom, dlh = _bwd_inputs(24)
    res, dom, dlh = _t(res, dtype), *_t([dom, dlh], dtype)
    want = bigru_heads_cm_bwd_reference(res, dom, dlh)
    padded = bigru_heads_cm_bwd_reference(
        pad_res(res, HP, CHP, NMIP), dom,
        torch.nn.functional.pad(dlh, (0, 0, 0, HP - H)))
    got = unpad_grads(padded, H, CH, NM_IN)
    rel = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= rel * scale
    dx, dmem, dh0u, dh0d = padded[:4]
    assert torch.count_nonzero(dx[:, CH:]) == 0
    assert torch.count_nonzero(dmem[:, NM_IN:]) == 0
    assert torch.count_nonzero(dh0u[H:]) == 0
    assert torch.count_nonzero(dh0d[H:]) == 0
    # gate-stacked gradients: padded rows of each gate block, padded columns
    for gp, k in zip(padded[4:13], (CH, NM_IN, 1, H, 1, H, 1, H, 1)):
        blocks = gp.reshape(3, HP, gp.shape[1])
        assert torch.count_nonzero(blocks[:, H:]) == 0
        assert torch.count_nonzero(blocks[:, :, k:]) == 0
    assert torch.count_nonzero(padded[13][:, H:]) == 0      # dwlat


@pytest.mark.parametrize("K", [HP, CHP + NMIP])
def test_pack_rows_round_trip_and_product(K):
    """pack_rows puts CTA r's gate rows g Hp + r Hc + jj at [r][g Hc + jj];
    unpacking gives the weight back, and the per-CTA products reassembled
    by gate equal _mm on the whole weight (exactly: the same dot
    products)."""
    rng = np.random.default_rng(1)
    w = torch.as_tensor(rng.standard_normal((3 * HP, K)), dtype=torch.float32)
    x = torch.as_tensor(rng.standard_normal((K, 7)), dtype=torch.float32)
    p = pack_rows(w, C)
    Hc = HP // C
    assert p.shape == (C, 3 * Hc, K) and p.is_contiguous()
    assert torch.equal(unpack_rows(p), w)
    out = torch.empty(3 * HP, 7)
    for r in range(C):
        y = _mm(p[r], x)
        for g in range(3):
            out[g * HP + r * Hc:g * HP + (r + 1) * Hc] = y[g * Hc:(g + 1) * Hc]
    torch.testing.assert_close(out, _mm(w, x), rtol=0, atol=0)


@pytest.mark.parametrize("N,K,rows,width", [
    (3 * HP, HP, HP // C, 3 * HP),          # Whh^T, W2^T slices
    (3 * HP, CHP + NMIP, 8, 3 * HP),        # [W1h | W1m]^T, 8 rows a CTA
    (NM, HP, HP // C, 16)])                 # Wlat^T, nm padded to 16
def test_pack_t_round_trip_and_product(N, K, rows, width):
    """pack_t slices w^T by input rows (CTA r computes the gradient of
    inputs [r rows, (r + 1) rows)); unpacking gives the weight back and
    the stacked per-CTA products equal _tmm (exact: the same sums)."""
    rng = np.random.default_rng(2)
    w = torch.as_tensor(rng.standard_normal((N, K)), dtype=torch.float32)
    d = torch.as_tensor(rng.standard_normal((N, 5)), dtype=torch.float32)
    p = pack_t(w, C, rows, width)
    assert p.shape == (C, rows, width) and p.is_contiguous()
    assert torch.equal(unpack_t(p, N, K), w)
    dp = torch.nn.functional.pad(d, (0, 0, 0, width - N))
    out = torch.cat([_mm(p[r], dp) for r in range(C)])[:K]
    torch.testing.assert_close(out, _tmm(w, d), rtol=0, atol=0)


@pytest.mark.parametrize("B", [16, 20])
def test_padded_plain_forward_matches_pallas_interpret(B):
    """The v6 plain version at the padded widths, cut back, against the
    JAX Pallas kernel (interpret mode, explicit float32) on the real
    widths; tolerance as tests/test_torch_ops_rnn.py's f32 case."""
    a = _fwd_inputs(B)
    om, lh = bigru_heads_init_cm_reference(
        *pad_init_args(_t(a), HP, NMIP))
    jom, jlh = _bigru_heads_init_cm_pallas(*_j(a), None, True, True)
    np.testing.assert_allclose(om.numpy(), np.asarray(jom), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(lh[:H].numpy(), np.asarray(jlh), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("B", [16, 20])
def test_padded_plain_backward_matches_pallas_interpret(B):
    """The backward's plain version at the padded widths, cut back, against
    the JAX Pallas backward (interpret mode, explicit float32) on the real
    widths; tolerance as tests/test_torch_ops_rnn_bwd.py's (the JAX
    suite's for its backward kernels)."""
    res, dom, dlh = _bwd_inputs(B)
    padded = bigru_heads_cm_bwd_reference(
        pad_res(_t(res), HP, CHP, NMIP), *_t([dom, np.pad(
            dlh, ((0, HP - H), (0, 0)))]))
    got = unpad_grads(padded, H, CH, NM_IN)
    want = _bigru_heads_cm_bwd_pallas(_j(res), *_j([dom, dlh]),
                                      interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-4,
                                   atol=2e-5)


# ------------------------------------------------------------ B8 and B10
# batch-major: widths the tiling does not divide, H 20 -> 32, the initial
# MLP 12 -> 32 (B10 pads it to 8 C), memory 5 -> 16; ragged batches
L8 = 6
CH10P = 32


def _b8_inputs(B, seed=5):
    """B8's residuals (xp [L, B, 3H], h0s [B, H], [in, out] weights at
    scale 0.3, flat biases) and the cotangents of (down, last_h)."""
    rng = np.random.default_rng(seed)
    shapes = [(L8, B, 3 * H), (B, H), (B, H), (H, 3 * H), (3 * H,),
              (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,), (L8, B, H),
              (B, H)]
    a = [(0.3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    return a[:9], a[9], a[10]


def _b10_inputs(B, seed=6):
    rng = np.random.default_rng(seed)
    shapes = [(L8, B, NF), (L8, B, NM_IN), (B, H), (B, H), (NF, CH), (CH,),
              (CH + NM_IN, 3 * H), (3 * H,), (H, 3 * H), (3 * H,),
              (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,), (H, NM), (NM,),
              (NM, NY), (NY,)]
    return [(0.25 * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def _pad_b8(res, dd, dl):
    """The residuals and cotangents as B8's wrapper pads them."""
    return (pad_lbh_res(res, HP),
            torch.nn.functional.pad(dd, (0, HP - H)),
            torch.nn.functional.pad(dl, (0, HP - H)))


@pytest.mark.parametrize("lead", [(), (3,), (2, 5)])
def test_gate_padding_of_the_last_dimension_round_trips(lead):
    """[..., 3H] -> [..., 3Hp] puts gate block g's unit j at g Hp + j, zero
    elsewhere; cutting back gives the tensor itself."""
    rng = np.random.default_rng(4)
    t = torch.as_tensor(rng.standard_normal((*lead, 3 * H)),
                        dtype=torch.float32)
    p = _pad_gates_last(t, HP)
    assert p.shape == (*lead, 3 * HP)
    for g in range(3):
        assert torch.equal(p[..., g * HP:g * HP + H], t[..., g * H:(g + 1) * H])
        assert torch.count_nonzero(p[..., g * HP + H:(g + 1) * HP]) == 0
    assert torch.equal(_unpad_gates_last(p, H), t)


def test_b8_weight_slices_are_the_wrappers_layout():
    """B8's wrapper hands the kernel pack_rows of each [in, out] weight's
    transpose (the replay's gate slices) and pack_t of it, which is the
    weight cut into C input-row slices [C, Hc, 3Hp]: the stacked
    per-slice transposed products equal the whole one (exact)."""
    rng = np.random.default_rng(7)
    w = torch.as_tensor(rng.standard_normal((H, 3 * H)), dtype=torch.float32)
    wp = pad_lbh_res((torch.zeros(1, 1, 3 * H), torch.zeros(1, H),
                      torch.zeros(1, H), w, torch.zeros(3 * H), w,
                      torch.zeros(3 * H), w, torch.zeros(3 * H)), HP)[3]
    assert wp.shape == (HP, 3 * HP)
    rows = pack_rows(wp.t(), C)
    assert torch.equal(unpack_rows(rows), wp.t())
    sl = pack_t(wp.t(), C, HP // C)
    assert torch.equal(sl, wp.reshape(C, HP // C, 3 * HP))
    d = torch.as_tensor(rng.standard_normal((3 * HP, 5)), dtype=torch.float32)
    out = torch.cat([_mm(sl[r], d) for r in range(C)])
    torch.testing.assert_close(out, _tmm(wp.t(), d), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b8_padding_leaves_gradients_unchanged(dtype):
    """B8's nine outputs on the residuals padded as its wrapper pads them,
    cut back, equal those on the real widths (f32 to 1e-6 of each
    output's scale, bf16 to one bf16 ulp of it, 2**-8: summation order
    over added zeros), and every padded row and column is exactly zero."""
    res, dd, dl = _b8_inputs(13)
    res, dd, dl = _t(res, dtype), *_t([dd, dl], dtype)
    want = bigru_bwd_reference_lbh(res, dd, dl)
    padded = bigru_bwd_reference_lbh(*_pad_b8(res, dd, dl))
    got = unpad_lbh_grads(padded, H)
    rel = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= rel * scale
    d_xp, dh0u, dh0d = padded[:3]
    blocks = d_xp.reshape(L8, 13, 3, HP)
    assert torch.count_nonzero(blocks[..., H:]) == 0
    assert torch.count_nonzero(dh0u[:, H:]) == 0
    assert torch.count_nonzero(dh0d[:, H:]) == 0
    for gw in padded[3::2]:                  # [Hp, 3Hp] weight gradients
        assert torch.count_nonzero(gw[H:]) == 0
        assert torch.count_nonzero(gw.reshape(HP, 3, HP)[..., H:]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b10_padding_leaves_forward_unchanged(dtype):
    """B10's plain version on the arguments padded as its wrapper pads them
    (H 20 -> 32, the initial MLP 12 -> 32, memory 5 -> 16) gives the same
    out and mem and the same real columns of last_h, and zero padded
    columns (f32 to 1e-6: summation order over added zeros; bf16 exactly:
    the same values rounded at the same points)."""
    a = _t(_b10_inputs(11), dtype)
    out, mem, lh = bigru_heads_init_lbh_reference(*a)
    p = pad_heads_init_lbh(a, HP, CH10P, NMIP)
    assert p[4].shape == (NF, CH10P) and p[6].shape == (CH10P + NMIP, 3 * HP)
    outp, memp, lhp = bigru_heads_init_lbh_reference(*p)
    tol = 1e-6 if dtype == torch.float32 else 0.0
    torch.testing.assert_close(outp, out, rtol=tol, atol=tol)
    torch.testing.assert_close(memp, mem, rtol=tol, atol=tol)
    torch.testing.assert_close(lhp[:, :H], lh, rtol=tol, atol=tol)
    assert torch.count_nonzero(lhp[:, H:]) == 0


@pytest.mark.parametrize("B", [16, 13])
def test_padded_plain_b8_matches_pallas_interpret(B):
    """B8's plain version at the padded width, cut back, against the JAX
    Pallas backward (interpret mode, f32) on the real widths, B 13 ragged
    against its 16-row tile: each output to 1e-5 of its scale, as
    tests/test_torch_ops_rnn_v2_bwd.py holds the unpadded one."""
    res, dd, dl = _b8_inputs(B)
    got = unpad_lbh_grads(bigru_bwd_reference_lbh(
        *_pad_b8(_t(res), *_t([dd, dl]))), H)
    want = _bigru_bwd_pallas_lbh(_j(res), *_j([dd, dl]), None, True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("B", [16, 13])
def test_padded_plain_b10_matches_pallas_interpret(B):
    """B10's plain version at the padded widths, cut back, against the JAX
    Pallas forward (interpret mode, f32, 8-column tiles, B 13 ragged) on
    the real widths; tolerance as tests/test_torch_ops_rnn_v34.py's."""
    a = _b10_inputs(B)
    out, mem, lh = bigru_heads_init_lbh_reference(
        *pad_heads_init_lbh(_t(a), HP, CH10P, NMIP))
    want = _bigru_heads_init_pallas_lbh(*_j(a), 8, True, True)
    for g, w in zip((out, mem, lh[:, :H]), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-6)


# ------------------------------------------------------------ B7 and B9
# B7's arguments are B8's residuals (pad_lbh_res); B9's input x [L, B, nx]
# is the X tile itself, so only its width is padded, to whole 16-wide
# k-steps (nx 12 -> 16)
NX9, KX9 = 12, 16


def _b9_inputs(B, seed=8):
    rng = np.random.default_rng(seed)
    shapes = [(L8, B, NX9), (B, H), (B, H), (NX9, 3 * H), (3 * H,),
              (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,), (H, 3 * H),
              (3 * H,), (H, NM), (NM,), (NM, NY), (NY,)]
    return [(0.25 * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


@pytest.mark.parametrize("kind,H_,CH_", [("b7", 192, 0), ("b7", 128, 0),
                                         ("b9", 192, 208)])
def test_plan_resident_for_b7_b9(kind, H_, CH_):
    """B7 at the v2 arm's H 192 and the physics trunk's H 128, and B9 at
    the v3 arm's widths (x 208 wide: the initial MLP's 192 and the memory's
    16; heads 16 + 6), keep their weights resident in clusters of 4 CTAs
    over 64-column tiles; B9's X tile needs no padding at 208. B7 has no
    heads, initial MLP or input tile, so its CTA needs less than B8's and
    B10's (the source's smem_bytes)."""
    p = mma_plan(kind, H_, CH_, 0, 16, 6)
    assert (p["C"], p["BT"], p["H"], p["stream"]) == (4, 64, H_, False)
    assert p["nm_in"] == 0 and p["CH"] == CH_
    assert p["smem"] == {("b7", 192): 217600, ("b7", 128): 121856,
                         ("b9", 192): 228576}[kind, H_]


@pytest.mark.parametrize("H_", [384, 640, 832])
@pytest.mark.parametrize("kind", ["b7", "b9"])
def test_plan_b7_b9_stream_up_to_the_widest(kind, H_):
    """From H 384 to MMA_H_MAX (832) B7 and B9 stream their weight slices
    through the ring, inside the 227 KB a CTA may use, carrying the state
    in one pass; B9's 208-wide input stays unpadded."""
    p = mma_plan(kind, H_, 208, 0, 16, 6)
    assert p["stream"] and p["smem"] <= _SMEM_MAX
    assert p["H"] % (8 * p["C"]) == 0 and p["H"] >= H_
    assert p["H"] // p["C"] // 8 <= 12 // (p["BT"] // 16) * 2
    assert p["CH"] == (208 if kind == "b9" else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b7_padding_leaves_forward_unchanged(dtype):
    """B7's plain version on its arguments padded as B8's wrapper pads
    them (pad_lbh_res, H 20 -> 32) gives the same down and last_h in the
    real columns and zeros in the padded ones (f32 to 1e-6: summation
    order over added zeros; bf16 exactly: the same values rounded at the
    same points)."""
    res, _, _ = _b8_inputs(13)
    res = _t(res, dtype)
    down, lh = bigru_reference_lbh(*res)
    downp, lhp = bigru_reference_lbh(*pad_lbh_res(res, HP))
    tol = 1e-6 if dtype == torch.float32 else 0.0
    torch.testing.assert_close(downp[..., :H], down, rtol=tol, atol=tol)
    torch.testing.assert_close(lhp[:, :H], lh, rtol=tol, atol=tol)
    assert torch.count_nonzero(downp[..., H:]) == 0
    assert torch.count_nonzero(lhp[:, H:]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b9_padding_leaves_forward_unchanged(dtype):
    """B9's plain version on the arguments padded as its wrapper pads them
    (H 20 -> 32, x's width 12 -> 16) gives the same out and mem and the
    same real columns of last_h, and zero padded columns (f32 to 1e-6,
    bf16 exactly, as B10's)."""
    a = _t(_b9_inputs(11), dtype)
    out, mem, lh = bigru_heads_lbh_reference(*a)
    p = pad_heads_lbh(a, HP, KX9)
    assert p[0].shape == (L8, 11, KX9) and p[3].shape == (KX9, 3 * HP)
    assert torch.count_nonzero(p[0][..., NX9:]) == 0
    outp, memp, lhp = bigru_heads_lbh_reference(*p)
    tol = 1e-6 if dtype == torch.float32 else 0.0
    torch.testing.assert_close(outp, out, rtol=tol, atol=tol)
    torch.testing.assert_close(memp, mem, rtol=tol, atol=tol)
    torch.testing.assert_close(lhp[:, :H], lh, rtol=tol, atol=tol)
    assert torch.count_nonzero(lhp[:, H:]) == 0


@pytest.mark.parametrize("B", [16, 13])
def test_padded_plain_b7_matches_pallas_interpret(B):
    """B7's plain version at the padded width, cut back, against the JAX
    Pallas forward (interpret mode, f32, 8-column tiles, B 13 ragged) on
    the real widths; tolerance as tests/test_torch_ops_rnn_v2.py's."""
    res, _, _ = _b8_inputs(B)
    down, lh = bigru_reference_lbh(*pad_lbh_res(_t(res), HP))
    jd, jl = _bigru_pallas_lbh(*_j(res), 8, True, True)
    np.testing.assert_allclose(down[..., :H].numpy(), np.asarray(jd),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(lh[:, :H].numpy(), np.asarray(jl), rtol=2e-5,
                               atol=1e-6)


@pytest.mark.parametrize("B", [16, 13])
def test_padded_plain_b9_matches_pallas_interpret(B):
    """B9's plain version at the padded widths, cut back, against the JAX
    Pallas forward (interpret mode, f32, 8-column tiles, B 13 ragged) on
    the real widths; tolerance as tests/test_torch_ops_rnn_v34.py's."""
    a = _b9_inputs(B)
    out, mem, lh = bigru_heads_lbh_reference(
        *pad_heads_lbh(_t(a), HP, KX9))
    want = _bigru_heads_pallas_lbh(*_j(a), 8, True, True)
    for g, w in zip((out, mem, lh[:, :H]), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-6)


# ---------------------------------------- B4 on tensor cores


@pytest.mark.parametrize("H_,nm_in", [(192, 16), (192, 0), (384, 16),
                                      (384, 0), (832, 16), (832, 0)])
def test_plan_b4(H_, nm_in):
    """B4 at the v5 arm's widths (stream 192, memory 16 or none, heads
    16 + 6): clusters of 4 CTAs over 64-column tiles with the weights
    resident at H 192, in the 228,576 bytes B9 takes (the down sweep is
    the largest phase of both); streamed from H 384 to MMA_H_MAX (832).
    x keeps its 192 rows and the memory its 16 (none: 0), whole 16-row
    k-steps already."""
    p = mma_plan("b4", H_, 192, nm_in, 16, 6)
    assert p["CH"] == 192 and p["nm_in"] == nm_in
    assert p["smem"] <= _SMEM_MAX and p["H"] % (8 * p["C"]) == 0
    assert p["H"] // p["C"] // 8 <= 12 // (p["BT"] // 16) * 2
    assert p["stream"] == (H_ > 320)
    if H_ == 192:
        assert (p["C"], p["BT"], p["smem"]) == (4, 64, 228576)
    assert p["BT"] <= 64          # the swizzle period of the X tile


def test_plan_b4_pads_the_memory_to_whole_k_steps():
    """x keeps its CH rows (the kernel reads them where they lie); the
    memory takes the zero rows that make CH + nm_in a multiple of 16, so
    the tile stacks both into whole k-steps: CH 12 + nm_in 5 -> 12 + 20."""
    p = mma_plan("b4", H, CH, NM_IN, NM, NY)
    assert (p["C"], p["H"], p["CH"], p["nm_in"]) == (C, HP, CH, 20)
    assert mma_plan("b4", H, CH, 0, NM, NY)["nm_in"] == 4


def _b4_args(B, seed=9):
    """The v5 forward's 17 arguments at the widths the tiling pads (H 20,
    CH 12, nm_in 5), numpy."""
    return _bwd_inputs(B, seed)[0]


@pytest.mark.parametrize("hoist", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b4_padding_leaves_forward_unchanged(dtype, hoist):
    """B4's plain version on its arguments padded as its tensor-core
    wrapper pads them (pad_cm_args: H 20 -> 32, the memory 5 -> 20 rows,
    x unpadded and not copied) gives the same outmem and the same real
    rows of lasth, and zero padded rows (f32 to 1e-6: summation order
    over added zeros; bf16 exactly: the same values rounded at the same
    points), with the projections rounded or not."""
    a = _t(_b4_args(11), dtype)
    om, lh = bigru_heads_cm_reference(*a, hoist_proj=hoist)
    p = pad_cm_args(a, HP, 20)
    assert p[0] is a[0] and p[1].shape == (L, 20, 11)
    assert p[5].shape == (3 * HP, 20) and p[7].shape == (3 * HP, HP)
    omp, lhp = bigru_heads_cm_reference(*p, hoist_proj=hoist)
    tol = 1e-6 if dtype == torch.float32 else 0.0
    torch.testing.assert_close(omp, om, rtol=tol, atol=tol)
    torch.testing.assert_close(lhp[:H], lh, rtol=tol, atol=tol)
    assert torch.count_nonzero(lhp[H:]) == 0


@pytest.mark.parametrize("hoist", [False, True])
@pytest.mark.parametrize("B", [16, 13])
def test_padded_plain_b4_matches_pallas_interpret(B, hoist):
    """B4's plain version at the padded widths, cut back, against the JAX
    Pallas forward (``_bigru_heads_cm_pallas`` in interpret mode, f32,
    8-column tiles, B 13 ragged) on the real widths, with the projections
    hoisted (its second body) and not; tolerance as
    tests/test_torch_ops_rnn_v5.py's."""
    a = _b4_args(B)
    om, lh = bigru_heads_cm_reference(*pad_cm_args(_t(a), HP, 20),
                                      hoist_proj=hoist)
    jom, jlh = _bigru_heads_cm_pallas(*_j(a), 8, True, True, hoist)
    np.testing.assert_allclose(om.numpy(), np.asarray(jom), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(lh[:H].numpy(), np.asarray(jlh), rtol=2e-5,
                               atol=2e-6)
