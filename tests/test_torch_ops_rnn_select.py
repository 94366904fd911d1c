"""The GRU kernels' design selector and the f32 cluster design of B7 and B8
on the CPU: ``gru_design`` picks a hand-written design from the dtype and
the widths alone and never refuses a width; ``f32_plan``'s tiling; the
cluster design's weight slices; a torch mirror of its B8 order (the
gradient bundles overwrite the stored gates and the weight gradients are
one GEMM over them, split in fixed ranges) against the plain backward; and
the plain B7 and B8 at a width the kernels used to refuse, against the
JAX package's Pallas kernels in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops.pallas_rnn import _bigru_bwd_pallas_lbh, _bigru_pallas_lbh
from climsim_tpu_torch.ops.pallas_rnn import (_SMEM_MAX, GRU_KINDS,
                                              bigru_bwd_reference_lbh,
                                              bigru_reference_lbh,
                                              cudacore_rows, f32_plan,
                                              find_mma_plan, gru_design,
                                              pack_k, pack_kt)

# the flagship's other widths (nm_in 16, nm 16, ny 6, nf 6); B9's x is the
# initial MLP's 192 and the memory's 16
OTHER = dict(nm_in=16, nm=16, ny=6, nf=6)


def _design(kind, dtype, H):
    CH = 208 if kind == "b9" else H
    return gru_design(kind, dtype, H, CH, **OTHER)


# (kind, H) -> the design bf16 takes: the tensor-core plan up to H 832 for
# every kind (960 for B7 and B8), the CUDA-core design in device scratch
# past it
BF16_CASES = [(k, H, "tensor_core" if H <= (960 if k in ("b7", "b8")
                                            else 832) else "cudacore_scratch")
              for k in GRU_KINDS for H in (832, 840, 960, 968)]
# f32: the cluster design for B7 and B8 at H 128 and 192; the CUDA-core
# design in shared memory up to H 296 (B3), 360 (B8), 440 (B1, B4, B10)
# and 448 (B7, B9), in device scratch past that
WIDEST_SMEM = dict(b1=440, b3=296, b4=440, b7=448, b8=360, b9=448, b10=440)
F32_CASES = [(k, H, "f32_cluster" if k in ("b7", "b8") and H <= 192 else
              "cudacore_smem" if H <= WIDEST_SMEM[k] else "cudacore_scratch")
             for k in GRU_KINDS for H in (128, 192, 360, 368, 512)]


@pytest.mark.parametrize("kind,H,want", BF16_CASES)
def test_selector_bf16(kind, H, want):
    d = _design(kind, torch.bfloat16, H)
    assert d["design"] == want
    assert (d["plan"] is not None) == (want == "tensor_core")


@pytest.mark.parametrize("kind,H,want", F32_CASES)
def test_selector_f32(kind, H, want):
    d = _design(kind, torch.float32, H)
    assert d["design"] == want
    if want == "f32_cluster":
        assert d["plan"] == f32_plan(kind, H)


@pytest.mark.parametrize("kind", GRU_KINDS)
def test_selector_takes_every_width(kind):
    """No kind refuses any H up to 2,048 in either dtype, and the choice
    between shared memory and device scratch follows the CUDA-core
    launchers' tile sizes (4 x 32 f32 bytes a row, 232,448 a block)."""
    for H in range(1, 2049):
        for dt in (torch.bfloat16, torch.float32):
            d = _design(kind, dt, H)
            if d["design"].startswith("cudacore"):
                rows = cudacore_rows(kind, H, 208 if kind == "b9" else H,
                                     **OTHER)
                assert (d["design"] == "cudacore_smem") == \
                    (128 * rows <= _SMEM_MAX), (H, dt)
            elif dt == torch.bfloat16:
                assert d["design"] == "tensor_core" and d["plan"] == \
                    find_mma_plan(kind, H, 208 if kind == "b9" else H,
                                  **OTHER)
            else:
                assert d["design"] == "f32_cluster" and kind in ("b7", "b8")


def test_cudacore_rows_match_the_widest_widths():
    """The widest H (a multiple of 8) whose tiles fit a block's shared
    memory, at the flagship's other widths: B3 296, B8 360, B1, B4 and B10
    440, B7 and B9 448."""
    for kind, widest in WIDEST_SMEM.items():
        fits = [H for H in range(8, 1025, 8)
                if 128 * cudacore_rows(kind, H, 208 if kind == "b9" else H,
                                       **OTHER) <= _SMEM_MAX]
        assert max(fits) == widest, kind


@pytest.mark.parametrize("kind,H,want", [
    ("b7", 128, dict(C=4, H=128, BT=64)),
    ("b8", 128, dict(C=4, H=128, BT=64, BT_bptt=64)),
    ("b7", 192, dict(C=8, H=192, BT=32)),
    ("b8", 192, dict(C=8, H=192, BT=32, BT_bptt=32)),
    ("b8", 20, dict(C=4, H=32, BT=64, BT_bptt=64)),
])
def test_f32_plan(kind, H, want):
    """The physics trunk (H 128) runs clusters of 4 CTAs over 64-column
    tiles in both of B8's phases; at H 192 (the v2 arm in f32) the
    resident slices need clusters of 8 over 32 columns. Each phase's
    shared memory stays under the 232,448 bytes a CTA may use, and a CTA
    has at most 256 threads (2 hidden units x 4 columns each)."""
    p = f32_plan(kind, H)
    assert {k: p[k] for k in want} == want
    for key in ("smem", "smem_bptt"):
        assert p.get(key, 0) <= _SMEM_MAX
    for key in ("BT", "BT_bptt"):
        if key in p:
            assert p["H"] // p["C"] // 2 * p[key] // 4 <= 256
    if kind == "b8" and H == 128:
        assert (p["smem"], p["smem_bptt"]) == (196608, 229376)


def test_f32_plan_refuses_past_its_width():
    assert f32_plan("b7", 200) is None and f32_plan("b8", 256) is None


def test_cluster_slices():
    """pack_k gives CTA r the gate columns g H + r Hc + j of a k-major
    [K, 3H] weight as [K, 3Hc]; pack_kt gives it the input rows r Hc + j
    transposed, [3H, Hc]: each CTA's products are the full products' rows
    of its hidden units."""
    rng = np.random.default_rng(0)
    K, H, C = 12, 16, 4
    Hc = H // C
    w = torch.as_tensor(rng.standard_normal((K, 3 * H)), dtype=torch.float32)
    x = torch.as_tensor(rng.standard_normal((K, 5)), dtype=torch.float32)
    full = (w.t() @ x).reshape(3, H, 5)
    sl = pack_k(w, C)
    assert sl.shape == (C, K, 3 * Hc)
    for r in range(C):
        part = (sl[r].t() @ x).reshape(3, Hc, 5)
        torch.testing.assert_close(part, full[:, r * Hc:(r + 1) * Hc],
                                   rtol=0, atol=1e-6)
    wt = torch.as_tensor(rng.standard_normal((H, 3 * H)), dtype=torch.float32)
    d = torch.as_tensor(rng.standard_normal((3 * H, 5)), dtype=torch.float32)
    slt = pack_kt(wt, C)
    assert slt.shape == (C, 3 * H, Hc)
    for r in range(C):
        torch.testing.assert_close(slt[r].t() @ d,
                                   (wt @ d)[r * Hc:(r + 1) * Hc], rtol=0,
                                   atol=1e-6)


# ------------------------------------------------- the B8 cluster order

def _gates(x, a, bh, h, H):
    """One GRU step channel-major: x the projection [3H, B] (bias in), a =
    Whh^T h [3H, B], bh [3H] -> (h_new, [r; z; n; hn])."""
    r = torch.sigmoid(x[:H] + (a[:H] + bh[:H, None]))
    z = torch.sigmoid(x[H:2 * H] + (a[H:2 * H] + bh[H:2 * H, None]))
    hn = a[2 * H:] + bh[2 * H:, None]
    n = torch.tanh(x[2 * H:] + r * hn)
    return (1 - z) * n + z * h, torch.cat([r, z, n, hn])


def _bundle(g, gates, hp, H):
    """The backward step's bundle [dar; daz; dan; dhn] and g z."""
    r, z, n, hn = gates.split(H)
    dz = g * (hp - n)
    dan = g * (1 - z) * (1 - n * n)
    return torch.cat([dan * hn * r * (1 - r), dz * z * (1 - z), dan,
                      dan * r]), g * z


def b8_cluster_order(res, d_down, d_lasth, BT=16, TK=16, S=3):
    """A torch mirror of the f32 cluster design's B8 (csrc/bigru_f32.cuh):
    the replay stores h and the gate bundles of both sweeps channel-major;
    each BPTT level's gradient bundle [dar; daz; dan; dhn] overwrites the
    level's stored gates, the tiles of BT columns sum it into their bias
    partials, and the carried gradient takes Whh^T d_hh (and d_up W2^T
    d_xp); the weight gradients are then one GEMM per weight over the
    L x B columns in chunks of TK, split in S fixed ranges of chunks whose
    partials are added in order, and the bias gradients the tiles'
    partials added in order."""
    xp, h0u, h0d, whu, bhu, w2, b2, whd, bhd = res
    L, B, H3 = xp.shape
    H = H3 // 3
    up, gu, gh, gd = [None] * L, [None] * L, [None] * L, [None] * L
    h = h0u.t()
    for l in range(L - 1, -1, -1):
        h, gu[l] = _gates(xp[l].t(), whu.t() @ h, bhu, h, H)
        up[l] = h
    h = h0d.t()
    for l in range(L):
        h, gd[l] = _gates(w2.t() @ up[l] + b2[:, None], whd.t() @ h, bhd, h,
                          H)
        gh[l] = h
    tiles = -(-B // BT)
    part = torch.zeros(tiles, 8 * H)

    def tile_sums(d, off):
        for t in range(tiles):
            part[t, off:off + 4 * H] += d[:, t * BT:(t + 1) * BT].sum(1)

    hh = lambda d: torch.cat([d[:2 * H], d[3 * H:]])    # d_hh
    dx = lambda d: d[:3 * H]                             # d_xp
    dup = [None] * L
    dh = d_lasth.t()
    for l in range(L - 1, -1, -1):
        hp = gh[l - 1] if l > 0 else h0d.t()
        gd[l], dh = _bundle(dh + d_down[l].t(), gd[l], hp, H)
        tile_sums(gd[l], 0)
        dh = dh + whd @ hh(gd[l])
        dup[l] = w2 @ dx(gd[l])
    dh0d = dh.t()
    d_xp = torch.empty_like(xp)
    du = torch.zeros(H, B)
    for l in range(L):
        hp = up[l + 1] if l < L - 1 else h0u.t()
        gu[l], du = _bundle(du + dup[l], gu[l], hp, H)
        tile_sums(gu[l], 4 * H)
        d_xp[l] = dx(gu[l]).t()
        du = du + whu @ hh(gu[l])
    dh0u = du.t()

    nb = -(-B // TK)
    Q = L * nb

    def gemm(A, edge, shift, G, rows):
        out = torch.zeros(H, 3 * H)
        for s in range(S):
            acc = torch.zeros(H, 3 * H)
            for q in range(Q * s // S, Q * (s + 1) // S):
                l, b0 = divmod(q, nb)
                a = A[l + shift] if 0 <= l + shift < L else edge
                cols = slice(b0 * TK, (b0 + 1) * TK)
                acc += a[:, cols] @ rows(G[l])[:, cols].t()
            out += acc
        return out

    dwhu = gemm(up, h0u.t(), 1, gu, hh)
    dw2 = gemm(up, None, 0, gd, dx)
    dwhd = gemm(gh, h0d.t(), -1, gd, hh)
    bias = torch.zeros(8 * H)
    for t in range(tiles):
        bias += part[t]
    down, upb = bias[:4 * H], bias[4 * H:]
    return d_xp, dh0u, dh0d, dwhu, hh(upb), dw2, dx(down), dwhd, hh(down)


def _v2_inputs(L, B, H, seed):
    """The residuals (xp, h0s and biases at scale 0.3; the weights at
    lecun scale 1 / sqrt(H), as a trained layer's, so that the gates' sums
    stay of order 1 at any width) and the cotangents of (down, last_h)."""
    rng = np.random.default_rng(seed)
    shapes = [(L, B, 3 * H), (B, H), (B, H), (H, 3 * H), (3 * H,),
              (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,), (L, B, H), (B, H)]
    a = [(0.3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    for i in (3, 5, 7):
        a[i] *= np.float32(1 / (0.3 * np.sqrt(H)))
    return a[:9], a[9], a[10]


@pytest.mark.parametrize("B", [40, 37])
def test_b8_cluster_order_matches_plain(B):
    """The mirror of the new order against the plain backward, each of
    the nine outputs to 2e-6 of its scale (summation order only: the
    bundles are the same values, the gradient sums are regrouped by
    column chunks, splits and tiles). B 37 leaves a ragged last tile and
    chunk."""
    res, dd, dl = _v2_inputs(6, B, 16, seed=B)
    t = lambda x: torch.as_tensor(x)
    res_t = [t(x) for x in res]
    got = b8_cluster_order(res_t, t(dd), t(dl))
    want = bigru_bwd_reference_lbh(res_t, t(dd), t(dl))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        err = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        assert err <= 2e-6, (i, err)


# ------------------------------------ the plain B7 and B8 at H 368 (f32)

def test_plain_b7_b8_at_a_refused_width_match_pallas():
    """H 368, which the CUDA-core B8 used to refuse (its tiles passed a
    block's shared memory) and which now runs in device scratch: the plain
    B7 and B8 against _bigru_pallas_lbh and _bigru_bwd_pallas_lbh in
    interpret mode (L 3, B 8, f32), to 1e-5 of each output's scale."""
    res, dd, dl = _v2_inputs(3, 8, 368, seed=5)
    t = lambda x: torch.as_tensor(x)
    j = lambda x: jnp.asarray(x, jnp.float32)
    got7 = bigru_reference_lbh(*[t(x) for x in res])
    want7 = _bigru_pallas_lbh(*[j(x) for x in res], interpret=True)
    got8 = bigru_bwd_reference_lbh([t(x) for x in res], t(dd), t(dl))
    want8 = _bigru_bwd_pallas_lbh([j(x) for x in res], j(dd), j(dl), None,
                                  True)
    for g, w in list(zip(got7, want7)) + list(zip(got8, want8)):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-5, err
    assert _design("b8", torch.float32, 368)["design"] == "cudacore_scratch"
