// The bf16 tensor-core fused emulator forward, one kernel body for four
// instances: the v6 channel-major forward (B1, bigru_heads_init_cm.cu),
// the v5 channel-major one (B4, bigru_heads_cm.cu), the v4 batch-major
// one (B10) and the v3 batch-major one (B9, both bigru_heads_lbh.cu). Per
// column: the initial MLP xi_l = dt(tanh(dt(Winit feat_l + binit))) (B4,
// B9: none), the up GRU sweep on the projection of [xi_l || mem_l] (B4:
// of the given [x_l || mem_l]; B9: of the given x_l), the down GRU sweep
// on the projection of the up states, and the latent and output heads.
//
// A column tile of BT columns is owned by a cluster of C CTAs (BT 64, C 4
// at H 192: 338 clusters at 21,600 columns, ~10 waves of 33 on 132 SMs;
// the wrappers pick BT and C from the widths, bigru_mma.cuh notes); CTA r
// owns hidden units [r H/C, (r + 1) H/C) and keeps its gate slices of
// [W1h | W1m] and Whh_up (then W2, Whh_dn and Wlat) in shared memory for
// the whole sweep (one cp.async load per sweep; 229 KB a CTA with the
// buffers at H 192), or from H ~ 320 on streams them through a ring
// (bigru_mma.cuh). Per level each CTA runs mma.sync for its [BT x 3H/C]
// gate block, the gate arithmetic in f32, keeps its f32 state slice in
// registers, and writes its dt(h) columns into every cluster CTA's next
// buffer through distributed shared memory; one cluster barrier per
// level. The initial MLP (6 inputs: CUDA cores) is split the same way:
// each CTA evaluates its CH/C rows of xi for the next level and writes
// them to every CTA; every CTA keeps the level's memory rows itself. The
// level's raw inputs (feat, mem_in) and the down sweep's slice of the up
// stream are loaded into registers a level ahead. The latent head is an
// mma on the full dt(h2) of the previous level, one m16 tile per CTA, the
// output head (nm inputs) on CUDA cores. The up stream stays a [L, H, B]
// bf16 device scratch: each CTA stores its rows, coalesced. The up
// sweep's input projection stays in the serial chain: a hoisted [L, 3H,
// B] projection would add ~3 GB of traffic a call while the chain is
// bound by latency, not by the projection's share of the products. What
// bounds a level is latency: with one CTA a SM, its 12 warps run the
// products, the gates, xi and the barrier one after the other (PERF.md).
//
// The template picks the layout of the raw inputs and the heads' outputs,
// the rounding of the projections and where the up sweep's input comes
// from (and kG16 the gate arithmetic: f32, or with acc32=False bf16, every
// projection then rounded to bf16 as the TPU bodies round it):
//   kBM false (B1): feat [L, nf, B], mem_in [L, nmi, B] in, outmem
//     [L, nm + ny, B] out; kRoundXP true: both sweeps' projections are
//     rounded to bf16 before the gates, as the v6 TPU body stores them;
//   kBM true (B10): feat [L, B, nf], mem_in [L, B, nmi] in, out [L, B, ny]
//     and mem [L, B, nm] out; kRoundXP false: both projections stay f32,
//     as the v4 TPU body keeps them. The up projection runs as one
//     product over the concatenated K = [xi || mem_in] where the TPU body
//     sums two (K = CH and K = nm_in): the operands are the same bf16
//     values, so only the f32 summation order differs.
//   kLoadX true (B9, with kBM true, kRoundXP false as the v3 TPU body
//     keeps its projections): no initial MLP and no memory rows; the
//     level's x_l [B, KX] (KX = CH, a multiple of 16; nf = nmi = 0) is
//     the X tile itself, copied by every CTA of the cluster from global
//     memory with cp.async into its next X buffer one level ahead (64
//     columns x 208 bf16, 27 KB a level at the v3 shapes), where B10 runs
//     xi_own and the memory rows. The copy needs no cluster exchange.
//   kLoadX true with kBM false (B4; kRoundXP as the caller's hoist_proj,
//     the v5 TPU bodies' two roundings): the X tile is the level's
//     channel-major x_l [CH, B] stacked over mem_l [nmi, B] (CH + nmi a
//     multiple of 16; nf = 0), which B9's batch-major tile cannot take
//     without a transposed copy. Every CTA copies it with cp.async a level
//     ahead as it lies, a 16-byte chunk of 8 columns of one row at a time,
//     into a [KX][BT] tile whose chunks are XOR-swizzled instead of padded
//     (xt_chunk: 53 KB for both buffers at the v5 shapes, against 60 KB
//     with padded [KX][BT + 8] rows and B9's 55 KB; at H 192 the down
//     sweep's 229 KB is the CTA's largest phase either way), and the up
//     product reads its A fragments with ldmatrix.trans. Neither a
//     staging buffer for a transpose in shared memory nor a register
//     prefetch of the tile fits the CTA (3.9 KB of shared memory and no
//     registers to spare at 160 a thread), and neither the cluster
//     exchange a split copy would need nor a transposing copy on the host
//     is paid.
// h0u, h0d and lasth are channel-major [H, B] in both (the v4 wrapper
// transposes its [B, H] ones: 8 MB each at the v4 shapes). Widths are
// padded by the wrappers (H and CH to a multiple of 8 C, mem_in to 16)
// with zero weights, which leaves every real output unchanged.
#pragma once
#include "bigru_mma.cuh"

namespace bmma {

struct FwdParams {
  const bf16 *feat, *mem_in, *h0u, *h0d, *winit, *binit;
  const bf16 *wx_up, *b1, *wh_up, *bh_up, *wx_dn, *b2, *wh_dn, *bh_dn;
  const bf16 *wlat, *blat, *wout, *bout;
  bf16 *mem, *out, *lasth, *up;
  // per level: elements between two levels of mem and out, and the
  // stride of each (HeadOut: B channel-major, nm or ny batch-major)
  size_t mem_lvl, out_lvl;
  int mem_ld, out_ld;
  int L, nf, CH, nmi, H, nm, ny, B, C, BT;
};

// xi for the CTA's rows [k0, k0 + CHc) of the level whose raw features are
// raw [nf][BT] f32: dt(tanh(dt(Winit feat + binit))), into X[b][k0 + .]
// of every CTA of the cluster; with kG16 the tanh is the TPU body's typed
// bf16 one (gates16::tanh2, four pairs a thread), as its bf16 input gives
// it
template <bool kG16>
__device__ __forceinline__ void xi_own(cg::cluster_group& cl, bf16* X,
                                       int ldx, const float* raw,
                                       const float* wi, const float* bi,
                                       int nf, int CHc, int k0, int BT) {
  for (int e = threadIdx.x; e < CHc / 8 * BT; e += NTH) {
    const int c = e / BT, b = e % BT;
    float v[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int jj = c * 8 + kk;
      float a = 0.0f;
      for (int f = 0; f < nf; ++f) a = fmaf(wi[jj * nf + f], raw[f * BT + b], a);
      v[kk] = kG16 ? a + bi[jj] : rnd(tanh_(rnd(a + bi[jj])));
    }
    uint4 v4;
    if constexpr (kG16) {
      using gates16::bits, gates16::pk, gates16::tanh2;
      v4 = make_uint4(
          bits(tanh2(pk(v[0], v[1]))), bits(tanh2(pk(v[2], v[3]))),
          bits(tanh2(pk(v[4], v[5]))), bits(tanh2(pk(v[6], v[7]))));
    } else {
      v4 = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                      pack2(v[4], v[5]), pack2(v[6], v[7]));
    }
    for (int q = 0; q < static_cast<int>(cl.num_blocks()); ++q)
      *reinterpret_cast<uint4*>(
          cl.map_shared_rank(X + b * ldx + k0 + c * 8, q)) = v4;
  }
}

__host__ __device__ inline size_t fwd_smem(int H, int C, int CH, int nmi,
                                           int nf, int nm, int ny, int BT,
                                           bool stream, bool xt) {
  const int Hc = H / C, nm8 = (nm + 7) / 8 * 8;
  Smem su(nullptr), sd(nullptr);
  up_bufs(su, Hc, CH + nmi, H, BT, nf, nf, CH / C, stream, xt);
  dn_bufs(sd, Hc, H, BT, nm8, nm + ny * nm + ny, stream);
  return su.off > sd.off ? su.off : sd.off;
}

// The level's batch-major input x_l [B][K] (K a multiple of 8, rows 16-byte
// aligned) into a [BT][ldx] smem tile with cp.async, zeros past B; the
// caller commits and waits
__device__ __forceinline__ void load_x_tile(bf16* X, int ldx, const bf16* x_l,
                                            int K, int B, int col0, int BT) {
  const int cpr = K / 8;
  for (int e = threadIdx.x; e < BT * cpr; e += NTH) {
    const int b = e / cpr, c = e % cpr, col = col0 + b;
    bf16* dst = X + b * ldx + c * 8;
    if (col < B)
      cp_async16(dst, x_l + static_cast<size_t>(col) * K + c * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// B4's level, x_l [CH, B] stacked over mem_l [KX - CH, B] (channel-major),
// into a [KX][BT] smem tile in the swizzled layout of xt_chunk: a 16-byte
// chunk of 8 columns of one row with cp.async where it lies inside the
// batch and the rows are 16-byte aligned (al: B a multiple of 8), else
// element by element with zeros past B (the ragged last tile, or any B
// not a multiple of 8); the caller commits and waits
__device__ __forceinline__ void load_x_tile_t(bf16* X, const bf16* x_l,
                                              const bf16* m_l, int CH,
                                              int KX, int B, int col0,
                                              int BT, bool al) {
  const int cpr = BT / 8;
  for (int e = threadIdx.x; e < KX * cpr; e += NTH) {
    const int k = e / cpr, c = e % cpr, col = col0 + c * 8;
    const bf16* src = (k < CH ? x_l + static_cast<size_t>(k) * B
                              : m_l + static_cast<size_t>(k - CH) * B) + col;
    bf16* dst = X + xt_chunk(k, c, cpr);
    if (al && col + 8 <= B) {
      cp_async16(dst, src);
    } else {
      unsigned short u[8];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        u[kk] = col + kk < B
                    ? __ldg(reinterpret_cast<const unsigned short*>(src) + kk)
                    : 0;
      *reinterpret_cast<uint4*>(dst) = make_uint4(
          u[0] | (static_cast<unsigned>(u[1]) << 16),
          u[2] | (static_cast<unsigned>(u[3]) << 16),
          u[4] | (static_cast<unsigned>(u[5]) << 16),
          u[6] | (static_cast<unsigned>(u[7]) << 16));
    }
  }
}

template <bool kBM, bool kRoundXP, bool kStream, bool kLoadX, bool kG16>
__global__ void __launch_bounds__(NTH, 1) mma_fwd_kernel(FwdParams p) {
  // B4: the X tile loaded channel-major, stored transposed
  constexpr bool kXT = kLoadX && !kBM;
  cg::cluster_group cl = cg::this_cluster();
  const int C = p.C, BT = p.BT, r = static_cast<int>(cl.block_rank());
  const int H = p.H, Hc = H / C, L = p.L, B = p.B, nf = p.nf, nmi = p.nmi;
  const int CH = p.CH, CHc = CH / C;
  const int nm = p.nm, ny = p.ny, nm8 = (nm + 7) / 8 * 8;
  const int KX = CH + nmi, LDX = KX + PAD, LDH = H + PAD;
  const int XS = BT * (kXT ? KX : LDX);   // one X buffer
  const int col0 = (blockIdx.x / C) * BT, tid = threadIdx.x;
  const size_t sB = B;
  const Warp w(BT);
  const Tiles tl(w, Hc / 8);
  extern __shared__ __align__(16) char smem_raw[];
  GruRegs R;

  // ---- up sweep, surface (l = L-1) to top
  {
    Smem s(smem_raw);
    const UpBufs u = up_bufs(s, Hc, KX, H, BT, nf, nf, CHc, kStream, kXT);
    const bf16* gx = p.wx_up + static_cast<size_t>(r) * 3 * Hc * KX;
    const bf16* gh = p.wh_up + static_cast<size_t>(r) * 3 * Hc * H;
    load_slice<kStream>(u.wx, gx, 3 * Hc, KX);
    load_slice<kStream>(u.wh, gh, 3 * Hc, H);
    const WSlice wx = slice<kStream>(u.wx, gx, KX);
    const WSlice wh = slice<kStream>(u.wh, gh, H);
    if constexpr (!kLoadX) {       // B4 and B9 have no initial MLP
      for (int e = tid; e < CHc * nf; e += NTH)
        u.wi[e] = b2f(p.winit[static_cast<size_t>(r) * CHc * nf + e]);
      for (int e = tid; e < CHc; e += NTH) u.bi[e] = b2f(p.binit[r * CHc + e]);
    }
    load_tile_t(u.h, LDH, p.h0u, H, B, col0, BT);
    gru_regs_init(R, w, tl, r, Hc, H, p.b1, p.bh_up, p.h0u, B, col0);
    const auto feat_l = [&](int l) { return p.feat + l * nf * sB; };
    const auto mem_l = [&](int l) { return p.mem_in + l * nmi * sB; };
    const auto x_l = [&](int l) { return p.feat + l * CH * sB; };
    const bool al = B % 8 == 0 &&
        ((reinterpret_cast<uintptr_t>(p.feat) |
          reinterpret_cast<uintptr_t>(p.mem_in)) & 15) == 0;
    const auto load_x = [&](bf16* X, int l) {
      if constexpr (kXT)
        load_x_tile_t(X, x_l(l), mem_l(l), CH, KX, B, col0, BT, al);
      else
        load_x_tile(X, LDX, x_l(l), KX, B, col0, BT);
    };
    RawPF pf;
    if constexpr (kLoadX) {
      load_x(u.x, L - 1);
      cp_async_wait_all();
      __syncthreads();
    } else {
      pf.fetch<kBM>(feat_l(L - 1), nf, mem_l(L - 1), nf + nmi, B, col0, BT);
      pf.commit_split(u.raw, nf, u.x, LDX, CH, nf + nmi, BT);
      cp_async_wait_all();
      __syncthreads();
      xi_own<kG16>(cl, u.x, LDX, u.raw, u.wi, u.bi, nf, CHc, r * CHc, BT);
    }
    cl.sync();
    int cur = 0;
    for (int s_ = 0; s_ < L; ++s_) {
      const int l = L - 1 - s_;
      const bool more = l > 0;
      bf16* hc = u.h + cur * BT * LDH;
      bf16* hn = u.h + (cur ^ 1) * BT * LDH;
      bf16* xc = u.x + cur * XS;
      bf16* xn = u.x + (cur ^ 1) * XS;
      if (more) {
        // B4, B9: the next level's X tile is copied while this one runs
        // (the buffer was last read before the previous level's barrier)
        if constexpr (kLoadX) {
          load_x(xn, l - 1);
          cp_async_commit();
        } else {
          pf.fetch<kBM>(feat_l(l - 1), nf, mem_l(l - 1), nf + nmi, B, col0,
                        BT);
        }
      }
      if (s_ > 0)
        store_tile_t(p.up + (static_cast<size_t>(l + 1) * H + r * Hc) * sB,
                     hc, LDH, r * Hc, Hc, B, col0, BT);
      gru_level<kRoundXP, kStream, kXT, kG16>(cl, R, xc, kXT ? BT : LDX, KX,
                                              wx, hc, wh, LDH, H, Hc, hn, w,
                                              tl, r, nullptr, B, col0,
                                              u.ring);
      if (more) {
        if constexpr (kLoadX) {
          cp_async_wait_all();     // the barrier below publishes the tile
        } else {
          pf.commit_split(u.raw, nf, xn, LDX, CH, nf + nmi, BT);
          __syncthreads();
          xi_own<kG16>(cl, xn, LDX, u.raw, u.wi, u.bi, nf, CHc, r * CHc, BT);
        }
      }
      cl.sync();
      cur ^= 1;
    }
    store_tile_t(p.up + static_cast<size_t>(r) * Hc * sB, u.h + cur * BT * LDH,
                 LDH, r * Hc, Hc, B, col0, BT);
  }
  cl.sync();

  // ---- down sweep, top (l = 0) to surface, and the heads
  {
    Smem s(smem_raw);
    const DnBufs d = dn_bufs(s, Hc, H, BT, nm8, nm + ny * nm + ny, kStream);
    const bf16* gx = p.wx_dn + static_cast<size_t>(r) * 3 * Hc * H;
    const bf16* gh = p.wh_dn + static_cast<size_t>(r) * 3 * Hc * H;
    load_slice<kStream>(d.wx, gx, 3 * Hc, H);
    load_slice<kStream>(d.wh, gh, 3 * Hc, H);
    const WSlice wx = slice<kStream>(d.wx, gx, H);
    const WSlice wh = slice<kStream>(d.wh, gh, H);
    load_rows(d.wl, LDH, p.wlat, nm8, H);
    load_heads(d.hw, p.blat, p.wout, p.bout, nm, ny);
    load_tile_t(d.h, LDH, p.h0d, H, B, col0, BT);
    gru_regs_init(R, w, tl, r, Hc, H, p.b2, p.bh_dn, p.h0d, B, col0);
    const auto up_l = [&](int l) { return p.up + static_cast<size_t>(l) * H * sB; };
    const auto mem_o = [&](int l) {
      return HeadOut<kBM>{p.mem + l * p.mem_lvl, p.mem_ld};
    };
    const auto out_o = [&](int l) {
      return HeadOut<kBM>{p.out + l * p.out_lvl, p.out_ld};
    };
    ChunkPF cp;
    cp.fetch(up_l(0), H, nullptr, r * Hc, (r + 1) * Hc, B, col0, BT);
    cp.commit(d.x, LDH, r * Hc, (r + 1) * Hc, BT);
    cp_async_wait_all();
    __syncthreads();
    bcast_cols(cl, d.x, LDH, r * Hc, Hc, BT);
    cl.sync();
    int cur = 0;
    for (int l = 0; l < L; ++l) {
      const bool more = l + 1 < L;
      bf16* hc = d.h + cur * BT * LDH;
      bf16* hn = d.h + (cur ^ 1) * BT * LDH;
      bf16* xc = d.x + cur * BT * LDH;
      bf16* xn = d.x + (cur ^ 1) * BT * LDH;
      if (more) cp.fetch(up_l(l + 1), H, nullptr, r * Hc, (r + 1) * Hc, B, col0, BT);
      if (l > 0)
        heads(hc, LDH, d.wl, H, nm, nm8, d.hw, ny, d.mem, mem_o(l - 1),
              out_o(l - 1), B, col0, BT, r, C);
      gru_level<kRoundXP, kStream, false, kG16>(cl, R, xc, LDH, H, wx, hc,
                                                wh, LDH, H, Hc, hn, w, tl, r,
                                                nullptr, B, col0, d.ring);
      if (more) {
        cp.commit(xn, LDH, r * Hc, (r + 1) * Hc, BT);
        __syncthreads();
        bcast_cols(cl, xn, LDH, r * Hc, Hc, BT);
      }
      cl.sync();
      cur ^= 1;
    }
    bf16* hl = d.h + cur * BT * LDH;
    heads(hl, LDH, d.wl, H, nm, nm8, d.hw, ny, d.mem, mem_o(L - 1),
          out_o(L - 1), B, col0, BT, r, C);
    store_tile_t(p.lasth + static_cast<size_t>(r) * Hc * sB, hl, LDH,
                 r * Hc, Hc, B, col0, BT);
  }
  cl.sync();   // no CTA leaves while another may still address its smem
}

// The launch of the forward: refuses (cudaErrorInvalidValue) the shapes
// outside the design, picks the resident or the streamed instantiation,
// and with g16 the bf16-gate one (acc32=False: every projection rounded,
// the gates in bf16 arithmetic, gates16.cuh).
// The initial MLP's rows split over the cluster (CH a multiple of 8 C);
// a loaded X tile only needs whole k-steps (B9: CH a multiple of 16; B4:
// CH + nmi) and a swizzle period of the transposed one (B4: BT 16, 32 or
// 64).
template <bool kBM, bool kRoundXP, bool kLoadX = false>
int launch_fwd(const FwdParams& p, int stream, int g16, cudaStream_t st) {
  const int C = p.C, BT = p.BT;
  const bool widths = kLoadX
      ? (kBM ? p.CH % 16 == 0 && p.nmi == 0
             : (p.CH + p.nmi) % 16 == 0 && BT <= 64) &&
            p.CH > 0 && p.nf == 0
      : p.CH % (8 * C) == 0 && p.nmi % 16 == 0 &&
            (p.nf + p.nmi) * BT <= PF * NTH;
  if (C < 1 || C > 8 || BT % 16 != 0 || BT < 16 || NW % (BT / 16) != 0 ||
      p.H % (8 * C) != 0 || !widths ||
      p.H / C / 8 > NW / (BT / 16) * MAXP ||
      p.H / C / 8 * BT > MAXI * NTH)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem(p.H, C, p.CH, p.nmi, p.nf, p.nm, p.ny, BT,
                               stream != 0, kLoadX && !kBM);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (g16) {
    // the bf16-gate mode rounds every projection whatever kRoundXP says,
    // so it has one instantiation
    if (stream)
      return launch_cluster(mma_fwd_kernel<kBM, true, true, kLoadX, true>, p,
                            C, BT, p.B, smem, st);
    return launch_cluster(mma_fwd_kernel<kBM, true, false, kLoadX, true>, p,
                          C, BT, p.B, smem, st);
  }
  if (stream)
    return launch_cluster(mma_fwd_kernel<kBM, kRoundXP, true, kLoadX, false>,
                          p, C, BT, p.B, smem, st);
  return launch_cluster(mma_fwd_kernel<kBM, kRoundXP, false, kLoadX, false>,
                        p, C, BT, p.B, smem, st);
}

}  // namespace bmma
