// v2 fused BiGRU forward, level-major [L, B, .]: the up GRU sweep over a
// precomputed input projection, then the down GRU sweep with its input
// projection fused. The trunk of the physics-constrained emulator.
//
// Replaces the TPU kernel climsim_tpu/ops/pallas_rnn.py::_bigru_kernel
// (wrapper _bigru_pallas_lbh).
//
// What it computes, per column (dt = the input type, f32 or bf16; gates
// and sums in f32):
//   up sweep l = L-1 .. 0:
//     hh = Whh_up dt(h) + bhh_up; r = s(xp_r + hh_r), z = s(xp_z + hh_z)
//     n  = tanh(xp_n + r hh_n);  h = (1 - z) n + z h;  up_l = dt(h)
//   down sweep l = 0 .. L-1:
//     x2 = W2 up_l + b2 (f32, not rounded); the same GRU step with Whh_dn
//     on h2;  down_l = dt(h2)
//   last_h = dt(h2)
//
// What bounds it on an H100 at the physics trunk's shapes (L 50, H 128,
// B 21,600): 3 x 3H x H = 147,456 multiply-adds per column and level (up
// recurrence, down projection, down recurrence) = 0.3185 TFLOP per call,
// 4.75 ms at the 67 TFLOP/s f32 rate (the f32 policy rules out TF32);
// the bytes it must move (xp, h0s in, down, last_h out, weights) are
// ~2.2 GB in f32, 0.66 ms at 3.35 TB/s. So it is bound by operations.
//
// Which design runs is the wrapper's choice from the dtype and the width
// (pallas_rnn.py::gru_design): f32 runs the cluster FFMA design at the end
// of this file where its plan fits (H up to 192), bf16 the tensor-core
// design below where its plan fits (H up to 960), and every other width
// the CUDA-core design here, its tiles in shared memory up to H 448 and in
// a device scratch past it; at the widths the other designs take it is
// kept as their timing twin.
//
// What the CUDA-core design does about the bound: it is a CUDA-core FMA
// kernel. Columns are independent, so each block owns a tile of BT
// columns and walks both sweeps level by level in an in-kernel loop (the
// TPU's sequential grid). A thread owns one hidden unit j for CG columns:
// for a fixed k the threads of a warp read 32 neighbouring outputs of the
// k-major ([in, out], flax's layout) weights, which stay in L2, and the
// level's xp and the outputs are read and written at neighbouring j, so
// every global access is coalesced. The state h (f32), dt(h) and the down
// sweep's input live in shared memory. The TPU kept the tile's up states
// in VMEM scratch; here they go into the `down` output itself: the down
// sweep at level l reads up_l (into shared memory) before it writes down_l
// over it, so no scratch is needed. The ragged last tile masks its
// columns (zero inputs, nothing stored) instead of padding.
// Built without --use_fast_math: expf/tanhf keep the 100-level recurrence
// within tolerance of the plain version.
//
// bf16 (the v2 arm's step at H 192, L 60, and the replay in the v3/v4
// arms' backward) runs the tensor-core design at the end of this file:
// 9 H^2 multiply-adds per column and level, 0.86 TFLOP per call at the v2
// shapes, 0.87 ms at the 989 TFLOP/s bf16 peak, so still bound by
// operations. It is B8's replay (bigru_mma_bwd.cuh's design, phase A of
// bigru_lbh_bwd.cu) storing no gates.
#include "bigru_f32.cuh"
#include "bigru_lbh.cuh"
#include "bigru_mma.cuh"

namespace {

using namespace bigru_v2;

struct Params {
  const void *xp, *h0u, *h0d, *whh_up, *bhh_up, *win2, *bin2, *whh_dn,
      *bhh_dn;
  void *down, *lasth;
  float* tiles;     // device scratch for the tiles, or null: shared memory
  int L, H, B;
};

// the f32 rows of [BT] a block keeps in its tiles
__host__ __device__ inline size_t tile_rows(int H) {
  return 4 * static_cast<size_t>(H);
}

template <typename T, bool kTiles, bool kG16>
__global__ void __launch_bounds__(NTH, 2) bigru_lbh_kernel(Params p) {
  const T* xp = static_cast<const T*>(p.xp);
  const T* whh_up = static_cast<const T*>(p.whh_up);
  const T* bhh_up = static_cast<const T*>(p.bhh_up);
  const T* win2 = static_cast<const T*>(p.win2);
  const T* bin2 = static_cast<const T*>(p.bin2);
  const T* whh_dn = static_cast<const T*>(p.whh_dn);
  const T* bhh_dn = static_cast<const T*>(p.bhh_dn);
  T* down = static_cast<T*>(p.down);
  T* lasth = static_cast<T*>(p.lasth);
  const int L = p.L, H = p.H, B = p.B;
  const int col0 = blockIdx.x * BT;
  const size_t level = static_cast<size_t>(B) * H;

  extern __shared__ float4 smem4[];
  float* s_hc = kTiles ? p.tiles + blockIdx.x * tile_rows(H) * BT
                       : reinterpret_cast<float*>(smem4);  // [H][BT] f32 state
  float* xh_cur = s_hc + H * BT;                    // [H][BT] dt(h)
  float* xh_nxt = xh_cur + H * BT;                  // [H][BT]
  float* s_x = xh_nxt + H * BT;                     // [H][BT] dt(up_l)

  // ---- up sweep, surface (l = L-1) to top; up_l is stored in down[l]
  load_level(s_hc, static_cast<const T*>(p.h0u), H, B, col0);
  load_level(xh_cur, static_cast<const T*>(p.h0u), H, B, col0);
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    gru_level<T, false, kG16>(xp + static_cast<size_t>(l) * B * 3 * H,
                              nullptr, nullptr, nullptr, whh_up, bhh_up,
                              xh_cur, s_hc, xh_nxt, down + l * level, nullptr,
                              H, B, col0);
    __syncthreads();
    float* t = xh_cur; xh_cur = xh_nxt; xh_nxt = t;
  }

  // ---- down sweep, top (l = 0) to surface; reads up_l from down[l]
  // before overwriting it with down_l
  load_level(s_hc, static_cast<const T*>(p.h0d), H, B, col0);
  load_level(xh_cur, static_cast<const T*>(p.h0d), H, B, col0);
  for (int l = 0; l < L; ++l) {
    load_level(s_x, down + l * level, H, B, col0);
    __syncthreads();
    gru_level<T, false, kG16>(nullptr, win2, bin2, s_x, whh_dn, bhh_dn, xh_cur,
                              s_hc, xh_nxt, down + l * level, nullptr, H, B,
                              col0);
    __syncthreads();
    float* t = xh_cur; xh_cur = xh_nxt; xh_nxt = t;
  }
  store_level(lasth, xh_cur, H, B, col0);
}

template <typename T, bool kG16 = false>
int launch(const Params& p, cudaStream_t stream) {
  const int blocks = (p.B + BT - 1) / BT;
  if (p.tiles != nullptr) {
    bigru_lbh_kernel<T, true, kG16><<<blocks, NTH, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * tile_rows(p.H) * BT;
  cudaError_t err = cudaFuncSetAttribute(
      bigru_lbh_kernel<T, false, kG16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bigru_lbh_kernel<T, false, kG16><<<blocks, NTH, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor); g16: 1 for the bf16
// gates (acc32=False, bfloat16 only: the down projection rounded,
// gates16.cuh). xp [L, B, 3H], h0u/h0d
// [B, H], weights k-major [H, 3H], biases [3H], down [L, B, H], lasth
// [B, H], all contiguous. tiles: null to keep the block's tiles in
// shared memory (4H x 32 f32, up to H 448), or a device scratch of
// ceil(B / 32) x 4H x 32 f32 (16-byte aligned) that takes them at any H:
// the kernel then launches with no dynamic shared memory, and
// __syncthreads orders a block's global accesses as it orders its shared
// ones. Returns the cudaError_t of the launch (0 on success).
extern "C" int bigru_lbh(int dtype, const void* xp, const void* h0u,
                         const void* h0d, const void* whh_up,
                         const void* bhh_up, const void* win2,
                         const void* bin2, const void* whh_dn,
                         const void* bhh_dn, void* down, void* lasth, int L,
                         int H, int B, int g16, void* tiles, void* stream) {
  Params p{xp, h0u, h0d, whh_up, bhh_up, win2, bin2, whh_dn, bhh_dn,
           down, lasth, static_cast<float*>(tiles), L, H, B};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !g16) return launch<float>(p, s);
  if (dtype == 1) return g16 ? launch<__nv_bfloat16, true>(p, s)
                             : launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------ bf16: tensor-core design
//
// A cluster of C CTAs owns a tile of BT columns, CTA r hidden units
// [r Hc, (r + 1) Hc) with its gate slices of the weights resident in
// shared memory for a sweep (or streamed through the ring from H ~ 320
// on, bigru_mma.cuh), the f32 state in the mma fragments and dt(h) sent
// to every CTA's next buffer through distributed shared memory, one
// cluster barrier a level (B1's and B8's design):
//   up sweep: the recurrence on the given projection xp (read batch-major
//     at the thread's fragment positions a level ahead; no product);
//   down sweep: the projection W2 dt(up_l) + b2 kept f32 (gru_level with
//     no rounding), then the recurrence.
// The up states go into the `down` output itself, as the CUDA-core design
// keeps them: batch-major from the fragments of the CTA that owns the
// hidden units, read back by that CTA a level ahead of the down sweep's
// level (through L2, ld.global.cg) and overwritten there by down_l; so
// there is no scratch. down and last_h are written batch-major from the
// fragments, a pair of neighbouring hidden units a 4-byte store. No heads,
// no initial MLP and no gate bundle: B7's plan has the widths of B8's
// replay.
namespace bmma {
namespace b7 {

struct Params {
  const bf16 *xp, *h0u, *h0d;
  const bf16 *wh_up, *bh_up, *wx_dn, *b2, *wh_dn, *bh_dn;
  bf16 *down, *lasth;
  int L, H, B, C, BT;
};

__host__ __device__ inline size_t smem_bytes(int H, int C, int BT,
                                             bool stream) {
  const int Hc = H / C;
  Smem su(nullptr), sd(nullptr);
  up_bufs(su, Hc, 0, H, BT, 0, 0, 0, stream);
  dn_bufs(sd, Hc, H, BT, 0, 0, stream);
  return su.off > sd.off ? su.off : sd.off;
}

template <bool kStream, bool kG16>
__global__ void __launch_bounds__(NTH, 1) b7_mma_kernel(Params p) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = p.C, BT = p.BT, r = static_cast<int>(cl.block_rank());
  const int H = p.H, Hc = H / C, L = p.L, B = p.B;
  const int LDH = H + PAD;
  const int col0 = (blockIdx.x / C) * BT;
  const size_t lvl = static_cast<size_t>(B) * H;     // a level of down
  const Warp w(BT);
  const Tiles tl(w, Hc / 8);
  extern __shared__ __align__(16) char smem_raw[];
  GruRegs R;

  // ---- up sweep, surface (l = L-1) to top; up_l into down[l]
  {
    Smem s(smem_raw);
    const UpBufs u = up_bufs(s, Hc, 0, H, BT, 0, 0, 0, kStream);
    const bf16* gh = p.wh_up + static_cast<size_t>(r) * 3 * Hc * H;
    load_slice<kStream>(u.wh, gh, 3 * Hc, H);
    const WSlice whu = slice<kStream>(u.wh, gh, H);
    load_tile_t(u.h, LDH, p.h0u, H, B, col0, BT);
    gru_regs_init(R, w, tl, r, Hc, H, nullptr, p.bh_up, p.h0u, B, col0);
    const auto xp_l = [&](int l) {
      return p.xp + static_cast<size_t>(l) * B * 3 * H;
    };
    XpPF xq;
    xq.fetch(xp_l(L - 1), w, tl, r, Hc, H, B, col0);
    cp_async_wait_all();
    __syncthreads();
    cl.sync();
    int cur = 0;
    for (int s_ = 0; s_ < L; ++s_) {
      const int l = L - 1 - s_;
      float ar[MAXP][4], az[MAXP][4], an[MAXP][4];
#pragma unroll
      for (int i = 0; i < MAXP; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ar[i][q] = xq.v[0][i][q];
          az[i][q] = xq.v[1][i][q];
          an[i][q] = xq.v[2][i][q];
        }
      if (l > 0) xq.fetch(xp_l(l - 1), w, tl, r, Hc, H, B, col0);
      gru_rec<kStream, kG16>(cl, R, ar, az, an, u.h + cur * BT * LDH, whu,
                             LDH, H, Hc, u.h + (cur ^ 1) * BT * LDH, w, tl, r,
                             nullptr, B, col0, u.ring);
      store_state_bm<kG16>(p.down + l * lvl, H, R, w, tl, r, Hc, B, col0);
      cl.sync();
      cur ^= 1;
    }
  }
  // the last barrier ended every access to another CTA's shared memory,
  // and the down sweep reads back only what its own CTA stored

  // ---- down sweep, top (l = 0) to surface
  {
    Smem s(smem_raw);
    const DnBufs d = dn_bufs(s, Hc, H, BT, 0, 0, kStream);
    const bf16* gx = p.wx_dn + static_cast<size_t>(r) * 3 * Hc * H;
    const bf16* gh = p.wh_dn + static_cast<size_t>(r) * 3 * Hc * H;
    load_slice<kStream>(d.wx, gx, 3 * Hc, H);
    load_slice<kStream>(d.wh, gh, 3 * Hc, H);
    const WSlice wx = slice<kStream>(d.wx, gx, H);
    const WSlice wh = slice<kStream>(d.wh, gh, H);
    load_tile_t(d.h, LDH, p.h0d, H, B, col0, BT);
    gru_regs_init(R, w, tl, r, Hc, H, p.b2, p.bh_dn, p.h0d, B, col0);
    const int k0 = r * Hc, k1 = (r + 1) * Hc;
    RowPF cp;
    cp.fetch(p.down, H, k0, k1, B, col0, BT);
    cp.commit(d.x, LDH, k0, k1, BT);
    cp_async_wait_all();
    __syncthreads();
    bcast_cols(cl, d.x, LDH, k0, Hc, BT);
    cl.sync();
    int cur = 0;
    for (int l = 0; l < L; ++l) {
      const bool more = l + 1 < L;
      bf16* xn = d.x + (cur ^ 1) * BT * LDH;
      if (more) cp.fetch(p.down + (l + 1) * lvl, H, k0, k1, B, col0, BT);
      gru_level<false, kStream, false, kG16>(
          cl, R, d.x + cur * BT * LDH, LDH, H, wx, d.h + cur * BT * LDH, wh,
          LDH, H, Hc, d.h + (cur ^ 1) * BT * LDH, w, tl, r, nullptr, B, col0,
          d.ring);
      store_state_bm<kG16>(p.down + l * lvl, H, R, w, tl, r, Hc, B, col0);
      if (more) {
        cp.commit(xn, LDH, k0, k1, BT);
        __syncthreads();
        bcast_cols(cl, xn, LDH, k0, Hc, BT);
      }
      cl.sync();
      cur ^= 1;
    }
    store_state_bm<kG16>(p.lasth, H, R, w, tl, r, Hc, B, col0);
  }
}

int launch(const Params& p, int stream, int g16, cudaStream_t st) {
  const int C = p.C, BT = p.BT, H = p.H;
  if (C < 1 || C > 8 || BT % 16 != 0 || BT < 16 || NW % (BT / 16) != 0 ||
      H % (8 * C) != 0 || H / C / 8 > NW / (BT / 16) * MAXP ||
      H / C / 8 * BT > MAXI * NTH)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(H, C, BT, stream != 0);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (g16)
    return stream
               ? launch_cluster(b7_mma_kernel<true, true>, p, C, BT, p.B,
                                smem, st)
               : launch_cluster(b7_mma_kernel<false, true>, p, C, BT, p.B,
                                smem, st);
  if (stream)
    return launch_cluster(b7_mma_kernel<true, false>, p, C, BT, p.B, smem, st);
  return launch_cluster(b7_mma_kernel<false, false>, p, C, BT, p.B, smem, st);
}

}  // namespace b7
}  // namespace bmma

// bf16 tensor-core design. ptrs, in order (H already padded to a multiple
// of 8 C, every tensor's gate blocks with it): xp [L, B, 3H], h0u, h0d
// [H, B] (channel-major), wh_up [C][3H/C][H] (the gate slices of
// Whh_up^T, [out, in]), bh_up [3H], wx_dn (W2^T) and wh_dn like wh_up,
// b2, bh_dn [3H], down [L, B, H], lasth [B, H]. stream: 1 for the
// streamed-weights instantiation; g16: 1 for the bf16 gates (acc32=False:
// the down projection rounded, gates16.cuh). Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for shapes outside the design).
extern "C" int bigru_lbh_mma(void* const* q, int L, int H, int B, int C,
                             int BT, int stream, int g16, void* st) {
  using bmma::bf16;
  const auto c = [&](int i) { return static_cast<const bf16*>(q[i]); };
  bmma::b7::Params p{c(0), c(1), c(2), c(3), c(4), c(5), c(6), c(7), c(8),
                     static_cast<bf16*>(q[9]), static_cast<bf16*>(q[10]),
                     L, H, B, C, BT};
  return bmma::b7::launch(p, stream, g16, static_cast<cudaStream_t>(st));
}

// ------------------------------------------------ f32: cluster design
//
// f32 (the physics trunk, L 50, H 128, and any f32 v2/v3/v4 arm) runs the
// cluster FFMA design of bigru_f32.cuh where its plan fits (H up to 192
// at the flagship's widths; the CUDA-core design above takes the rest).
// At the physics trunk's shapes its bound is the 0.3185 TFLOP above at
// 67 TFLOP/s, 4.75 ms: the design keeps every operand of a level's
// products in shared memory and the state in registers, so the level runs
// FFMA from 128-bit shared loads (24 FMAs a 4-load k-step), one cluster
// barrier a level, where the CUDA-core design reads three weights from L2
// for every 8 FMAs and keeps the state in shared memory.
//
// ptrs, in order (H already padded to a multiple of 8 C, every tensor's
// gate blocks with it): xp [L, B, 3H]; h0u, h0d [H, Bs] channel-major,
// zero past B; wh_up [C][H][3H/C] (CTA r's gate columns of the k-major
// Whh_up), bh_up [3H], wx_dn (W2) and wh_dn like wh_up, b2, bh_dn [3H];
// up [L, H, Bs] f32 scratch (the up states the down sweep reads back);
// down [L, B, H], lasth [B, H]. Bs: B rounded up to a multiple of 4.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for
// shapes outside the design).
extern "C" int bigru_lbh_f32(void* const* q, int L, int H, int B, int Bs,
                             int C, int BT, void* st) {
  const auto c = [&](int i) { return static_cast<const float*>(q[i]); };
  const auto m = [&](int i) { return static_cast<float*>(q[i]); };
  bf32::SweepParams p{c(0), c(1), c(2), c(3), c(4), c(5), c(6), c(7), c(8),
                      m(9), nullptr, nullptr, nullptr, m(10), m(11),
                      L, H, B, Bs, C, BT};
  return bf32::launch_sweep<false>(p, static_cast<cudaStream_t>(st));
}
