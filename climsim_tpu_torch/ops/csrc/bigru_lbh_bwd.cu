// v2 fused BiGRU backward, level-major [L, B, .]: replay of both sweeps,
// the down-sweep BPTT, the up-sweep BPTT, and the weight gradients. The
// training backward of the physics-constrained emulator's trunk.
//
// Replaces the TPU kernel climsim_tpu/ops/pallas_rnn.py::_bigru_bwd_kernel
// (wrapper _bigru_bwd_pallas_lbh).
//
// What it computes, per column (dt = the input type, f32 or bf16; every
// sum is accumulated in f32; "dt(v)" rounds v to dt):
//   phase A, replay: the up sweep (l = L-1 .. 0) on xp, then the down
//     sweep on x2 = W2 up_l + b2 (f32, not rounded), as the forward (B7);
//     h and the gate bundle [r; z; n; hn] of every level are stored in dt.
//   phase B1, l = L-1 .. 0: dh2 += d_down_l; the GRU backward step gives
//     (dar, daz, dan, dhn) from the stored gates and h2_{l-1}; dh2 <- dh2 z
//     + Whh_dn dt([dar; daz; dhn]); d_up_l = W2 dt([dar; daz; dan]) (f32).
//   phase B2, l = 0 .. L-1: du += d_up_l; the same step on the up sweep
//     with h_{l+1}; d_xp_l = dt([dar; daz; dan]); du <- du z + Whh_up
//     dt([dar; daz; dhn]).
//   weight gradients, sums over levels and columns: dWin2 = sum dt(up_l)
//     dt(dxp2_l)^T, dWhh_dn = sum dt(h2_{l-1}) dt(d_hh_dn,l)^T, dWhh_up =
//     sum dt(h_{l+1}) dt(d_hh_up,l)^T (h0_dn, h0_up at the edges); the
//     biases the f32 sums of the unrounded bundles; cast to dt at the end.
//
// What bounds it on an H100 at the physics trunk's shapes (L 50, H 128,
// B 21,600): 27 H^2 = 442,368 multiply-adds per column and level (the
// replay's three products 9 H^2, the two BPTT sweeps' transposed products
// 9 H^2, the three weight gradients 9 H^2) = 0.955 TFLOP per call, 14.3 ms
// at the 67 TFLOP/s f32 rate (the f32 policy rules out TF32); the bytes it
// must move (xp, d_down, h0s, d_lasth in; d_xp, dh0s, the gradients out)
// are ~3.9 GB in f32, 1.16 ms at 3.35 TB/s. So it is bound by operations.
//
// Which design runs is the wrapper's choice from the dtype and the width
// (pallas_rnn.py::gru_design): f32 runs the cluster FFMA design at the end
// of this file where its plan fits (H up to 192), bf16 the tensor-core
// design below where its plan fits (H up to 960), and every other width
// the CUDA-core design here, its tiles in shared memory up to H 360 and in
// a device scratch past it; at the widths the other designs take it is
// kept as their timing twin.
//
// What the CUDA-core design does about the bound: it runs on the CUDA
// cores (f32 accumulation of dt products), like B7. The work splits in
// two:
//   1. bigru_lbh_bwd_kernel: one block per tile of BT columns walks the
//      three phases in in-kernel loops (the TPU's sequential grid). Phase
//      A is B7's level (bigru_lbh.cuh) with the gate bundle stored. The
//      state and the level's rounded gradient bundle live in shared memory
//      as f32 (80 KB at H 128, two blocks per SM). The TPU kept the tile's
//      [L, Bt, .] replay state in VMEM (~256 KB a column in f32), beyond an
//      SM's 227 KB; here h and the gates of both sweeps, d_up and the
//      per-level f32 gradient streams (d_hh of each sweep and dxp2, [L, B,
//      3H]) go to device scratch that the wrapper allocates: ~11 GB at
//      21,600 columns in f32 (up_h and g_h 0.55 GB each, the gates 2.2 GB
//      each, d_up 0.55 GB, the streams 1.66 GB each). Weights stay in L2:
//      k-major ([in, out]) for the replay, [out, in] copies for the
//      transposed products, so a warp reads 32 neighbouring values either
//      way.
//   2. The TPU accumulated the weight gradients across its sequential
//      grid in revisiting output blocks; CUDA blocks run at once. So
//      outer_sum_kernel reduces each gradient over the L x B rows as a
//      tiled product (64 x 64 output tiles, 32-row chunks) split into S row
//      ranges writing f32 partial sums, col_sum_kernel does the bias sums
//      the same way, and sum_parts_kernel adds the partials in a fixed
//      order and casts. Deterministic: no atomics.
// The ragged last tile is masked: a pad column reads zero inputs and zero
// cotangents and nothing of it is stored (the TPU wrapper pads instead).
// Built without --use_fast_math: expf/tanhf keep the 100-level recurrence
// within tolerance of the plain version.
//
// bf16 (the v4 arm's training backward, and the v2 arms') runs the
// tensor-core design at the end of this file: B3's (bigru_mma_bwd.cuh)
// without the heads. At the v4 shapes (L 60, H 192, B 21,600) its bound
// is 27 H^2 multiply-adds per column and level at the 989 TFLOP/s bf16
// peak, 2.6 ms; what it keeps from the CUDA-core design is the order of
// the phases, and what it drops are the f32 [L, B, 3H] gradient streams
// (3 x 3 GB at those shapes) and the CUDA-core reductions over them.
#include "bigru_f32.cuh"
#include "bigru_lbh.cuh"
#include "bigru_mma_bwd.cuh"

namespace {

using namespace bigru_v2;
using bigru::sum_parts_kernel;

constexpr int RT = 64;          // output tile of the gradient reductions
constexpr int RK = 32;          // rows per reduction chunk
constexpr int RTH = 256;        // threads per reduction block

// pointer slots, in the order the wrapper passes them
enum Slot {
  XP, H0U, H0D,
  WHHU_K, WIN2_K, WHHD_K,       // [H, 3H] k-major, for the replay
  WHHU_T, WIN2_T, WHHD_T,       // [3H, H], for the transposed products
  BHHU, BIN2, BHHD,
  DDOWN, DLASTH,
  DXP, DH0U, DH0D,
  DWHHU, DBHHU, DWIN2, DBIN2, DWHHD, DBHHD,
  // scratch: dt [L, B, H] x2, [L, B, 4H] x2; f32 [L, B, H], [L, B, 3H] x3,
  // the reductions' partial sums; the block tiles in device memory (null:
  // in shared memory)
  UP_H, G_H, GATES_U, GATES_D, DUP, DHHU, DHHD, DXP2, WORK, TILES,
  NSLOT
};

// the f32 rows of [BT] a block keeps in its tiles
__host__ __device__ inline size_t tile_rows(int H) {
  return 5 * static_cast<size_t>(H);
}

struct Params {
  void* p[NSLOT];
  int L, H, B;
};

// p[i] where the column is inside the batch, zero past the ragged edge
template <typename S>
__device__ __forceinline__ float ldm(const S* p, size_t i, bool ok) {
  return ok ? ldp(p + i) : 0.0f;
}

// a[q] += sum_{o < n} W[o*H + k] * D[o][c0 + q]: a product with a [3H, H]
// ([out, in]) weight contracting its out axis; W starts at the caller's
// first row, D [n][BT] f32 in shared memory
template <typename T>
__device__ __forceinline__ void mvt(float (&a)[CG], const T* __restrict__ W,
                                    int H, int k, int n, const float* D,
                                    int c0) {
#pragma unroll 4
  for (int o = 0; o < n; ++o) {
    const float w = ldw(W + static_cast<size_t>(o) * H + k);
    const float4* d4 = reinterpret_cast<const float4*>(D + o * BT + c0);
#pragma unroll
    for (int v = 0; v < CG / 4; ++v) {
      const float4 d = d4[v];
      a[4 * v + 0] = fmaf(w, d.x, a[4 * v + 0]);
      a[4 * v + 1] = fmaf(w, d.y, a[4 * v + 1]);
      a[4 * v + 2] = fmaf(w, d.z, a[4 * v + 2]);
      a[4 * v + 3] = fmaf(w, d.w, a[4 * v + 3]);
    }
  }
}

// a += Whh dt(d_hh) with d_hh = [dar; daz; dhn]: rows 0..2H-1 of the
// [3H, H] weight against D's rows 0..2H-1, row block 2H.. against D's
// rows 3H..4H-1
template <typename T>
__device__ __forceinline__ void add_whh(float (&a)[CG],
                                        const T* __restrict__ whh_t, int H,
                                        int k, const float* D, int c0) {
  mvt<T>(a, whh_t, H, k, 2 * H, D, c0);
  mvt<T>(a, whh_t + static_cast<size_t>(2) * H * H, H, k, H,
         D + 3 * H * BT, c0);
}

// The GRU backward step of one level for every (hidden unit, column
// group): dh [H][BT] f32 in shared memory, plus the addend add_l [B][H]
// (d_down in dt, or d_up in f32) when given; the stored gates gs [B][4H]
// and the previous state hp [B][H] in dt. Writes the rounded bundle
// dt([dar; daz; dan; dhn]) to D [4H][BT], d_hh = [dar; daz; dhn] to
// dhh [B][3H] (f32), d_xp = [dar; daz; dan] to dxp_f [B][3H] (f32) or
// dxp_t [B][3H] (dt) when given, and dh z back to dh (the first term of
// dh_prev).
template <typename T, typename A>
__device__ __forceinline__ void gru_bwd_level(
    float* dh, const A* add_l, const T* gs, const T* hp, float* D,
    float* dhh, float* dxp_f, T* dxp_t, int H, int B, int col0) {
  const size_t H3 = 3 * static_cast<size_t>(H), H4 = 4 * H;
  for (int item = threadIdx.x; item < H * NCG; item += NTH) {
    const int j = item % H;
    const int c0 = (item / H) * CG;
#pragma unroll 2
    for (int q = 0; q < CG; ++q) {
      const int c = c0 + q, col = col0 + c, e = j * BT + c;
      const bool ok = col < B;
      const size_t cs = static_cast<size_t>(col);
      float g = dh[e];
      if (add_l != nullptr) g += ldm(add_l, cs * H + j, ok);
      const float r = ldm(gs, cs * H4 + j, ok);
      const float z = ldm(gs, cs * H4 + H + j, ok);
      const float n = ldm(gs, cs * H4 + 2 * H + j, ok);
      const float hn = ldm(gs, cs * H4 + 3 * H + j, ok);
      const float h_prev = ldm(hp, cs * H + j, ok);
      const float dz = g * (h_prev - n);
      const float dan = g * (1.0f - z) * (1.0f - n * n);
      const float dar = dan * hn * r * (1.0f - r);
      const float daz = dz * z * (1.0f - z);
      const float dhn = dan * r;
      D[e] = rnd<T>(dar);
      D[H * BT + e] = rnd<T>(daz);
      D[2 * H * BT + e] = rnd<T>(dan);
      D[3 * H * BT + e] = rnd<T>(dhn);
      if (ok) {
        float* hh = dhh + cs * H3 + j;
        hh[0] = dar;
        hh[H] = daz;
        hh[2 * H] = dhn;
        if (dxp_f != nullptr) {
          float* x = dxp_f + cs * H3 + j;
          x[0] = dar;
          x[H] = daz;
          x[2 * H] = dan;
        }
        if (dxp_t != nullptr) {
          T* x = dxp_t + cs * H3 + j;
          x[0] = from_f<T>(dar);
          x[H] = from_f<T>(daz);
          x[2 * H] = from_f<T>(dan);
        }
      }
      dh[e] = g * z;
    }
  }
}

template <typename T, bool kTiles>
__global__ void __launch_bounds__(NTH, 2) bigru_lbh_bwd_kernel(Params p) {
  const int L = p.L, H = p.H, B = p.B;
  const size_t lvl = static_cast<size_t>(B) * H;       // a [B][H] level
  const int col0 = blockIdx.x * BT;
  auto in = [&](int s) { return static_cast<const T*>(p.p[s]); };
  T* up_h = static_cast<T*>(p.p[UP_H]);
  T* g_h = static_cast<T*>(p.p[G_H]);
  T* gates_u = static_cast<T*>(p.p[GATES_U]);
  T* gates_d = static_cast<T*>(p.p[GATES_D]);
  float* dup = static_cast<float*>(p.p[DUP]);
  float* dhhu = static_cast<float*>(p.p[DHHU]);
  float* dhhd = static_cast<float*>(p.p[DHHD]);
  float* dxp2 = static_cast<float*>(p.p[DXP2]);
  extern __shared__ float4 smem4[];
  float* sm = kTiles ? static_cast<float*>(p.p[TILES]) +
                           blockIdx.x * tile_rows(H) * BT
                     : reinterpret_cast<float*>(smem4);

  // ---- phase A: replay the up sweep (surface to top), then the down
  {
    float* s_hc = sm;                       // [H][BT] f32 state
    float* xh_cur = s_hc + H * BT;          // [H][BT] dt(h)
    float* xh_nxt = xh_cur + H * BT;        // [H][BT]
    float* s_x = xh_nxt + H * BT;           // [H][BT] dt(up_l)
    load_level(s_hc, in(H0U), H, B, col0);
    load_level(xh_cur, in(H0U), H, B, col0);
    __syncthreads();
    for (int l = L - 1; l >= 0; --l) {
      gru_level<T, true>(in(XP) + 3 * l * lvl, nullptr, nullptr, nullptr,
                         in(WHHU_K), in(BHHU), xh_cur, s_hc, xh_nxt,
                         up_h + l * lvl, gates_u + 4 * l * lvl, H, B, col0);
      __syncthreads();
      float* t = xh_cur; xh_cur = xh_nxt; xh_nxt = t;
    }
    load_level(s_hc, in(H0D), H, B, col0);
    load_level(xh_cur, in(H0D), H, B, col0);
    for (int l = 0; l < L; ++l) {
      load_level(s_x, up_h + l * lvl, H, B, col0);
      __syncthreads();
      gru_level<T, true>(nullptr, in(WIN2_K), in(BIN2), s_x, in(WHHD_K),
                         in(BHHD), xh_cur, s_hc, xh_nxt, g_h + l * lvl,
                         gates_d + 4 * l * lvl, H, B, col0);
      __syncthreads();
      float* t = xh_cur; xh_cur = xh_nxt; xh_nxt = t;
    }
  }

  float* s_dh = sm;                         // [H][BT] carry gradient, f32
  float* s_D = s_dh + H * BT;               // [4H][BT] rounded bundle

  // ---- phase B1: down-sweep BPTT (surface to top)
  load_level(s_dh, in(DLASTH), H, B, col0);
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    gru_bwd_level<T, T>(s_dh, in(DDOWN) + l * lvl, gates_d + 4 * l * lvl,
                        l > 0 ? g_h + (l - 1) * lvl : in(H0D), s_D,
                        dhhd + 3 * l * lvl, dxp2 + 3 * l * lvl, nullptr, H,
                        B, col0);
    __syncthreads();
    // dh2_prev = dh2 z + Whh_dn dt(d_hh); d_up = W2 dt(d_xp)
    float* dup_l = dup + l * lvl;
    for (int item = threadIdx.x; item < H * NCG; item += NTH) {
      const int k = item % H, c0 = (item / H) * CG;
      float ah[CG], au[CG];
#pragma unroll
      for (int q = 0; q < CG; ++q) ah[q] = au[q] = 0.0f;
      add_whh<T>(ah, in(WHHD_T), H, k, s_D, c0);
      mvt<T>(au, in(WIN2_T), H, k, 3 * H, s_D, c0);
#pragma unroll
      for (int q = 0; q < CG; ++q) {
        const int c = c0 + q, col = col0 + c;
        s_dh[k * BT + c] += ah[q];
        if (col < B) dup_l[static_cast<size_t>(col) * H + k] = au[q];
      }
    }
    __syncthreads();
  }
  store_level(static_cast<T*>(p.p[DH0D]), s_dh, H, B, col0);
  __syncthreads();

  // ---- phase B2: up-sweep BPTT (top to surface) from a zero carry
  for (int e = threadIdx.x; e < H * BT; e += NTH) s_dh[e] = 0.0f;
  __syncthreads();
  T* dxp = static_cast<T*>(p.p[DXP]);
  for (int l = 0; l < L; ++l) {
    gru_bwd_level<T, float>(s_dh, dup + l * lvl, gates_u + 4 * l * lvl,
                            l < L - 1 ? up_h + (l + 1) * lvl : in(H0U), s_D,
                            dhhu + 3 * l * lvl, nullptr, dxp + 3 * l * lvl,
                            H, B, col0);
    __syncthreads();
    // du_prev = du z + Whh_up dt(d_hh)
    for (int item = threadIdx.x; item < H * NCG; item += NTH) {
      const int k = item % H, c0 = (item / H) * CG;
      float a[CG];
#pragma unroll
      for (int q = 0; q < CG; ++q) a[q] = 0.0f;
      add_whh<T>(a, in(WHHU_T), H, k, s_D, c0);
#pragma unroll
      for (int q = 0; q < CG; ++q) s_dh[k * BT + c0 + q] += a[q];
    }
    __syncthreads();
  }
  store_level(static_cast<T*>(p.p[DH0U]), s_dh, H, B, col0);
}

// ---------------------------------------------------------------- reductions

// A weight gradient over the L x B rows r = l*B + b: out [M, N] = sum_r
// a_r[m] * dt(g_r[n]), where a_r is row l + shift of the state a [L][B][M]
// (dt), or the edge state [B][M] (the initial state) when l + shift falls
// outside 0..L-1, and g the f32 stream [L*B][N].
struct OuterJob {
  const void* a; int shift; const void* edge;
  const float* g;
  void* out; int M, N;
};

template <typename T>
__global__ void __launch_bounds__(RTH)
outer_sum_kernel(OuterJob jb, int L, int B, int S, float* part) {
  __shared__ __align__(16) float As[RK][RT + 4];
  __shared__ __align__(16) float Gs[RK][RT + 4];
  const int ntn = (jb.N + RT - 1) / RT;
  const int m0 = (blockIdx.x / ntn) * RT, n0 = (blockIdx.x % ntn) * RT;
  const int s = blockIdx.y;
  const int rows = L * B;
  const long nch = (rows + RK - 1) / RK;
  const long first = nch * s / S, last = nch * (s + 1) / S;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* A = static_cast<const T*>(jb.a);
  const T* E = static_cast<const T*>(jb.edge);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (long ch = first; ch < last; ++ch) {
    for (int e = tid; e < RK * RT; e += RTH) {
      const int kk = e / RT, i = e % RT;
      const int r = static_cast<int>(ch) * RK + kk;
      float av = 0.0f, gv = 0.0f;
      if (r < rows) {
        const int l = r / B, b = r - l * B, ls = l + jb.shift;
        const int m = m0 + i, n = n0 + i;
        if (m < jb.M) {
          const T* row = (ls >= 0 && ls < L)
                             ? A + (static_cast<size_t>(ls) * B + b) * jb.M
                             : E + static_cast<size_t>(b) * jb.M;
          av = ldw(row + m);
        }
        if (n < jb.N)
          gv = rnd<T>(__ldg(jb.g + static_cast<size_t>(r) * jb.N + n));
      }
      As[kk][i] = av;
      Gs[kk][i] = gv;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < RK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 g4 = *reinterpret_cast<const float4*>(&Gs[k][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < jb.M && n < jb.N)
        part[(static_cast<size_t>(s) * jb.M + m) * jb.N + n] = acc[i][j];
    }
}

// part[s][n] = sum of g[r][n] over the rows r of split s (the bias
// gradients: the unrounded f32 stream), one block per split
__global__ void col_sum_kernel(const float* g, int rows, int N, int S,
                               float* part) {
  const int s = blockIdx.x;
  const int first = static_cast<int>(static_cast<long>(rows) * s / S);
  const int last = static_cast<int>(static_cast<long>(rows) * (s + 1) / S);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float a = 0.0f;
#pragma unroll 8
    for (int r = first; r < last; ++r)
      a += __ldg(g + static_cast<size_t>(r) * N + n);
    part[static_cast<size_t>(s) * N + n] = a;
  }
}

template <typename T>
int outer_sum(const OuterJob& jb, int L, int B, int S, float* work,
              cudaStream_t st) {
  const int tiles = ((jb.M + RT - 1) / RT) * ((jb.N + RT - 1) / RT);
  outer_sum_kernel<T><<<dim3(tiles, S), RTH, 0, st>>>(jb, L, B, S, work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int MN = jb.M * jb.N;
  sum_parts_kernel<T><<<(MN + RTH - 1) / RTH, RTH, 0, st>>>(
      work, S, MN, static_cast<T*>(jb.out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int col_sum(const float* g, int rows, int N, int S, float* work, void* out,
            cudaStream_t st) {
  const int threads = N < 1024 ? (N + 31) / 32 * 32 : 1024;
  col_sum_kernel<<<S, threads, 0, st>>>(g, rows, N, S, work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_parts_kernel<T><<<(N + RTH - 1) / RTH, RTH, 0, st>>>(
      work, S, N, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Params& p, int S, cudaStream_t st) {
  const int L = p.L, H = p.H, B = p.B;
  const int blocks = (B + BT - 1) / BT;
  cudaError_t err;
  if (p.p[TILES] != nullptr) {
    bigru_lbh_bwd_kernel<T, true><<<blocks, NTH, 0, st>>>(p);
  } else {
    const size_t smem = sizeof(float) * tile_rows(H) * BT;
    err = cudaFuncSetAttribute(bigru_lbh_bwd_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    bigru_lbh_bwd_kernel<T, false><<<blocks, NTH, smem, st>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  float* work = static_cast<float*>(p.p[WORK]);
  const float* dhhu = static_cast<const float*>(p.p[DHHU]);
  const float* dhhd = static_cast<const float*>(p.p[DHHD]);
  const float* dxp2 = static_cast<const float*>(p.p[DXP2]);
  const OuterJob outer[] = {
      {p.p[UP_H], 0, nullptr, dxp2, p.p[DWIN2], H, 3 * H},
      {p.p[G_H], -1, p.p[H0D], dhhd, p.p[DWHHD], H, 3 * H},
      {p.p[UP_H], 1, p.p[H0U], dhhu, p.p[DWHHU], H, 3 * H},
  };
  for (const OuterJob& jb : outer) {
    const int rc = outer_sum<T>(jb, L, B, S, work, st);
    if (rc != 0) return rc;
  }
  // the bias sums split 4x finer: they read as many bytes for far fewer
  // operations (the wrapper's WORK holds S x H x 3H floats)
  const struct { const float* g; void* out; } bias[] = {
      {dxp2, p.p[DBIN2]}, {dhhd, p.p[DBHHD]}, {dhhu, p.p[DBHHU]}};
  for (const auto& bj : bias) {
    const int rc = col_sum<T>(bj.g, L * B, 3 * H, 4 * S, work, bj.out, st);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ptrs: nslot device pointers in the
// order of enum Slot (inputs, k-major and [out, in] weights, biases,
// cotangents, outputs, gradients in the weights' layouts, scratch), all
// contiguous; activations level-major [L, B, C] / [B, H]. S: row splits of
// the weight-gradient reductions (WORK holds S x H x 3H floats). TILES:
// null to keep the block's tiles in shared memory (5H x 32 f32, up to H
// 360), or a device scratch of ceil(B / 32) x 5H x 32 f32 that takes them
// at any H (no dynamic shared memory; __syncthreads orders a block's
// global accesses as its shared ones). Returns the cudaError_t of the
// launches (0 on success).
extern "C" int bigru_lbh_bwd(int dtype, int nslot, void* const* ptrs, int L,
                             int H, int B, int S, void* stream) {
  if (nslot != NSLOT || S < 1 || H < 4)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  for (int i = 0; i < NSLOT; ++i) p.p[i] = ptrs[i];
  p.L = L; p.H = H; p.B = B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, S, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, S, s);
  return static_cast<int>(cudaErrorInvalidValue);
}


// ------------------------------------------------ bf16: tensor-core design
//
// B3's design (bigru_heads_cm_bwd.cu) on the v2 backward, which has no
// initial MLP, heads or input projection of the up sweep:
//   1. b8_mma_kernel: a cluster of C CTAs owns a tile of BT columns, CTA r
//      hidden units [r Hc, (r + 1) Hc). Phase A replays the up sweep on
//      the given projection xp (read batch-major at the thread's fragment
//      positions a level ahead; no product) and the down sweep with the
//      projection W2 dt(up_l) + b2 kept f32 (gru_level<false>), storing h
//      and the gate bundle (bf16, channel-major scratch). Phase B1 runs
//      the down-sweep BPTT with d_down_l added to the carried gradient
//      (read batch-major at the fragment positions) and the transposed
//      products Whh_dn^T dt(d_hh) and W2^T dt(d_xp) (d_up, f32); phase B2
//      the up-sweep BPTT from a zero carry, adding d_up_l, writing d_xp_l
//      = dt([dar; daz; dan]) batch-major and forming Whh_up^T dt(d_hh).
//      The transposed slices [Hc][3H] stay resident for the phase (or
//      stream through the ring); the rounded bundles overwrite the gates.
//   2. wgrad_mma_kernel: dWhh_up, dWin2 and dWhh_dn (in the [out, in]
//      layout; the wrapper transposes the three [3H, H] results) as bf16
//      GEMMs over the L x B contraction on the stored bundles and states,
//      and bias_sum_kernel the three bias gradients from the tiles' f32
//      partials. No atomics: two calls are bit-identical.
namespace bmma {
namespace b8 {

struct Params {
  const bf16 *xp, *h0u, *h0d, *dd, *dlh;
  const bf16 *wh_up, *bh_up, *wx_dn, *b2, *wh_dn, *bh_dn;
  const bf16 *whT_dn, *w2T, *whT_up;
  bf16 *dxp, *dh0u, *dh0d;
  bf16 *up_h, *g_h, *gates_u, *gates_d;
  float *dup, *bpart;
  int L, H, B, C, BT;
};

__host__ __device__ inline size_t smem_bytes(int H, int C, int BT,
                                             bool stream) {
  const int Hc = H / C;
  Smem su(nullptr), sd(nullptr), sb(nullptr), sc(nullptr);
  up_bufs(su, Hc, 0, H, BT, 0, 0, 0, stream);
  dn_bufs(sd, Hc, H, BT, 0, 0, stream);
  b_bufs(sb, Hc, H, BT, 0, 0, 0, Hc, false, stream);
  b_bufs(sc, Hc, H, BT, 0, 0, 0, 0, false, stream);
  size_t m = su.off;
  if (sd.off > m) m = sd.off;
  if (sb.off > m) m = sb.off;
  if (sc.off > m) m = sc.off;
  return m;
}

template <bool kStream>
__global__ void __launch_bounds__(NTH, 1) b8_mma_kernel(Params p) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = p.C, BT = p.BT, r = static_cast<int>(cl.block_rank());
  const int H = p.H, Hc = H / C, L = p.L, B = p.B;
  const int LDH = H + PAD, LDD = 4 * H + PAD;
  const int tile = blockIdx.x / C, col0 = tile * BT;
  const size_t sB = B, lvH = static_cast<size_t>(H) * B;
  float* part = p.bpart + static_cast<size_t>(tile) * 8 * H;
  const Warp w(BT);
  const Tiles tl(w, Hc / 8);
  extern __shared__ __align__(16) char smem_raw[];

  // ---- phase A: replay the up sweep (surface to top), then the down
  {
    GruRegs R;
    Smem s(smem_raw);
    const UpBufs u = up_bufs(s, Hc, 0, H, BT, 0, 0, 0, kStream);
    const bf16* gh = p.wh_up + static_cast<size_t>(r) * 3 * Hc * H;
    load_slice<kStream>(u.wh, gh, 3 * Hc, H);
    const WSlice whu = slice<kStream>(u.wh, gh, H);
    load_tile_t(u.h, LDH, p.h0u, H, B, col0, BT);
    gru_regs_init(R, w, tl, r, Hc, H, nullptr, p.bh_up, p.h0u, B, col0);
    const auto xp_l = [&](int l) { return p.xp + static_cast<size_t>(l) * sB * 3 * H; };
    XpPF xq;
    xq.fetch(xp_l(L - 1), w, tl, r, Hc, H, B, col0);
    cp_async_wait_all();
    __syncthreads();
    cl.sync();
    int cur = 0;
    for (int s_ = 0; s_ < L; ++s_) {
      const int l = L - 1 - s_;
      bf16* hc = u.h + cur * BT * LDH;
      bf16* hn = u.h + (cur ^ 1) * BT * LDH;
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
      if (s_ > 0)
        store_tile_t(p.up_h + (l + 1) * lvH + r * Hc * sB, hc, LDH, r * Hc,
                     Hc, B, col0, BT);
      gru_rec<kStream>(cl, R, ar, az, an, hc, whu, LDH, H, Hc, hn, w, tl, r,
                       p.gates_u + l * 4 * lvH, B, col0, u.ring);
      cl.sync();
      cur ^= 1;
    }
    store_tile_t(p.up_h + r * Hc * sB, u.h + cur * BT * LDH, LDH, r * Hc, Hc,
                 B, col0, BT);
    cl.sync();

    Smem s2(smem_raw);
    const DnBufs d = dn_bufs(s2, Hc, H, BT, 0, 0, kStream);
    const bf16* gx2 = p.wx_dn + static_cast<size_t>(r) * 3 * Hc * H;
    const bf16* gh2 = p.wh_dn + static_cast<size_t>(r) * 3 * Hc * H;
    load_slice<kStream>(d.wx, gx2, 3 * Hc, H);
    load_slice<kStream>(d.wh, gh2, 3 * Hc, H);
    const WSlice wxd = slice<kStream>(d.wx, gx2, H);
    const WSlice whd = slice<kStream>(d.wh, gh2, H);
    load_tile_t(d.h, LDH, p.h0d, H, B, col0, BT);
    gru_regs_init(R, w, tl, r, Hc, H, p.b2, p.bh_dn, p.h0d, B, col0);
    ChunkPF cp;
    cp.fetch(p.up_h, H, nullptr, r * Hc, (r + 1) * Hc, B, col0, BT);
    cp.commit(d.x, LDH, r * Hc, (r + 1) * Hc, BT);
    cp_async_wait_all();
    __syncthreads();
    bcast_cols(cl, d.x, LDH, r * Hc, Hc, BT);
    cl.sync();
    cur = 0;
    for (int l = 0; l < L; ++l) {
      const bool more = l + 1 < L;
      bf16* hc = d.h + cur * BT * LDH;
      bf16* hn = d.h + (cur ^ 1) * BT * LDH;
      bf16* xc = d.x + cur * BT * LDH;
      bf16* xn = d.x + (cur ^ 1) * BT * LDH;
      if (more)
        cp.fetch(p.up_h + (l + 1) * lvH, H, nullptr, r * Hc, (r + 1) * Hc, B,
                 col0, BT);
      if (l > 0)
        store_tile_t(p.g_h + (l - 1) * lvH + r * Hc * sB, hc, LDH, r * Hc,
                     Hc, B, col0, BT);
      gru_level<false, kStream>(cl, R, xc, LDH, H, wxd, hc, whd, LDH, H, Hc,
                                hn, w, tl, r, p.gates_d + l * 4 * lvH, B,
                                col0, d.ring);
      if (more) {
        cp.commit(xn, LDH, r * Hc, (r + 1) * Hc, BT);
        __syncthreads();
        bcast_cols(cl, xn, LDH, r * Hc, Hc, BT);
      }
      cl.sync();
      cur ^= 1;
    }
    store_tile_t(p.g_h + (L - 1) * lvH + r * Hc * sB, d.h + cur * BT * LDH,
                 LDH, r * Hc, Hc, B, col0, BT);
    cl.sync();
  }

  float bp[4][MAXP][2];
  // ---- phase B1: down-sweep BPTT (surface to top)
  {
    Smem s(smem_raw);
    const BBufs bb = b_bufs(s, Hc, H, BT, 0, 0, 0, Hc, false, kStream);
    const bf16* gwh = p.whT_dn + static_cast<size_t>(r) * Hc * 3 * H;
    const bf16* gwu = p.w2T + static_cast<size_t>(r) * Hc * 3 * H;
    load_slice<kStream>(bb.wh, gwh, Hc, 3 * H);
    load_slice<kStream>(bb.wu, gwu, Hc, 3 * H);
    const WSlice wh = slice<kStream>(bb.wh, gwh, 3 * H);
    const WSlice wu = slice<kStream>(bb.wu, gwu, 3 * H);
    float dh[MAXP][4];
    load_frag(dh, p.dlh, w, tl, r, Hc, B, col0);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < MAXP; ++i) bp[k][i][0] = bp[k][i][1] = 0.0f;
    cp_async_wait_all();
    __syncthreads();
    cluster_arrive();
    for (int l = L - 1; l >= 0; --l) {
      cluster_wait();       // every CTA has read the last level's bundle
      gru_bwd(dh, AddBM{p.dd + l * lvH, H}, p.gates_d + l * 4 * lvH,
              l > 0 ? p.g_h + (l - 1) * lvH : p.h0d, bb.D, LDD, bp, w, tl, r,
              Hc, H, B, col0);
      __syncthreads();
      for (int k = 0; k < 4; ++k) bcast_cols(cl, bb.D, LDD, k * H + r * Hc, Hc, BT);
      cl.sync();
      // dh2_prev = dh2 z + Whh_dn^T dt(d_hh); d_up = W2^T dt(d_xp)
      float ah[MAXP][4], au[MAXP][4];
      zero_acc(ah);
      zero_acc(au);
      warp_mma<kStream>(ah, bb.D, LDD, wh, 0, Hc, w, tl, 2 * H, bb.ring);
      warp_mma<kStream>(ah, bb.D + 3 * H, LDD, wh, 2 * H, Hc, w, tl, H,
                        bb.ring);
      warp_mma<kStream>(au, bb.D, LDD, wu, 0, Hc, w, tl, 3 * H, bb.ring);
      float* dup_l = p.dup + l * lvH;
#pragma unroll
      for (int i = 0; i < MAXP; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dh[i][q] += ah[i][q];
          const int j = r * Hc + w.col(tl.nt[i] * 8, q), col = col0 + w.row(q);
          if (tl.on[i] && col < B) dup_l[j * sB + col] = au[i][q];
        }
      cluster_arrive();
    }
    cluster_wait();
    store_frag(p.dh0d, dh, w, tl, r, Hc, B, col0);
    reduce_bias(bp, bb.red, part + 4 * H, w, tl, r, Hc, H, BT);
    cl.sync();
  }

  // ---- phase B2: up-sweep BPTT (top to surface) from a zero carry
  {
    Smem s(smem_raw);
    const BBufs bc = b_bufs(s, Hc, H, BT, 0, 0, 0, 0, false, kStream);
    const bf16* gwh = p.whT_up + static_cast<size_t>(r) * Hc * 3 * H;
    load_slice<kStream>(bc.wh, gwh, Hc, 3 * H);
    const WSlice wh = slice<kStream>(bc.wh, gwh, 3 * H);
    float du[MAXP][4];
    zero_acc(du);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < MAXP; ++i) bp[k][i][0] = bp[k][i][1] = 0.0f;
    cp_async_wait_all();
    __syncthreads();
    cluster_arrive();
    for (int l = 0; l < L; ++l) {
      cluster_wait();
      gru_bwd(du, AddCM{p.dup + l * lvH, sB}, p.gates_u + l * 4 * lvH,
              l < L - 1 ? p.up_h + (l + 1) * lvH : p.h0u, bc.D, LDD, bp, w,
              tl, r, Hc, H, B, col0, p.dxp + l * sB * 3 * H);
      __syncthreads();
      // the product reads d_hh = [dar; daz; dhn]: bundle blocks 0, 1, 3
      for (int k = 0; k < 4; ++k)
        if (k != 2) bcast_cols(cl, bc.D, LDD, k * H + r * Hc, Hc, BT);
      cl.sync();
      // du_prev = du z + Whh_up^T dt(d_hh)
      float ah[MAXP][4];
      zero_acc(ah);
      warp_mma<kStream>(ah, bc.D, LDD, wh, 0, Hc, w, tl, 2 * H, bc.ring);
      warp_mma<kStream>(ah, bc.D + 3 * H, LDD, wh, 2 * H, Hc, w, tl, H,
                        bc.ring);
#pragma unroll
      for (int i = 0; i < MAXP; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) du[i][q] += ah[i][q];
      cluster_arrive();
    }
    cluster_wait();
    store_frag(p.dh0u, du, w, tl, r, Hc, B, col0);
    reduce_bias(bp, bc.red, part, w, tl, r, Hc, H, BT);
  }
  cl.sync();   // no CTA leaves while another may still address its smem
}

struct Grads {
  bf16 *dwhh_up, *dbhh_up, *dwin2, *dbin2, *dwhh_dn, *dbhh_dn;
};

int launch(const Params& p, const Grads& g, float* work, int S, int stream,
           cudaStream_t st) {
  const int C = p.C, BT = p.BT, H = p.H;
  if (C < 1 || C > 8 || BT % 16 != 0 || BT < 16 || NW % (BT / 16) != 0 ||
      H % (8 * C) != 0 || H / C / 8 > NW / (BT / 16) * MAXP ||
      H / C / 8 * BT > MAXI * NTH || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(H, C, BT, stream != 0);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = stream ? launch_cluster(b8_mma_kernel<true>, p, C, BT, p.B,
                                         smem, st)
                        : launch_cluster(b8_mma_kernel<false>, p, C, BT, p.B,
                                         smem, st);
  if (rc != 0) return rc;
  const int L = p.L, B = p.B, tiles = (B + BT - 1) / BT;
  const size_t sB = B, bundle = 4 * H * sB;
  const GJob jobs[] = {
      {p.gates_u, bundle, 2 * H, H, p.up_h, H * sB, 1, p.h0u, g.dwhh_up,
       3 * H, H},
      {p.gates_d, bundle, 3 * H, 0, p.up_h, H * sB, 0, nullptr, g.dwin2,
       3 * H, H},
      {p.gates_d, bundle, 2 * H, H, p.g_h, H * sB, -1, p.h0d, g.dwhh_dn,
       3 * H, H},
  };
  const int rg = gemms(jobs, L, B, S, work, st);
  if (rg != 0) return rg;
  bias_sum_kernel<<<(8 * H + 255) / 256, 256, 0, st>>>(
      p.bpart, tiles, H, 0, 0, nullptr, g.dbhh_up, g.dbin2, g.dbhh_dn,
      nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace b8
}  // namespace bmma

// bf16 tensor-core design. ptrs, in order (H already padded to a multiple
// of 8 C, every tensor's gate blocks with it):
//   xp [L, B, 3H], h0u, h0d [H, B] (channel-major), d_down [L, B, H],
//   d_lasth [H, B] (channel-major);
//   wh_up [C][3H/C][H] (the gate slices of Whh_up^T, [out, in]), bh_up
//   [3H], wx_dn (W2^T) and wh_dn like wh_up, b2, bh_dn [3H];
//   whT_dn, w2T, whT_up [C][H/C][3H] (the input-row slices of Whh_dn, W2
//   and Whh_up, [in, out]);
//   d_xp [L, B, 3H], dh0u, dh0d [H, B] (channel-major);
//   scratch up_h, g_h [L, H, B], gates_u, gates_d [L, 4H, B] (bf16), d_up
//   [L, H, B] f32, bias partials [tiles, 8H] f32, work [S x 3H x H] f32;
//   gradients dwhh_up^T [3H, H], dbhh_up [3H], dwin2^T, dbin2, dwhh_dn^T,
//   dbhh_dn.
// stream: 1 for the streamed-weights instantiation. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for shapes outside
// the design).
extern "C" int bigru_lbh_bwd_mma(int nptr, void* const* q, int L, int H,
                                 int B, int C, int BT, int S, int stream,
                                 void* st) {
  using bmma::bf16;
  if (nptr != 30) return static_cast<int>(cudaErrorInvalidValue);
  const auto c = [&](int i) { return static_cast<const bf16*>(q[i]); };
  const auto m = [&](int i) { return static_cast<bf16*>(q[i]); };
  bmma::b8::Params p{c(0), c(1), c(2), c(3), c(4),
                     c(5), c(6), c(7), c(8), c(9), c(10),
                     c(11), c(12), c(13),
                     m(14), m(15), m(16),
                     m(17), m(18), m(19), m(20),
                     static_cast<float*>(q[21]), static_cast<float*>(q[22]),
                     L, H, B, C, BT};
  bmma::b8::Grads g{m(24), m(25), m(26), m(27), m(28), m(29)};
  return bmma::b8::launch(p, g, static_cast<float*>(q[23]), S, stream,
                          static_cast<cudaStream_t>(st));
}

// ------------------------------------------------ f32: cluster design
//
// B8's BPTT and weight-gradient kernels of the f32 cluster design; the
// replay is bigru_f32.cuh's sweep kernel with the gate bundles stored.
namespace bf32 {

// ------------------------------------------------------------ BPTT sweeps

// B8's two BPTT sweeps. Slices [C][3H][Hc]: CTA r's rows of a k-major
// [H, 3H] weight transposed (slice[o][jl] = W[r Hc + jl][o]). The gate
// bundles [L][4H][Bs] are overwritten in place by the gradient bundles
// [dar; daz; dan; dhn], the left factor of the weight gradients. d_up
// [L][H][Bs] f32 scratch; d_xp [L][B][3H], dh0s [B][H]; bpart [tiles][8H]
// the tiles' sums of the down (first 4H) and up bundles.
struct BpttParams {
  const float *dd, *dlh, *h0u, *h0d, *up, *gh;
  float *gates_u, *gates_d;
  const float *whT_dn, *w2T, *whT_up;
  float *dup, *dxp, *dh0u, *dh0d, *bpart;
  int L, H, B, Bs, C, BT;
};

__host__ __device__ inline size_t bptt_smem(int H, int C, int BT) {
  const size_t Hc = H / C;
  return sizeof(float) * (2 * 3 * static_cast<size_t>(H) * Hc +
                          4 * static_cast<size_t>(H) * BT);
}

// A level's inputs of the backward step at the thread's units and
// columns: the stored gates [r, z, n, hn] (gl [4H][Bs]), the previous
// state (hp [H][Bs]) and the gradient's addend (d_down, batch-major
// [B][H], or d_up, channel-major [H][Bs]); fetched into registers a level
// ahead, while the current level's products run.
struct BwdIn {
  float gt[4][2][4], h[2][4], add[2][4];
  __device__ void fetch(const float* gl, const float* hp, const float* add_l,
                        bool add_bm, int H, int B, int Bs, int j0, int col) {
    const size_t lvl = static_cast<size_t>(H) * Bs;
#pragma unroll
    for (int g = 0; g < 4; ++g) load_quads(gt[g], gl + g * lvl, Bs, j0, col);
    load_quads(h, hp, Bs, j0, col);
    if (!add_bm) {
      load_quads(add, add_l, Bs, j0, col);
      return;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float2 v = make_float2(0.f, 0.f);
      if (col + c < B)
        v = __ldg(reinterpret_cast<const float2*>(
            add_l + static_cast<size_t>(col + c) * H + j0));
      add[0][c] = v.x;
      add[1][c] = v.y;
    }
  }
};

// The GRU backward step of the thread's units and columns: g the carried
// gradient of h, plus the level's addend, with the level's gates and
// previous state (in) -> the bundle d = [dar, daz, dan, dhn]; g becomes
// g z (the first term of dh_prev).
__device__ __forceinline__ void bwd_step(float (&g)[2][4], const BwdIn& in,
                                         float (&d)[4][2][4]) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float dh = g[u][c] + in.add[u][c];
      const float rr = in.gt[0][u][c], zz = in.gt[1][u][c];
      const float nn = in.gt[2][u][c];
      const float dz = dh * (in.h[u][c] - nn);
      const float dan = dh * (1.0f - zz) * (1.0f - nn * nn);
      d[0][u][c] = dan * in.gt[3][u][c] * rr * (1.0f - rr);
      d[1][u][c] = dz * zz * (1.0f - zz);
      d[2][u][c] = dan;
      d[3][u][c] = dan * rr;
      g[u][c] = dh * zz;
    }
}

// ah[u][c] += sum_o A[o][jl + u] Dhh[o][c] (Whh^T d_hh, d_hh = D's rows
// [dar; daz; dhn]) and, with kW2, au[u][c] += sum_o W[o][jl + u] D[o][c]
// (W2^T d_xp, d_xp = rows [dar; daz; dan]); A, W [3H][Hc] and D [4H][BT]
// in shared memory. The two share the dar and daz rows' loads.
template <bool kW2>
__device__ __forceinline__ void prod_t(float (&ah)[2][4], float (&au)[2][4],
                                       const float* A, const float* W,
                                       const float* D, int H, int Hc, int BT,
                                       const Map& m) {
  const float* a = A + m.jl;
  const float* w = W + m.jl;
  const float* d = D + m.c0;
#pragma unroll 4
  for (int o = 0; o < 2 * H; ++o) {
    const float4 dv = *reinterpret_cast<const float4*>(d + o * BT);
    const float ds[4] = {dv.x, dv.y, dv.z, dv.w};
    const float2 av = *reinterpret_cast<const float2*>(a + o * Hc);
    float2 wv = make_float2(0.f, 0.f);
    if (kW2) wv = *reinterpret_cast<const float2*>(w + o * Hc);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ah[0][c] = fmaf(av.x, ds[c], ah[0][c]);
      ah[1][c] = fmaf(av.y, ds[c], ah[1][c]);
      if (kW2) {
        au[0][c] = fmaf(wv.x, ds[c], au[0][c]);
        au[1][c] = fmaf(wv.y, ds[c], au[1][c]);
      }
    }
  }
#pragma unroll 4
  for (int o = 2 * H; o < 3 * H; ++o) {
    const float4 dv = *reinterpret_cast<const float4*>(d + (o + H) * BT);
    const float ds[4] = {dv.x, dv.y, dv.z, dv.w};
    const float2 av = *reinterpret_cast<const float2*>(a + o * Hc);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ah[0][c] = fmaf(av.x, ds[c], ah[0][c]);
      ah[1][c] = fmaf(av.y, ds[c], ah[1][c]);
    }
    if (kW2) {
      const float4 nv = *reinterpret_cast<const float4*>(d + o * BT);
      const float ns[4] = {nv.x, nv.y, nv.z, nv.w};
      const float2 wv = *reinterpret_cast<const float2*>(w + o * Hc);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        au[0][c] = fmaf(wv.x, ns[c], au[0][c]);
        au[1][c] = fmaf(wv.y, ns[c], au[1][c]);
      }
    }
  }
}

// The tile's sums of a sweep's bundles, in a fixed order: each thread's
// sums s[g][u] (over its columns and the levels) go to red [BT/4][4][Hc]
// in shared memory, then thread t < 4 Hc adds the column quads in order
// into out[g H + r Hc + jl] (out = the tile's 4H sums).
__device__ __forceinline__ void reduce_sums(const float (&s)[4][2], float* red,
                                            float* out, int H, int Hc, int BT,
                                            int r, const Map& m) {
  const int q = m.c0 / 4, nq = BT / 4;
  __syncthreads();
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int u = 0; u < 2; ++u) red[(q * 4 + g) * Hc + m.jl + u] = s[g][u];
  __syncthreads();
  for (int t = threadIdx.x; t < 4 * Hc; t += blockDim.x) {
    const int g = t / Hc, jl = t % Hc;
    float a = 0.0f;
    for (int qq = 0; qq < nq; ++qq) a += red[(qq * 4 + g) * Hc + jl];
    out[g * H + r * Hc + jl] = a;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NTH_MAX, 1) f32_bptt_kernel(BpttParams p) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = p.C, BT = p.BT, r = static_cast<int>(cl.block_rank());
  const int H = p.H, Hc = H / C, L = p.L, B = p.B, Bs = p.Bs;
  const int tile = blockIdx.x / C, col0 = tile * BT;
  const Map m(BT);
  const int j0 = r * Hc + m.jl, col = col0 + m.c0;
  const size_t lvl = static_cast<size_t>(H) * Bs, wsz = static_cast<size_t>(3) * H * Hc;
  float* part = p.bpart + static_cast<size_t>(tile) * 8 * H;
  extern __shared__ __align__(16) float smem[];
  float* wa = smem;                         // [3H][Hc]
  float* wb = wa + wsz;                     // [3H][Hc]
  float* D = wb + wsz;                      // [4H][BT] the level's bundle
  float d[4][2][4], s[4][2];

  // ---- the down-sweep BPTT (surface to top)
  {
    load_vec(wa, p.whT_dn + r * wsz, wsz);
    load_vec(wb, p.w2T + r * wsz, wsz);
    float dh[2][4];
    load_quads(dh, p.dlh, Bs, j0, col);
#pragma unroll
    for (int g = 0; g < 4; ++g) s[g][0] = s[g][1] = 0.0f;
    BwdIn in;
    const auto fetch = [&](int l) {
      in.fetch(p.gates_d + 4 * l * lvl, l > 0 ? p.gh + (l - 1) * lvl : p.h0d,
               p.dd + static_cast<size_t>(l) * B * H, true, H, B, Bs, j0,
               col);
    };
    fetch(L - 1);
    __syncthreads();
    cluster_arrive();
    for (int l = L - 1; l >= 0; --l) {
      cluster_wait();       // every CTA has read the last level's bundle
      float* gl = p.gates_d + 4 * l * lvl;
      bwd_step(dh, in, d);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
          s[g][u] += ((d[g][u][0] + d[g][u][1]) + d[g][u][2]) + d[g][u][3];
        if (col < B) store_quads(gl + g * lvl, d[g], Bs, j0, col);
        bcast_quads(cl, D + g * H * BT, d[g], BT, j0, m.c0, C);
      }
      cl.sync();
      if (l > 0) fetch(l - 1);
      // dh2_prev = dh2 z + Whh_dn^T d_hh; d_up = W2^T d_xp
      float ah[2][4] = {}, au[2][4] = {};
      prod_t<true>(ah, au, wa, wb, D, H, Hc, BT, m);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) dh[u][c] += ah[u][c];
      if (col < B) store_quads(p.dup + l * lvl, au, Bs, j0, col);
      cluster_arrive();
    }
    cluster_wait();
    store_pairs(p.dh0d, dh, H, B, j0, col);
    reduce_sums(s, D, part, H, Hc, BT, r, m);
  }

  // ---- the up-sweep BPTT (top to surface) from a zero carry
  {
    load_vec(wa, p.whT_up + r * wsz, wsz);
    float du[2][4] = {};
#pragma unroll
    for (int g = 0; g < 4; ++g) s[g][0] = s[g][1] = 0.0f;
    BwdIn in;
    const auto fetch = [&](int l) {
      in.fetch(p.gates_u + 4 * l * lvl,
               l < L - 1 ? p.up + (l + 1) * lvl : p.h0u, p.dup + l * lvl,
               false, H, B, Bs, j0, col);
    };
    fetch(0);
    __syncthreads();
    cluster_arrive();
    for (int l = 0; l < L; ++l) {
      cluster_wait();
      float* gl = p.gates_u + 4 * l * lvl;
      bwd_step(du, in, d);
      float* dxl = p.dxp + static_cast<size_t>(l) * B * 3 * H;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
          s[g][u] += ((d[g][u][0] + d[g][u][1]) + d[g][u][2]) + d[g][u][3];
        if (col < B) store_quads(gl + g * lvl, d[g], Bs, j0, col);
        if (g < 3) store_pairs(dxl + g * H, d[g], 3 * H, B, j0, col);
        if (g != 2) bcast_quads(cl, D + g * H * BT, d[g], BT, j0, m.c0, C);
      }
      cl.sync();
      if (l + 1 < L) fetch(l + 1);
      // du_prev = du z + Whh_up^T d_hh
      float ah[2][4] = {}, unused[2][4];
      prod_t<false>(ah, unused, wa, nullptr, D, H, Hc, BT, m);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) du[u][c] += ah[u][c];
      cluster_arrive();
    }
    cluster_wait();
    store_pairs(p.dh0u, du, H, B, j0, col);
    reduce_sums(s, D, part + 4 * H, H, Hc, BT, r, m);
  }
  // no CTA leaves while another may still address its shared memory: the
  // last remote store preceded the last level's barrier
}

// ------------------------------------------------------- weight gradients

// A weight gradient out[m][n] = sum over levels l and columns b of
// A_l[m][b] G_l[row(n)][b] (M = H, N = 3H): A_l = A[l + shift] ([L][H][Bs],
// the states) or the edge state [H][Bs] where l + shift leaves 0 .. L-1;
// G_l the level's gradient bundle [4H][Bs], row(n) = n below 2H and n + hi
// from there (hi = H: d_hh = [dar; daz; dhn]; 0: d_xp = [dar; daz; dan]).
struct GJob {
  const float *A, *edge, *G;
  int shift, hi;
};
struct GJobs {
  GJob j[3];
  float* out[3];    // the gradients [H][3H]
};

constexpr int TM = 128, TN = 128, TK = 16, GTH = 256;

// One output tile TM x TN of one job over split s of the L x ceil(B / TK)
// column chunks, written to part[s][job][M][N]: a register-blocked FFMA
// GEMM, 8 x 8 outputs a thread, its A and G chunks staged through a
// double-buffered shared-memory tile (the next chunk's 16-byte loads in
// registers while the current one runs). Fixed order everywhere, no
// atomics: two calls are bit-identical.
__global__ void __launch_bounds__(GTH, 2)
f32_wgrad_kernel(GJobs jobs, int L, int H, int B, int Bs, int S,
                 float* part) {
  __shared__ __align__(16) float As[2][TK][TM + 4];
  __shared__ __align__(16) float Gs[2][TK][TN + 4];
  const int M = H, N = 3 * H;
  const int mt = (M + TM - 1) / TM, nt = (N + TN - 1) / TN;
  const int job = blockIdx.x / (mt * nt), t = blockIdx.x % (mt * nt);
  const int m0 = (t / nt) * TM, n0 = (t % nt) * TN, s = blockIdx.y;
  const GJob jb = jobs.j[job];
  const int nb = (B + TK - 1) / TK;
  const long Q = static_cast<long>(L) * nb;
  const long q0 = Q * s / S, q1 = Q * (s + 1) / S;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t lvl = static_cast<size_t>(H) * Bs;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float4 ra[2], rg[2];
  // loader e = tid + 256 i: tile row e / 4, columns 4 (e % 4) .. + 3
  const auto fetch = [&](long q) {
    const int l = static_cast<int>(q / nb);
    const int b = static_cast<int>(q % nb) * TK;
    const int ls = l + jb.shift;
    const float* Al = (ls >= 0 && ls < L) ? jb.A + ls * lvl : jb.edge;
    const float* Gl = jb.G + 4 * l * lvl;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + GTH * i, row = e / 4, c = b + 4 * (e % 4);
      const int mm = m0 + row, nn = n0 + row;
      const bool ok = c < B;
      ra[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      rg[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok && mm < M)
        ra[i] = __ldcg(reinterpret_cast<const float4*>(
            Al + static_cast<size_t>(mm) * Bs + c));
      if (ok && nn < N) {
        const int gr = nn < 2 * H ? nn : nn + jb.hi;
        rg[i] = __ldcg(reinterpret_cast<const float4*>(
            Gl + static_cast<size_t>(gr) * Bs + c));
      }
    }
  };
  const auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + GTH * i, row = e / 4, k = 4 * (e % 4);
      As[buf][k][row] = ra[i].x;
      As[buf][k + 1][row] = ra[i].y;
      As[buf][k + 2][row] = ra[i].z;
      As[buf][k + 3][row] = ra[i].w;
      Gs[buf][k][row] = rg[i].x;
      Gs[buf][k + 1][row] = rg[i].y;
      Gs[buf][k + 2][row] = rg[i].z;
      Gs[buf][k + 3][row] = rg[i].w;
    }
  };
  int buf = 0;
  if (q0 < q1) {
    fetch(q0);
    stash(0);
  }
  __syncthreads();
  for (long q = q0; q < q1; ++q) {
    if (q + 1 < q1) fetch(q + 1);
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 g0 = *reinterpret_cast<const float4*>(&Gs[buf][k][tx * 4]);
      const float4 g1 =
          *reinterpret_cast<const float4*>(&Gs[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
    }
    if (q + 1 < q1) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  float* out = part + (static_cast<size_t>(s) * 3 + job) * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int mm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (mm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (nn < N) out[static_cast<size_t>(mm) * N + nn] = acc[i][j];
    }
  }
}

// out_job[i] = sum_s part[s][job][i], the splits added in order
__global__ void f32_sum_parts_kernel(const float* part, int S, int MN,
                                     GJobs jobs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * MN) return;
  const int job = i / MN, e = i % MN;
  float a = 0.0f;
  for (int s = 0; s < S; ++s)
    a += part[(static_cast<size_t>(s) * 3 + job) * MN + e];
  jobs.out[job][e] = a;
}

// The bias gradients from the tiles' bundle sums, the tiles added in
// order: dbhh_up the up bundles' [dar; daz; dhn], dbin2 the down bundles'
// [dar; daz; dan], dbhh_dn their [dar; daz; dhn].
__global__ void f32_bias_kernel(const float* bpart, int tiles, int H,
                                float* dbhh_up, float* dbin2,
                                float* dbhh_dn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 9 * H) return;
  const int which = i / (3 * H), e = i % (3 * H), g = e / H, j = e % H;
  const int row = (which == 1 || g < 2) ? g : 3;
  const int off = (which == 0 ? 4 * H : 0) + row * H + j;
  float a = 0.0f;
  for (int t = 0; t < tiles; ++t) a += bpart[static_cast<size_t>(t) * 8 * H + off];
  (which == 0 ? dbhh_up : which == 1 ? dbin2 : dbhh_dn)[e] = a;
}

inline int launch_bptt(const BpttParams& p, cudaStream_t st) {
  if (!plan_ok(p.H, p.C, p.BT) || p.Bs % 4 != 0 || p.Bs < p.B)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bptt_smem(p.H, p.C, p.BT);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster(f32_bptt_kernel, p, p.C, (p.B + p.BT - 1) / p.BT,
                        threads_of(p.H, p.C, p.BT), smem, st);
}

}  // namespace bf32

// f32 (the physics trunk's training backward, L 50, H 128, and any f32
// v2/v3/v4 arm's) runs the cluster FFMA design of bigru_f32.cuh where its
// plan fits, in the order the bf16 design above uses:
//   1. f32_sweep_kernel<true>: the replay (B7's cluster sweeps) storing h
//      and the gate bundle [r; z; n; hn] of both sweeps, f32,
//      channel-major;
//   2. f32_bptt_kernel: the down-sweep and then the up-sweep BPTT on
//      clusters of the same C, each CTA's [3H][Hc] slices of Whh^T (and
//      W2^T) resident, the level's gradient bundle [dar; daz; dan; dhn]
//      sent to every CTA over distributed shared memory, the carried
//      gradient in registers; the bundle overwrites the stored gates, so
//      it is the weight gradients' left factor and no [L, B, 3H] gradient
//      stream is kept (6.07 GB of scratch at L 50, B 21,600, H 128, where
//      the CUDA-core design took 11.05 GB);
//   3. f32_wgrad_kernel: dWhh_up, dWin2 and dWhh_dn as one register-
//      blocked FFMA GEMM over the L x B contraction, split in S fixed
//      ranges; f32_sum_parts_kernel adds the splits in order and
//      f32_bias_kernel the tiles' bias sums. No atomics: two calls are
//      bit-identical.
// Its bound at the physics trunk's shapes is the 0.9555 TFLOP above at
// 67 TFLOP/s, 14.26 ms.
//
// ptrs, in order (H already padded to a multiple of 8 C, every tensor's
// gate blocks with it; Bs = B rounded up to a multiple of 4):
//   xp [L, B, 3H]; h0u, h0d [H, Bs] (channel-major, zero past B); d_down
//   [L, B, H]; d_lasth [H, Bs] (channel-major, zero past B);
//   wh_up, bh_up, wx_dn, b2, wh_dn, bh_dn as bigru_lbh_f32's;
//   whT_dn, w2T, whT_up [C][3H][H/C] (CTA r's input rows of the k-major
//   Whh_dn, W2, Whh_up, transposed);
//   d_xp [L, B, 3H], dh0u, dh0d [B, H];
//   scratch up, gh [L, H, Bs], gates_u, gates_d [L, 4H, Bs], d_up
//   [L, H, Bs], bias sums [ceil(B / BTb), 8H], GEMM splits [S, 3, H, 3H];
//   dwhh_up, dwin2, dwhh_dn [H, 3H] (k-major), dbhh_up, dbin2, dbhh_dn
//   [3H].
// BTa, BTb: the sweeps' and the BPTT's column tiles. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for shapes outside
// the design).
extern "C" int bigru_lbh_bwd_f32(int nptr, void* const* q, int L, int H,
                                 int B, int Bs, int C, int BTa, int BTb,
                                 int S, void* st) {
  if (nptr != 30 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto c = [&](int i) { return static_cast<const float*>(q[i]); };
  const auto m = [&](int i) { return static_cast<float*>(q[i]); };
  cudaStream_t s = static_cast<cudaStream_t>(st);
  const bf32::SweepParams sp{c(0), c(1), c(2), c(5), c(6), c(7), c(8),
                             c(9), c(10), m(17), m(18), m(19), m(20),
                             nullptr, nullptr, L, H, B, Bs, C, BTa};
  int rc = bf32::launch_sweep<true>(sp, s);
  if (rc != 0) return rc;
  const bf32::BpttParams bp{c(3), c(4), c(1), c(2), m(17), m(18), m(19),
                            m(20), c(11), c(12), c(13), m(21), m(14),
                            m(15), m(16), m(22), L, H, B, Bs, C, BTb};
  rc = bf32::launch_bptt(bp, s);
  if (rc != 0) return rc;
  const bf32::GJobs jobs{{{m(17), c(1), m(19), 1, H},
                          {m(17), nullptr, m(20), 0, 0},
                          {m(18), c(2), m(20), -1, H}},
                         {m(24), m(25), m(26)}};
  const int mt = (H + bf32::TM - 1) / bf32::TM;
  const int nt = (3 * H + bf32::TN - 1) / bf32::TN;
  float* part = m(23);
  bf32::f32_wgrad_kernel<<<dim3(3 * mt * nt, S), bf32::GTH, 0, s>>>(
      jobs, L, H, B, Bs, S, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int MN = 3 * H * H;
  bf32::f32_sum_parts_kernel<<<(3 * MN + 255) / 256, 256, 0, s>>>(
      part, S, MN, jobs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bf32::f32_bias_kernel<<<(9 * H + 255) / 256, 256, 0, s>>>(
      c(22), (B + BTb - 1) / BTb, H, m(27), m(28), m(29));
  return static_cast<int>(cudaGetLastError());
}
