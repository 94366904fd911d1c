// The f32 cluster design of the v2 BiGRU on the CUDA cores: the sweeps of
// the forward (B7, bigru_lbh.cu) and of the backward's replay (B8,
// bigru_lbh_bwd.cu, which holds B8's BPTT and weight-gradient kernels),
// and the helpers they share, in float32.
//
// The f32 policy rules out TF32 (and so 3xTF32): every product is FFMA on
// the CUDA cores, accumulated in f32, so only the summation order differs
// from the plain version. Built without --use_fast_math: expf/tanhf keep
// the 100-level recurrences within the f32 gates.
//
// Plan (the wrapper's f32_plan): a cluster of C CTAs owns a tile of BT
// columns; CTA r owns the hidden units [r Hc, (r + 1) Hc), Hc = H / C, and
// keeps its gate slices of a sweep's weights resident in shared memory,
// k-major [H][3 Hc] (the three gate columns of its units for every input).
// A thread owns 2 hidden units x 4 columns: its f32 state sits in
// registers, and a level's product is a register-blocked micro-tile of
// 3 gates x 2 units x 4 columns (24 accumulators) over k, each k one
// 128-bit load of the state tile and three 64-bit loads of the weights
// for 24 FMAs. A warp spans 4 unit pairs x 8 column quads, so its state
// load reads 8 distinct 16-byte words and its weight loads 4 distinct
// 8-byte words: one shared-memory wavefront each. The level's new h (f32)
// goes from the registers to every CTA's next state tile over distributed
// shared memory (two 16-byte stores a thread and CTA), one cluster barrier
// a level; the state tile is double-buffered, so a CTA never writes a
// buffer another may still read.
//
// Scratch layouts are channel-major [L][rows][Bs] f32 (Bs = B rounded up
// to 4, so every 4-column quad is one aligned 16-byte word): a thread
// stores and loads its units' quads whole, and a tile's rows are read
// back as 16-byte copies. xp, d_down, d_xp and B7's down / last_h keep the
// caller's batch-major layout and are read and written 8 bytes (a unit
// pair) a column.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf32 {

namespace cg = cooperative_groups;

constexpr int NTH_MAX = 256;            // threads of a CTA at most
constexpr size_t SMEM_MAX = 232448;     // dynamic shared memory per CTA

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A thread's place in the tile: local units jl, jl + 1 and tile columns
// c0 .. c0 + 3. The CTA has Hc / 2 x BT / 4 threads (Hc a multiple of 8,
// BT of 32): warp w covers unit pairs 4 (w / (BT / 32)) .. + 3 and column
// quads 8 (w % (BT / 32)) .. + 7.
struct Map {
  int jl, c0;
  __device__ explicit Map(int BT) {
    const int wpr = BT / 32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    jl = 2 * ((warp / wpr) * 4 + (lane >> 3));
    c0 = 4 * ((warp % wpr) * 8 + (lane & 7));
  }
};

// n floats (a multiple of 4, both 16-byte aligned) from global memory
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         size_t n) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (size_t e = threadIdx.x; e < n / 4; e += blockDim.x) d[e] = __ldg(s + e);
}

// dst[k][c] = src[k][col0 + c] for k < rows, c < BT, from a channel-major
// [rows][Bs] array: 16-byte copies with cp.async (L2 only: the tile may
// have been written by another CTA of this kernel), zero past Bs. The
// caller commits, waits and synchronises.
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int rows, int Bs, int col0,
                                          int BT) {
  const int q4 = BT / 4;
  for (int e = threadIdx.x; e < rows * q4; e += blockDim.x) {
    const int k = e / q4, c = (e % q4) * 4, col = col0 + c;
    float* d = dst + k * BT + c;
    if (col < Bs)
      cp_async16(d, src + static_cast<size_t>(k) * Bs + col);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// v[u][.] = src[j0 + u][col .. col + 3] of a channel-major [.][Bs] array
// (zero past Bs)
__device__ __forceinline__ void load_quads(float (&v)[2][4], const float* src,
                                           int Bs, int j0, int col) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col < Bs)
      q = __ldcg(reinterpret_cast<const float4*>(
          src + static_cast<size_t>(j0 + u) * Bs + col));
    v[u][0] = q.x; v[u][1] = q.y; v[u][2] = q.z; v[u][3] = q.w;
  }
}

// dst[j0 + u][col .. col + 3] = v[u][.] (col < Bs, checked by the caller)
__device__ __forceinline__ void store_quads(float* dst, const float (&v)[2][4],
                                            int Bs, int j0, int col) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
    *reinterpret_cast<float4*>(dst + static_cast<size_t>(j0 + u) * Bs + col) =
        make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
}

// dst[col + c][j0 .. j0 + 1] = (v[0][c], v[1][c]) of a batch-major [B][ld]
// array, inside the batch
__device__ __forceinline__ void store_pairs(float* dst, const float (&v)[2][4],
                                            int ld, int B, int j0, int col) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (col + c < B)
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(col + c) * ld +
                                 j0) = make_float2(v[0][c], v[1][c]);
}

// The thread's quads of dt(h) = h written to rows j0, j0 + 1 of the next
// state tile [H][BT] of every CTA of the cluster
__device__ __forceinline__ void bcast_quads(cg::cluster_group& cl, float* buf,
                                            const float (&v)[2][4], int BT,
                                            int j0, int c0, int C) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    float* p = buf + (j0 + u) * BT + c0;
    const float4 q = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
    for (int r = 0; r < C; ++r)
      *reinterpret_cast<float4*>(cl.map_shared_rank(p, r)) = q;
  }
}

// a[g][u][c] += sum_k W[k][g Hc + jl + u] X[k][c0 + c]: W [K][3 Hc] and
// X [K][BT] in shared memory
__device__ __forceinline__ void prod3(float (&a)[3][2][4], const float* W,
                                      int Hc, const float* X, int BT, int K,
                                      const Map& m) {
  const float* w = W + m.jl;
  const float* x = X + m.c0;
  const int ldw = 3 * Hc;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 xv = *reinterpret_cast<const float4*>(x + k * BT);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float2 wv =
          *reinterpret_cast<const float2*>(w + k * ldw + g * Hc);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        a[g][0][c] = fmaf(wv.x, xs[c], a[g][0][c]);
        a[g][1][c] = fmaf(wv.y, xs[c], a[g][1][c]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&a)[3][2][4]) {
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[g][u][c] = 0.0f;
}

// b[g][u] = bias[g H + j0 + u]
__device__ __forceinline__ void biases(float (&b)[3][2], const float* bias,
                                       int H, int j0) {
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int u = 0; u < 2; ++u) b[g][u] = __ldg(bias + g * H + j0 + u);
}

// The GRU update of the thread's units and columns: x the input
// projection (bias included), a = Whh h (no bias), bh the recurrent bias;
// h updated in place, the gate bundle [r, z, n, hn] into gt.
__device__ __forceinline__ void gru_step(float (&h)[2][4],
                                         const float (&x)[3][2][4],
                                         const float (&a)[3][2][4],
                                         const float (&bh)[3][2],
                                         float (&gt)[4][2][4]) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float r = sigm(x[0][u][c] + (a[0][u][c] + bh[0][u]));
      const float z = sigm(x[1][u][c] + (a[1][u][c] + bh[1][u]));
      const float hn = a[2][u][c] + bh[2][u];
      const float n = tanhf(x[2][u][c] + r * hn);
      h[u][c] = (1.0f - z) * n + z * h[u][c];
      gt[0][u][c] = r;
      gt[1][u][c] = z;
      gt[2][u][c] = n;
      gt[3][u][c] = hn;
    }
}

// ------------------------------------------------------------------ sweeps

// B7 (kGates false) and B8's replay (kGates true). Slices [C][H][3 Hc]
// (CTA r's gate columns of a k-major [H, 3H] weight), biases [3H]; h0s
// channel-major [H][Bs]; up [L][H][Bs] the up states (scratch). B7 writes
// down [L][B][H] and lasth [B][H]; the replay writes the down states gh
// [L][H][Bs] and the gate bundles [L][4H][Bs] of both sweeps.
struct SweepParams {
  const float *xp, *h0u, *h0d;
  const float *wh_up, *bh_up, *wx_dn, *b2, *wh_dn, *bh_dn;
  float *up, *gh, *gates_u, *gates_d, *down, *lasth;
  int L, H, B, Bs, C, BT;
};

__host__ __device__ inline size_t sweep_smem(int H, int C, int BT) {
  const size_t Hc = H / C, w = static_cast<size_t>(H) * 3 * Hc;
  const size_t up = w + 2 * static_cast<size_t>(H) * BT;
  const size_t dn = 2 * w + 3 * static_cast<size_t>(H) * BT;
  return sizeof(float) * (up > dn ? up : dn);
}

template <bool kGates>
__global__ void __launch_bounds__(NTH_MAX, 1) f32_sweep_kernel(SweepParams p) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = p.C, BT = p.BT, r = static_cast<int>(cl.block_rank());
  const int H = p.H, Hc = H / C, L = p.L, B = p.B, Bs = p.Bs;
  const int col0 = (blockIdx.x / C) * BT;
  const Map m(BT);
  const int j0 = r * Hc + m.jl, col = col0 + m.c0;
  const size_t lvl = static_cast<size_t>(H) * Bs;
  const size_t wsz = static_cast<size_t>(H) * 3 * Hc;
  extern __shared__ __align__(16) float smem[];
  float h[2][4], bx[3][2], bh[3][2], gt[4][2][4];
  // the level's new h into the next state tile of every CTA, and the
  // sweep's stores (the states st, with kGates the gate bundles)
  const auto emit = [&](float* hnext, float* st, float* gates) {
    bcast_quads(cl, hnext, h, BT, j0, m.c0, C);
    if (col < B) {
      if (st != nullptr) store_quads(st, h, Bs, j0, col);
      if (kGates)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          store_quads(gates + g * lvl, gt[g], Bs, j0, col);
    }
  };

  // ---- up sweep, surface (l = L-1) to top, on the given projection xp
  {
    float* ws = smem;                       // [H][3 Hc]
    float* hb = ws + wsz;                   // [2][H][BT]
    load_vec(ws, p.wh_up + r * wsz, wsz);
    copy_tile(hb, p.h0u, H, Bs, col0, BT);
    cp_async_commit();
    biases(bh, p.bh_up, H, j0);
    load_quads(h, p.h0u, Bs, j0, col);
    float xq[3][2][4];
    const auto fetch = [&](int l) {
      const float* xl = p.xp + static_cast<size_t>(l) * B * 3 * H;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          float2 v = make_float2(0.f, 0.f);
          if (col + c < B)
            v = __ldg(reinterpret_cast<const float2*>(
                xl + static_cast<size_t>(col + c) * 3 * H + g * H + j0));
          xq[g][0][c] = v.x;
          xq[g][1][c] = v.y;
        }
    };
    fetch(L - 1);
    cp_async_wait_all();
    cl.sync();              // every CTA's tiles are set before a DSMEM store
    int cur = 0;
    for (int s = 0; s < L; ++s) {
      const int l = L - 1 - s;
      float a[3][2][4], x[3][2][4];
      zero(a);
      prod3(a, ws, Hc, hb + cur * H * BT, BT, H, m);
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c) x[g][u][c] = xq[g][u][c];
      if (l > 0) fetch(l - 1);
      gru_step(h, x, a, bh, gt);
      emit(hb + (cur ^ 1) * H * BT, p.up + l * lvl, p.gates_u + 4 * l * lvl);
      cl.sync();
      cur ^= 1;
    }
  }
  // the up states were stored to global memory by every CTA of the
  // cluster: make them visible to the others before they read them back
  __threadfence();
  cl.sync();

  // ---- down sweep, top (l = 0) to surface: x2 = W2 up_l + b2 (f32),
  // then the recurrence
  {
    float* wx = smem;                       // [H][3 Hc]
    float* wh = wx + wsz;                   // [H][3 Hc]
    float* hb = wh + wsz;                   // [2][H][BT]
    float* xt = hb + 2 * H * BT;            // [H][BT] up_l
    load_vec(wx, p.wx_dn + r * wsz, wsz);
    load_vec(wh, p.wh_dn + r * wsz, wsz);
    copy_tile(hb, p.h0d, H, Bs, col0, BT);
    copy_tile(xt, p.up, H, Bs, col0, BT);
    cp_async_commit();
    biases(bx, p.b2, H, j0);
    biases(bh, p.bh_dn, H, j0);
    load_quads(h, p.h0d, Bs, j0, col);
    cp_async_wait_all();
    __syncthreads();
    int cur = 0;
    for (int l = 0; l < L; ++l) {
      float ax[3][2][4], ah[3][2][4];
      zero(ax);
      zero(ah);
      prod3(ax, wx, Hc, xt, BT, H, m);
      prod3(ah, wh, Hc, hb + cur * H * BT, BT, H, m);
      __syncthreads();                      // every thread has read xt
      if (l + 1 < L) {
        copy_tile(xt, p.up + (l + 1) * lvl, H, Bs, col0, BT);
        cp_async_commit();
      }
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c) ax[g][u][c] += bx[g][u];
      gru_step(h, ax, ah, bh, gt);
      if (kGates) {
        emit(hb + (cur ^ 1) * H * BT, p.gh + l * lvl,
             p.gates_d + 4 * l * lvl);
      } else {
        emit(hb + (cur ^ 1) * H * BT, nullptr, nullptr);
        store_pairs(p.down + static_cast<size_t>(l) * B * H, h, H, B, j0,
                    col);
      }
      cp_async_wait_all();
      cl.sync();
      cur ^= 1;
    }
    if (!kGates) store_pairs(p.lasth, h, H, B, j0, col);
  }
}

// ----------------------------------------------------------------- launch

template <typename P>
int launch_cluster(void (*kernel)(P), const P& p, int C, int tiles,
                   int threads, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the plan's limits, checked before a launch: H a multiple of 8 C, BT of
// 32, Hc / 2 x BT / 4 <= NTH_MAX threads, C <= 8
inline bool plan_ok(int H, int C, int BT) {
  if (C < 1 || C > 8 || H % (8 * C) != 0 || BT < 32 || BT % 32 != 0)
    return false;
  return (H / C / 2) * (BT / 4) <= NTH_MAX;
}

inline int threads_of(int H, int C, int BT) { return (H / C / 2) * (BT / 4); }

template <bool kGates>
int launch_sweep(const SweepParams& p, cudaStream_t st) {
  if (!plan_ok(p.H, p.C, p.BT) || p.Bs % 4 != 0 || p.Bs < p.B)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sweep_smem(p.H, p.C, p.BT);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster(f32_sweep_kernel<kGates>, p, p.C,
                        (p.B + p.BT - 1) / p.BT, threads_of(p.H, p.C, p.BT),
                        smem, st);
}

}  // namespace bf32
