// v5/v6 channel-major BiGRU + heads backward: replay of both sweeps,
// heads + down-sweep BPTT, up-sweep BPTT, and the weight gradients,
// channel-major [L, C, B].
//
// Replaces the TPU kernel climsim_tpu/ops/pallas_rnn.py::
// _bigru_heads_cm_bwd_kernel (wrapper _bigru_heads_cm_bwd_pallas).
//
// What it computes, per column (dt = the input type, f32 or bf16; every
// sum is accumulated in f32; "dt(v)" rounds v to dt):
//   phase A, replay: the up sweep (l = L-1 .. 0) with the projection
//     xp = W1h x_l + W1m mem_l + b1 kept in f32 (the TPU replay does not
//     round it, unlike the forward kernel), then the down sweep; h and the
//     gate bundle [r; z; n; hn] of every level are stored in dt.
//   phase B, l = L-1 .. 0: mem_l = dt(Wlat dt(h2_l) + blat) recomputed;
//     dmem_tot = dmem_l + Wout^T dout_l; dh2 += Wlat^T dt(dmem_tot); the
//     GRU backward step gives (dar, daz, dan, dhn); dh2 <- dh2 z +
//     Whh_dn^T dt([dar; daz; dhn]); d_up_l = W2^T dt([dar; daz; dan]).
//   phase C, l = 0 .. L-1: du += d_up_l; the same step on the up sweep;
//     dx_l = dt(W1h^T dt(d_xp)), dmem_l = dt(W1m^T dt(d_xp)).
//   weight gradients: sum over levels and columns of dt(left) x right
//     (e.g. dWhh_dn += dt(d_hh) dt(h2_{l-1})^T), bias gradients the f32
//     sums of the unrounded left factors; cast to dt at the end.
//
// What bounds it on an H100 at the flagship shapes (L 60, CH = H 192,
// nm_in 16, nm 16, ny 6, B 21,600): 1,364,160 multiply-adds per column
// and level (phase A 451,584, phase B 451,776, phase C 460,800, weight
// gradients included) = 3.54 TFLOP per call, 3.58 ms at the 989 TFLOP/s
// dense bf16 tensor-core peak; the bytes it must move (x, mem_in, h0s,
// the cotangents in; dx, dmem, dh0s, the gradients out) are ~0.2 GB,
// 0.06 ms at 3.35 TB/s. So it is bound by operations.
//
// What this first design does about it: like the forward kernel, it runs
// on the CUDA cores (f32 accumulation of dt products), so its floor is
// the ~67 TFLOP/s f32 FMA rate, ~53 ms. The work splits in two:
//   1. bigru_heads_cm_bwd_kernel: one block per tile of BT columns walks
//      all three phases in in-kernel loops (the TPU's sequential grid).
//      The state, the level's rounded gradient bundle and the heads live
//      in shared memory as f32 (152 KB at H 192, one block per SM); the
//      per-column scratch the TPU kept in VMEM (~276 KB a column in bf16:
//      h and the gates of both sweeps, d_up) goes to device-memory
//      scratch the wrapper allocates, as do the per-level gradient
//      streams [dar; daz; dan; dhn] of both sweeps (f32). Weights are read
//      straight from global memory, where they stay resident in the 50 MB
//      L2: k-major ([in, out]) for the replay's products, [out, in] for
//      the transposed products of the backward, so a warp's 32 threads
//      read 32 neighbouring outputs either way.
//   2. The TPU accumulated the weight gradients across its sequential
//      grid in revisiting output blocks; CUDA blocks run at once. So
//      outer_sum_kernel reduces each gradient over the L x B axis as a
//      tiled product (64 x 64 output tiles, 32-column chunks) split into
//      S column ranges, each writing f32 partial sums, and sum_parts_kernel
//      adds the S partials in a fixed order and casts; row_sum_kernel does
//      the bias sums with a fixed tree. The result is deterministic: no
//      atomics.
// The ragged edge is masked in the kernels: a pad column reads zero
// inputs and zero cotangents and nothing of it is stored, so it adds
// nothing to the sums (the TPU pads with zeros for the same effect).
// This design is kept for f32 (the F32 policy rules out TF32); bf16 runs
// the tensor-core design at the end of this file. Built without
// --use_fast_math: expf/tanhf keep the 60-level recurrence within
// tolerance of the plain version.
#include "bigru_common.cuh"
#include "bigru_mma_bwd.cuh"

namespace {

using namespace bigru;

constexpr int RT = 64;          // output tile of the gradient reductions
constexpr int RK = 32;          // columns per reduction chunk
constexpr int RTH = 256;        // threads per reduction block

// p[i] where the column is inside the batch, zero past the ragged edge
template <typename S>
__device__ __forceinline__ float ldm(const S* p, size_t i, bool ok) {
  return ok ? ldp(p + i) : 0.0f;
}

// pointer slots, in the order the wrapper passes them
enum Slot {
  X, MEM_IN, H0U, H0D,
  // k-major [in, out] weights, for the replay's products
  WIN1H_K, WIN1M_K, WHHU_K, WIN2_K, WHHD_K, WLAT_K,
  // [out, in] weights, for the transposed products
  WIN1H, WIN1M, WHHU, WIN2, WHHD, WLAT, WOUT,
  BIN1, BHHU, BIN2, BHHD, BLAT,
  DOUTMEM, DLASTH,
  DX, DMEM, DH0U, DH0D,
  DWIN1H, DWIN1M, DBIN1, DWHHU, DBHHU, DWIN2, DBIN2, DWHHD, DBHHD,
  DWLAT, DBLAT, DWOUT, DBOUT,
  // scratch: dt [L, H, B] x2, [L, 4H, B] x2, [L, nm, B];
  // f32 [L, H, B], [L, 4H, B] x2, [L, nm, B], reduction partials
  UP_H, G_H, GATES_U, GATES_D, MEML, DUP, DGU, DGD, DMT, WORK,
  // the block tiles in device memory (null: in shared memory)
  TILES,
  NSLOT
};

struct Params {
  void* p[NSLOT];
  int L, CH, nm_in, H, nm, ny, B;
};

// the f32 rows of [BT] a block keeps in its tiles (the larger of phase
// A's and phase B's)
__host__ __device__ inline size_t tile_rows(const Params& p) {
  const int xrows = p.CH + p.nm_in > p.H ? p.CH + p.nm_in : p.H;
  const size_t a = static_cast<size_t>(3 * p.H + xrows);
  const size_t b = static_cast<size_t>(6 * p.H + 2 * p.nm + p.ny);
  return a > b ? a : b;
}

// a[c] += sum_{j < n} W[j*ld + k] * D[j][c0 + c]: a product with the
// transpose of an [out, in] weight (contracting its out axis); W starts
// at the caller's first row, D [n][BT] f32 in shared memory.
template <typename T>
__device__ __forceinline__ void mvt(float (&a)[CG], const T* __restrict__ W,
                                    int ld, int k, int n, const float* D,
                                    int c0) {
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float w = ldw(W + static_cast<size_t>(j) * ld + k);
    const float4* d4 = reinterpret_cast<const float4*>(D + j * BT + c0);
#pragma unroll
    for (int q = 0; q < CG / 4; ++q) {
      const float4 d = d4[q];
      a[4 * q + 0] = fmaf(w, d.x, a[4 * q + 0]);
      a[4 * q + 1] = fmaf(w, d.y, a[4 * q + 1]);
      a[4 * q + 2] = fmaf(w, d.z, a[4 * q + 2]);
      a[4 * q + 3] = fmaf(w, d.w, a[4 * q + 3]);
    }
  }
}

// dst[r][col0 + c] = dt(src[r][c]) inside the batch
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, const float* src,
                                           int rows, int B, int col0) {
  for (int e = threadIdx.x; e < rows * BT; e += NTH) {
    const int r = e / BT, c = e % BT, col = col0 + c;
    if (col < B) dst[static_cast<size_t>(r) * B + col] = from_f<T>(src[e]);
  }
}

// One replayed GRU level for every (hidden unit, column group) of the
// tile: the projection X1 W1 (+ X2 W2) + b in f32, the recurrent product
// on xh = dt(h), the state hc [H][BT] f32 updated in place (each element
// read and written by one thread), xh_new = dt(h_new); h_new and the gate
// bundle [r; z; n; hn] go to hs [H, B] and gs [4H, B] in dt.
template <typename T>
__device__ __forceinline__ void replay_level(
    const T* __restrict__ W1, const float* X1, int K1,
    const T* __restrict__ W2, const float* X2, int K2,
    const T* __restrict__ bin, const T* __restrict__ whh,
    const T* __restrict__ bhh, const float* xh, float* hc, float* xh_new,
    int H, T* hs, T* gs, int B, int col0) {
  const size_t sB = B;
  for (int item = threadIdx.x; item < H * NCG; item += NTH) {
    const int j = item % H;
    const int c0 = (item / H) * CG;
    float ar[CG], az[CG], an[CG], hn[CG];
#pragma unroll
    for (int q = 0; q < CG; ++q) ar[q] = az[q] = an[q] = hn[q] = 0.0f;
    gate_mv<T>(ar, az, an, W1, K1, H, j, X1, c0);
    if (K2 > 0) gate_mv<T>(ar, az, an, W2, K2, H, j, X2, c0);
    const float br = ldw(bin + j), bz = ldw(bin + H + j),
                bn = ldw(bin + 2 * H + j);
#pragma unroll
    for (int q = 0; q < CG; ++q) {
      ar[q] += br;
      az[q] += bz;
      an[q] += bn;
    }
    // r and z take x + hh: accumulate the recurrent product onto x
    gate_mv<T>(ar, az, hn, whh, H, H, j, xh, c0);
    const float cr = ldw(bhh + j), cz = ldw(bhh + H + j),
                cn = ldw(bhh + 2 * H + j);
#pragma unroll
    for (int q = 0; q < CG; ++q) {
      const float r = sigmoidf_(ar[q] + cr);
      const float z = sigmoidf_(az[q] + cz);
      const float hnq = hn[q] + cn;
      const float n = tanhf(an[q] + r * hnq);
      const int e = j * BT + c0 + q;
      const float h = (1.0f - z) * n + z * hc[e];
      hc[e] = h;
      xh_new[e] = rnd<T>(h);
      const int col = col0 + c0 + q;
      if (col < B) {
        hs[j * sB + col] = from_f<T>(h);
        gs[j * sB + col] = from_f<T>(r);
        gs[(H + j) * sB + col] = from_f<T>(z);
        gs[(2 * H + j) * sB + col] = from_f<T>(n);
        gs[(3 * H + j) * sB + col] = from_f<T>(hnq);
      }
    }
  }
}

// The GRU backward step of one level for every (hidden unit, column
// group): dh [H][BT] f32 (in shared memory, plus the addend dh_add
// [H, B] f32 from device memory when given), the stored gates gs [4H, B]
// and the previous state hp [H, B] in dt. Writes the rounded bundle
// dt([dar; daz; dan; dhn]) to D [4H][BT], the f32 bundle to ds [4H, B],
// and dh z back to dh (the first term of dh_prev).
template <typename T>
__device__ __forceinline__ void gru_bwd_level(float* dh, const float* dh_add,
                                              const T* gs, const T* hp,
                                              float* D, float* ds, int H,
                                              int B, int col0) {
  const size_t sB = B;
  for (int item = threadIdx.x; item < H * NCG; item += NTH) {
    const int j = item % H;
    const int c0 = (item / H) * CG;
#pragma unroll 4
    for (int q = 0; q < CG; ++q) {
      const int c = c0 + q, col = col0 + c, e = j * BT + c;
      const bool ok = col < B;
      float g = dh[e];
      if (dh_add != nullptr) g += ldm(dh_add, j * sB + col, ok);
      const float r = ldm(gs, j * sB + col, ok);
      const float z = ldm(gs, (H + j) * sB + col, ok);
      const float n = ldm(gs, (2 * H + j) * sB + col, ok);
      const float hn = ldm(gs, (3 * H + j) * sB + col, ok);
      const float h_prev = ldm(hp, j * sB + col, ok);
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
        ds[j * sB + col] = dar;
        ds[(H + j) * sB + col] = daz;
        ds[(2 * H + j) * sB + col] = dan;
        ds[(3 * H + j) * sB + col] = dhn;
      }
      dh[e] = g * z;
    }
  }
}

// dh[k] += Whh^T dt(d_hh) with d_hh = [dar; daz; dhn]: whh [3H, H]
// ([out, in]) contracted over its rows against D's rows 0..2H-1, 3H..4H-1
template <typename T>
__device__ __forceinline__ void add_whh_t(float (&a)[CG],
                                          const T* __restrict__ whh, int H,
                                          int k, const float* D, int c0) {
  mvt<T>(a, whh, H, k, 2 * H, D, c0);
  mvt<T>(a, whh + static_cast<size_t>(2) * H * H, H, k, H, D + 3 * H * BT,
         c0);
}

template <typename T, bool kTiles>
__global__ void __launch_bounds__(NTH, 1)
bigru_heads_cm_bwd_kernel(Params p) {
  const int L = p.L, CH = p.CH, nmi = p.nm_in, H = p.H, nm = p.nm,
            ny = p.ny, B = p.B;
  const size_t sB = B;
  const int col0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  auto in = [&](int s) { return static_cast<const T*>(p.p[s]); };
  T* up_h = static_cast<T*>(p.p[UP_H]);
  T* g_h = static_cast<T*>(p.p[G_H]);
  T* gates_u = static_cast<T*>(p.p[GATES_U]);
  T* gates_d = static_cast<T*>(p.p[GATES_D]);
  T* meml = static_cast<T*>(p.p[MEML]);
  float* dup = static_cast<float*>(p.p[DUP]);
  float* dgu = static_cast<float*>(p.p[DGU]);
  float* dgd = static_cast<float*>(p.p[DGD]);
  float* dmt = static_cast<float*>(p.p[DMT]);
  extern __shared__ float4 smem4[];
  float* sm = kTiles ? static_cast<float*>(p.p[TILES]) +
                           blockIdx.x * tile_rows(p) * BT
                     : reinterpret_cast<float*>(smem4);

  // ---- phase A: replay the up sweep (surface to top), then the down
  {
    float* s_hc = sm;                       // [H][BT] f32 state
    float* xh_cur = s_hc + H * BT;          // [H][BT] dt(h)
    float* xh_nxt = xh_cur + H * BT;        // [H][BT]
    float* s_x = xh_nxt + H * BT;           // [max(CH + nm_in, H)][BT]
    load_tile(s_hc, in(H0U), H, B, col0);
    load_tile(xh_cur, in(H0U), H, B, col0);
    for (int l = L - 1; l >= 0; --l) {
      load_tile(s_x, in(X) + l * CH * sB, CH, B, col0);
      load_tile(s_x + CH * BT, in(MEM_IN) + l * nmi * sB, nmi, B, col0);
      __syncthreads();
      replay_level<T>(in(WIN1H_K), s_x, CH, in(WIN1M_K), s_x + CH * BT, nmi,
                      in(BIN1), in(WHHU_K), in(BHHU), xh_cur, s_hc, xh_nxt,
                      H, up_h + l * H * sB, gates_u + l * 4 * H * sB, B,
                      col0);
      __syncthreads();
      float* t = xh_cur; xh_cur = xh_nxt; xh_nxt = t;
    }
    load_tile(s_hc, in(H0D), H, B, col0);
    load_tile(xh_cur, in(H0D), H, B, col0);
    for (int l = 0; l < L; ++l) {
      load_tile(s_x, up_h + l * H * sB, H, B, col0);
      __syncthreads();
      replay_level<T>(in(WIN2_K), s_x, H, in(WIN2_K), s_x, 0, in(BIN2),
                      in(WHHD_K), in(BHHD), xh_cur, s_hc, xh_nxt, H,
                      g_h + l * H * sB, gates_d + l * 4 * H * sB, B, col0);
      __syncthreads();
      float* t = xh_cur; xh_cur = xh_nxt; xh_nxt = t;
    }
  }

  // ---- phase B: heads + down sweep backward (surface to top)
  {
    float* s_dg = sm;                       // [H][BT] dh2, f32
    float* s_D = s_dg + H * BT;             // [4H][BT] rounded bundle
    float* s_hd = s_D + 4 * H * BT;         // [H][BT] dt(h2_l)
    float* s_dmo = s_hd + H * BT;           // [nm + ny][BT] cotangents
    float* s_dmt = s_dmo + (nm + ny) * BT;  // [nm][BT] dt(dmem_tot)
    const T* wlat = in(WLAT);
    const T* wlat_k = in(WLAT_K);
    const T* wout = in(WOUT);
    const T* blat = in(BLAT);
    load_tile(s_dg, in(DLASTH), H, B, col0);
    for (int l = L - 1; l >= 0; --l) {
      load_tile(s_hd, g_h + l * H * sB, H, B, col0);
      load_tile(s_dmo, in(DOUTMEM) + l * (nm + ny) * sB, nm + ny, B, col0);
      __syncthreads();
      // the latent head recomputed as the forward rounds it (for dWout)
      T* meml_l = meml + l * nm * sB;
      for (int e = tid; e < nm * BT; e += NTH) {
        const int m = e / BT, c = e % BT, col = col0 + c;
        float a = 0.0f;
        for (int k = 0; k < H; ++k)
          a = fmaf(ldw(wlat_k + k * nm + m), s_hd[k * BT + c], a);
        if (col < B) meml_l[m * sB + col] = from_f<T>(a + ldw(blat + m));
      }
      // dmem_tot = dmem_head + Wout^T dout
      float* dmt_l = dmt + l * nm * sB;
      for (int e = tid; e < nm * BT; e += NTH) {
        const int m = e / BT, c = e % BT, col = col0 + c;
        float a = 0.0f;
        for (int o = 0; o < ny; ++o)
          a = fmaf(ldw(wout + o * nm + m), s_dmo[(nm + o) * BT + c], a);
        a += s_dmo[e];
        s_dmt[e] = rnd<T>(a);
        if (col < B) dmt_l[m * sB + col] = a;
      }
      __syncthreads();
      // dh2 += Wlat^T dt(dmem_tot)
      for (int item = tid; item < H * NCG; item += NTH) {
        const int j = item % H, c0 = (item / H) * CG;
        float a[CG];
#pragma unroll
        for (int q = 0; q < CG; ++q) a[q] = 0.0f;
        mvt<T>(a, wlat, H, j, nm, s_dmt, c0);
#pragma unroll
        for (int q = 0; q < CG; ++q) s_dg[j * BT + c0 + q] += a[q];
      }
      // the GRU step on h2 (owner-computes: the same (j, c0) items)
      gru_bwd_level<T>(s_dg, nullptr, gates_d + l * 4 * H * sB,
                       l > 0 ? g_h + (l - 1) * H * sB : in(H0D), s_D,
                       dgd + l * 4 * H * sB, H, B, col0);
      __syncthreads();
      // dh2_prev = dh2 z + Whh_dn^T dt(d_hh); d_up = W2^T dt(d_xp)
      float* dup_l = dup + l * H * sB;
      for (int item = tid; item < H * NCG; item += NTH) {
        const int k = item % H, c0 = (item / H) * CG;
        float ah[CG], au[CG];
#pragma unroll
        for (int q = 0; q < CG; ++q) ah[q] = au[q] = 0.0f;
        add_whh_t<T>(ah, in(WHHD), H, k, s_D, c0);
        mvt<T>(au, in(WIN2), H, k, 3 * H, s_D, c0);
#pragma unroll
        for (int q = 0; q < CG; ++q) {
          const int c = c0 + q, col = col0 + c;
          s_dg[k * BT + c] += ah[q];
          if (col < B) dup_l[k * sB + col] = au[q];
        }
      }
      __syncthreads();
    }
    store_tile(static_cast<T*>(p.p[DH0D]), s_dg, H, B, col0);
  }
  __syncthreads();

  // ---- phase C: up sweep backward (top to surface)
  {
    float* s_du = sm;                       // [H][BT] du, f32
    float* s_D = s_du + H * BT;             // [4H][BT] rounded bundle
    T* dx = static_cast<T*>(p.p[DX]);
    T* dmem = static_cast<T*>(p.p[DMEM]);
    for (int e = tid; e < H * BT; e += NTH) s_du[e] = 0.0f;
    __syncthreads();
    const int K = H + CH + nmi;
    for (int l = 0; l < L; ++l) {
      gru_bwd_level<T>(s_du, dup + l * H * sB, gates_u + l * 4 * H * sB,
                       l < L - 1 ? up_h + (l + 1) * H * sB : in(H0U), s_D,
                       dgu + l * 4 * H * sB, H, B, col0);
      __syncthreads();
      // du_prev = du z + Whh_up^T dt(d_hh); dx = W1h^T dt(d_xp);
      // dmem = W1m^T dt(d_xp)
      for (int item = tid; item < K * NCG; item += NTH) {
        const int k = item % K, c0 = (item / K) * CG;
        float a[CG];
#pragma unroll
        for (int q = 0; q < CG; ++q) a[q] = 0.0f;
        if (k < H) {
          add_whh_t<T>(a, in(WHHU), H, k, s_D, c0);
#pragma unroll
          for (int q = 0; q < CG; ++q) s_du[k * BT + c0 + q] += a[q];
          continue;
        }
        T* dst;
        if (k < H + CH) {
          mvt<T>(a, in(WIN1H), CH, k - H, 3 * H, s_D, c0);
          dst = dx + (l * CH + (k - H)) * sB;
        } else {
          mvt<T>(a, in(WIN1M), nmi, k - H - CH, 3 * H, s_D, c0);
          dst = dmem + (l * nmi + (k - H - CH)) * sB;
        }
#pragma unroll
        for (int q = 0; q < CG; ++q) {
          const int col = col0 + c0 + q;
          if (col < B) dst[col] = from_f<T>(a[q]);
        }
      }
      __syncthreads();
    }
    store_tile(static_cast<T*>(p.p[DH0U]), s_du, H, B, col0);
  }
}

// ---------------------------------------------------------------- reductions

// A gradient sum over levels and columns: out [M, N] = sum_{l, b}
// dt(left[l][row(m)][b]) * right[l + shift][n][b], where row(m) = m for
// m < split, m + gap after (so [dar; daz; dhn] reads rows 0..2H-1 and
// 3H..4H-1 of a [4H] bundle), and the right operand's level l + shift
// outside 0..L-1 is the edge tensor [N, B] (the initial state).
struct OuterJob {
  const void* a; size_t a_lvl; int split, gap;
  const void* b; size_t b_lvl; int shift; const void* edge;
  void* out; int M, N;
};

template <typename TA, typename T>
__global__ void __launch_bounds__(RTH)
outer_sum_kernel(OuterJob jb, int L, int B, int S, float* part) {
  __shared__ float As[RK][RT + 1];
  __shared__ float Bs[RK][RT + 1];
  const int ntn = (jb.N + RT - 1) / RT;
  const int m0 = (blockIdx.x / ntn) * RT, n0 = (blockIdx.x % ntn) * RT;
  const int s = blockIdx.y;
  const long nbc = (B + RK - 1) / RK;
  const long total = L * nbc;
  const long first = total * s / S, last = total * (s + 1) / S;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kk = tid % RK, r0 = tid / RK;
  const TA* A = static_cast<const TA*>(jb.a);
  const T* Bm = static_cast<const T*>(jb.b);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (long ch = first; ch < last; ++ch) {
    const int l = static_cast<int>(ch / nbc);
    const int b = static_cast<int>(ch % nbc) * RK + kk;
    const bool ok = b < B;
    const int lb = l + jb.shift;
    const T* Bl = (lb >= 0 && lb < L) ? Bm + lb * jb.b_lvl
                                      : static_cast<const T*>(jb.edge);
    const TA* Al = A + l * jb.a_lvl;
    for (int r = r0; r < RT; r += RTH / RK) {
      const int m = m0 + r, n = n0 + r;
      float av = 0.0f, bv = 0.0f;
      if (ok && m < jb.M) {
        const int row = m < jb.split ? m : m + jb.gap;
        av = rnd<T>(ldw(Al + static_cast<size_t>(row) * B + b));
      }
      if (ok && n < jb.N) bv = ldw(Bl + static_cast<size_t>(n) * B + b);
      As[kk][r] = av;
      Bs[kk][r] = bv;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < RK; ++k) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k][ty * 4 + i];
        bb[i] = Bs[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
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

// out[m] = dt(sum_{l, b} left[l][row(m)][b]), unrounded left (the bias
// gradients); one block per row, a fixed-order tree
template <typename TA, typename T>
__global__ void __launch_bounds__(RTH)
row_sum_kernel(OuterJob jb, int L, int B) {
  __shared__ float red[RTH];
  const int m = blockIdx.x;
  const int row = m < jb.split ? m : m + jb.gap;
  const TA* A = static_cast<const TA*>(jb.a);
  float s = 0.0f;
  for (int l = 0; l < L; ++l) {
    const TA* a = A + l * jb.a_lvl + static_cast<size_t>(row) * B;
    for (int b = threadIdx.x; b < B; b += RTH) s += ldw(a + b);
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = RTH / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) static_cast<T*>(jb.out)[m] = from_f<T>(red[0]);
}

template <typename TA, typename T>
int outer_sum(const OuterJob& jb, int L, int B, int S, float* work,
              cudaStream_t st) {
  if (jb.M == 0 || jb.N == 0) return 0;
  const int tiles = ((jb.M + RT - 1) / RT) * ((jb.N + RT - 1) / RT);
  outer_sum_kernel<TA, T><<<dim3(tiles, S), RTH, 0, st>>>(jb, L, B, S,
                                                          work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int MN = jb.M * jb.N;
  sum_parts_kernel<T><<<(MN + RTH - 1) / RTH, RTH, 0, st>>>(
      work, S, MN, static_cast<T*>(jb.out));
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename T>
int row_sum(const OuterJob& jb, int L, int B, cudaStream_t st) {
  if (jb.M == 0) return 0;
  row_sum_kernel<TA, T><<<jb.M, RTH, 0, st>>>(jb, L, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Params& p, int S, cudaStream_t st) {
  const int L = p.L, CH = p.CH, nmi = p.nm_in, H = p.H, nm = p.nm,
            ny = p.ny, B = p.B;
  const size_t sB = B;
  const int blocks = (B + BT - 1) / BT;
  cudaError_t err;
  if (p.p[TILES] != nullptr) {
    bigru_heads_cm_bwd_kernel<T, true><<<blocks, NTH, 0, st>>>(p);
  } else {
    const size_t smem = sizeof(float) * BT * tile_rows(p);
    err = cudaFuncSetAttribute(bigru_heads_cm_bwd_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    bigru_heads_cm_bwd_kernel<T, false><<<blocks, NTH, smem, st>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  float* work = static_cast<float*>(p.p[WORK]);
  const void* dgu = p.p[DGU];
  const void* dgd = p.p[DGD];
  const void* dmt = p.p[DMT];
  const size_t bundle = 4 * H * sB;
  // the 4H bundle read as d_xp = [dar; daz; dan] or d_hh = [dar; daz; dhn]
  const int xp_split = 3 * H, hh_split = 2 * H;
  const OuterJob outer[] = {
      {dgu, bundle, xp_split, 0, p.p[X], CH * sB, 0, nullptr, p.p[DWIN1H],
       3 * H, CH},
      {dgu, bundle, xp_split, 0, p.p[MEM_IN], nmi * sB, 0, nullptr,
       p.p[DWIN1M], 3 * H, nmi},
      {dgu, bundle, hh_split, H, p.p[UP_H], H * sB, 1, p.p[H0U],
       p.p[DWHHU], 3 * H, H},
      {dgd, bundle, xp_split, 0, p.p[UP_H], H * sB, 0, nullptr, p.p[DWIN2],
       3 * H, H},
      {dgd, bundle, hh_split, H, p.p[G_H], H * sB, -1, p.p[H0D], p.p[DWHHD],
       3 * H, H},
      {dmt, nm * sB, nm, 0, p.p[G_H], H * sB, 0, nullptr, p.p[DWLAT], nm,
       H},
  };
  for (const OuterJob& jb : outer) {
    const int rc = outer_sum<float, T>(jb, L, B, S, work, st);
    if (rc != 0) return rc;
  }
  // dWout: the left factor is dout, the cotangent rows nm.. (already dt)
  const T* dout = static_cast<const T*>(p.p[DOUTMEM]) + nm * sB;
  const OuterJob wout = {dout, (nm + ny) * sB, ny, 0, p.p[MEML], nm * sB,
                         0, nullptr, p.p[DWOUT], ny, nm};
  int rc = outer_sum<T, T>(wout, L, B, S, work, st);
  if (rc != 0) return rc;

  const OuterJob bias[] = {
      {dgu, bundle, xp_split, 0, nullptr, 0, 0, nullptr, p.p[DBIN1], 3 * H,
       1},
      {dgu, bundle, hh_split, H, nullptr, 0, 0, nullptr, p.p[DBHHU], 3 * H,
       1},
      {dgd, bundle, xp_split, 0, nullptr, 0, 0, nullptr, p.p[DBIN2], 3 * H,
       1},
      {dgd, bundle, hh_split, H, nullptr, 0, 0, nullptr, p.p[DBHHD], 3 * H,
       1},
      {dmt, nm * sB, nm, 0, nullptr, 0, 0, nullptr, p.p[DBLAT], nm, 1},
  };
  for (const OuterJob& jb : bias) {
    rc = row_sum<float, T>(jb, L, B, st);
    if (rc != 0) return rc;
  }
  const OuterJob bout = {dout, (nm + ny) * sB, ny, 0, nullptr, 0, 0,
                         nullptr, p.p[DBOUT], ny, 1};
  return row_sum<T, T>(bout, L, B, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ptrs: nslot device pointers in the
// order of enum Slot (inputs, k-major and [out, in] weights, flat biases,
// cotangents, outputs, gradients in the weights' layouts, scratch);
// activations channel-major [L, C, B] / [H, B], contiguous. S: column
// splits of the weight-gradient reductions (the WORK scratch holds S x
// the largest weight in f32). TILES: null to keep the block's tiles in
// shared memory (max(3H + max(CH + nm_in, H), 6H + 2 nm + ny) x 32 f32,
// up to H 296 at the flagship's other widths), or a device scratch of
// ceil(B / 32) times that that takes them at any H (no dynamic shared
// memory; __syncthreads orders a block's global accesses as its shared
// ones). Returns the cudaError_t of the launches (0 on success).
extern "C" int bigru_heads_cm_bwd(int dtype, int nslot,
                                  void* const* ptrs, int L, int CH,
                                  int nm_in, int H, int nm, int ny, int B,
                                  int S, void* stream) {
  if (nslot != NSLOT || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  for (int i = 0; i < NSLOT; ++i) p.p[i] = ptrs[i];
  p.L = L; p.CH = CH; p.nm_in = nm_in; p.H = H; p.nm = nm; p.ny = ny;
  p.B = B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, S, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, S, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------ bf16: tensor-core design
//
// The bf16 path (the flagship policy) splits as the CUDA-core one, with
// every product on tensor cores and the phase's weights resident (or,
// from H ~ 320 on, streamed through a ring: bigru_mma.cuh); the pieces it
// shares with B8 live in bigru_mma_bwd.cuh:
//   1. b3_mma_kernel: a cluster of C CTAs owns a tile of BT columns, CTA r
//      hidden units [r Hc, (r + 1) Hc), as in the forward (bmma notes).
//      Phase A replays both sweeps with B1's level (xp kept f32, as the
//      TPU replay keeps it), storing h and the gate bundle [r; z; n; hn]
//      (bf16) and the latent head mem_l for dWout. Phases B and C run the
//      GRU backward step at the thread's fragment positions (dh / du in
//      registers), write the rounded bundle dt([dar; daz; dan; dhn]) to
//      their own columns of a [BT][4H] smem tile, copy it to every CTA of
//      the cluster (distributed shared memory), and after one cluster
//      barrier compute the transposed products for the rows they own:
//      Whh^T dt(d_hh) and W2^T dt(d_xp) (B), Whh_up^T dt(d_hh) and
//      [W1h | W1m]^T dt(d_xp) (C), from [in-rows x 3H] slices of the
//      weights that stay in shared memory for the phase. A second,
//      split-phase cluster barrier keeps a fast CTA from writing the
//      next level's bundle before every CTA has read this one. The
//      rounded bundle also overwrites the gates in place (bf16): it is
//      exactly the left factor of the weight gradients, so the f32
//      [L, 4H, B] streams of the CUDA-core design are gone (~8 GB at
//      21,600 columns). The bias sums take the unrounded f32 values: each
//      thread sums its own positions over the levels, and each tile writes
//      f32 partials [tiles, 8H + nm + ny] in a fixed order.
//   2. wgrad_mma_kernel: each weight gradient sum_{l,b} dt(left) right as
//      a bf16 tensor-core GEMM over the L x B contraction (128 x 64 output
//      tiles, 32-column chunks fetched a chunk ahead, split into a fixed
//      number of column ranges whose f32 partials sum_parts_kernel adds in
//      order); bias_sum_kernel adds the
//      tiles' bias partials in order. No atomics: two calls are
//      bit-identical.
namespace b3mma {

using namespace bmma;
// names the CUDA-core design's namespace (bigru) also declares
using bmma::NTH;
using bmma::gru_level;

struct BwdParams {
  const bf16 *x, *mem_in, *h0u, *h0d, *dom, *dlh;
  const bf16 *wx_up, *b1, *wh_up, *bh_up, *wx_dn, *b2, *wh_dn, *bh_dn;
  const bf16 *wlat, *blat, *whT_dn, *w2T, *wlT, *wout, *whT_up, *w1T;
  bf16 *dx, *dmem, *dh0u, *dh0d;
  bf16 *up_h, *g_h, *gates_u, *gates_d, *meml, *dmt;
  float *dup, *bpart;
  int L, CHp, nmi, H, nm, ny, B, C, BT, KXc;
};

__host__ __device__ inline size_t b3_smem(int H, int C, int CHp, int nmi,
                                          int nm, int ny, int BT, int KXc,
                                          bool stream) {
  const int Hc = H / C, nm8 = (nm + 7) / 8 * 8, nm16 = (nm + 15) / 16 * 16;
  Smem su(nullptr), sd(nullptr), sb(nullptr), sc(nullptr);
  up_bufs(su, Hc, CHp + nmi, H, BT, 0, 0, 0, stream);
  dn_bufs(sd, Hc, H, BT, nm8, nm, stream);
  b_bufs(sb, Hc, H, BT, nm16, nm, ny, Hc, true, stream);
  b_bufs(sc, Hc, H, BT, nm16, nm, ny, KXc, false, stream);
  size_t m = su.off;
  if (sd.off > m) m = sd.off;
  if (sb.off > m) m = sb.off;
  if (sc.off > m) m = sc.off;
  return m;
}

template <bool kStream>
__global__ void __launch_bounds__(NTH, 1) b3_mma_kernel(BwdParams p) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = p.C, BT = p.BT, r = static_cast<int>(cl.block_rank());
  const int H = p.H, Hc = H / C, L = p.L, B = p.B, CHp = p.CHp, nmi = p.nmi;
  const int nm = p.nm, ny = p.ny, nm8 = (nm + 7) / 8 * 8;
  const int nm16 = (nm + 15) / 16 * 16, KXc = p.KXc;
  const int KX = CHp + nmi, LDX = KX + PAD, LDH = H + PAD;
  const int LDD = 4 * H + PAD, LDL = nm16 + PAD;
  const int tile = blockIdx.x / C, col0 = tile * BT, tid = threadIdx.x;
  const size_t sB = B, lvH = static_cast<size_t>(H) * B;
  const int PW = 8 * H + nm + ny;
  float* part = p.bpart + static_cast<size_t>(tile) * PW;
  const Warp w(BT);
  const Tiles tl(w, Hc / 8);
  extern __shared__ __align__(16) char smem_raw[];

  // ---- phase A: replay the up sweep (surface to top), then the down
  {
    GruRegs R;
    Smem s(smem_raw);
    const UpBufs u = up_bufs(s, Hc, KX, H, BT, 0, 0, 0, kStream);
    const bf16* gx = p.wx_up + static_cast<size_t>(r) * 3 * Hc * KX;
    const bf16* gh = p.wh_up + static_cast<size_t>(r) * 3 * Hc * H;
    load_slice<kStream>(u.wx, gx, 3 * Hc, KX);
    load_slice<kStream>(u.wh, gh, 3 * Hc, H);
    const WSlice wxu = slice<kStream>(u.wx, gx, KX);
    const WSlice whu = slice<kStream>(u.wh, gh, H);
    load_tile_t(u.h, LDH, p.h0u, H, B, col0, BT);
    gru_regs_init(R, w, tl, r, Hc, H, p.b1, p.bh_up, p.h0u, B, col0);
    const int k0 = min(KX, r * KXc), k1 = min(KX, (r + 1) * KXc);
    const auto x_l = [&](int l) { return p.x + static_cast<size_t>(l) * CHp * sB; };
    const auto m_l = [&](int l) { return p.mem_in + static_cast<size_t>(l) * nmi * sB; };
    ChunkPF cp;
    cp.fetch(x_l(L - 1), CHp, m_l(L - 1), k0, k1, B, col0, BT);
    cp.commit(u.x, LDX, k0, k1, BT);
    cp_async_wait_all();
    __syncthreads();
    bcast_cols(cl, u.x, LDX, k0, k1 - k0, BT);
    cl.sync();
    int cur = 0;
    for (int s_ = 0; s_ < L; ++s_) {
      const int l = L - 1 - s_;
      const bool more = l > 0;
      bf16* hc = u.h + cur * BT * LDH;
      bf16* hn = u.h + (cur ^ 1) * BT * LDH;
      bf16* xc = u.x + cur * BT * LDX;
      bf16* xn = u.x + (cur ^ 1) * BT * LDX;
      if (more) cp.fetch(x_l(l - 1), CHp, m_l(l - 1), k0, k1, B, col0, BT);
      if (s_ > 0)
        store_tile_t(p.up_h + (l + 1) * lvH + r * Hc * sB, hc, LDH, r * Hc,
                     Hc, B, col0, BT);
      gru_level<false, kStream>(cl, R, xc, LDX, KX, wxu, hc, whu, LDH, H, Hc,
                                hn, w, tl, r, p.gates_u + l * 4 * lvH, B,
                                col0, u.ring);
      if (more) {
        cp.commit(xn, LDX, k0, k1, BT);
        __syncthreads();
        bcast_cols(cl, xn, LDX, k0, k1 - k0, BT);
      }
      cl.sync();
      cur ^= 1;
    }
    store_tile_t(p.up_h + r * Hc * sB, u.h + cur * BT * LDH, LDH, r * Hc, Hc,
                 B, col0, BT);
    cl.sync();

    Smem s2(smem_raw);
    const DnBufs d = dn_bufs(s2, Hc, H, BT, nm8, nm, kStream);
    const bf16* gx2 = p.wx_dn + static_cast<size_t>(r) * 3 * Hc * H;
    const bf16* gh2 = p.wh_dn + static_cast<size_t>(r) * 3 * Hc * H;
    load_slice<kStream>(d.wx, gx2, 3 * Hc, H);
    load_slice<kStream>(d.wh, gh2, 3 * Hc, H);
    const WSlice wxd = slice<kStream>(d.wx, gx2, H);
    const WSlice whd = slice<kStream>(d.wh, gh2, H);
    load_rows(d.wl, LDH, p.wlat, nm8, H);
    load_heads(d.hw, p.blat, nullptr, nullptr, nm, 0);
    load_tile_t(d.h, LDH, p.h0d, H, B, col0, BT);
    gru_regs_init(R, w, tl, r, Hc, H, p.b2, p.bh_dn, p.h0d, B, col0);
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
      if (l > 0) {
        store_tile_t(p.g_h + (l - 1) * lvH + r * Hc * sB, hc, LDH, r * Hc,
                     Hc, B, col0, BT);
        heads(hc, LDH, d.wl, H, nm, nm8, d.hw, 0, d.mem,
              HeadOut<false>{p.meml + static_cast<size_t>(l - 1) * nm * sB, B},
              HeadOut<false>{nullptr, 0}, B, col0, BT, r, C);
      }
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
    bf16* hl = d.h + cur * BT * LDH;
    store_tile_t(p.g_h + (L - 1) * lvH + r * Hc * sB, hl, LDH, r * Hc, Hc, B,
                 col0, BT);
    heads(hl, LDH, d.wl, H, nm, nm8, d.hw, 0, d.mem,
          HeadOut<false>{p.meml + static_cast<size_t>(L - 1) * nm * sB, B},
          HeadOut<false>{nullptr, 0}, B, col0, BT, r, C);
    cl.sync();
  }

  float bp[4][MAXP][2];
  // ---- phase B: heads + down sweep backward (surface to top)
  {
    Smem s(smem_raw);
    const BBufs bb = b_bufs(s, Hc, H, BT, nm16, nm, ny, Hc, true, kStream);
    const bf16* gwh = p.whT_dn + static_cast<size_t>(r) * Hc * 3 * H;
    const bf16* gwu = p.w2T + static_cast<size_t>(r) * Hc * 3 * H;
    load_slice<kStream>(bb.wh, gwh, Hc, 3 * H);
    load_slice<kStream>(bb.wu, gwu, Hc, 3 * H);
    const WSlice wh = slice<kStream>(bb.wh, gwh, 3 * H);
    const WSlice wu = slice<kStream>(bb.wu, gwu, 3 * H);
    load_rows(bb.wl, LDL, p.wlT + static_cast<size_t>(r) * Hc * nm16, Hc,
              nm16);
    float dh[MAXP][4], dtp[PF], dbo[PF];
#pragma unroll
    for (int i = 0; i < MAXP; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = r * Hc + w.col(tl.nt[i] * 8, q), col = col0 + w.row(q);
        dh[i][q] = tl.on[i] && col < B ? b2f(p.dlh[j * sB + col]) : 0.0f;
      }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < MAXP; ++i) bp[k][i][0] = bp[k][i][1] = 0.0f;
#pragma unroll
    for (int i = 0; i < PF; ++i) dtp[i] = dbo[i] = 0.0f;
    const int nmo = nm + ny;
    const auto dom_l = [&](int l) { return p.dom + static_cast<size_t>(l) * nmo * sB; };
    RawPF pf;
    pf.fetch(dom_l(L - 1), nmo, nullptr, nmo, B, col0, BT);
    cp_async_wait_all();
    __syncthreads();
    cluster_arrive();
    for (int l = L - 1; l >= 0; --l) {
      pf.commit(bb.raw, nmo, BT);
#pragma unroll
      for (int i = 0; i < PF; ++i)      // dbout: the dout rows, unrounded
        if ((tid + i * NTH) / BT >= nm && tid + i * NTH < nmo * BT)
          dbo[i] += pf.v[i];
      if (l > 0) pf.fetch(dom_l(l - 1), nmo, nullptr, nmo, B, col0, BT);
      __syncthreads();
      // dmem_tot = dmem_head + Wout^T dout (f32; every CTA the whole tile)
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        const int e = tid + i * NTH;
        if (e >= nm16 * BT) continue;
        const int m = e / BT, b = e % BT;
        float a = 0.0f;
        if (m < nm) {
          for (int o = 0; o < ny; ++o)
            a = fmaf(b2f(p.wout[o * nm + m]), bb.raw[(nm + o) * BT + b], a);
          a += bb.raw[m * BT + b];
          dtp[i] += a;
          if (r == 0 && col0 + b < B)
            p.dmt[(static_cast<size_t>(l) * nm + m) * sB + col0 + b] =
                __float2bfloat16_rn(a);
        }
        bb.dmt[b * LDL + m] = __float2bfloat16_rn(a);
      }
      __syncthreads();
      // dh2 += Wlat^T dt(dmem_tot)
      float al[MAXP][4];
      zero_acc(al);
      warp_mma<false>(al, bb.dmt, LDL, WSlice{bb.wl, LDL}, 0, Hc, w, tl, nm16,
                      nullptr);
#pragma unroll
      for (int i = 0; i < MAXP; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) dh[i][q] += al[i][q];
      cluster_wait();       // every CTA has read the last level's bundle
      gru_bwd(dh, AddNone{}, p.gates_d + l * 4 * lvH,
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
    if (r == 0) {       // dblat and dbout: sums over the tile's columns
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        const int e = tid + i * NTH;
        if (e < nm16 * BT) bb.raw[e] = dtp[i];
      }
      __syncthreads();
      for (int m = tid; m < nm; m += NTH) {
        float a = 0.0f;
        for (int b = 0; b < BT; ++b) a += bb.raw[m * BT + b];
        part[8 * H + m] = a;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        const int e = tid + i * NTH;
        if (e < nmo * BT) bb.raw[e] = dbo[i];
      }
      __syncthreads();
      for (int o = tid; o < ny; o += NTH) {
        float a = 0.0f;
        for (int b = 0; b < BT; ++b) a += bb.raw[(nm + o) * BT + b];
        part[8 * H + nm + o] = a;
      }
    }
    cl.sync();
  }

  // ---- phase C: up sweep backward (top to surface)
  {
    Smem s(smem_raw);
    const BBufs bc = b_bufs(s, Hc, H, BT, nm16, nm, ny, KXc, false, kStream);
    const bf16* gwh = p.whT_up + static_cast<size_t>(r) * Hc * 3 * H;
    const bf16* gwu = p.w1T + static_cast<size_t>(r) * KXc * 3 * H;
    load_slice<kStream>(bc.wh, gwh, Hc, 3 * H);
    load_slice<kStream>(bc.wu, gwu, KXc, 3 * H);
    const WSlice wh = slice<kStream>(bc.wh, gwh, 3 * H);
    const WSlice wu = slice<kStream>(bc.wu, gwu, 3 * H);
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
              tl, r, Hc, H, B, col0);
      __syncthreads();
      for (int k = 0; k < 4; ++k) bcast_cols(cl, bc.D, LDD, k * H + r * Hc, Hc, BT);
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
      // [dx; dmem] rows of this CTA = dt([W1h | W1m]^T dt(d_xp))
      const int ntx = KXc / 8;
      for (int base = 0; base < ntx; base += w.nwn * MAXP) {
        const Tiles tx(w, ntx, base);
        float ax[MAXP][4];
        zero_acc(ax);
        warp_mma<kStream>(ax, bc.D, LDD, wu, 0, KXc, w, tx, 3 * H, bc.ring);
#pragma unroll
        for (int i = 0; i < MAXP; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int kx = r * KXc + w.col(tx.nt[i] * 8, q);
            const int col = col0 + w.row(q);
            if (!tx.on[i] || col >= B) continue;
            const bf16 v = __float2bfloat16_rn(ax[i][q]);
            if (kx < CHp)
              p.dx[(static_cast<size_t>(l) * CHp + kx) * sB + col] = v;
            else if (kx < KX)
              p.dmem[(static_cast<size_t>(l) * nmi + kx - CHp) * sB + col] = v;
          }
      }
      cluster_arrive();
    }
    cluster_wait();
    store_frag(p.dh0u, du, w, tl, r, Hc, B, col0);
    reduce_bias(bp, bc.red, part, w, tl, r, Hc, H, BT);
  }
  cl.sync();   // no CTA leaves while another may still address its smem
}

// gradient outputs, in the weights' padded shapes
struct Grads {
  bf16 *dwin1h, *dwin1m, *dbin1, *dwhh_up, *dbhh_up, *dwin2, *dbin2;
  bf16 *dwhh_dn, *dbhh_dn, *dwlat, *dblat, *dwout, *dbout;
};

int launch_mma(const BwdParams& p, const Grads& g, float* work, int S,
               int stream, cudaStream_t st) {
  const int C = p.C, BT = p.BT, H = p.H, nm16 = (p.nm + 15) / 16 * 16;
  const int KX = p.CHp + p.nmi;
  if (C < 1 || C > 8 || BT % 16 != 0 || BT < 16 || NW % (BT / 16) != 0 ||
      H % (8 * C) != 0 || p.CHp % 16 != 0 || p.nmi % 16 != 0 ||
      p.KXc % 8 != 0 || p.KXc * C < KX || H / C / 8 > NW / (BT / 16) * MAXP ||
      (p.nm + p.ny) * BT > PF * NTH || nm16 * BT > PF * NTH ||
      H / C / 8 * BT > MAXI * NTH || p.KXc / 8 * BT > MAXI * NTH || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = b3_smem(H, C, p.CHp, p.nmi, p.nm, p.ny, BT, p.KXc,
                              stream != 0);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = stream ? launch_cluster(b3_mma_kernel<true>, p, C, BT, p.B,
                                         smem, st)
                        : launch_cluster(b3_mma_kernel<false>, p, C, BT, p.B,
                                         smem, st);
  if (rc != 0) return rc;

  const int L = p.L, B = p.B, CHp = p.CHp, nmi = p.nmi, nm = p.nm, ny = p.ny;
  const int tiles = (B + BT - 1) / BT;
  const size_t sB = B, bundle = 4 * H * sB;
  const int xp_split = 3 * H, hh_split = 2 * H;
  const GJob jobs[] = {
      {p.gates_u, bundle, xp_split, 0, p.x, CHp * sB, 0, nullptr, g.dwin1h,
       3 * H, CHp},
      {p.gates_u, bundle, xp_split, 0, p.mem_in, nmi * sB, 0, nullptr,
       g.dwin1m, 3 * H, nmi},
      {p.gates_u, bundle, hh_split, H, p.up_h, H * sB, 1, p.h0u, g.dwhh_up,
       3 * H, H},
      {p.gates_d, bundle, xp_split, 0, p.up_h, H * sB, 0, nullptr, g.dwin2,
       3 * H, H},
      {p.gates_d, bundle, hh_split, H, p.g_h, H * sB, -1, p.h0d, g.dwhh_dn,
       3 * H, H},
      {p.dmt, nm * sB, nm, 0, p.g_h, H * sB, 0, nullptr, g.dwlat, nm, H},
      {p.dom + nm * sB, (nm + ny) * sB, ny, 0, p.meml, nm * sB, 0, nullptr,
       g.dwout, ny, nm},
  };
  const int rg = gemms(jobs, L, B, S, work, st);
  if (rg != 0) return rg;
  const int PW = 8 * H + nm + ny;
  bias_sum_kernel<<<(PW + 255) / 256, 256, 0, st>>>(
      p.bpart, tiles, H, nm, ny, g.dbin1, g.dbhh_up, g.dbin2, g.dbhh_dn,
      g.dblat, g.dbout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace b3mma

// The CUDA-core design in bf16 under a second name, kept to time it
// against the tensor-core design; no wrapper selects it.
extern "C" int bigru_heads_cm_bwd_cudacore(int nslot, void* const* ptrs,
                                           int L, int CH, int nm_in, int H,
                                           int nm, int ny, int B, int S,
                                           void* stream) {
  return bigru_heads_cm_bwd(1, nslot, ptrs, L, CH, nm_in, H, nm, ny, B, S,
                            stream);
}

// bf16 tensor-core design. ptrs, in order (dims already padded: H to a
// multiple of 8 C, CH and nm_in to 16; KXc = the rows of [W1h | W1m]^T
// each CTA owns, a multiple of 8 with C KXc >= CH + nm_in):
//   x [L, CH, B], mem_in [L, nm_in, B], h0u, h0d [H, B], d_outmem
//   [L, nm + ny, B], d_lasth [H, B];
//   wx_up [C][3H/C][CH + nm_in], b1 [3H], wh_up [C][3H/C][H], bh_up, wx_dn
//   [C][3H/C][H], b2, wh_dn, bh_dn, wlat [nm8][H], blat [nm] (the forward's
//   gate slices, [out, in]);
//   whT_dn [C][H/C][3H], w2T [C][H/C][3H], wlT [C][H/C][nm16], wout
//   [ny, nm], whT_up [C][H/C][3H], w1T [C][KXc][3H] (transposed slices);
//   dx [L, CH, B], dmem [L, nm_in, B], dh0u, dh0d [H, B];
//   scratch up_h, g_h [L, H, B], gates_u, gates_d [L, 4H, B], meml,
//   dmt [L, nm, B] (bf16), dup [L, H, B] f32, bias partials
//   [tiles, 8H + nm + ny] f32, work [S x the largest weight] f32;
//   gradients dwin1h [3H, CH], dwin1m [3H, nm_in], dbin1, dwhh_up [3H, H],
//   dbhh_up, dwin2, dbin2, dwhh_dn, dbhh_dn, dwlat [nm, H], dblat, dwout
//   [ny, nm], dbout.
// stream: 1 for the streamed-weights instantiation. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for shapes outside
// the design).
extern "C" int bigru_heads_cm_bwd_mma(int nptr, void* const* q, int L,
                                      int CH, int nm_in, int H, int nm,
                                      int ny, int B, int C, int BT, int KXc,
                                      int S, int stream, void* st) {
  using bmma::bf16;
  if (nptr != 48) return static_cast<int>(cudaErrorInvalidValue);
  const auto c = [&](int i) { return static_cast<const bf16*>(q[i]); };
  const auto m = [&](int i) { return static_cast<bf16*>(q[i]); };
  b3mma::BwdParams p{c(0), c(1), c(2), c(3), c(4), c(5),
                     c(6), c(7), c(8), c(9), c(10), c(11), c(12), c(13),
                     c(14), c(15), c(16), c(17), c(18), c(19), c(20), c(21),
                     m(22), m(23), m(24), m(25),
                     m(26), m(27), m(28), m(29), m(30), m(31),
                     static_cast<float*>(q[32]), static_cast<float*>(q[33]),
                     L, CH, nm_in, H, nm, ny, B, C, BT, KXc};
  b3mma::Grads g{m(35), m(36), m(37), m(38), m(39), m(40), m(41),
                 m(42), m(43), m(44), m(45), m(46), m(47)};
  return b3mma::launch_mma(p, g, static_cast<float*>(q[34]), S, stream,
                           static_cast<cudaStream_t>(st));
}
