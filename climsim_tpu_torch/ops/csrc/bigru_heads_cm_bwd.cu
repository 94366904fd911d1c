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
// Tensor cores and weights resident in shared memory are later work.
// Built without --use_fast_math: expf/tanhf keep the 60-level recurrence
// within tolerance of the plain version.
#include "bigru_common.cuh"

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
  NSLOT
};

struct Params {
  void* p[NSLOT];
  int L, CH, nm_in, H, nm, ny, B;
};

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

template <typename T>
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
  float* sm = reinterpret_cast<float*>(smem4);

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
  const int xrows = CH + nmi > H ? CH + nmi : H;
  const size_t smA = static_cast<size_t>(3 * H + xrows);
  const size_t smB = static_cast<size_t>(6 * H + 2 * nm + ny);
  const size_t smem = sizeof(float) * BT * (smA > smB ? smA : smB);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_heads_cm_bwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bigru_heads_cm_bwd_kernel<T><<<(B + BT - 1) / BT, NTH, smem, st>>>(p);
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
// the largest weight in f32). Returns the cudaError_t of the launches (0
// on success).
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
