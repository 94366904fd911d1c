// Tile and device helpers shared by the v2 level-major BiGRU forward
// (bigru_lbh.cu, B7) and backward (bigru_lbh_bwd.cu, B8): the column tile,
// the gate products of a level and one GRU level of the tile.
//
// Layout: a level is [B][X] (the features innermost). A block owns BT
// columns; a thread owns one hidden unit j for CG of them, so for a fixed
// k the threads of a warp read 32 neighbouring outputs of a k-major
// ([in, out], flax's layout) weight, and the level's inputs and outputs
// are read and written at neighbouring j.
#pragma once
#include "bigru_common.cuh"
#include "gates16.cuh"

namespace bigru_v2 {

using bigru::from_f;
using bigru::ldp;
using bigru::ldw;
using bigru::rnd;
using bigru::sigmoidf_;

constexpr int BT = 32;          // columns per block
constexpr int CG = 8;           // columns per thread
constexpr int NCG = BT / CG;
constexpr int NTH = 256;        // threads per block

// a[g][q] += sum_k W[k][g*H + j] * X[k][c0 + q] for the gate rows g of
// hidden unit j; W k-major [K][3H], X [K][BT] f32 in shared memory.
template <typename T>
__device__ __forceinline__ void gates_mv(float (&a)[3][CG],
                                         const T* __restrict__ W, int K,
                                         int H, int j, const float* X,
                                         int c0) {
  const int ld = 3 * H;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const T* w = W + static_cast<size_t>(k) * ld + j;
    const float w0 = ldw(w), w1 = ldw(w + H), w2 = ldw(w + 2 * H);
    const float4* x4 = reinterpret_cast<const float4*>(X + k * BT + c0);
#pragma unroll
    for (int v = 0; v < CG / 4; ++v) {
      const float4 x = x4[v];
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[0][4 * v + e] = fmaf(w0, xs[e], a[0][4 * v + e]);
        a[1][4 * v + e] = fmaf(w1, xs[e], a[1][4 * v + e]);
        a[2][4 * v + e] = fmaf(w2, xs[e], a[2][4 * v + e]);
      }
    }
  }
}

// One GRU level of the tile. The input projection x (bias included) is
// either read from xp_l [B][3H] (up sweep, W2 == nullptr) or computed as
// W2^T X2 + b2 from X2 [H][BT] (down sweep). xh = dt(h) [H][BT] is the
// recurrent operand; hc [H][BT] the f32 state, updated in place (each
// element is read and written by one thread); xh_new receives dt(h_new)
// and out_l [B][H] the stored dt(h_new). With kGates the gate bundle
// [r; z; n; hn] (hn with its bias) goes to gates_l [B][4H] in dt, as the
// backward's replay stores it. kG16 (the forward's acc32=False, T bf16,
// no kGates): the down sweep's projection is rounded, the state is a bf16
// value and the gates run in packed bf16 arithmetic (gates16.cuh, two
// columns a step).
template <typename T, bool kGates, bool kG16 = false>
__device__ __forceinline__ void gru_level(
    const T* __restrict__ xp_l, const T* __restrict__ W2,
    const T* __restrict__ b2, const float* X2, const T* __restrict__ whh,
    const T* __restrict__ bhh, const float* xh, float* hc, float* xh_new,
    T* out_l, T* gates_l, int H, int B, int col0) {
  for (int item = threadIdx.x; item < H * NCG; item += NTH) {
    const int j = item % H;
    const int c0 = (item / H) * CG;
    float hh[3][CG], x[3][CG];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int q = 0; q < CG; ++q) hh[g][q] = x[g][q] = 0.0f;
    gates_mv<T>(hh, whh, H, H, j, xh, c0);
    if (W2 != nullptr) {
      gates_mv<T>(x, W2, H, H, j, X2, c0);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float bg = ldw(b2 + g * H + j);
#pragma unroll
        for (int q = 0; q < CG; ++q)
          x[g][q] = kG16 ? rnd<T>(x[g][q] + bg) : x[g][q] + bg;
      }
    } else {
#pragma unroll
      for (int q = 0; q < CG; ++q) {
        const int col = col0 + c0 + q;
        if (col < B) {
          const T* xr = xp_l + static_cast<size_t>(col) * 3 * H + j;
#pragma unroll
          for (int g = 0; g < 3; ++g) x[g][q] = ldw(xr + g * H);
        }
      }
    }
    const float cr = ldw(bhh + j), cz = ldw(bhh + H + j),
                cn = ldw(bhh + 2 * H + j);
    if constexpr (kG16) {
      using gates16::pk;
#pragma unroll
      for (int q = 0; q < CG; q += 2) {       // two columns a step
        const int e = j * BT + c0 + q;
        const float2 h = __bfloat1622float2(gates16::step2(
            pk(x[0][q], x[0][q + 1]), pk(x[1][q], x[1][q + 1]),
            pk(x[2][q], x[2][q + 1]), pk(hh[0][q] + cr, hh[0][q + 1] + cr),
            pk(hh[1][q] + cz, hh[1][q + 1] + cz),
            pk(hh[2][q] + cn, hh[2][q + 1] + cn), pk(hc[e], hc[e + 1])));
        hc[e] = xh_new[e] = h.x;
        hc[e + 1] = xh_new[e + 1] = h.y;
        const int col = col0 + c0 + q;
        if (col < B) out_l[static_cast<size_t>(col) * H + j] = from_f<T>(h.x);
        if (col + 1 < B)
          out_l[static_cast<size_t>(col + 1) * H + j] = from_f<T>(h.y);
      }
      continue;
    }
#pragma unroll
    for (int q = 0; q < CG; ++q) {
      const float r = sigmoidf_(x[0][q] + (hh[0][q] + cr));
      const float z = sigmoidf_(x[1][q] + (hh[1][q] + cz));
      const float hn = hh[2][q] + cn;
      const float n = tanhf(x[2][q] + r * hn);
      const int e = j * BT + c0 + q;
      const float h = (1.0f - z) * n + z * hc[e];
      hc[e] = h;
      xh_new[e] = rnd<T>(h);
      const int col = col0 + c0 + q;
      if (col < B) {
        out_l[static_cast<size_t>(col) * H + j] = from_f<T>(h);
        if (kGates) {
          T* gl = gates_l + static_cast<size_t>(col) * 4 * H + j;
          gl[0] = from_f<T>(r);
          gl[H] = from_f<T>(z);
          gl[2 * H] = from_f<T>(n);
          gl[3 * H] = from_f<T>(hn);
        }
      }
    }
  }
}

// dst[k][c] = src[col0 + c][k] (a [B][H] level) for k < H, zero past the
// ragged edge
template <typename T>
__device__ __forceinline__ void load_level(float* dst, const T* src, int H,
                                           int B, int col0) {
  for (int e = threadIdx.x; e < H * BT; e += NTH) {
    const int k = e / BT, c = e % BT, col = col0 + c;
    dst[e] = col < B ? ldp(src + static_cast<size_t>(col) * H + k) : 0.0f;
  }
}

// dst[col0 + c][j] = dt(src[j][c]) inside the batch (a [B][H] level)
template <typename T>
__device__ __forceinline__ void store_level(T* dst, const float* src, int H,
                                            int B, int col0) {
  for (int e = threadIdx.x; e < H * BT; e += NTH) {
    const int c = e / H, j = e % H, col = col0 + c;
    if (col < B)
      dst[static_cast<size_t>(col) * H + j] = from_f<T>(src[j * BT + c]);
  }
}

}  // namespace bigru_v2
