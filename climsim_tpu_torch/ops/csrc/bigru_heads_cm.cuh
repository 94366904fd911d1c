// The channel-major BiGRU + heads sweeps shared by the v6 fused emulator
// forward (bigru_heads_init_cm.cu, B1) and the v5 one (bigru_heads_cm.cu,
// B4): one GRU level of a 32-column tile, and the down sweep with the
// latent-memory and output heads. The two kernels differ only in what
// feeds the up sweep (v6 evaluates the initial MLP in the kernel, v5
// reads its output) and in whether the sweeps' input projections are
// rounded to the storage type before the gates (kRoundXP: v6 always, v5
// when it hoists the projections, as the TPU kernels store them).
#pragma once
#include "bigru_common.cuh"
#include "gates16.cuh"

namespace bigru {

// One GRU level for every (hidden unit, column group) of the tile.
// X1 [K1][BT] with W1 [K1][3H] and X2 [K2][BT] with W2 [K2][3H] form the
// input projection (K2 = 0 for the down sweep); xh = dt(h) [H][BT] is the
// recurrent operand; hc [H][BT] the f32 state, updated in place (each
// element is read and written by one thread); xh_new receives dt(h_new).
// kG16 (acc32=False, T bf16): the projection is rounded, the state is a
// bf16 value and the gates run in packed bf16 arithmetic (gates16.cuh,
// two columns a step), the recurrent product with its bias rounded on its
// own before the sums.
template <typename T, bool kRoundXP, bool kG16 = false>
__device__ __forceinline__ void gru_level(
    const T* __restrict__ W1, const float* X1, int K1,
    const T* __restrict__ W2, const float* X2, int K2,
    const T* __restrict__ bin, const T* __restrict__ whh,
    const T* __restrict__ bhh, const float* xh, float* hc, float* xh_new,
    int H) {
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
      if (kRoundXP || kG16) {           // the projection is stored in dt
        ar[q] = rnd<T>(ar[q]);
        az[q] = rnd<T>(az[q]);
        an[q] = rnd<T>(an[q]);
      }
    }
    const float cr = ldw(bhh + j), cz = ldw(bhh + H + j),
                cn = ldw(bhh + 2 * H + j);
    if constexpr (kG16) {
      float hr[CG], hz[CG];
#pragma unroll
      for (int q = 0; q < CG; ++q) hr[q] = hz[q] = 0.0f;
      gate_mv<T>(hr, hz, hn, whh, H, H, j, xh, c0);
      using gates16::pk;
#pragma unroll
      for (int q = 0; q < CG; q += 2) {       // two columns a step
        const int e = j * BT + c0 + q;
        const float2 h = __bfloat1622float2(gates16::step2(
            pk(ar[q], ar[q + 1]), pk(az[q], az[q + 1]), pk(an[q], an[q + 1]),
            pk(hr[q] + cr, hr[q + 1] + cr), pk(hz[q] + cz, hz[q + 1] + cz),
            pk(hn[q] + cn, hn[q + 1] + cn), pk(hc[e], hc[e + 1])));
        hc[e] = xh_new[e] = h.x;
        hc[e + 1] = xh_new[e + 1] = h.y;
      }
      continue;
    }
    // r and z take x + hh: accumulate the recurrent product onto x
    gate_mv<T>(ar, az, hn, whh, H, H, j, xh, c0);
#pragma unroll
    for (int q = 0; q < CG; ++q) {
      const float r = sigmoidf_(ar[q] + cr);
      const float z = sigmoidf_(az[q] + cz);
      const float n = tanhf(an[q] + r * (hn[q] + cn));
      const int e = j * BT + c0 + q;
      const float h = (1.0f - z) * n + z * hc[e];
      hc[e] = h;
      xh_new[e] = rnd<T>(h);
    }
  }
}

// up[l][:, tile] = dt(h), the up sweep's output that the down sweep reads
template <typename T>
__device__ __forceinline__ void store_up(T* up_l, const float* xh, int H,
                                         int B, int col0) {
  for (int e = threadIdx.x; e < H * BT; e += NTH) {
    const int j = e / BT, c = e % BT, col = col0 + c;
    if (col < B) up_l[static_cast<size_t>(j) * B + col] = from_f<T>(xh[e]);
  }
}

// The down sweep, top (l = 0) to surface, over the up stream up [L, H, B],
// with the heads: mem_l = dt(Wlat dt(h2) + blat), out_l = dt(Wout mem_l +
// bout), outmem[l] = [mem_l; out_l]; lasth = dt(h2). Shared memory: s_hc,
// xh0, xh1 [H][BT], s_x [H][BT], s_mem [nm][BT]. Starts with a barrier, so
// the caller's up sweep may still be reading shared memory. kG16 as
// gru_level's.
template <typename T, bool kRoundXP, bool kG16 = false>
__device__ __forceinline__ void down_sweep_heads(
    const T* up, const T* h0d, const T* win2, const T* bin2,
    const T* whh_dn, const T* bhh_dn, const T* __restrict__ wlat,
    const T* __restrict__ blat, const T* __restrict__ wout,
    const T* __restrict__ bout, T* outmem, T* lasth, float* s_hc,
    float* xh_cur, float* xh_nxt, float* s_x, float* s_mem, int L, int H,
    int nm, int ny, int B, int col0) {
  const int tid = threadIdx.x;
  __syncthreads();
  load_tile(s_hc, h0d, H, B, col0);
  load_tile(xh_cur, h0d, H, B, col0);
  const int nmo = nm + ny;
  for (int l = 0; l < L; ++l) {
    load_tile(s_x, up + static_cast<size_t>(l) * H * B, H, B, col0);
    __syncthreads();
    gru_level<T, kRoundXP, kG16>(win2, s_x, H, win2, s_x, 0, bin2, whh_dn,
                                 bhh_dn, xh_cur, s_hc, xh_nxt, H);
    __syncthreads();
    float* t = xh_cur; xh_cur = xh_nxt; xh_nxt = t;
    T* om = outmem + static_cast<size_t>(l) * nmo * B;
    // latent memory head on dt(h2)
    for (int e = tid; e < nm * BT; e += NTH) {
      const int m = e / BT, c = e % BT, col = col0 + c;
      float a = 0.0f;
      for (int k = 0; k < H; ++k)
        a = fmaf(ldw(wlat + k * nm + m), xh_cur[k * BT + c], a);
      const float v = rnd<T>(a + ldw(blat + m));
      s_mem[e] = v;
      if (col < B) om[static_cast<size_t>(m) * B + col] = from_f<T>(v);
    }
    __syncthreads();
    // output head on the (dt-rounded) memory
    for (int e = tid; e < ny * BT; e += NTH) {
      const int o = e / BT, c = e % BT, col = col0 + c;
      float a = 0.0f;
      for (int m = 0; m < nm; ++m)
        a = fmaf(ldw(wout + m * ny + o), s_mem[m * BT + c], a);
      if (col < B)
        om[static_cast<size_t>(nm + o) * B + col] =
            from_f<T>(a + ldw(bout + o));
    }
  }
  for (int e = tid; e < H * BT; e += NTH) {
    const int j = e / BT, c = e % BT, col = col0 + c;
    if (col < B)
      lasth[static_cast<size_t>(j) * B + col] = from_f<T>(xh_cur[e]);
  }
}

}  // namespace bigru
