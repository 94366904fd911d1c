// Device helpers shared by the BiGRU kernels: the v6 fused emulator's
// forward (bigru_heads_init_cm.cu) and backward (bigru_heads_cm_bwd.cu),
// and through bigru_lbh.cuh the v2 forward and backward (bigru_lbh.cu,
// bigru_lbh_bwd.cu): loads of f32 or bf16 weights and activations into
// f32, rounding to the storage type, the v6 column tile and gate products,
// and the last pass of the weight-gradient reductions.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace bigru {

constexpr int BT = 32;          // columns per block
constexpr int CG = 16;          // columns per thread in the GRU phases
constexpr int NCG = BT / CG;
constexpr int NTH = 384;        // threads per block (H 192 x NCG 2)

__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) {
  unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
// plain loads for data this kernel writes itself
__device__ __forceinline__ float ldp(const float* p) { return *p; }
__device__ __forceinline__ float ldp(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// round an f32 value to dt and back
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// a{0,1,2}[c] += sum_k W[k][g*H + j] * X[k][c0 + c] for the three gate
// rows g = 0, 1, 2 of hidden unit j; W k-major [K][3H], X [K][BT] f32.
template <typename T>
__device__ __forceinline__ void gate_mv(float (&a0)[CG], float (&a1)[CG],
                                        float (&a2)[CG],
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
    for (int q = 0; q < CG / 4; ++q) {
      const float4 x = x4[q];
      a0[4 * q + 0] = fmaf(w0, x.x, a0[4 * q + 0]);
      a0[4 * q + 1] = fmaf(w0, x.y, a0[4 * q + 1]);
      a0[4 * q + 2] = fmaf(w0, x.z, a0[4 * q + 2]);
      a0[4 * q + 3] = fmaf(w0, x.w, a0[4 * q + 3]);
      a1[4 * q + 0] = fmaf(w1, x.x, a1[4 * q + 0]);
      a1[4 * q + 1] = fmaf(w1, x.y, a1[4 * q + 1]);
      a1[4 * q + 2] = fmaf(w1, x.z, a1[4 * q + 2]);
      a1[4 * q + 3] = fmaf(w1, x.w, a1[4 * q + 3]);
      a2[4 * q + 0] = fmaf(w2, x.x, a2[4 * q + 0]);
      a2[4 * q + 1] = fmaf(w2, x.y, a2[4 * q + 1]);
      a2[4 * q + 2] = fmaf(w2, x.z, a2[4 * q + 2]);
      a2[4 * q + 3] = fmaf(w2, x.w, a2[4 * q + 3]);
    }
  }
}

// dst[r][c] = src[r][col0 + c] for r < rows, zero past the ragged edge
template <typename S>
__device__ __forceinline__ void load_tile(float* dst, const S* src,
                                          int rows, int B, int col0) {
  for (int e = threadIdx.x; e < rows * BT; e += NTH) {
    const int r = e / BT, c = e % BT, col = col0 + c;
    dst[e] = col < B ? ldp(src + static_cast<size_t>(r) * B + col) : 0.0f;
  }
}

// out[i] = dt(sum_s part[s][i]), the splits added in order (the last pass
// of a weight-gradient reduction split over S column ranges)
template <typename T>
__global__ void sum_parts_kernel(const float* part, int S, int MN, T* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float a = 0.0f;
  for (int s = 0; s < S; ++s) a += part[static_cast<size_t>(s) * MN + i];
  out[i] = from_f<T>(a);
}

}  // namespace bigru
