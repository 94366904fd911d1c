// The GRU gate step in bf16 arithmetic, for the forward kernels' bf16-gate
// mode (acc32=False): JAX's _gru_step with the state carried in bf16 and
// the typed transcendentals (climsim_tpu/ops/pallas_rnn.py:51-95). Every
// operation takes bf16 operands and rounds its exact result to bf16 (round
// to nearest even), as the plain version's torch ops on bf16 tensors and
// the TPU body do. The recurrent product stays an f32 sum of bf16
// products that takes its bias in f32 and is rounded once, as the TPU
// body's dot does.
//
// The step runs on pairs: two hidden units of one column (q = (0, 1) and
// (2, 3) of an m16n8 accumulator fragment) in the tensor-core design, two
// columns of one unit in the CUDA-core one. A sum, difference or product
// is one packed bf16x2 instruction in its _rn form, which nvcc never
// contracts into a fused multiply-add (that would round once where JAX
// rounds twice). It rounds the exact result once, which is the bf16 that
// f32 arithmetic followed by a rounding gives: the product of two bf16
// values is exact in f32, and f32's 24 bits let a sum of two 8-bit values
// round twice without moving (tests/test_torch_gates16.py).
//
// The transcendentals come from the SFU and still give the bits of IEEE
// expf and division, on which the bf16 roundings land:
// - exp(-S x) (S 1 for the sigmoid, 2 for the typed tanh's sigmoid(2x)) is
//   ex2.approx of x * -S log2(e): at most 2.5 ulps from the exact value,
//   plus 1.23 S |x| ulps from the rounded argument; expf is within 2 ulps
//   of it. A lane whose f32 result lies within 6 + 1.25 S |x| ulps of a
//   bf16 rounding midpoint (its low 16 bits near 0x8000) takes expf; on
//   every other lane both round to the same bf16. 5 of the 34,145 bf16 x
//   whose exp(-x) is a normal f32 take expf (chip_smoke phase 16).
// - 1/d, d = bf16(1 + e) >= 1, is the SFU's MUFU.RCP (rcp.approx.ftz),
//   within 1 ulp of 1/d. For a bf16 d that is not a power of 2, 1/d lies
//   at least 128.5 f32 ulps from a bf16 midpoint, so it rounds as IEEE
//   division's quotient does; a power of 2 is exact. Where S x < -87,
//   1 + e may pass 2^126 and 1/d be an f32 subnormal, which bf16 holds
//   and the flushing form (like __fdividef) loses: such a lane takes
//   rcp.approx.f32, which keeps it, on the rare path.
// Both rules act on a pair at once: a pair with a lane near a tie or
// below -87 / S takes the rare path, in a branch that a warp runs only
// where one of its lanes needs it; the step checks r's and z's pairs
// together, so two branches a step.
// The sigmoid and the typed tanh keep JAX's order of operations.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace gates16 {

using bf2 = __nv_bfloat162;

__device__ __forceinline__ bf2 pk(float lo, float hi) {
  return __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ uint32_t bits(bf2 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ bf2 splat(float v) {
  return __float2bfloat162_rn(v);
}

// a pair's lanes as f32 (bf16 is the upper half of an f32)
__device__ __forceinline__ float2 unpk(bf2 v) {
  const uint32_t b = bits(v);
  return make_float2(__uint_as_float(b << 16),
                     __uint_as_float(b & 0xFFFF0000u));
}

__device__ __forceinline__ float ex2(float t) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(t));
  return y;
}
// 1 / d from MUFU.RCP alone (kKeep false: subnormal quotients flush), or
// with the subnormal quotients kept (rcp.approx.f32)
template <bool kKeep>
__device__ __forceinline__ float rcp(float d) {
  float y;
  if constexpr (kKeep)
    asm("rcp.approx.f32 %0, %1;" : "=f"(y) : "f"(d));
  else
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(d));
  return y;
}

// exp(-S x) from the SFU, S = 1 for the sigmoid and 2 for the typed
// tanh's sigmoid(2x), x a bf16 value
template <int S>
__device__ __forceinline__ float ex2_of(float x) {
  return ex2(x * (-S * 1.44269504088896341f));
}
// the tie rule: y = ex2_of<S>(x) lies within 6 + 1.25 S |x| ulps of a
// bf16 rounding midpoint. Its distance is the low 16 bits less 0x8000,
// exactly, as the float 2^23 + low16 less 2^23 + 2^15.
template <int S>
__device__ __forceinline__ bool near_tie(float x, float y) {
  const float dist =
      __uint_as_float((__float_as_uint(y) & 0xFFFFu) | 0x4B000000u) -
      8421376.0f;
  return fabsf(dist) <= fmaf(fabsf(x), S * 1.25f, 6.0f);
}
// the exponentials of a pair from the SFU
template <int S>
__device__ __forceinline__ float2 sfu_exp(float2 f) {
  return make_float2(ex2_of<S>(f.x), ex2_of<S>(f.y));
}
// whether the pair takes the rare path: a lane near a tie, or below
// -87 / S (1 + e past 2^126 can only come from there)
template <int S>
__device__ __forceinline__ bool rare(float2 f, float2 y) {
  return near_tie<S>(f.x, y.x) | near_tie<S>(f.y, y.y) |
         (fminf(f.x, f.y) < -87.0f / S);
}
// values that round to the bf16s of expf(-S f): expf where y is near a tie
template <int S>
__device__ __forceinline__ float2 settle(float2 f, float2 y) {
  return make_float2(near_tie<S>(f.x, y.x) ? expf(-(S * f.x)) : y.x,
                     near_tie<S>(f.y, y.y) ? expf(-(S * f.y)) : y.y);
}
// 1 / (1 + e), each operation rounded to bf16
template <bool kKeep>
__device__ __forceinline__ bf2 recip1p(float2 e) {
  const float2 d = unpk(__hadd2_rn(splat(1.0f), pk(e.x, e.y)));
  return pk(rcp<kKeep>(d.x), rcp<kKeep>(d.y));
}

// 1 / (1 + exp(-S x)), each operation rounded to bf16
template <int S>
__device__ __forceinline__ bf2 sigmoid_s(bf2 x) {
  const float2 f = unpk(x);
  const float2 e = sfu_exp<S>(f);
  if (rare<S>(f, e)) return recip1p<true>(settle<S>(f, e));
  return recip1p<false>(e);
}
__device__ __forceinline__ bf2 sigmoid2(bf2 x) { return sigmoid_s<1>(x); }
// 2 sigmoid(2x) - 1: 2x is exact, and so is the product 2 s, so the fused
// form rounds 2 s - 1 once, as the separate product and difference do
__device__ __forceinline__ bf2 tanh2(bf2 x) {
  return __hfma2(sigmoid_s<2>(x), splat(2.0f), splat(-1.0f));
}

// the typed tanh of one bf16 value, for a loop of single elements (both
// lanes of the pair hold x)
__device__ __forceinline__ float tanh1(float x) {
  return __low2float(tanh2(splat(x)));
}

// One update of two hidden units: xr, xz, xn the input projection (bias
// included), hr, hz, hn the recurrent product with its bias, each rounded
// to bf16; h the bf16 state. Returns the new state.
__device__ __forceinline__ bf2 step2(bf2 xr, bf2 xz, bf2 xn, bf2 hr, bf2 hz,
                                     bf2 hn, bf2 h) {
  const float2 fr = unpk(__hadd2_rn(xr, hr)), fz = unpk(__hadd2_rn(xz, hz));
  const float2 er = sfu_exp<1>(fr), ez = sfu_exp<1>(fz);
  bf2 r, z;
  if (rare<1>(fr, er) | rare<1>(fz, ez)) {
    r = recip1p<true>(settle<1>(fr, er));
    z = recip1p<true>(settle<1>(fz, ez));
  } else {
    r = recip1p<false>(er);
    z = recip1p<false>(ez);
  }
  const bf2 n = tanh2(__hadd2_rn(xn, __hmul2_rn(r, hn)));
  return __hadd2_rn(__hmul2_rn(__hsub2_rn(splat(1.0f), z), n),
                    __hmul2_rn(z, h));
}

}  // namespace gates16
