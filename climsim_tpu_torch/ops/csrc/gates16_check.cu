// Card checks of the bf16-gate step (gates16.cuh), run by chip_smoke.py and
// the card-only tests through ops/gates16.py; no model path launches them.
// They hold the step against the accurate forms it replaced, which stay
// here as the reference: every operation in f32 and then rounded to bf16,
// with IEEE expf and division (this file is built without fast math, as
// every source is).
// - gates16_check_unary: the sigmoid and the typed tanh on bf16 inputs
//   (all 65,536 of them in the checks), the tie rule's choice for each
//   input and the SFU exponential's error against the float64 exp.
// - gates16_check_step: the step on seeded operand sets, in pairs of
//   lanes, as the kernels pack them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gates16.cuh"

namespace {

namespace ref {

__device__ __forceinline__ float r16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float sigmoid(float x) {
  return r16(1.0f / r16(1.0f + r16(expf(-x))));
}
__device__ __forceinline__ float tanh(float x) {
  return r16(2.0f * sigmoid(2.0f * x) - 1.0f);
}
__device__ __forceinline__ float step(float xr, float xz, float xn, float ar,
                                      float az, float an, float cr, float cz,
                                      float cn, float h) {
  const float hr = r16(ar + cr), hz = r16(az + cz), hn = r16(an + cn);
  const float r = sigmoid(r16(xr + hr));
  const float z = sigmoid(r16(xz + hz));
  const float n = tanh(r16(xn + r16(r * hn)));
  return r16(r16(r16(1.0f - z) * n) + r16(z * h));
}

}  // namespace ref

__device__ __forceinline__ float f16(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}
__device__ __forceinline__ uint16_t b16(float v) {
  return static_cast<uint16_t>(__float_as_uint(v) >> 16);
}
__device__ __forceinline__ uint16_t lo16(gates16::bf2 v) {
  return static_cast<uint16_t>(gates16::bits(v) & 0xFFFFu);
}

// |y - exp(-S x)| in f32 ulps of the exact value, -1 where that value is
// not a normal f32
template <int S>
__device__ float ex2_ulps(float x) {
  const double v = exp(-static_cast<double>(S) * static_cast<double>(x));
  if (!(v >= ldexp(1.0, -126) && v < ldexp(1.0, 128))) return -1.0f;
  const double ulp = ldexp(1.0, ilogb(v) - 23);
  return static_cast<float>(
      fabs(static_cast<double>(gates16::ex2_of<S>(x)) - v) / ulp);
}

// out [n][4]: sigmoid, its reference, tanh, its reference (bf16 bits);
// slow [n][2]: the tie rule's choice for S = 1, 2; err [n][2]: ex2_ulps
__global__ void unary_kernel(const uint16_t* x, int n, uint16_t* out,
                             uint8_t* slow, float* err) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = f16(x[i]);
  const gates16::bf2 v2 = gates16::splat(v);
  out[4 * i] = lo16(gates16::sigmoid2(v2));
  out[4 * i + 1] = b16(ref::sigmoid(v));
  out[4 * i + 2] = lo16(gates16::tanh2(v2));
  out[4 * i + 3] = b16(ref::tanh(v));
  slow[2 * i] = gates16::near_tie<1>(v, gates16::ex2_of<1>(v));
  slow[2 * i + 1] = gates16::near_tie<2>(v, gates16::ex2_of<2>(v));
  err[2 * i] = ex2_ulps<1>(v);
  err[2 * i + 1] = ex2_ulps<2>(v);
}

// lanes 2k and 2k + 1 of sums [n][6] (xr, xz, xn: the input projection's
// f32 sums with their bias; ar, az, an: the recurrent product's f32 sums)
// and bf [n][4] (cr, cz, cn: the recurrent bias; h: the state) form one
// pair; out [n][2]: the new step's state and the reference's
__global__ void step_kernel(const float* sums, const uint16_t* bf, int n,
                            uint16_t* out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (2 * k + 1 >= n) return;
  const float* s0 = sums + 12 * k;
  const float* s1 = s0 + 6;
  const uint16_t* c0 = bf + 8 * k;
  const uint16_t* c1 = c0 + 4;
  using gates16::pk;
  const gates16::bf2 h = gates16::step2(
      pk(s0[0], s1[0]), pk(s0[1], s1[1]), pk(s0[2], s1[2]),
      pk(s0[3] + f16(c0[0]), s1[3] + f16(c1[0])),
      pk(s0[4] + f16(c0[1]), s1[4] + f16(c1[1])),
      pk(s0[5] + f16(c0[2]), s1[5] + f16(c1[2])), pk(f16(c0[3]), f16(c1[3])));
  const uint32_t hb = gates16::bits(h);
  out[4 * k] = static_cast<uint16_t>(hb & 0xFFFFu);
  out[4 * k + 2] = static_cast<uint16_t>(hb >> 16);
  for (int e = 0; e < 2; ++e) {
    const float* s = e ? s1 : s0;
    const uint16_t* c = e ? c1 : c0;
    out[4 * k + 2 * e + 1] = b16(ref::step(
        ref::r16(s[0]), ref::r16(s[1]), ref::r16(s[2]), s[3], s[4], s[5],
        f16(c[0]), f16(c[1]), f16(c[2]), f16(c[3])));
  }
}

}  // namespace

// x [n] bf16 bits; out [n, 4] and slow [n, 2] as unary_kernel; err [n, 2]
// f32. Returns the cudaError_t of the launch.
extern "C" int gates16_check_unary(const void* x, int n, void* out,
                                   void* slow, void* err, void* stream) {
  unary_kernel<<<(n + 255) / 256, 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), n, static_cast<uint16_t*>(out),
      static_cast<uint8_t*>(slow), static_cast<float*>(err));
  return static_cast<int>(cudaGetLastError());
}

// sums [n, 6] f32, bf [n, 4] bf16 bits, n even; out [n, 2] bf16 bits, as
// step_kernel. Returns the cudaError_t of the launch.
extern "C" int gates16_check_step(const void* sums, const void* bf, int n,
                                  void* out, void* stream) {
  const int pairs = n / 2;
  step_kernel<<<(pairs + 255) / 256, 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sums), static_cast<const uint16_t*>(bf), n,
      static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
