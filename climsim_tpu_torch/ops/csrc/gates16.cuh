// The GRU gate step in bf16 arithmetic, for the forward kernels' bf16-gate
// mode (acc32=False): JAX's _gru_step with the state carried in bf16 and
// the typed transcendentals (climsim_tpu/ops/pallas_rnn.py:51-95). Every
// operation takes bf16 operands, runs in f32 and is rounded to bf16 (round
// to nearest even), which is one bf16 operation: the plain version's
// torch ops on bf16 tensors and the TPU body round the same way. The
// recurrent product stays an f32 sum of bf16 products that takes its bias
// in f32 and is rounded once, as the TPU body's dot does.
#pragma once
#include <cuda_bf16.h>

namespace gates16 {

__device__ __forceinline__ float r16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// 1 / (1 + exp(-x)), each operation rounded (IEEE expf and division: the
// kernels are built without --use_fast_math)
__device__ __forceinline__ float sigmoid(float x) {
  return r16(1.0f / r16(1.0f + r16(expf(-x))));
}
// 2 sigmoid(2x) - 1 (the products by 2 are exact)
__device__ __forceinline__ float tanh(float x) {
  return r16(2.0f * sigmoid(2.0f * x) - 1.0f);
}
// One hidden unit's update: xr, xz, xn the input projection (bias
// included) rounded to bf16; ar, az, an the recurrent product's f32 sums
// and cr, cz, cn its bias; h the bf16 state. Returns the new state, a
// bf16 value.
__device__ __forceinline__ float step(float xr, float xz, float xn, float ar,
                                      float az, float an, float cr, float cz,
                                      float cn, float h) {
  const float hr = r16(ar + cr), hz = r16(az + cz), hn = r16(an + cn);
  const float r = sigmoid(r16(xr + hr));
  const float z = sigmoid(r16(xz + hz));
  const float n = tanh(r16(xn + r16(r * hn)));
  return r16(r16(r16(1.0f - z) * n) + r16(z * h));
}

}  // namespace gates16
