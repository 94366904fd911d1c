// v2 fused BiGRU forward, level-major [L, B, .]: the up GRU sweep over a
// precomputed input projection, then the down GRU sweep with its input
// projection fused. The trunk of the physics-constrained emulator.
//
// Replaces the TPU kernel climsim_tpu/ops/pallas_rnn.py::_bigru_kernel
// (wrapper _bigru_pallas_lbh).
//
// What it computes, per column (dt = the input type, f32 or bf16; gates
// and sums in f32):
//   up sweep l = L-1 .. 0:
//     hh = Whh_up dt(h) + bhh_up; r = s(xp_r + hh_r), z = s(xp_z + hh_z)
//     n  = tanh(xp_n + r hh_n);  h = (1 - z) n + z h;  up_l = dt(h)
//   down sweep l = 0 .. L-1:
//     x2 = W2 up_l + b2 (f32, not rounded); the same GRU step with Whh_dn
//     on h2;  down_l = dt(h2)
//   last_h = dt(h2)
//
// What bounds it on an H100 at the physics trunk's shapes (L 50, H 128,
// B 21,600): 3 x 3H x H = 147,456 multiply-adds per column and level (up
// recurrence, down projection, down recurrence) = 0.3185 TFLOP per call,
// 4.75 ms at the 67 TFLOP/s f32 rate (the f32 policy rules out TF32);
// the bytes it must move (xp, h0s in, down, last_h out, weights) are
// ~2.2 GB in f32, 0.66 ms at 3.35 TB/s. So it is bound by operations.
//
// What this first design does about it: like B1 it is a CUDA-core FMA
// kernel. Columns are independent, so each block owns a tile of BT
// columns and walks both sweeps level by level in an in-kernel loop (the
// TPU's sequential grid). A thread owns one hidden unit j for CG columns:
// for a fixed k the threads of a warp read 32 neighbouring outputs of the
// k-major ([in, out], flax's layout) weights, which stay in L2, and the
// level's xp and the outputs are read and written at neighbouring j, so
// every global access is coalesced. The state h (f32), dt(h) and the down
// sweep's input live in shared memory. The TPU kept the tile's up states
// in VMEM scratch; here they go into the `down` output itself: the down
// sweep at level l reads up_l (into shared memory) before it writes down_l
// over it, so no scratch is needed. The ragged last tile masks its
// columns (zero inputs, nothing stored) instead of padding.
// Built without --use_fast_math: expf/tanhf keep the 100-level recurrence
// within tolerance of the plain version.
#include "bigru_lbh.cuh"

namespace {

using namespace bigru_v2;

struct Params {
  const void *xp, *h0u, *h0d, *whh_up, *bhh_up, *win2, *bin2, *whh_dn,
      *bhh_dn;
  void *down, *lasth;
  int L, H, B;
};

template <typename T>
__global__ void __launch_bounds__(NTH, 2) bigru_lbh_kernel(Params p) {
  const T* xp = static_cast<const T*>(p.xp);
  const T* whh_up = static_cast<const T*>(p.whh_up);
  const T* bhh_up = static_cast<const T*>(p.bhh_up);
  const T* win2 = static_cast<const T*>(p.win2);
  const T* bin2 = static_cast<const T*>(p.bin2);
  const T* whh_dn = static_cast<const T*>(p.whh_dn);
  const T* bhh_dn = static_cast<const T*>(p.bhh_dn);
  T* down = static_cast<T*>(p.down);
  T* lasth = static_cast<T*>(p.lasth);
  const int L = p.L, H = p.H, B = p.B;
  const int col0 = blockIdx.x * BT;
  const size_t level = static_cast<size_t>(B) * H;

  extern __shared__ float4 smem4[];
  float* s_hc = reinterpret_cast<float*>(smem4);   // [H][BT] f32 state
  float* xh_cur = s_hc + H * BT;                    // [H][BT] dt(h)
  float* xh_nxt = xh_cur + H * BT;                  // [H][BT]
  float* s_x = xh_nxt + H * BT;                     // [H][BT] dt(up_l)

  // ---- up sweep, surface (l = L-1) to top; up_l is stored in down[l]
  load_level(s_hc, static_cast<const T*>(p.h0u), H, B, col0);
  load_level(xh_cur, static_cast<const T*>(p.h0u), H, B, col0);
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    gru_level<T, false>(xp + static_cast<size_t>(l) * B * 3 * H, nullptr,
                        nullptr, nullptr, whh_up, bhh_up, xh_cur, s_hc,
                        xh_nxt, down + l * level, nullptr, H, B, col0);
    __syncthreads();
    float* t = xh_cur; xh_cur = xh_nxt; xh_nxt = t;
  }

  // ---- down sweep, top (l = 0) to surface; reads up_l from down[l]
  // before overwriting it with down_l
  load_level(s_hc, static_cast<const T*>(p.h0d), H, B, col0);
  load_level(xh_cur, static_cast<const T*>(p.h0d), H, B, col0);
  for (int l = 0; l < L; ++l) {
    load_level(s_x, down + l * level, H, B, col0);
    __syncthreads();
    gru_level<T, false>(nullptr, win2, bin2, s_x, whh_dn, bhh_dn, xh_cur,
                        s_hc, xh_nxt, down + l * level, nullptr, H, B,
                        col0);
    __syncthreads();
    float* t = xh_cur; xh_cur = xh_nxt; xh_nxt = t;
  }
  store_level(lasth, xh_cur, H, B, col0);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(p.H) * BT;
  cudaError_t err = cudaFuncSetAttribute(
      bigru_lbh_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (p.B + BT - 1) / BT;
  bigru_lbh_kernel<T><<<blocks, NTH, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor). xp [L, B, 3H], h0u/h0d
// [B, H], weights k-major [H, 3H], biases [3H], down [L, B, H], lasth
// [B, H], all contiguous. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int bigru_lbh(int dtype, const void* xp, const void* h0u,
                         const void* h0d, const void* whh_up,
                         const void* bhh_up, const void* win2,
                         const void* bin2, const void* whh_dn,
                         const void* bhh_dn, void* down, void* lasth, int L,
                         int H, int B, void* stream) {
  Params p{xp, h0u, h0d, whh_up, bhh_up, win2, bin2, whh_dn, bhh_dn,
           down, lasth, L, H, B};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
