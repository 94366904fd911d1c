// v6 fused emulator forward: initial MLP + split up-projection + up GRU
// sweep + down GRU sweep + latent/output heads, channel-major [L, C, B].
//
// Replaces the TPU kernel climsim_tpu/ops/pallas_rnn.py::
// _bigru_heads_init_cm_kernel (wrapper _bigru_heads_init_cm_pallas).
//
// What it computes, per column (dt = the input type, f32 or bf16; every
// sum is accumulated in f32):
//   xi_l  = dt(tanh(dt(Winit feat_l + binit)))
//   up sweep l = L-1 .. 0:
//     xp  = dt(W1h xi_l + W1m mem_l + b1)
//     hh  = Whh_up dt(h) + bhh_up;  r = s(xp_r + hh_r), z = s(xp_z + hh_z)
//     n   = tanh(xp_n + r hh_n);   h = (1 - z) n + z h;   up_l = dt(h)
//   down sweep l = 0 .. L-1:
//     xp2 = dt(W2 up_l + b2); the same GRU step with Whh_dn on h2
//     mem_l = dt(Wlat dt(h2) + blat); out_l = dt(Wout mem_l + bout)
//     outmem[l] = [mem_l; out_l]
//   lasth = dt(h2)
//
// What bounds it on an H100 at the flagship shapes (L 60, nf 6, nm 16,
// ny 6, H 192, B 21,600): 455,904 multiply-adds per column and level
// (1,152 init + 119,808 up projection + 3 x 110,592 recurrences and down
// projection + 3,072 + 96 heads) = 1.18 TFLOP per call, 1.19 ms at the
// 989 TFLOP/s dense bf16 tensor-core peak; the bytes it must move (feat,
// mem_in, h0s in; outmem, lasth out; bf16) are ~0.14 GB, 0.04 ms at
// 3.35 TB/s. So it is bound by operations.
//
// What this first design does about it: it is a CUDA-core FMA kernel
// (f32 accumulation of dt products), not a tensor-core one, so its floor
// is the card's ~67 TFLOP/s f32 FMA rate, ~18 ms, not 1.19 ms. Columns
// are independent, so each block owns a tile of BT columns and walks all
// L levels of both sweeps in an in-kernel loop (the TPU's sequential
// grid). The 120 dependent GRU steps are serial per tile, so 675 tiles
// at B 21,600 keep 2 blocks on each of the 132 SMs. Hopper cannot hold a
// [576, 192] recurrent weight (216 KB bf16) per block next to the state,
// so weights are read k-major ([in, out], flax's own layout) straight
// from global memory, where the 0.9 MB of bf16 weights stay resident in
// the 50 MB L2: for a fixed k the threads of a warp read 32 neighbouring
// outputs, one coalesced 64-byte load. The state h (f32), dt(h) and the
// level's input live in shared memory as f32; the up stream [L, H, B]
// that the down sweep reads goes to a scratch tensor the wrapper
// allocates. B is ragged: the last tile masks its columns itself. The GRU
// level and the down sweep with the heads are shared with the v5 kernel
// (bigru_heads_cm.cuh). This design is kept for f32 (the F32 policy rules
// out TF32); bf16 runs the tensor-core design at the end of this file.
// Built without --use_fast_math: expf/tanhf keep the 60-level recurrence
// within tolerance of the plain version.
#include "bigru_heads_cm.cuh"
#include "bigru_mma_fwd.cuh"

namespace {

using namespace bigru;

struct Params {
  const void *feat, *mem_in, *h0u, *h0d;
  const void *winit, *binit, *win1h, *win1m, *bin1, *whh_up, *bhh_up;
  const void *win2, *bin2, *whh_dn, *bhh_dn, *wlat, *blat, *wout, *bout;
  void *outmem, *lasth, *up;
  float* tiles;     // device scratch for the tiles, or null: shared memory
  int L, nf, nm_in, H, nm, ny, B;
};

// the f32 rows of [BT] a block keeps in its tiles
__host__ __device__ inline size_t tile_rows(const Params& p) {
  return 4 * static_cast<size_t>(p.H) + p.nm_in + p.nf + p.nm;
}

template <typename T, bool kTiles, bool kG16>
__global__ void __launch_bounds__(NTH, 2)
bigru_heads_init_cm_kernel(Params p) {
  const T* feat = static_cast<const T*>(p.feat);
  const T* mem_in = static_cast<const T*>(p.mem_in);
  const T* winit = static_cast<const T*>(p.winit);
  const T* binit = static_cast<const T*>(p.binit);
  const T* blat = static_cast<const T*>(p.blat);
  const T* wlat = static_cast<const T*>(p.wlat);
  const T* wout = static_cast<const T*>(p.wout);
  const T* bout = static_cast<const T*>(p.bout);
  T* outmem = static_cast<T*>(p.outmem);
  T* lasth = static_cast<T*>(p.lasth);
  T* up = static_cast<T*>(p.up);
  const int L = p.L, nf = p.nf, nmi = p.nm_in, H = p.H, nm = p.nm,
            ny = p.ny, B = p.B;
  const int col0 = blockIdx.x * BT;
  const int tid = threadIdx.x;

  extern __shared__ float4 smem4[];
  float* s_hc = kTiles ? p.tiles + blockIdx.x * tile_rows(p) * BT
                       : reinterpret_cast<float*>(smem4);  // [H][BT] f32 state
  float* xh_cur = s_hc + H * BT;                    // [H][BT] dt(h)
  float* xh_nxt = xh_cur + H * BT;                  // [H][BT]
  float* s_x = xh_nxt + H * BT;                     // [H + nm_in][BT]
  float* s_feat = s_x + (H + nmi) * BT;             // [nf][BT]
  float* s_mem = s_feat + nf * BT;                  // [nm][BT]

  // ---- up sweep, surface (l = L-1) to top
  load_tile(s_hc, static_cast<const T*>(p.h0u), H, B, col0);
  load_tile(xh_cur, static_cast<const T*>(p.h0u), H, B, col0);
  for (int l = L - 1; l >= 0; --l) {
    load_tile(s_feat, feat + static_cast<size_t>(l) * nf * B, nf, B, col0);
    load_tile(s_x + H * BT, mem_in + static_cast<size_t>(l) * nmi * B, nmi,
              B, col0);
    __syncthreads();
    // initial MLP: the pre-activation is rounded to dt before the tanh
    // (with kG16 the TPU body's typed bf16 tanh, 2 sigmoid(2x) - 1)
    for (int e = tid; e < H * BT; e += NTH) {
      const int j = e / BT, c = e % BT;
      float a = 0.0f;
      for (int f = 0; f < nf; ++f)
        a = fmaf(ldw(winit + f * H + j), s_feat[f * BT + c], a);
      const float pre = rnd<T>(a + ldw(binit + j));
      s_x[e] = kG16 ? gates16::tanh1(pre) : rnd<T>(tanhf(pre));
    }
    __syncthreads();
    gru_level<T, true, kG16>(static_cast<const T*>(p.win1h), s_x, H,
                       static_cast<const T*>(p.win1m), s_x + H * BT, nmi,
                       static_cast<const T*>(p.bin1),
                       static_cast<const T*>(p.whh_up),
                       static_cast<const T*>(p.bhh_up), xh_cur, s_hc, xh_nxt,
                       H);
    __syncthreads();
    float* t = xh_cur; xh_cur = xh_nxt; xh_nxt = t;
    store_up(up + static_cast<size_t>(l) * H * B, xh_cur, H, B, col0);
  }

  // ---- down sweep, top (l = 0) to surface, and the heads
  down_sweep_heads<T, true, kG16>(up, static_cast<const T*>(p.h0d),
                            static_cast<const T*>(p.win2),
                            static_cast<const T*>(p.bin2),
                            static_cast<const T*>(p.whh_dn),
                            static_cast<const T*>(p.bhh_dn), wlat, blat,
                            wout, bout, outmem, lasth, s_hc, xh_cur, xh_nxt,
                            s_x, s_mem, L, H, nm, ny, B, col0);
}

template <typename T, bool kG16 = false>
int launch(const Params& p, cudaStream_t stream) {
  const int blocks = (p.B + BT - 1) / BT;
  if (p.tiles != nullptr) {
    bigru_heads_init_cm_kernel<T, true, kG16><<<blocks, NTH, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * BT * tile_rows(p);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_heads_init_cm_kernel<T, false, kG16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bigru_heads_init_cm_kernel<T, false, kG16>
      <<<blocks, NTH, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ------------------------------------------------ bf16: tensor-core design
//
// The bf16 path (the flagship policy) runs on tensor cores: the kernel
// body of bigru_mma_fwd.cuh in its channel-major instance, with both
// sweeps' projections rounded to bf16 before the gates, as the v6 TPU
// body stores them. Its weight slices are resident in shared memory up to
// H ~ 320 and streamed through a ring beyond (bigru_mma.cuh).
// dtype: 0 = float32, 1 = bfloat16; g16: 1 for the bf16 gates (acc32=False,
// gates16.cuh; bfloat16 only). Weights are k-major ([in, out]),
// biases flat; activations channel-major [L, C, B] / [H, B], contiguous.
// up is a [L, H, B] scratch of the input type. tiles: null to keep the
// block's tiles in shared memory ((4H + nm_in + nf + nm) x 32 f32, up to
// H 440 at the flagship's other widths), or a device scratch of
// ceil(B / 32) times that (16-byte aligned) that takes them at any H: the
// kernel then launches with no dynamic shared memory, and __syncthreads
// orders a block's global accesses as its shared ones. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int bigru_heads_init_cm(
    int dtype, const void* feat, const void* mem_in, const void* h0u,
    const void* h0d, const void* winit, const void* binit,
    const void* win1h, const void* win1m, const void* bin1,
    const void* whh_up, const void* bhh_up, const void* win2,
    const void* bin2, const void* whh_dn, const void* bhh_dn,
    const void* wlat, const void* blat, const void* wout, const void* bout,
    void* outmem, void* lasth, void* up, int L, int nf, int nm_in, int H,
    int nm, int ny, int B, int g16, void* tiles, void* stream) {
  Params p{feat, mem_in, h0u, h0d, winit, binit, win1h, win1m, bin1,
           whh_up, bhh_up, win2, bin2, whh_dn, bhh_dn, wlat, blat, wout,
           bout, outmem, lasth, up, static_cast<float*>(tiles), L, nf,
           nm_in, H, nm, ny, B};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !g16) return launch<float>(p, s);
  if (dtype == 1) return g16 ? launch<__nv_bfloat16, true>(p, s)
                             : launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same CUDA-core design in bf16 under a second name, kept to time it
// against the tensor-core design; no wrapper selects it.
extern "C" int bigru_heads_init_cm_cudacore(
    const void* feat, const void* mem_in, const void* h0u, const void* h0d,
    const void* winit, const void* binit, const void* win1h,
    const void* win1m, const void* bin1, const void* whh_up,
    const void* bhh_up, const void* win2, const void* bin2,
    const void* whh_dn, const void* bhh_dn, const void* wlat,
    const void* blat, const void* wout, const void* bout, void* outmem,
    void* lasth, void* up, int L, int nf, int nm_in, int H, int nm, int ny,
    int B, void* tiles, void* stream) {
  return bigru_heads_init_cm(1, feat, mem_in, h0u, h0d, winit, binit, win1h,
                             win1m, bin1, whh_up, bhh_up, win2, bin2, whh_dn,
                             bhh_dn, wlat, blat, wout, bout, outmem, lasth,
                             up, L, nf, nm_in, H, nm, ny, B, 0, tiles,
                             stream);
}

// bf16 tensor-core design. ptrs, in order: feat [L, nf, B], mem_in
// [L, nmi, B], h0u, h0d [H, B], winit [H, nf], binit [H], wx_up
// [C][3H/C][H + nmi] (the gate slices of [W1h | W1m], [out, in]), b1
// [3H], wh_up [C][3H/C][H], bh_up [3H], wx_dn (W2) and wh_dn like wh_up,
// b2, bh_dn [3H], wlat [nm8][H] (rows past nm zero), blat [nm], wout
// [ny, nm], bout [ny], outmem [L, nm + ny, B], lasth [H, B], up [L, H, B]
// scratch; H and nmi already padded. stream: 1 for the streamed-weights
// instantiation; g16: 1 for the bf16 gates (acc32=False, gates16.cuh).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for shapes
// outside the design).
extern "C" int bigru_heads_init_cm_mma(void* const* ptrs, int L, int nf,
                                       int nmi, int H, int nm, int ny,
                                       int B, int C, int BT, int stream,
                                       int g16, void* st) {
  using bmma::bf16;
  const bf16* const* c = reinterpret_cast<const bf16* const*>(ptrs);
  bf16* outmem = static_cast<bf16*>(ptrs[18]);
  const size_t sB = B, nmo = static_cast<size_t>(nm + ny) * sB;
  bmma::FwdParams p{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8],
                    c[9], c[10], c[11], c[12], c[13], c[14], c[15], c[16],
                    c[17], outmem, outmem + nm * sB,
                    static_cast<bf16*>(ptrs[19]), static_cast<bf16*>(ptrs[20]),
                    nmo, nmo, B, B,
                    L, nf, H, nmi, H, nm, ny, B, C, BT};
  return bmma::launch_fwd<false, true>(p, stream, g16,
                                       static_cast<cudaStream_t>(st));
}
