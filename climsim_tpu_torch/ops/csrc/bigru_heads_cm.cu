// v5 fused emulator forward: split up-projection of the initial-MLP
// stream and the memory + up GRU sweep + down GRU sweep + latent/output
// heads, channel-major [L, C, B].
//
// Replaces the TPU kernels climsim_tpu/ops/pallas_rnn.py::
// _bigru_heads_cm_kernel and _bigru_heads_cm_hoist_kernel (wrapper
// _bigru_heads_cm_pallas; hoist_proj picks the second).
//
// What it computes, per column (dt = the input type, f32 or bf16; every
// sum is accumulated in f32; R = dt when the projections are hoisted, the
// identity when not, as the two TPU bodies store them):
//   up sweep l = L-1 .. 0:
//     xp  = R(W1h x_l + W1m mem_l + b1)
//     hh  = Whh_up dt(h) + bhh_up;  r = s(xp_r + hh_r), z = s(xp_z + hh_z)
//     n   = tanh(xp_n + r hh_n);   h = (1 - z) n + z h;   up_l = dt(h)
//   down sweep l = 0 .. L-1:
//     xp2 = R(W2 up_l + b2); the same GRU step with Whh_dn on h2
//     mem_l = dt(Wlat dt(h2) + blat); out_l = dt(Wout mem_l + bout)
//     outmem[l] = [mem_l; out_l]
//   lasth = dt(h2)
// The TPU's hoisted body computes a block of 15 levels' projections ahead
// of their chain steps; the values, and so the result, are the same as
// computing each level's projection just before its step, which this
// kernel does for both variants.
//
// What bounds it on an H100 at the flagship's v5 shapes (L 60, CH 192,
// nm_in 16, H 192, nm 16, ny 6, B 21,600): 3H (CH + nm_in + 3H) + nm H +
// ny nm = 454,752 multiply-adds per column and level (119,808 up
// projection, 3 x 110,592 recurrences and down projection, 3,168 heads) =
// 1.18 TFLOP per call, 1.19 ms at the 989 TFLOP/s dense bf16 tensor-core
// peak; the bytes it must move (x, mem_in, h0s in; outmem, lasth out;
// bf16) are ~0.62 GB, 0.19 ms at 3.35 TB/s. So it is bound by operations.
//
// What the CUDA-core design does about it (f32; in bf16 kept only to be
// timed against the tensor-core design below): it is B1's CUDA-core
// design (bigru_heads_init_cm.cu), with the initial MLP replaced by a load
// of the level's x: a CUDA-core FMA kernel whose floor is the card's ~67
// TFLOP/s f32 FMA rate (~18 ms), one block per 32-column tile walking all
// L levels of both sweeps, weights read k-major from L2, the state in
// shared memory, the up stream in a scratch tensor, the ragged last tile
// masked. The GRU level and the down sweep with the heads are B1's
// (bigru_heads_cm.cuh), with the rounding of the projections a template
// flag.
//
// B4 in bf16 (the v5 arm's policy) runs on tensor cores instead: the
// kernel body of bigru_mma_fwd.cuh (B9's design, a cluster of 4 CTAs over
// 64 columns at H 192) in its channel-major instance with a loaded X tile:
// every CTA copies the level's x [CH, B] and mem_in [nm_in, B] rows with
// cp.async a level ahead into a transposed, XOR-swizzled [KX][BT] tile
// and reads its product's fragments with ldmatrix.trans; the projections
// are rounded to bf16 or kept f32 as hoist_proj says, and the heads are
// written channel-major into outmem as B1 writes them. Its entry point is
// bigru_heads_cm_mma at the end of this file; the CUDA-core design's bf16
// instances stay callable as bigru_heads_cm_cudacore, and no wrapper
// selects them.
#include "bigru_heads_cm.cuh"
#include "bigru_mma_fwd.cuh"

namespace {

using namespace bigru;

struct Params {
  const void *x, *mem_in, *h0u, *h0d;
  const void *win1h, *win1m, *bin1, *whh_up, *bhh_up;
  const void *win2, *bin2, *whh_dn, *bhh_dn, *wlat, *blat, *wout, *bout;
  void *outmem, *lasth, *up;
  float* tiles;     // device scratch for the tiles, or null: shared memory
  int L, CH, nm_in, H, nm, ny, B;
};

// the f32 rows of [BT] a block keeps in its tiles
__host__ __device__ inline size_t tile_rows(const Params& p) {
  const int xrows = p.CH + p.nm_in > p.H ? p.CH + p.nm_in : p.H;
  return 3 * static_cast<size_t>(p.H) + xrows + p.nm;
}

template <typename T, bool kHoist, bool kTiles, bool kG16>
__global__ void __launch_bounds__(NTH, 2) bigru_heads_cm_kernel(Params p) {
  const T* x = static_cast<const T*>(p.x);
  const T* mem_in = static_cast<const T*>(p.mem_in);
  T* up = static_cast<T*>(p.up);
  const int L = p.L, CH = p.CH, nmi = p.nm_in, H = p.H, B = p.B;
  const int col0 = blockIdx.x * BT;

  extern __shared__ float4 smem4[];
  float* s_hc = kTiles ? p.tiles + blockIdx.x * tile_rows(p) * BT
                       : reinterpret_cast<float*>(smem4);  // [H][BT] f32 state
  float* xh_cur = s_hc + H * BT;                    // [H][BT] dt(h)
  float* xh_nxt = xh_cur + H * BT;                  // [H][BT]
  float* s_x = xh_nxt + H * BT;                     // [x rows][BT]
  float* s_mem = s_x + max(CH + nmi, H) * BT;       // [nm][BT]

  // ---- up sweep, surface (l = L-1) to top
  load_tile(s_hc, static_cast<const T*>(p.h0u), H, B, col0);
  load_tile(xh_cur, static_cast<const T*>(p.h0u), H, B, col0);
  for (int l = L - 1; l >= 0; --l) {
    load_tile(s_x, x + static_cast<size_t>(l) * CH * B, CH, B, col0);
    load_tile(s_x + CH * BT, mem_in + static_cast<size_t>(l) * nmi * B, nmi,
              B, col0);
    __syncthreads();
    gru_level<T, kHoist, kG16>(static_cast<const T*>(p.win1h), s_x, CH,
                         static_cast<const T*>(p.win1m), s_x + CH * BT, nmi,
                         static_cast<const T*>(p.bin1),
                         static_cast<const T*>(p.whh_up),
                         static_cast<const T*>(p.bhh_up), xh_cur, s_hc,
                         xh_nxt, H);
    __syncthreads();
    float* t = xh_cur; xh_cur = xh_nxt; xh_nxt = t;
    store_up(up + static_cast<size_t>(l) * H * B, xh_cur, H, B, col0);
  }

  // ---- down sweep, top (l = 0) to surface, and the heads
  down_sweep_heads<T, kHoist, kG16>(
      up, static_cast<const T*>(p.h0d), static_cast<const T*>(p.win2),
      static_cast<const T*>(p.bin2), static_cast<const T*>(p.whh_dn),
      static_cast<const T*>(p.bhh_dn), static_cast<const T*>(p.wlat),
      static_cast<const T*>(p.blat), static_cast<const T*>(p.wout),
      static_cast<const T*>(p.bout), static_cast<T*>(p.outmem),
      static_cast<T*>(p.lasth), s_hc, xh_cur, xh_nxt, s_x, s_mem, L, H, p.nm,
      p.ny, B, col0);
}

template <typename T, bool kHoist, bool kG16 = false>
int launch(const Params& p, cudaStream_t stream) {
  const int blocks = (p.B + BT - 1) / BT;
  if (p.tiles != nullptr) {
    bigru_heads_cm_kernel<T, kHoist, true, kG16>
        <<<blocks, NTH, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * BT * tile_rows(p);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_heads_cm_kernel<T, kHoist, false, kG16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bigru_heads_cm_kernel<T, kHoist, false, kG16>
      <<<blocks, NTH, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; g16: 1 for the bf16 gates
// (acc32=False, bfloat16 only: both projections rounded whatever hoist
// says, gates16.cuh); hoist: 1 rounds the sweeps' input projections to
// dtype before the gates (the TPU's hoisted body), 0 keeps them f32.
// Weights are k-major ([in, out]), biases flat; activations
// channel-major [L, C, B] / [H, B], contiguous; nm_in may be 0. up is a
// [L, H, B] scratch of the input type. tiles: null to keep the block's
// tiles in shared memory ((3H + max(CH + nm_in, H) + nm) x 32 f32, up to
// H 440 at the flagship's other widths), or a device scratch of
// ceil(B / 32) times that that takes them at any H (no dynamic shared
// memory; __syncthreads orders a block's global accesses as its shared
// ones). Returns the cudaError_t of the launch (0 on success).
extern "C" int bigru_heads_cm(
    int dtype, int hoist, const void* x, const void* mem_in,
    const void* h0u, const void* h0d, const void* win1h, const void* win1m,
    const void* bin1, const void* whh_up, const void* bhh_up,
    const void* win2, const void* bin2, const void* whh_dn,
    const void* bhh_dn, const void* wlat, const void* blat,
    const void* wout, const void* bout, void* outmem, void* lasth, void* up,
    int L, int CH, int nm_in, int H, int nm, int ny, int B, int g16,
    void* tiles, void* stream) {
  Params p{x, mem_in, h0u, h0d, win1h, win1m, bin1, whh_up, bhh_up, win2,
           bin2, whh_dn, bhh_dn, wlat, blat, wout, bout, outmem, lasth, up,
           static_cast<float*>(tiles), L, CH, nm_in, H, nm, ny, B};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && !g16) return hoist ? launch<float, true>(p, s)
                                       : launch<float, false>(p, s);
  if (dtype == 1 && g16) return launch<bf16, true, true>(p, s);
  if (dtype == 1) return hoist ? launch<bf16, true>(p, s)
                               : launch<bf16, false>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same CUDA-core design in bf16 under a second name, kept to time it
// against the tensor-core design; no wrapper selects it.
extern "C" int bigru_heads_cm_cudacore(
    int hoist, const void* x, const void* mem_in, const void* h0u,
    const void* h0d, const void* win1h, const void* win1m, const void* bin1,
    const void* whh_up, const void* bhh_up, const void* win2,
    const void* bin2, const void* whh_dn, const void* bhh_dn,
    const void* wlat, const void* blat, const void* wout, const void* bout,
    void* outmem, void* lasth, void* up, int L, int CH, int nm_in, int H,
    int nm, int ny, int B, void* tiles, void* stream) {
  return bigru_heads_cm(1, hoist, x, mem_in, h0u, h0d, win1h, win1m, bin1,
                        whh_up, bhh_up, win2, bin2, whh_dn, bhh_dn, wlat,
                        blat, wout, bout, outmem, lasth, up, L, CH, nm_in, H,
                        nm, ny, B, 0, tiles, stream);
}

// bf16 tensor-core design. ptrs, in order: x [L, CH, B], mem_in [L, nmi,
// B], h0u, h0d [H, B], wx_up [C][3H/C][CH + nmi] (the gate slices of [W1h
// | W1m], [out, in]), b1 [3H], wh_up [C][3H/C][H], bh_up [3H], wx_dn (W2)
// and wh_dn like wh_up, b2, bh_dn [3H], wlat [nm8][H] (rows past nm zero),
// blat [nm], wout [ny, nm], bout [ny], outmem [L, nm + ny, B], lasth
// [H, B], up [L, H, B] scratch; H already padded to a multiple of 8 C,
// nmi so that CH + nmi is a multiple of 16. stream: 1 for the
// streamed-weights instantiation; hoist: 1 rounds both sweeps'
// projections to bf16; g16: 1 for the bf16 gates (acc32=False, which
// rounds both projections whatever hoist says). Returns the cudaError_t
// of the launch (cudaErrorInvalidValue for shapes outside the design).
extern "C" int bigru_heads_cm_mma(void* const* ptrs, int L, int CH, int nmi,
                                  int H, int nm, int ny, int B, int C,
                                  int BT, int stream, int hoist, int g16,
                                  void* st) {
  using bmma::bf16;
  const bf16* const* c = reinterpret_cast<const bf16* const*>(ptrs);
  bf16* outmem = static_cast<bf16*>(ptrs[16]);
  const size_t sB = B, nmo = static_cast<size_t>(nm + ny) * sB;
  bmma::FwdParams p{c[0], c[1], c[2], c[3], nullptr, nullptr, c[4], c[5],
                    c[6], c[7], c[8], c[9], c[10], c[11], c[12], c[13],
                    c[14], c[15], outmem, outmem + nm * sB,
                    static_cast<bf16*>(ptrs[17]), static_cast<bf16*>(ptrs[18]),
                    nmo, nmo, B, B,
                    L, 0, CH, nmi, H, nm, ny, B, C, BT};
  cudaStream_t s = static_cast<cudaStream_t>(st);
  return hoist || g16
             ? bmma::launch_fwd<false, true, true>(p, stream, g16, s)
             : bmma::launch_fwd<false, false, true>(p, stream, 0, s);
}
