// v3 and v4 fused emulator forward, batch-major [L, B, C]: the up-sweep
// input projection (v4: after the initial MLP, on [xi ; mem_in] with no
// concatenation materialized), the up GRU sweep, the down GRU sweep with
// its input projection, and the latent-memory and output heads, one
// kernel. Two C entry points: bigru_heads_lbh (v3, B9) and
// bigru_heads_init_lbh (v4, B10).
//
// Replaces the TPU kernels climsim_tpu/ops/pallas_rnn.py::
// _bigru_heads_kernel (wrapper _bigru_heads_pallas_lbh, v3) and
// _bigru_heads_init_kernel_merged (wrapper _bigru_heads_init_pallas_lbh,
// v4; its unmerged twin _bigru_heads_init_kernel has no caller).
//
// What it computes, per column (dt = the input type, f32 or bf16; every
// sum is accumulated in f32; the projections stay f32, unrounded, as the
// TPU bodies keep them under acc32):
//   v4 only: xi_l = dt(tanh(dt(feat_l Winit + binit)))
//   up sweep l = L-1 .. 0:
//     xp  = x_l W1 + b1              (v4: xi_l W1[:CH] + mem_l W1[CH:] + b1)
//     hh  = dt(h) Whh_up + bhh_up;  r = s(xp_r + hh_r), z = s(xp_z + hh_z)
//     n   = tanh(xp_n + r hh_n);    h = (1 - z) n + z h;   up_l = dt(h)
//   down sweep l = 0 .. L-1:
//     xp2 = up_l W2 + b2; the same GRU step with Whh_dn on h2
//     mem_l = dt(dt(h2) Wlat + blat);  out_l = dt(mem_l Wout + bout)
//   last_h = dt(h2)
//
// What bounds it on an H100 at the v3/v4 arms' shapes (L 60, H 192,
// B 21,600; v3 nx 208, v4 nf 6 + nm_in 16, nm 16, ny 6): 454,752 (v3) and
// 455,904 (v4) multiply-adds per column and level (the up projection
// 119,808, three 110,592 recurrence/projection products, the heads 3,168,
// and for v4 the initial MLP 1,152) = 1.18 TFLOP per call, 1.19 ms at the
// 989 TFLOP/s dense bf16 tensor-core peak; the bytes it must move (x in;
// out, mem, last_h out; weights) are 0.2-0.6 GB, 0.06-0.18 ms at 3.35 TB/s.
// So it is bound by operations.
//
// What the CUDA-core design does about it (f32; in bf16 kept only to be
// timed against the tensor-core designs below):
// it is B1's CUDA-core design (bigru_heads_init_cm.cu), re-indexed
// batch-major: a CUDA-core FMA kernel (f32
// accumulation of dt products; floor ~18 ms at the card's 67 TFLOP/s f32
// FMA rate), one block per tile of BT columns walking all L levels of both
// sweeps in an in-kernel loop (the TPU's sequential grid), 675 tiles at
// B 21,600 with two blocks on each SM (~101 KB of shared memory each).
// Weights are read k-major ([in, out], flax's layout) from global memory,
// where they stay resident in L2. The GRU level is bigru_heads_cm.cuh's,
// with the projections left unrounded. A level's batch-major input
// [B][C] is moved into the [C][BT] f32 tile the products read, and the
// heads are written back batch-major. The TPU kept the tile's up states in
// a VMEM scratch; they are 23 KB per column in bf16, so here they go to a
// [L, H, B] device scratch of the input type that the wrapper allocates,
// stored and read coalesced along the columns. The ragged last tile masks
// its columns (zero inputs, nothing stored) instead of padding.
// Built without --use_fast_math: expf/tanhf keep the 60-level recurrence
// within tolerance of the plain version.
//
// B9 and B10 in bf16 (the v3 and v4 arms' policy) run on tensor cores
// instead: the kernel body of bigru_mma_fwd.cuh (B1's design) in its
// batch-major instances, the raw inputs read and the heads written
// [L, B, C], both sweeps' projections kept in f32 as the v3 and v4 TPU
// bodies keep them; B9's up sweep takes its level's x [B, 208] as the X
// tile itself (copied with cp.async a level ahead) where B10 computes the
// initial MLP. A CTA's weight slices are resident up to H ~ 320 and
// streamed beyond (bigru_mma.cuh). Their entry points are
// bigru_heads_lbh_mma and bigru_heads_init_lbh_mma at the end of this
// file; the CUDA-core design's bf16 instances stay callable for timing
// them against the tensor-core ones, and no wrapper selects them.
#include "bigru_heads_cm.cuh"
#include "bigru_mma_fwd.cuh"

namespace {

using namespace bigru;

struct Params {
  const void *x, *mem_in, *h0u, *h0d;
  const void *winit, *binit, *win1, *bin1, *whh_up, *bhh_up;
  const void *win2, *bin2, *whh_dn, *bhh_dn, *wlat, *blat, *wout, *bout;
  void *out, *mem, *lasth, *up;
  // nx: x's channels (v4: the raw features nf); ch: the width of the up
  // projection's first part (v3: nx; v4: the initial MLP's); nm_in: its
  // second part (v3: 0)
  int L, nx, ch, nm_in, H, nm, ny, B;
  float* tiles;     // device scratch for the tiles, or null: shared memory
};

// the f32 rows of [BT] a block of kernel <., kInit> keeps in its tiles
__host__ __device__ inline size_t tile_rows(const Params& p, bool init) {
  const int kx = p.H > p.ch + p.nm_in ? p.H : p.ch + p.nm_in;
  return 3 * static_cast<size_t>(p.H) + kx + (init ? p.nx : 0) + p.nm;
}

// dst[k][c] = src[col0 + c][k] (a [B][K] level) for k < K, zero past the
// ragged edge
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int K,
                                          int B, int col0) {
  for (int e = threadIdx.x; e < K * BT; e += NTH) {
    const int k = e / BT, c = e % BT, col = col0 + c;
    dst[e] = col < B ? ldp(src + static_cast<size_t>(col) * K + k) : 0.0f;
  }
}

// dst[col0 + c][j] = dt(src[j][c]) inside the batch (a [B][H] array)
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float* src, int H,
                                           int B, int col0) {
  for (int e = threadIdx.x; e < H * BT; e += NTH) {
    const int c = e / H, j = e % H, col = col0 + c;
    if (col < B)
      dst[static_cast<size_t>(col) * H + j] = from_f<T>(src[j * BT + c]);
  }
}

template <typename T, bool kInit, bool kTiles, bool kG16>
__global__ void __launch_bounds__(NTH, 2) bigru_heads_lbh_kernel(Params p) {
  const T* x = static_cast<const T*>(p.x);
  const T* mem_in = static_cast<const T*>(p.mem_in);
  const T* winit = static_cast<const T*>(p.winit);
  const T* binit = static_cast<const T*>(p.binit);
  const T* win1 = static_cast<const T*>(p.win1);
  const T* wlat = static_cast<const T*>(p.wlat);
  const T* blat = static_cast<const T*>(p.blat);
  const T* wout = static_cast<const T*>(p.wout);
  const T* bout = static_cast<const T*>(p.bout);
  T* out = static_cast<T*>(p.out);
  T* mem = static_cast<T*>(p.mem);
  T* up = static_cast<T*>(p.up);
  const int L = p.L, nx = p.nx, ch = p.ch, nmi = p.nm_in, H = p.H,
            nm = p.nm, ny = p.ny, B = p.B;
  const int col0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int kx = max(H, ch + nmi);

  extern __shared__ float4 smem4[];
  float* s_hc = kTiles ? p.tiles + blockIdx.x * tile_rows(p, kInit) * BT
                       : reinterpret_cast<float*>(smem4);  // [H][BT] f32 state
  float* xh_cur = s_hc + H * BT;                    // [H][BT] dt(h)
  float* xh_nxt = xh_cur + H * BT;                  // [H][BT]
  float* s_x = xh_nxt + H * BT;                     // [kx][BT]
  float* s_feat = s_x + kx * BT;                    // [nx][BT] (v4)
  float* s_mem = s_feat + (kInit ? nx : 0) * BT;    // [nm][BT]

  // ---- up sweep, surface (l = L-1) to top
  load_rows(s_hc, static_cast<const T*>(p.h0u), H, B, col0);
  load_rows(xh_cur, static_cast<const T*>(p.h0u), H, B, col0);
  for (int l = L - 1; l >= 0; --l) {
    const size_t lev = static_cast<size_t>(l) * B;
    if constexpr (kInit) {
      load_rows(s_feat, x + lev * nx, nx, B, col0);
      load_rows(s_x + ch * BT, mem_in + lev * nmi, nmi, B, col0);
      __syncthreads();
      // initial MLP: the pre-activation is rounded to dt before the tanh
      // (with kG16 the TPU body's typed bf16 tanh, 2 sigmoid(2x) - 1)
      for (int e = tid; e < ch * BT; e += NTH) {
        const int j = e / BT, c = e % BT;
        float a = 0.0f;
        for (int f = 0; f < nx; ++f)
          a = fmaf(ldw(winit + f * ch + j), s_feat[f * BT + c], a);
        const float pre = rnd<T>(a + ldw(binit + j));
        s_x[e] = kG16 ? gates16::tanh1(pre) : rnd<T>(tanhf(pre));
      }
    } else {
      load_rows(s_x, x + lev * nx, nx, B, col0);
    }
    __syncthreads();
    gru_level<T, false, kG16>(win1, s_x, ch,
                              win1 + static_cast<size_t>(ch) * 3 * H,
                        s_x + ch * BT, nmi, static_cast<const T*>(p.bin1),
                        static_cast<const T*>(p.whh_up),
                        static_cast<const T*>(p.bhh_up), xh_cur, s_hc, xh_nxt,
                        H);
    __syncthreads();
    float* t = xh_cur; xh_cur = xh_nxt; xh_nxt = t;
    store_up(up + static_cast<size_t>(l) * H * B, xh_cur, H, B, col0);
  }

  // ---- down sweep, top (l = 0) to surface, and the heads
  __syncthreads();
  load_rows(s_hc, static_cast<const T*>(p.h0d), H, B, col0);
  load_rows(xh_cur, static_cast<const T*>(p.h0d), H, B, col0);
  for (int l = 0; l < L; ++l) {
    load_tile(s_x, up + static_cast<size_t>(l) * H * B, H, B, col0);
    __syncthreads();
    gru_level<T, false, kG16>(static_cast<const T*>(p.win2), s_x, H,
                              static_cast<const T*>(p.win2), s_x, 0,
                        static_cast<const T*>(p.bin2),
                        static_cast<const T*>(p.whh_dn),
                        static_cast<const T*>(p.bhh_dn), xh_cur, s_hc, xh_nxt,
                        H);
    __syncthreads();
    float* t = xh_cur; xh_cur = xh_nxt; xh_nxt = t;
    const size_t lev = static_cast<size_t>(l) * B;
    // latent memory head on dt(h2), written [B][nm]
    for (int e = tid; e < nm * BT; e += NTH) {
      const int c = e / nm, m = e % nm, col = col0 + c;
      float a = 0.0f;
      for (int k = 0; k < H; ++k)
        a = fmaf(ldw(wlat + k * nm + m), xh_cur[k * BT + c], a);
      const float v = rnd<T>(a + ldw(blat + m));
      s_mem[m * BT + c] = v;
      if (col < B) mem[(lev + col) * nm + m] = from_f<T>(v);
    }
    __syncthreads();
    // output head on the (dt-rounded) memory, written [B][ny]
    for (int e = tid; e < ny * BT; e += NTH) {
      const int c = e / ny, o = e % ny, col = col0 + c;
      float a = 0.0f;
      for (int m = 0; m < nm; ++m)
        a = fmaf(ldw(wout + m * ny + o), s_mem[m * BT + c], a);
      if (col < B) out[(lev + col) * ny + o] = from_f<T>(a + ldw(bout + o));
    }
  }
  store_rows(static_cast<T*>(p.lasth), xh_cur, H, B, col0);
}

template <typename T, bool kInit, bool kG16 = false>
int launch(const Params& p, cudaStream_t stream) {
  const int blocks = (p.B + BT - 1) / BT;
  if (p.tiles != nullptr) {
    bigru_heads_lbh_kernel<T, kInit, true, kG16>
        <<<blocks, NTH, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * BT * tile_rows(p, kInit);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_heads_lbh_kernel<T, kInit, false, kG16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bigru_heads_lbh_kernel<T, kInit, false, kG16>
      <<<blocks, NTH, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInit>
int dispatch(int dtype, int g16, const Params& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !g16) return launch<float, kInit>(p, s);
  if (dtype == 1) return g16 ? launch<__nv_bfloat16, kInit, true>(p, s)
                             : launch<__nv_bfloat16, kInit>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor); g16: 1 for the bf16
// gates (acc32=False, bfloat16 only: both projections rounded,
// gates16.cuh). Activations batch-major
// and contiguous: x [L, B, nx], h0u/h0d [B, H]; weights k-major ([in,
// out]), biases flat; out [L, B, ny], mem [L, B, nm], lasth [B, H]; up is
// a [L, H, B] scratch of the input type. tiles: null to keep the block's
// tiles in shared memory ((3H + max(H, ch + nm_in) + nm, v4 + nf) x 32
// f32, up to H 448 (v3) and 440 (v4) at the flagship's other widths), or
// a device scratch of ceil(B / 32) times that that takes them at any H
// (no dynamic shared memory; __syncthreads orders a block's global
// accesses as its shared ones). Returns the cudaError_t of the launch (0
// on success).
extern "C" int bigru_heads_lbh(
    int dtype, const void* x, const void* h0u, const void* h0d,
    const void* win1, const void* bin1, const void* whh_up,
    const void* bhh_up, const void* win2, const void* bin2,
    const void* whh_dn, const void* bhh_dn, const void* wlat,
    const void* blat, const void* wout, const void* bout, void* out,
    void* mem, void* lasth, void* up, int L, int nx, int H, int nm, int ny,
    int B, int g16, void* tiles, void* stream) {
  Params p{x, nullptr, h0u, h0d, nullptr, nullptr, win1, bin1, whh_up,
           bhh_up, win2, bin2, whh_dn, bhh_dn, wlat, blat, wout, bout,
           out, mem, lasth, up, L, nx, nx, 0, H, nm, ny, B,
           static_cast<float*>(tiles)};
  return dispatch<false>(dtype, g16, p, stream);
}

// The v4 entry: feat [L, B, nf] and mem_in [L, B, nm_in] in, the initial
// MLP winit [nf, ch], binit [ch], win1 [ch + nm_in, 3H]; the rest as
// bigru_heads_lbh.
extern "C" int bigru_heads_init_lbh(
    int dtype, const void* feat, const void* mem_in, const void* h0u,
    const void* h0d, const void* winit, const void* binit, const void* win1,
    const void* bin1, const void* whh_up, const void* bhh_up,
    const void* win2, const void* bin2, const void* whh_dn,
    const void* bhh_dn, const void* wlat, const void* blat, const void* wout,
    const void* bout, void* out, void* mem, void* lasth, void* up, int L,
    int nf, int ch, int nm_in, int H, int nm, int ny, int B, int g16,
    void* tiles, void* stream) {
  Params p{feat, mem_in, h0u, h0d, winit, binit, win1, bin1, whh_up,
           bhh_up, win2, bin2, whh_dn, bhh_dn, wlat, blat, wout, bout,
           out, mem, lasth, up, L, nf, ch, nm_in, H, nm, ny, B,
           static_cast<float*>(tiles)};
  return dispatch<true>(dtype, g16, p, stream);
}

// B10 in bf16 on the tensor-core design. ptrs, in order: feat [L, B, nf],
// mem_in [L, B, nmi], h0u, h0d [H, B] (channel-major), winit [CH][nf],
// binit [CH], wx_up [C][3H/C][CH + nmi] (the gate slices of W1^T, [out,
// in]), b1 [3H], wh_up [C][3H/C][H], bh_up [3H], wx_dn (W2^T) and wh_dn
// like wh_up, b2, bh_dn [3H], wlat [nm8][H] (Wlat^T, rows past nm zero),
// blat [nm], wout [ny, nm] (Wout^T), bout [ny], out [L, B, ny], mem [L,
// B, nm], lasth [H, B], up [L, H, B] scratch; H, CH and nmi already padded
// (H and CH to a multiple of 8 C, nmi to 16). stream: 1 for the
// streamed-weights instantiation; g16: 1 for the bf16 gates (acc32=False:
// both projections rounded, gates16.cuh). Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for shapes outside the design).
extern "C" int bigru_heads_init_lbh_mma(void* const* ptrs, int L, int nf,
                                        int CH, int nmi, int H, int nm,
                                        int ny, int B, int C, int BT,
                                        int stream, int g16, void* st) {
  using bmma::bf16;
  const bf16* const* c = reinterpret_cast<const bf16* const*>(ptrs);
  const size_t sB = B;
  bmma::FwdParams p{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8],
                    c[9], c[10], c[11], c[12], c[13], c[14], c[15], c[16],
                    c[17], static_cast<bf16*>(ptrs[19]),
                    static_cast<bf16*>(ptrs[18]), static_cast<bf16*>(ptrs[20]),
                    static_cast<bf16*>(ptrs[21]),
                    static_cast<size_t>(nm) * sB, static_cast<size_t>(ny) * sB,
                    nm, ny,
                    L, nf, CH, nmi, H, nm, ny, B, C, BT};
  return bmma::launch_fwd<true, false>(p, stream, g16,
                                       static_cast<cudaStream_t>(st));
}

// B9 in bf16 on the tensor-core design. ptrs, in order: x [L, B, KX], h0u,
// h0d [H, B] (channel-major), wx_up [C][3H/C][KX] (the gate slices of
// W1^T, [out, in]), b1 [3H], wh_up [C][3H/C][H], bh_up [3H], wx_dn (W2^T)
// and wh_dn like wh_up, b2, bh_dn [3H], wlat [nm8][H] (Wlat^T, rows past
// nm zero), blat [nm], wout [ny, nm] (Wout^T), bout [ny], out [L, B, ny],
// mem [L, B, nm], lasth [H, B], up [L, H, B] scratch; H already padded to
// a multiple of 8 C, KX (x's width) to 16. stream: 1 for the
// streamed-weights instantiation; g16 as bigru_heads_init_lbh_mma's.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for shapes
// outside the design).
extern "C" int bigru_heads_lbh_mma(void* const* ptrs, int L, int KX, int H,
                                   int nm, int ny, int B, int C, int BT,
                                   int stream, int g16, void* st) {
  using bmma::bf16;
  const bf16* const* c = reinterpret_cast<const bf16* const*>(ptrs);
  const size_t sB = B;
  bmma::FwdParams p{c[0], nullptr, c[1], c[2], nullptr, nullptr, c[3], c[4],
                    c[5], c[6], c[7], c[8], c[9], c[10], c[11], c[12], c[13],
                    c[14], static_cast<bf16*>(ptrs[16]),
                    static_cast<bf16*>(ptrs[15]), static_cast<bf16*>(ptrs[17]),
                    static_cast<bf16*>(ptrs[18]),
                    static_cast<size_t>(nm) * sB, static_cast<size_t>(ny) * sB,
                    nm, ny,
                    L, 0, KX, 0, H, nm, ny, B, C, BT};
  return bmma::launch_fwd<true, false, true>(p, stream, g16,
                                             static_cast<cudaStream_t>(st));
}
