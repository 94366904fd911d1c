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
#include "bigru_mma.cuh"

namespace {

using namespace bigru;

struct Params {
  const void *feat, *mem_in, *h0u, *h0d;
  const void *winit, *binit, *win1h, *win1m, *bin1, *whh_up, *bhh_up;
  const void *win2, *bin2, *whh_dn, *bhh_dn, *wlat, *blat, *wout, *bout;
  void *outmem, *lasth, *up;
  int L, nf, nm_in, H, nm, ny, B;
};

template <typename T>
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
  float* s_hc = reinterpret_cast<float*>(smem4);   // [H][BT] f32 state
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
    for (int e = tid; e < H * BT; e += NTH) {
      const int j = e / BT, c = e % BT;
      float a = 0.0f;
      for (int f = 0; f < nf; ++f)
        a = fmaf(ldw(winit + f * H + j), s_feat[f * BT + c], a);
      s_x[e] = rnd<T>(tanhf(rnd<T>(a + ldw(binit + j))));
    }
    __syncthreads();
    gru_level<T, true>(static_cast<const T*>(p.win1h), s_x, H,
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
  down_sweep_heads<T, true>(up, static_cast<const T*>(p.h0d),
                            static_cast<const T*>(p.win2),
                            static_cast<const T*>(p.bin2),
                            static_cast<const T*>(p.whh_dn),
                            static_cast<const T*>(p.bhh_dn), wlat, blat,
                            wout, bout, outmem, lasth, s_hc, xh_cur, xh_nxt,
                            s_x, s_mem, L, H, nm, ny, B, col0);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * BT *
      (4 * static_cast<size_t>(p.H) + p.nm_in + p.nf + p.nm);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_heads_init_cm_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (p.B + BT - 1) / BT;
  bigru_heads_init_cm_kernel<T><<<blocks, NTH, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ------------------------------------------------ bf16: tensor-core design
//
// The bf16 path (the flagship policy) runs on tensor cores with resident
// weights. A column tile of BT columns is owned by a cluster of C CTAs
// (BT 64, C 4 at H 192: 338 clusters at 21,600 columns, ~10 waves of 33
// on 132 SMs; the wrapper picks BT and C from the shapes, bmma notes);
// CTA r owns hidden units [r H/C, (r + 1) H/C) and keeps its gate slices
// of [W1h | W1m] and Whh_up (then W2, Whh_dn and Wlat) in shared memory
// for the whole sweep (one cp.async load per sweep; 229 KB a CTA with the
// buffers at H 192). Per level each CTA runs mma.sync for its
// [BT x 3H/C] gate block, the gate arithmetic in f32 with the TPU body's
// roundings (xp rounded to bf16 before the gates), keeps its f32 state
// slice in registers, and writes its dt(h) columns into every cluster
// CTA's next buffer through distributed shared memory; one cluster
// barrier per level. The initial MLP (6 inputs: CUDA cores) is split the
// same way: each CTA evaluates its H/C rows of xi for the next level and
// writes them to every CTA; every CTA keeps the level's memory rows
// itself. The level's raw inputs (feat, mem_in) and the down sweep's
// slice of the up stream are loaded into registers a level ahead. The
// latent head is an mma on the full dt(h2) of the previous level, one m16
// tile per CTA, the output head (nm inputs) on CUDA cores. The up stream
// stays a [L, H, B] bf16 device scratch: each CTA stores its rows,
// coalesced. The up sweep's input projection stays in the serial chain: a
// hoisted [L, 3H, B] projection would add ~3 GB of traffic a call while
// the chain is bound by latency, not by the projection's share of the
// products. What bounds a level is latency: with one CTA a SM, its 12
// warps run the products, the gates, xi and the barrier one after the
// other (PERF.md §6). Widths are padded by the wrapper (H to a
// multiple of 8 C, mem_in to 16) with zero weights, which leaves every
// real output unchanged.
namespace b1mma {

using namespace bmma;
// names the CUDA-core design's namespace (bigru) also declares
using bmma::NTH;
using bmma::rnd;
using bmma::gru_level;

struct MmaParams {
  const bf16 *feat, *mem_in, *h0u, *h0d, *winit, *binit;
  const bf16 *wx_up, *b1, *wh_up, *bh_up, *wx_dn, *b2, *wh_dn, *bh_dn;
  const bf16 *wlat, *blat, *wout, *bout;
  bf16 *outmem, *lasth, *up;
  int L, nf, nmi, H, nm, ny, B, C, BT;
};

// xi for the CTA's rows [k0, k0 + Hc) of the level whose raw features are
// raw [nf][BT] f32: dt(tanh(dt(Winit feat + binit))), into X[b][k0 + .]
// of every CTA of the cluster
__device__ __forceinline__ void xi_own(cg::cluster_group& cl, bf16* X,
                                       int ldx, const float* raw,
                                       const float* wi, const float* bi,
                                       int nf, int Hc, int k0, int BT) {
  for (int e = threadIdx.x; e < Hc / 8 * BT; e += NTH) {
    const int c = e / BT, b = e % BT;
    float v[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int jj = c * 8 + kk;
      float a = 0.0f;
      for (int f = 0; f < nf; ++f) a = fmaf(wi[jj * nf + f], raw[f * BT + b], a);
      v[kk] = rnd(tanh_(rnd(a + bi[jj])));
    }
    const uint4 v4 = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                pack2(v[4], v[5]), pack2(v[6], v[7]));
    for (int q = 0; q < static_cast<int>(cl.num_blocks()); ++q)
      *reinterpret_cast<uint4*>(
          cl.map_shared_rank(X + b * ldx + k0 + c * 8, q)) = v4;
  }
}

__host__ __device__ inline size_t b1_smem(int H, int C, int nmi, int nf,
                                          int nm, int ny, int BT) {
  const int Hc = H / C, nm8 = (nm + 7) / 8 * 8;
  Smem su(nullptr), sd(nullptr);
  up_bufs(su, Hc, H + nmi, H, BT, nf, nf);
  dn_bufs(sd, Hc, H, BT, nm8, nm + ny * nm + ny);
  return su.off > sd.off ? su.off : sd.off;
}

__global__ void __launch_bounds__(NTH, 1) b1_mma_kernel(MmaParams p) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = p.C, BT = p.BT, r = static_cast<int>(cl.block_rank());
  const int H = p.H, Hc = H / C, L = p.L, B = p.B, nf = p.nf, nmi = p.nmi;
  const int nm = p.nm, ny = p.ny, nm8 = (nm + 7) / 8 * 8;
  const int KX = H + nmi, LDX = KX + PAD, LDH = H + PAD;
  const int col0 = (blockIdx.x / C) * BT, tid = threadIdx.x;
  const size_t sB = B;
  const Warp w(BT);
  const Tiles tl(w, Hc / 8);
  extern __shared__ __align__(16) char smem_raw[];
  GruRegs R;

  // ---- up sweep, surface (l = L-1) to top
  {
    Smem s(smem_raw);
    const UpBufs u = up_bufs(s, Hc, KX, H, BT, nf, nf);
    load_rows(u.wx, LDX, p.wx_up + static_cast<size_t>(r) * 3 * Hc * KX,
              3 * Hc, KX);
    load_rows(u.wh, LDH, p.wh_up + static_cast<size_t>(r) * 3 * Hc * H,
              3 * Hc, H);
    for (int e = tid; e < Hc * nf; e += NTH)
      u.wi[e] = b2f(p.winit[static_cast<size_t>(r) * Hc * nf + e]);
    for (int e = tid; e < Hc; e += NTH) u.bi[e] = b2f(p.binit[r * Hc + e]);
    load_tile_t(u.h, LDH, p.h0u, H, B, col0, BT);
    gru_regs_init(R, w, tl, r, Hc, H, p.b1, p.bh_up, p.h0u, B, col0);
    const auto feat_l = [&](int l) { return p.feat + l * nf * sB; };
    const auto mem_l = [&](int l) { return p.mem_in + l * nmi * sB; };
    RawPF pf;
    pf.fetch(feat_l(L - 1), nf, mem_l(L - 1), nf + nmi, B, col0, BT);
    pf.commit_split(u.raw, nf, u.x, LDX, H, nf + nmi, BT);
    cp_async_wait_all();
    __syncthreads();
    xi_own(cl, u.x, LDX, u.raw, u.wi, u.bi, nf, Hc, r * Hc, BT);
    cl.sync();
    int cur = 0;
    for (int s_ = 0; s_ < L; ++s_) {
      const int l = L - 1 - s_;
      const bool more = l > 0;
      bf16* hc = u.h + cur * BT * LDH;
      bf16* hn = u.h + (cur ^ 1) * BT * LDH;
      bf16* xc = u.x + cur * BT * LDX;
      bf16* xn = u.x + (cur ^ 1) * BT * LDX;
      if (more) pf.fetch(feat_l(l - 1), nf, mem_l(l - 1), nf + nmi, B, col0, BT);
      if (s_ > 0)
        store_tile_t(p.up + (static_cast<size_t>(l + 1) * H + r * Hc) * sB,
                     hc, LDH, r * Hc, Hc, B, col0, BT);
      gru_level<true>(cl, R, xc, LDX, KX, u.wx, hc, u.wh, LDH, H, Hc, hn, w,
                      tl, r, nullptr, B, col0);
      if (more) {
        pf.commit_split(u.raw, nf, xn, LDX, H, nf + nmi, BT);
        __syncthreads();
        xi_own(cl, xn, LDX, u.raw, u.wi, u.bi, nf, Hc, r * Hc, BT);
      }
      cl.sync();
      cur ^= 1;
    }
    store_tile_t(p.up + static_cast<size_t>(r) * Hc * sB, u.h + cur * BT * LDH,
                 LDH, r * Hc, Hc, B, col0, BT);
  }
  cl.sync();

  // ---- down sweep, top (l = 0) to surface, and the heads
  {
    Smem s(smem_raw);
    const DnBufs d = dn_bufs(s, Hc, H, BT, nm8, nm + ny * nm + ny);
    load_rows(d.wx, LDH, p.wx_dn + static_cast<size_t>(r) * 3 * Hc * H,
              3 * Hc, H);
    load_rows(d.wh, LDH, p.wh_dn + static_cast<size_t>(r) * 3 * Hc * H,
              3 * Hc, H);
    load_rows(d.wl, LDH, p.wlat, nm8, H);
    load_heads(d.hw, p.blat, p.wout, p.bout, nm, ny);
    load_tile_t(d.h, LDH, p.h0d, H, B, col0, BT);
    gru_regs_init(R, w, tl, r, Hc, H, p.b2, p.bh_dn, p.h0d, B, col0);
    const auto up_l = [&](int l) { return p.up + static_cast<size_t>(l) * H * sB; };
    ChunkPF cp;
    cp.fetch(up_l(0), H, nullptr, r * Hc, (r + 1) * Hc, B, col0, BT);
    cp.commit(d.x, LDH, r * Hc, (r + 1) * Hc, BT);
    cp_async_wait_all();
    __syncthreads();
    bcast_cols(cl, d.x, LDH, r * Hc, Hc, BT);
    cl.sync();
    const int nmo = nm + ny;
    int cur = 0;
    for (int l = 0; l < L; ++l) {
      const bool more = l + 1 < L;
      bf16* hc = d.h + cur * BT * LDH;
      bf16* hn = d.h + (cur ^ 1) * BT * LDH;
      bf16* xc = d.x + cur * BT * LDH;
      bf16* xn = d.x + (cur ^ 1) * BT * LDH;
      if (more) cp.fetch(up_l(l + 1), H, nullptr, r * Hc, (r + 1) * Hc, B, col0, BT);
      if (l > 0) {
        bf16* om = p.outmem + static_cast<size_t>(l - 1) * nmo * sB;
        heads(hc, LDH, d.wl, H, nm, nm8, d.hw, ny, d.mem,
              om, om + nm * sB, B, col0, BT, r, C);
      }
      gru_level<true>(cl, R, xc, LDH, H, d.wx, hc, d.wh, LDH, H, Hc, hn, w,
                      tl, r, nullptr, B, col0);
      if (more) {
        cp.commit(xn, LDH, r * Hc, (r + 1) * Hc, BT);
        __syncthreads();
        bcast_cols(cl, xn, LDH, r * Hc, Hc, BT);
      }
      cl.sync();
      cur ^= 1;
    }
    bf16* hl = d.h + cur * BT * LDH;
    bf16* om = p.outmem + static_cast<size_t>(L - 1) * nmo * sB;
    heads(hl, LDH, d.wl, H, nm, nm8, d.hw, ny, d.mem, om,
          om + nm * sB, B, col0, BT, r, C);
    store_tile_t(p.lasth + static_cast<size_t>(r) * Hc * sB, hl, LDH,
                 r * Hc, Hc, B, col0, BT);
  }
  cl.sync();   // no CTA leaves while another may still address its smem
}

int launch_mma(const MmaParams& p, cudaStream_t st) {
  const int C = p.C, BT = p.BT;
  if (C < 1 || C > 8 || BT % 16 != 0 || BT < 16 || NW % (BT / 16) != 0 ||
      p.H % (8 * C) != 0 || p.nmi % 16 != 0 ||
      p.H / C / 8 > NW / (BT / 16) * MAXP ||
      (p.nf + p.nmi) * BT > PF * NTH || p.H / C / 8 * BT > MAXI * NTH)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = b1_smem(p.H, C, p.nmi, p.nf, p.nm, p.ny, BT);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      b1_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((p.B + BT - 1) / BT) * C);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, b1_mma_kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace b1mma

// dtype: 0 = float32, 1 = bfloat16. Weights are k-major ([in, out]),
// biases flat; activations channel-major [L, C, B] / [H, B], contiguous.
// up is a [L, H, B] scratch of the input type. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int bigru_heads_init_cm(
    int dtype, const void* feat, const void* mem_in, const void* h0u,
    const void* h0d, const void* winit, const void* binit,
    const void* win1h, const void* win1m, const void* bin1,
    const void* whh_up, const void* bhh_up, const void* win2,
    const void* bin2, const void* whh_dn, const void* bhh_dn,
    const void* wlat, const void* blat, const void* wout, const void* bout,
    void* outmem, void* lasth, void* up, int L, int nf, int nm_in, int H,
    int nm, int ny, int B, void* stream) {
  Params p{feat, mem_in, h0u, h0d, winit, binit, win1h, win1m, bin1,
           whh_up, bhh_up, win2, bin2, whh_dn, bhh_dn, wlat, blat, wout,
           bout, outmem, lasth, up, L, nf, nm_in, H, nm, ny, B};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
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
    int B, void* stream) {
  return bigru_heads_init_cm(1, feat, mem_in, h0u, h0d, winit, binit, win1h,
                             win1m, bin1, whh_up, bhh_up, win2, bin2, whh_dn,
                             bhh_dn, wlat, blat, wout, bout, outmem, lasth,
                             up, L, nf, nm_in, H, nm, ny, B, stream);
}

// bf16 tensor-core design. ptrs, in order: feat [L, nf, B], mem_in
// [L, nmi, B], h0u, h0d [H, B], winit [H, nf], binit [H], wx_up
// [C][3H/C][H + nmi] (the gate slices of [W1h | W1m], [out, in]), b1
// [3H], wh_up [C][3H/C][H], bh_up [3H], wx_dn (W2) and wh_dn like wh_up,
// b2, bh_dn [3H], wlat [nm8][H] (rows past nm zero), blat [nm], wout
// [ny, nm], bout [ny], outmem [L, nm + ny, B], lasth [H, B], up [L, H, B]
// scratch; H and nmi already padded. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for shapes outside the design).
extern "C" int bigru_heads_init_cm_mma(void* const* ptrs, int L, int nf,
                                       int nmi, int H, int nm, int ny,
                                       int B, int C, int BT, void* stream) {
  using bmma::bf16;
  const bf16* const* c = reinterpret_cast<const bf16* const*>(ptrs);
  b1mma::MmaParams p{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8],
              c[9], c[10], c[11], c[12], c[13], c[14], c[15], c[16], c[17],
              static_cast<bf16*>(ptrs[18]), static_cast<bf16*>(ptrs[19]),
              static_cast<bf16*>(ptrs[20]), L, nf, nmi, H, nm, ny, B, C, BT};
  return b1mma::launch_mma(p, static_cast<cudaStream_t>(stream));
}
