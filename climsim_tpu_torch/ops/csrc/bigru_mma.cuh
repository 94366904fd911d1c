// Tensor-core building blocks of the bf16 BiGRU kernels: the fused
// forward of bigru_mma_fwd.cuh (v6, B1 in bigru_heads_init_cm.cu; v4 and
// v3, B10 and B9 in bigru_heads_lbh.cu), the v2 forward (B7 in
// bigru_lbh.cu) and the backward of bigru_mma_bwd.cuh (v6/v5, B3 in
// bigru_heads_cm_bwd.cu; v2, B8 in bigru_lbh_bwd.cu).
//
// A column tile of BT columns is owned by a thread-block cluster of C
// CTAs; CTA r owns hidden units [r Hc, (r + 1) Hc), Hc = H / C. Products
// run as warp-level mma.sync.m16n8k16 (bf16 operands, f32 accumulation)
// with ldmatrix from shared memory, M = the tile's columns, N = outputs,
// K = inputs: the activation tile is the row-major A operand [BT][K] and
// a weight slice in the [out, in] layout is the "col" B operand [N][K].
// Every row of both carries PAD elements of padding, so the 8 rows an
// ldmatrix reads fall in distinct banks for every K that is a multiple of
// 16. Operands are exact in bf16 (the TPU bodies round them to the
// storage type before each product), so only the summation order differs
// from the CUDA-core design.
//
// Warp layout: NW warps form NWM = BT / 16 rows of m16 tiles by NWN =
// NW / NWM columns; warp (wm, wn) owns m16 tile wm and the n8 tiles wn,
// wn + NWN, ... of a product. State that a CTA carries across levels
// (f32 h, or dh in the backward) sits in the fragments of those tiles,
// so each thread keeps it in registers; the wrappers choose (C, BT) so
// that one pass of MAXP tiles per warp covers a CTA's Hc / 8 tiles.
//
// Weights: a CTA's slices of a sweep's weights stay resident in shared
// memory where they fit (kStream false; H 192: 3 x 48 x 200 bf16 each).
// From H ~ 320 on they do not, next to the state and input tiles, so the
// streamed mode (kStream true, chosen by the wrappers' plan from the
// widths alone) keeps them in global memory, where every cluster reads
// the same few MB out of L2, and each product stages its weight slice
// through a double-buffered ring of [rows][KC] k-chunks in shared memory:
// cp.async fills chunk c + 1 while the warps run chunk c. The state stays
// in the fragments either way; the products, and so the results, are the
// same sums in the same order (a streamed chunk is consumed by the same
// k-steps as the resident slice).
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gates16.cuh"

namespace bmma {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// One CTA a SM: 12 warps hide more of the latency of a level's serial
// gate arithmetic than 8 do, and 2 n8 tiles a warp leave the backward's
// state in registers (PERF.md §6).
constexpr int NTH = 384;        // threads per CTA
constexpr int NW = NTH / 32;    // warps per CTA
constexpr int MAXP = 2;         // n8 tiles of carried state per warp
constexpr int PAD = 8;          // bf16 elements of padding per smem row
constexpr int PF = 8;           // prefetched tile elements per thread
constexpr int MAXI = 2;         // prefetched 8-row chunks per thread
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory per CTA
constexpr int KC = 64;          // k-chunk of a streamed weight slice

__device__ __forceinline__ float b2f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// sigmoid and tanh from the SFU's exp2 and reciprocal: within a few 1e-7
// of the libm functions on the gates' range (an infinite exp gives the
// limits 0, 1 and -1), far inside the bf16 storage these kernels round
// to, at a fraction of their cost
__device__ __forceinline__ float sigm(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float tanh_(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}
// the same, each 8 x 8 block transposed: the A fragments of a tile
// stored [K][M] (B4's channel-major X tile, xt_chunk)
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}
__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(saddr(p)));
}
// d += a b: one m16n8k16 tile, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   saddr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the two halves of a cluster barrier, for a barrier whose wait can be
// deferred past independent work
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A warp's place in the tile: its m16 tile, its n8 tiles, its lane's
// fragment coordinates (rows g and g + 8, columns 2t and 2t + 1).
struct Warp {
  int m0, wn, nwn, lane, g, t;
  __device__ Warp(int BT) {
    const int warp = threadIdx.x >> 5, nwm = BT / 16;
    lane = threadIdx.x & 31;
    m0 = (warp % nwm) * 16;
    wn = warp / nwm;
    nwn = NW / nwm;
    g = lane >> 2;
    t = lane & 3;
  }
  // tile column of fragment element q of n8 tile n0, and its row
  __device__ int col(int n0, int q) const { return n0 + 2 * t + (q & 1); }
  __device__ int row(int q) const { return m0 + g + 8 * (q >> 1); }
};

// The warp's n8 tiles nt[i] = base + wn + nwn i of ntl, with on[i] set
// for those that exist (carried state takes one pass, base 0: ntl <= nwn
// MAXP, checked by the host).
struct Tiles {
  int nt[MAXP];
  bool on[MAXP];
  __device__ Tiles(const Warp& w, int ntl, int base = 0) {
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      nt[i] = base + w.wn + w.nwn * i;
      on[i] = nt[i] < ntl;
    }
  }
};

// A tile stored transposed, [K][M] (M = the tile's BT columns, a multiple
// of 8), as 16-byte chunks of 8 columns with the chunk index q = k (M / 8)
// + m / 8 swizzled to q ^ ((q >> 3) & 7): the 8 rows k .. k + 7 an
// ldmatrix reads at one chunk then fall in distinct banks (for M 16, 32
// and 64), with no padding. The element offset of chunk (k, c).
__host__ __device__ __forceinline__ int xt_chunk(int k, int c, int cpr) {
  const int q = k * cpr + c;
  return (q ^ ((q >> 3) & 7)) * 8;
}

// One k-step's fragments of a warp's product: A's m16 x k16 tile and,
// per tile i that is on, G weight n8 x k16 tiles (rows 8 nt[i] + g gstep).
template <int G>
struct Frag {
  uint32_t a[4];
  uint32_t b[MAXP][G][2];
  __device__ __forceinline__ void load(const bf16* pa, const bf16* pw,
                                       int ldw, int gstep, const Tiles& tl,
                                       int k) {
    ldsm4(a, pa + k);
    load_b(pw, ldw, gstep, tl, k);
  }
  __device__ __forceinline__ void load_b(const bf16* pw, int ldw, int gstep,
                                         const Tiles& tl, int k) {
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (!tl.on[i]) continue;
      const bf16* p = pw + tl.nt[i] * 8 * ldw + k;
#pragma unroll
      for (int g = 0; g < G; ++g) ldsm2(b[i][g], p + g * gstep);
    }
  }
};

// The k-loop of a warp's product over K (a multiple of 16): ``run`` runs
// the mma of one k-step's fragments. (Loading the next k-step's fragments
// ahead costs registers and measured no faster at these widths.) With kAT
// the A tile is stored transposed and swizzled (xt_chunk; lda = its
// columns): lanes 8j .. 8j + 7 address the rows k + 8 (j >> 1) + i of
// block j's columns m0 + 8 (j & 1), and ldmatrix.trans hands every lane
// the row-major fragments of the non-transposed load.
template <int G, bool kAT = false, typename Run>
__device__ __forceinline__ void k_loop(const bf16* A, int lda, const bf16* W,
                                       int ldw, int gstep, const Warp& w,
                                       const Tiles& tl, int K, Run run) {
  const bf16* pw = W + (w.lane & 7) * ldw + (((w.lane >> 3) & 1) << 3);
  Frag<G> f;
  if constexpr (kAT) {
    const int cpr = lda >> 3, row = ((w.lane >> 4) << 3) + (w.lane & 7);
    const int ch = (w.m0 >> 3) + ((w.lane >> 3) & 1);
    for (int k = 0; k < K; k += 16) {
      ldsm4t(f.a, A + xt_chunk(k + row, ch, cpr));
      f.load_b(pw, ldw, gstep, tl, k);
      run(f);
    }
  } else {
    const bf16* pa = A + (w.m0 + (w.lane & 15)) * lda + ((w.lane >> 4) << 3);
    for (int k = 0; k < K; k += 16) {
      f.load(pa, pw, ldw, gstep, tl, k);
      run(f);
    }
  }
}

// A CTA's slice of a weight, [rows][K] in the [out, in] layout: resident
// in shared memory (row stride K + PAD), or, in the streamed mode, in
// global memory (row stride K), staged through the ring by the products.
struct WSlice {
  const bf16* p;
  int ld;
};

// rows x kc bf16 of a global [rows][ld] slice from column k0 into a ring
// slot [rows][KC + PAD], with cp.async (kc and k0 multiples of 8)
__device__ __forceinline__ void stage_chunk(bf16* slot, const bf16* W, int ld,
                                            int k0, int rows, int kc) {
  const int cpr = kc / 8;
  for (int e = threadIdx.x; e < rows * cpr; e += NTH) {
    const int rr = e / cpr, c = e % cpr;
    cp_async16(slot + rr * (KC + PAD) + c * 8,
               W + static_cast<size_t>(rr) * ld + k0 + c * 8);
  }
}

// The k-loop of a product over K inputs (a multiple of 16): A [.][lda]
// from column 0, the weight slice W (rows [nrows], gate g at rows g grows)
// from column wk0. Resident: k_loop on the slice. Streamed: the slice's
// columns [wk0, wk0 + K) in KC-wide chunks through the two ring slots,
// chunk c + 1 loading while chunk c runs; every thread of the CTA calls
// it (it synchronises the CTA), and no other cp.async is in flight. kAT:
// A is stored transposed (k_loop), a chunk's rows KC further down.
template <bool kStream, int G, bool kAT = false, typename Run>
__device__ __forceinline__ void k_run(const bf16* A, int lda, WSlice W,
                                      int wk0, int grows, int nrows, int K,
                                      bf16* ring, const Warp& w,
                                      const Tiles& tl, Run run) {
  if constexpr (!kStream) {
    k_loop<G, kAT>(A, lda, W.p + wk0, W.ld, grows * W.ld, w, tl, K, run);
  } else {
    constexpr int LDR = KC + PAD;
    const int nch = (K + KC - 1) / KC;
    const size_t slot = static_cast<size_t>(nrows) * LDR;
    stage_chunk(ring, W.p, W.ld, wk0, nrows, K < KC ? K : KC);
    cp_async_commit();
    for (int c = 0; c < nch; ++c) {
      const int kc = K - c * KC < KC ? K - c * KC : KC;
      if (c + 1 < nch) {
        const int kn = K - (c + 1) * KC < KC ? K - (c + 1) * KC : KC;
        stage_chunk(ring + ((c + 1) & 1) * slot, W.p, W.ld,
                    wk0 + (c + 1) * KC, nrows, kn);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      k_loop<G, kAT>(A + c * KC * (kAT ? lda : 1), lda,
                     ring + (c & 1) * slot, LDR, grows * LDR, w, tl, kc, run);
      __syncthreads();
    }
  }
}

// acc[i] += A[m0:m0+16][0:K] W[8 nt[i] : +8][wk0 : wk0 + K]^T for the
// tiles that are on; A [.][lda] bf16 in shared memory, W a slice of nrows
// rows.
template <bool kStream>
__device__ __forceinline__ void warp_mma(float (&acc)[MAXP][4],
                                         const bf16* A, int lda, WSlice W,
                                         int wk0, int nrows, const Warp& w,
                                         const Tiles& tl, int K, bf16* ring) {
  k_run<kStream, 1>(A, lda, W, wk0, 0, nrows, K, ring, w, tl,
                    [&](const Frag<1>& f) {
#pragma unroll
                      for (int i = 0; i < MAXP; ++i)
                        if (tl.on[i]) mma(acc[i], f.a, f.b[i][0]);
                    });
}

// The three gate blocks of a GRU product at once: o_g[i] += A W_g^T with
// W_g the rows [g Hc, (g + 1) Hc) of a CTA's [3 Hc][K] weight slice. A
// sweep keeps its resident slices with the row stride of the activation
// tile they multiply (K + PAD), so the resident k-loop addresses both with
// lda: with one stride for both operands the compiler shares their
// address arithmetic in the hot loop (PERF.md §6). kAT: A is stored
// transposed (k_loop), and the slice keeps its own stride.
template <bool kStream, bool kAT = false>
__device__ __forceinline__ void warp_mma3(float (&o0)[MAXP][4],
                                          float (&o1)[MAXP][4],
                                          float (&o2)[MAXP][4],
                                          const bf16* A, int lda, WSlice W,
                                          int Hc, const Warp& w,
                                          const Tiles& tl, int K,
                                          bf16* ring) {
  if constexpr (!kStream && !kAT) W.ld = lda;
  k_run<kStream, 3, kAT>(A, lda, W, 0, Hc, 3 * Hc, K, ring, w, tl,
                    [&](const Frag<3>& f) {
#pragma unroll
                      for (int i = 0; i < MAXP; ++i) {
                        if (!tl.on[i]) continue;
                        mma(o0[i], f.a, f.b[i][0]);
                        mma(o1[i], f.a, f.b[i][1]);
                        mma(o2[i], f.a, f.b[i][2]);
                      }
                    });
}

// Elements of a ring of two [rows][KC + PAD] slots (none when resident)
__host__ __device__ inline size_t ring_elems(bool stream, int rows) {
  return stream ? static_cast<size_t>(2) * rows * (KC + PAD) : 0;
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[i][q] = 0.0f;
}

// rows x K bf16 from global (contiguous, K a multiple of 8, 16-byte
// aligned) into shared memory rows of stride ldd, with cp.async; the
// caller waits (cp_async_wait_all) and syncs.
__device__ __forceinline__ void load_rows(bf16* dst, int ldd,
                                          const bf16* src, int rows, int K) {
  const int cpr = K / 8;
  for (int e = threadIdx.x; e < rows * cpr; e += NTH) {
    const int rr = e / cpr, c = e % cpr;
    cp_async16(dst + rr * ldd + c * 8,
               src + static_cast<size_t>(rr) * K + c * 8);
  }
}

// dst[b][k] = src[k][col0 + b] for the tile's columns (zero past B): a
// channel-major [rows, B] tile transposed into a [BT][ldd] smem tile.
__device__ __forceinline__ void load_tile_t(bf16* dst, int ldd,
                                            const bf16* src, int rows,
                                            int B, int col0, int BT) {
  for (int e = threadIdx.x; e < rows * BT; e += NTH) {
    const int k = e / BT, b = e % BT, col = col0 + b;
    dst[b * ldd + k] = col < B ? src[static_cast<size_t>(k) * B + col]
                               : __float2bfloat16(0.0f);
  }
}

// dst[k][col0 + b] = src[b][k0 + k] for k < rows inside the batch: a
// [BT][lds] smem tile's column range stored channel-major, coalesced.
__device__ __forceinline__ void store_tile_t(bf16* dst, const bf16* src,
                                             int lds, int k0, int rows,
                                             int B, int col0, int BT) {
  for (int e = threadIdx.x; e < rows * BT; e += NTH) {
    const int k = e / BT, b = e % BT, col = col0 + b;
    if (col < B) dst[static_cast<size_t>(k) * B + col] = src[b * lds + k0 + k];
  }
}

// Copy the columns [k0, k0 + n) (n a multiple of 8) of a [BT][ld] smem
// buffer to the same place in every other CTA of the cluster (16-byte
// stores into distributed shared memory).
__device__ __forceinline__ void bcast_cols(cg::cluster_group& cl, bf16* buf,
                                           int ld, int k0, int n, int BT) {
  const int C = static_cast<int>(cl.num_blocks());
  const int r = static_cast<int>(cl.block_rank());
  const int cpr = n / 8;
  for (int e = threadIdx.x; e < BT * cpr; e += NTH) {
    const int b = e / cpr, c = e % cpr;
    bf16* p = buf + b * ld + k0 + c * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    for (int q = 1; q < C; ++q) {
      const int dst = (r + q) % C;
      *reinterpret_cast<uint4*>(cl.map_shared_rank(p, dst)) = v;
    }
  }
}

// The chunks of 8 rows [k0, k1) of a channel-major input that stacks
// src1 [n1, B] over src2 [n2, B], one level, loaded 8 rows x 1 column per
// item into registers ahead of use (fetch) and stored transposed into a
// [BT][ld] smem tile at columns k (commit); the launchers refuse shapes
// with more than MAXI items a thread.
struct ChunkPF {
  uint4 v[MAXI];
  __device__ static uint4 load8(const bf16* s1, int n1, const bf16* s2,
                                int k, int B, int col) {
    uint4 out = make_uint4(0, 0, 0, 0);
    if (col >= static_cast<int>(B)) return out;
    unsigned short u[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int row = k + kk;
      const bf16* p = row < n1 ? s1 + static_cast<size_t>(row) * B
                               : s2 + static_cast<size_t>(row - n1) * B;
      u[kk] = __ldg(reinterpret_cast<const unsigned short*>(p + col));
    }
    out.x = u[0] | (static_cast<unsigned>(u[1]) << 16);
    out.y = u[2] | (static_cast<unsigned>(u[3]) << 16);
    out.z = u[4] | (static_cast<unsigned>(u[5]) << 16);
    out.w = u[6] | (static_cast<unsigned>(u[7]) << 16);
    return out;
  }
  __device__ void fetch(const bf16* s1, int n1, const bf16* s2, int k0,
                        int k1, int B, int col0, int BT) {
    const int n = (k1 - k0) / 8 * BT;
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
      const int e = threadIdx.x + i * NTH;
      if (e < n)
        v[i] = load8(s1, n1, s2, k0 + (e / BT) * 8, B, col0 + e % BT);
    }
  }
  __device__ void commit(bf16* dst, int ld, int k0, int k1,
                         int BT) const {
    const int n = (k1 - k0) / 8 * BT;
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
      const int e = threadIdx.x + i * NTH;
      if (e < n) {
        const int k = k0 + (e / BT) * 8, b = e % BT;
        *reinterpret_cast<uint4*>(dst + b * ld + k) = v[i];
      }
    }
  }
};

// The columns [k0, k1) (multiples of 8) of a batch-major level [B][ld],
// 16 bytes an item, loaded into registers ahead of use (fetch) and stored
// into a [BT][ldx] smem tile at the same columns (commit); zero past B.
// The loads go through L2 only (ld.global.cg): B7 reads its up states
// back from the output the same kernel wrote them to. The launchers refuse
// shapes with more than MAXI items a thread.
struct RowPF {
  uint4 v[MAXI];
  __device__ void fetch(const bf16* src, int ld, int k0, int k1, int B,
                        int col0, int BT) {
    const int cpr = (k1 - k0) / 8, n = cpr * BT;
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
      const int e = threadIdx.x + i * NTH;
      if (e >= n) continue;
      const int col = col0 + e / cpr;
      v[i] = col < B ? __ldcg(reinterpret_cast<const uint4*>(
                           src + static_cast<size_t>(col) * ld + k0 +
                           (e % cpr) * 8))
                     : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ void commit(bf16* dst, int ldx, int k0, int k1, int BT) const {
    const int cpr = (k1 - k0) / 8, n = cpr * BT;
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
      const int e = threadIdx.x + i * NTH;
      if (e < n)
        *reinterpret_cast<uint4*>(dst + (e / cpr) * ldx + k0 + (e % cpr) * 8) =
            v[i];
    }
  }
};

// The up sweep's projection of one level, xp_l [B, 3H] batch-major, at the
// thread's fragment positions (pairs of neighbouring hidden units), f32,
// zero past B: loaded into registers a level ahead of use (B7, and B8's
// replay).
struct XpPF {
  float v[3][MAXP][4];
  __device__ void fetch(const bf16* xp_l, const Warp& w, const Tiles& tl,
                        int r, int Hc, int H, int B, int col0) {
#pragma unroll
    for (int i = 0; i < MAXP; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = r * Hc + w.col(tl.nt[i] * 8, 0);
        const int col = col0 + w.row(2 * h);
        const bool ok = tl.on[i] && col < B;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          float2 f = make_float2(0.0f, 0.0f);
          if (ok)
            f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                xp_l + static_cast<size_t>(col) * 3 * H + g * H + j));
          v[g][i][2 * h] = f.x;
          v[g][i][2 * h + 1] = f.y;
        }
      }
  }
};

// A [rows, B] tile of one level that stacks s1 [n1, B] over s2 [rows -
// n1, B], f32, loaded into registers ahead of use (fetch) and stored as
// [rows][BT] f32 in shared memory (commit); the launchers refuse shapes
// with more than PF elements a thread. The level is channel-major, or
// with kBM batch-major: s1 [B, n1] and s2 [B, rows - n1].
struct RawPF {
  float v[PF];
  template <bool kBM>
  __device__ static float ld(const bf16* s1, int n1, const bf16* s2,
                             int rows, int e, int B, int col0, int BT) {
    const int k = e / BT, col = col0 + e % BT;
    if (col >= B) return 0.0f;
    const size_t c = col;
    if constexpr (kBM)
      return b2f(k < n1 ? s1[c * n1 + k] : s2[c * (rows - n1) + k - n1]);
    else
      return b2f(k < n1 ? s1[static_cast<size_t>(k) * B + c]
                        : s2[static_cast<size_t>(k - n1) * B + c]);
  }
  template <bool kBM = false>
  __device__ void fetch(const bf16* s1, int n1, const bf16* s2, int rows,
                        int B, int col0, int BT) {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int e = threadIdx.x + i * NTH;
      v[i] = e < rows * BT ? ld<kBM>(s1, n1, s2, rows, e, B, col0, BT) : 0.0f;
    }
  }
  __device__ void commit(float* dst, int rows, int BT) const {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int e = threadIdx.x + i * NTH;
      if (e < rows * BT) dst[e] = v[i];
    }
  }
  // commit with the rows past nf going to X[b][xcol + k - nf] in bf16
  __device__ void commit_split(float* dst, int nf, bf16* X, int ldx,
                               int xcol, int rows, int BT) const {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int e = threadIdx.x + i * NTH;
      if (e >= rows * BT) continue;
      const int k = e / BT, b = e % BT;
      if (k < nf) dst[e] = v[i];
      else X[b * ldx + xcol + k - nf] = __float2bfloat16_rn(v[i]);
    }
  }
};

// A bump allocator over dynamic shared memory: regions 16-byte aligned.
struct Smem {
  size_t off = 0;
  char* base;
  __host__ __device__ explicit Smem(char* b) : base(b) {}
  template <typename T>
  __host__ __device__ T* take(size_t n) {
    T* p = reinterpret_cast<T*>(base + off);
    off += (n * sizeof(T) + 15) / 16 * 16;
    return p;
  }
};


// ---------------------------------------------------------------- sweeps
// Shared-memory layouts of a forward sweep (B1, B10, and B3's and B8's
// replay): the CTA's weight slices (resident) or the ring they stream
// through (rows 3 Hc), the double-buffered dt(h) [2][BT][H] and level
// input [2][BT][KX] (KX 0: B8's up sweep takes its projection from global
// memory; with xt, B4's, transposed: [2][KX][BT], unpadded). The up sweep
// adds the f32 raw inputs of a level and the CTA's slice of the initial
// MLP (CHc of its rows; forward only: nraw, nf > 0);
// the down sweep the latent head's weight [nm8][H], an f32 [BT][nm8]
// scratch and the heads' small f32 parameters [blat; wout; bout] (nhw of
// them).
struct UpBufs {
  bf16 *wx, *wh, *h, *x, *ring;
  float *raw, *wi, *bi;
};
__host__ __device__ inline UpBufs up_bufs(Smem& s, int Hc, int KX, int H,
                                          int BT, int nraw, int nf, int CHc,
                                          bool stream, bool xt = false) {
  UpBufs u;
  const size_t res = stream ? 0 : 3 * Hc;
  u.wx = s.take<bf16>(res * (KX > 0 ? KX + PAD : 0));
  u.wh = s.take<bf16>(res * (H + PAD));
  u.ring = s.take<bf16>(ring_elems(stream, 3 * Hc));
  u.h = s.take<bf16>(static_cast<size_t>(2 * BT) * (H + PAD));
  u.x = s.take<bf16>(static_cast<size_t>(2 * BT) *
                     (KX > 0 ? (xt ? KX : KX + PAD) : 0));
  u.raw = s.take<float>(static_cast<size_t>(nraw) * BT);
  u.wi = s.take<float>(static_cast<size_t>(CHc) * nf);
  u.bi = s.take<float>(nf > 0 ? CHc : 0);
  return u;
}
struct DnBufs {
  bf16 *wx, *wh, *h, *x, *wl, *ring;
  float *mem, *hw;
};
__host__ __device__ inline DnBufs dn_bufs(Smem& s, int Hc, int H, int BT,
                                          int nm8, int nhw, bool stream) {
  DnBufs d;
  const size_t res = stream ? 0 : 3 * Hc;
  d.wx = s.take<bf16>(res * (H + PAD));
  d.wh = s.take<bf16>(res * (H + PAD));
  d.ring = s.take<bf16>(ring_elems(stream, 3 * Hc));
  d.h = s.take<bf16>(static_cast<size_t>(2 * BT) * (H + PAD));
  d.x = s.take<bf16>(static_cast<size_t>(2 * BT) * (H + PAD));
  d.wl = s.take<bf16>(static_cast<size_t>(nm8) * (H + PAD));
  d.mem = s.take<float>(static_cast<size_t>(BT) * nm8);
  d.hw = s.take<float>(nhw);
  return d;
}

// A sweep's weight slice: the resident copy in shared memory (row stride
// K + PAD), or in the streamed mode the global one (stride K)
template <bool kStream>
__device__ __forceinline__ WSlice slice(const bf16* smem, const bf16* glob,
                                        int K) {
  return kStream ? WSlice{glob, K} : WSlice{smem, K + PAD};
}
// the resident copy's load (nothing to do when streamed); the caller waits
template <bool kStream>
__device__ __forceinline__ void load_slice(bf16* smem, const bf16* glob,
                                           int rows, int K) {
  if constexpr (!kStream) load_rows(smem, K + PAD, glob, rows, K);
}

// A thread's registers over a sweep: the f32 state h (the bf16-gate mode
// carries it packed in h2, the pairs q = (0, 1) and (2, 3)) and the input
// and recurrent biases at its fragment columns.
struct GruRegs {
  float h[MAXP][4];
  gates16::bf2 h2[MAXP][2];
  float bx[3][MAXP][2], bh[3][MAXP][2];
};

// The state of R at the thread's fragment positions into a batch-major
// [B][ld] array (CTA r's hidden units; a pair of neighbouring units a
// 4-byte store), nothing past B: dt(R.h), or with kG16 R.h2 as it is
template <bool kG16>
__device__ __forceinline__ void store_state_bm(bf16* dst, int ld,
                                               const GruRegs& R,
                                               const Warp& w, const Tiles& tl,
                                               int r, int Hc, int B,
                                               int col0) {
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (!tl.on[i]) continue;
    const int j = r * Hc + w.col(tl.nt[i] * 8, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + w.row(2 * h);
      if (col < B)
        *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(col) * ld + j) =
            kG16 ? gates16::bits(R.h2[i][h])
                 : pack2(R.h[i][2 * h], R.h[i][2 * h + 1]);
    }
  }
}

// h from h0 [H, B] and the biases bx (none: zero), bh [3H] at the
// thread's fragment positions of CTA r's hidden units
__device__ __forceinline__ void gru_regs_init(GruRegs& R, const Warp& w,
                                              const Tiles& tl, int r, int Hc,
                                              int H, const bf16* bx,
                                              const bf16* bh, const bf16* h0,
                                              int B, int col0) {
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = r * Hc + w.col(tl.nt[i] * 8, q), col = col0 + w.row(q);
      R.h[i][q] = tl.on[i] && col < B
                      ? b2f(h0[static_cast<size_t>(j) * B + col]) : 0.0f;
    }
    R.h2[i][0] = gates16::pk(R.h[i][0], R.h[i][1]);
    R.h2[i][1] = gates16::pk(R.h[i][2], R.h[i][3]);
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = r * Hc + w.col(tl.nt[i] * 8, e);
        R.bx[g][i][e] = tl.on[i] && bx != nullptr ? b2f(bx[g * H + j]) : 0.0f;
        R.bh[g][i][e] = tl.on[i] ? b2f(bh[g * H + j]) : 0.0f;
      }
  }
}

// The recurrent half of a GRU level of CTA r's hidden units over the
// tile, on the input projection xp = (ar, az, an) at the thread's
// fragment positions (input bias included): r and z on xp + Whh dt(h) +
// bh, n = tanh(xp_n + r (Whh_n dt(h) + bh_n)), h = (1 - z) n + z h in f32.
// dt(h_new) goes to the CTA's own columns of Hnxt [BT][ldh] in every CTA
// of the cluster (distributed shared memory); with gates (the replay) h's
// gate bundle [r; z; n; hn] goes to gates [4H, B]. kG16 (the forwards'
// acc32=False): xp is rounded to bf16 here, the state is R.h2 and the gates
// run in packed bf16 arithmetic (gates16.cuh), the recurrent product with
// its bias rounded on its own before the sums; no gate bundle.
template <bool kStream, bool kG16 = false>
__device__ __forceinline__ void gru_rec(cg::cluster_group& cl, GruRegs& R,
                                        float (&ar)[MAXP][4],
                                        float (&az)[MAXP][4],
                                        const float (&an)[MAXP][4],
                                        const bf16* Hcur, WSlice Wh, int ldh,
                                        int H, int Hc, bf16* Hnxt,
                                        const Warp& w, const Tiles& tl, int r,
                                        bf16* gates, int B, int col0,
                                        bf16* ring) {
  float hn[MAXP][4], hr[MAXP][4], hz[MAXP][4];
  zero_acc(hn);
  if constexpr (kG16) {
    // the recurrent product of r and z on its own: it takes its bias and
    // is rounded before the sum with x
    zero_acc(hr);
    zero_acc(hz);
    warp_mma3<kStream>(hr, hz, hn, Hcur, ldh, Wh, Hc, w, tl, H, ring);
  } else {
    // r and z take x + hh: the recurrent product accumulates onto x
    warp_mma3<kStream>(ar, az, hn, Hcur, ldh, Wh, Hc, w, tl, H, ring);
  }
  const size_t sB = B;
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (!tl.on[i]) continue;
    uint32_t p0, p1;
    if constexpr (kG16) {
      using gates16::pk;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int q = 2 * p;
        R.h2[i][p] = gates16::step2(
            pk(ar[i][q], ar[i][q + 1]), pk(az[i][q], az[i][q + 1]),
            pk(an[i][q], an[i][q + 1]),
            pk(hr[i][q] + R.bh[0][i][0], hr[i][q + 1] + R.bh[0][i][1]),
            pk(hz[i][q] + R.bh[1][i][0], hz[i][q + 1] + R.bh[1][i][1]),
            pk(hn[i][q] + R.bh[2][i][0], hn[i][q + 1] + R.bh[2][i][1]),
            R.h2[i][p]);
      }
      p0 = gates16::bits(R.h2[i][0]);
      p1 = gates16::bits(R.h2[i][1]);
    } else {
      float hv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float rr = sigm(ar[i][q] + R.bh[0][i][q & 1]);
        const float zz = sigm(az[i][q] + R.bh[1][i][q & 1]);
        const float hq = hn[i][q] + R.bh[2][i][q & 1];
        const float nn = tanh_(an[i][q] + rr * hq);
        hv[q] = (1.0f - zz) * nn + zz * R.h[i][q];
        R.h[i][q] = hv[q];
        if (gates != nullptr) {
          const int j = r * Hc + w.col(tl.nt[i] * 8, q);
          const int col = col0 + w.row(q);
          if (col < B) {
            gates[j * sB + col] = __float2bfloat16_rn(rr);
            gates[(H + j) * sB + col] = __float2bfloat16_rn(zz);
            gates[(2 * H + j) * sB + col] = __float2bfloat16_rn(nn);
            gates[(3 * H + j) * sB + col] = __float2bfloat16_rn(hq);
          }
        }
      }
      p0 = pack2(hv[0], hv[1]);
      p1 = pack2(hv[2], hv[3]);
    }
    const int j = r * Hc + w.col(tl.nt[i] * 8, 0);
    for (int q = 0; q < static_cast<int>(cl.num_blocks()); ++q) {
      *reinterpret_cast<uint32_t*>(
          cl.map_shared_rank(Hnxt + w.row(0) * ldh + j, q)) = p0;
      *reinterpret_cast<uint32_t*>(
          cl.map_shared_rank(Hnxt + w.row(2) * ldh + j, q)) = p1;
    }
  }
}

// One GRU level with its input projection: xp = X Wx^T + bx (rounded to
// bf16 with kRoundXP, as the v6 forward stores it, and always with kG16,
// as every TPU body rounds it to its bf16 gate type, there by gru_rec's
// packing; f32 in the v4 forward and the backward's replays), then
// gru_rec. X [BT][ldx] with KX inputs, or with kXT stored transposed,
// [KX][BT] swizzled (xt_chunk; ldx BT).
template <bool kRoundXP, bool kStream, bool kXT = false, bool kG16 = false>
__device__ __forceinline__ void gru_level(cg::cluster_group& cl, GruRegs& R,
                                          const bf16* X, int ldx, int KX,
                                          WSlice Wx, const bf16* Hcur,
                                          WSlice Wh, int ldh, int H, int Hc,
                                          bf16* Hnxt, const Warp& w,
                                          const Tiles& tl, int r, bf16* gates,
                                          int B, int col0, bf16* ring) {
  float ar[MAXP][4], az[MAXP][4], an[MAXP][4];
  zero_acc(ar);
  zero_acc(az);
  zero_acc(an);
  warp_mma3<kStream, kXT>(ar, az, an, X, ldx, Wx, Hc, w, tl, KX, ring);
#pragma unroll
  for (int i = 0; i < MAXP; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ar[i][q] += R.bx[0][i][q & 1];
      az[i][q] += R.bx[1][i][q & 1];
      an[i][q] += R.bx[2][i][q & 1];
      if (kRoundXP && !kG16) {
        ar[i][q] = rnd(ar[i][q]);
        az[i][q] = rnd(az[i][q]);
        an[i][q] = rnd(an[i][q]);
      }
    }
  gru_rec<kStream, kG16>(cl, R, ar, az, an, Hcur, Wh, ldh, H, Hc, Hnxt, w,
                         tl, r, gates, B, col0, ring);
}

// The heads' small parameters into shared memory as f32: hw = [blat (nm);
// wout (ny x nm); bout (ny)], ny 0 for the latent head alone.
__device__ __forceinline__ void load_heads(float* hw, const bf16* blat,
                                           const bf16* wout,
                                           const bf16* bout, int nm,
                                           int ny) {
  for (int e = threadIdx.x; e < nm + ny * nm + ny; e += NTH)
    hw[e] = b2f(e < nm ? blat[e]
                       : e < nm + ny * nm ? wout[e - nm]
                                          : bout[e - nm - ny * nm]);
}

// Where a head writes its rows of one level: element (row m, column col)
// at p[m ld + col] (channel-major [rows, B], ld B) or with kBM at
// p[col ld + m] (batch-major [B, rows], ld rows); a level holds fewer than
// 2^31 elements
template <bool kBM>
struct HeadOut {
  bf16* p;
  int ld;
  __device__ bf16& at(int m, int col) const {
    return kBM ? p[col * ld + m] : p[m * ld + col];
  }
};

// The latent head on dt(h2) of one level, Hl [BT][ldh], for CTA r's
// m16 tiles (r, r + C, ...), one warp each: mem = dt(Wlat dt(h2) + blat)
// into om_mem's rows m < nm and, with om_out.p, out = dt(Wout mem + bout)
// into its ny rows. Wl [nm8][ldh] and hw (as load_heads) in shared memory
// (Wl's rows past nm zero), smem_mem an f32 [BT][nm8] scratch.
template <bool kBM>
__device__ __forceinline__ void heads(const bf16* Hl, int ldh, const bf16* Wl,
                                      int H, int nm, int nm8,
                                      const float* hw, int ny,
                                      float* smem_mem, HeadOut<kBM> om_mem,
                                      HeadOut<kBM> om_out, int B, int col0,
                                      int BT, int r, int C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int k = 0;
  for (int mt = r; mt < BT / 16; mt += C, ++k) {
    if (warp != NW - 1 - (k % NW)) continue;
    const int m0 = mt * 16;
    const bf16* pa = Hl + (m0 + (lane & 15)) * ldh + ((lane >> 4) << 3);
    for (int n0 = 0; n0 < nm8; n0 += 8) {
      const bf16* pw = Wl + (n0 + (lane & 7)) * ldh + (((lane >> 3) & 1) << 3);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int kk = 0; kk < H; kk += 16) {
        uint32_t a[4], b[2];
        ldsm4(a, pa + kk);
        ldsm2(b, pw + kk);
        mma(acc, a, b);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = n0 + 2 * t + (q & 1), b = m0 + g + 8 * (q >> 1);
        if (m >= nm) continue;
        const float v = rnd(acc[q] + hw[m]);
        smem_mem[b * nm8 + m] = v;
        if (col0 + b < B) om_mem.at(m, col0 + b) = __float2bfloat16_rn(v);
      }
    }
    if (om_out.p == nullptr) continue;
    __syncwarp();
    for (int e = lane; e < 16 * ny; e += 32) {
      const int b = m0 + e % 16, o = e / 16;
      float a = 0.0f;
      for (int m = 0; m < nm; ++m)
        a = fmaf(hw[nm + o * nm + m], smem_mem[b * nm8 + m], a);
      if (col0 + b < B)
        om_out.at(o, col0 + b) = __float2bfloat16_rn(a + hw[nm + ny * nm + o]);
    }
    __syncwarp();
  }
}

// Launch a cluster kernel of C CTAs a tile over the tiles of B columns
template <typename P>
int launch_cluster(void (*kernel)(P), const P& p, int C, int BT, int B,
                   size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + BT - 1) / BT) * C);
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
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bmma
