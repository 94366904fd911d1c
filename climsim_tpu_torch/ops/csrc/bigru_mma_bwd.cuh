// Tensor-core building blocks of the bf16 BiGRU backward kernels: the
// v6/v5 channel-major backward (B3, bigru_heads_cm_bwd.cu) and the v2
// batch-major one (B8, bigru_lbh_bwd.cu).
//
// Both replay the sweeps with bigru_mma.cuh's level, storing h and the
// gate bundle [r; z; n; hn] (bf16, channel-major [L, 4H, B] device
// scratch), then run the two BPTT sweeps with the GRU backward step at
// the thread's fragment positions (the carried gradient in registers):
// each CTA writes the rounded bundle dt([dar; daz; dan; dhn]) of its
// hidden units to its own columns of a [BT][4H] smem tile, copies it to
// every CTA of the cluster (distributed shared memory), and after one
// cluster barrier computes the transposed products for the rows it owns
// from [in-rows x 3H] weight slices (resident for the phase, or streamed
// through the ring, bigru_mma.cuh). The rounded bundle also overwrites the
// gates in place: it is exactly the left factor of the weight gradients,
// so no f32 [L, 4H, B] gradient streams are kept. The bias sums take the
// unrounded f32 values: each thread sums its own positions over the
// levels, and each tile writes f32 partials in a fixed order.
// wgrad_mma_kernel then forms each weight gradient sum_{l,b} dt(left)
// right as a bf16 tensor-core GEMM over the L x B contraction, and
// bias_sum_kernel adds the tiles' bias partials in order. No atomics: two
// calls are bit-identical.
#pragma once
#include "bigru_common.cuh"
#include "bigru_mma.cuh"

namespace bmma {

// Shared-memory layout of a BPTT phase: the CTA's transposed slices
// wh [Hc][3H] (Whh^T) and wu [wu_rows][3H] (W2^T, or B3's [W1h | W1m]^T
// rows), resident, or the ring they stream through; the bundle tile D
// [BT][4H]; with the heads (B3's phase B) Wlat^T's slice [Hc][nm16], the
// tile's dt(dmem_tot) [BT][nm16] and its raw cotangents [rows][BT] f32;
// the bias reduction's scratch.
struct BBufs {
  bf16 *wh, *wu, *ring, *wl, *D, *dmt;
  float *raw, *red;
};
__host__ __device__ inline BBufs b_bufs(Smem& s, int Hc, int H, int BT,
                                        int nm16, int nm, int ny,
                                        int wu_rows, bool heads,
                                        bool stream) {
  BBufs b;
  const int LDT = 3 * H + PAD;
  b.wh = s.take<bf16>(stream ? 0 : static_cast<size_t>(Hc) * LDT);
  b.wu = s.take<bf16>(stream ? 0 : static_cast<size_t>(wu_rows) * LDT);
  b.ring = s.take<bf16>(ring_elems(stream, Hc > wu_rows ? Hc : wu_rows));
  b.wl = s.take<bf16>(heads ? static_cast<size_t>(Hc) * (nm16 + PAD) : 0);
  b.D = s.take<bf16>(static_cast<size_t>(BT) * (4 * H + PAD));
  b.dmt = s.take<bf16>(heads ? static_cast<size_t>(BT) * (nm16 + PAD) : 0);
  const int rows = nm + ny > nm16 ? nm + ny : nm16;
  b.raw = s.take<float>(heads ? static_cast<size_t>(rows) * BT : 0);
  b.red = s.take<float>(static_cast<size_t>(BT / 16) * 4 * Hc);
  return b;
}

// The addend of the carried gradient at (hidden unit j, column col):
// none, an f32 channel-major [H, B] level (d_up), or a bf16 batch-major
// [B, H] level (B8's d_down)
struct AddNone {
  __device__ float operator()(int, int) const { return 0.0f; }
};
struct AddCM {
  const float* p;
  size_t B;
  __device__ float operator()(int j, int col) const { return p[j * B + col]; }
};
struct AddBM {
  const bf16* p;
  int H;
  __device__ float operator()(int j, int col) const {
    return b2f(p[static_cast<size_t>(col) * H + j]);
  }
};

// The GRU backward step of one level at the thread's fragment positions:
// g = dh + add(j, col), the stored gates [4H, B] and h_prev [H, B]; the
// rounded bundle dt([dar; daz; dan; dhn]) goes to the CTA's columns of D
// [BT][ldd] and over the gates in place (inside the batch), and with dxp
// d_xp = dt([dar; daz; dan]) to dxp [B, 3H] (batch-major, B8); bp sums the
// unrounded bundle over the thread's rows; dh <- g z.
template <typename Add>
__device__ __forceinline__ void gru_bwd(float (&dh)[MAXP][4], Add add,
                                        bf16* gates, const bf16* hp, bf16* D,
                                        int ldd, float (&bp)[4][MAXP][2],
                                        const Warp& w, const Tiles& tl,
                                        int r, int Hc, int H, int B,
                                        int col0, bf16* dxp = nullptr) {
  const size_t sB = B;
  float in[MAXP][4][6];
#pragma unroll
  for (int i = 0; i < MAXP; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = r * Hc + w.col(tl.nt[i] * 8, q), col = col0 + w.row(q);
      const bool ok = tl.on[i] && col < B;
      const size_t e = j * sB + col;
      in[i][q][0] = ok ? add(j, col) : 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        in[i][q][1 + k] = ok ? b2f(gates[k * H * sB + e]) : 0.0f;
      in[i][q][5] = ok ? b2f(hp[e]) : 0.0f;
    }
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (!tl.on[i]) continue;
    float v[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float g = dh[i][q] + in[i][q][0];
      const float rr = in[i][q][1], zz = in[i][q][2], nn = in[i][q][3];
      const float hnn = in[i][q][4], h_prev = in[i][q][5];
      const float dz = g * (h_prev - nn);
      const float dan = g * (1.0f - zz) * (1.0f - nn * nn);
      const float dar = dan * hnn * rr * (1.0f - rr);
      const float daz = dz * zz * (1.0f - zz);
      const float dhn = dan * rr;
      v[q][0] = dar;
      v[q][1] = daz;
      v[q][2] = dan;
      v[q][3] = dhn;
      dh[i][q] = g * zz;
      const int j = r * Hc + w.col(tl.nt[i] * 8, q), col = col0 + w.row(q);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bp[k][i][q & 1] += v[q][k];
        if (col < B)
          gates[(k * H + j) * sB + col] = __float2bfloat16_rn(v[q][k]);
      }
    }
    const int j = r * Hc + w.col(tl.nt[i] * 8, 0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      *reinterpret_cast<uint32_t*>(D + w.row(0) * ldd + k * H + j) =
          pack2(v[0][k], v[1][k]);
      *reinterpret_cast<uint32_t*>(D + w.row(2) * ldd + k * H + j) =
          pack2(v[2][k], v[3][k]);
    }
    if (dxp != nullptr) {
      const int c0 = col0 + w.row(0), c2 = col0 + w.row(2);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (c0 < B)
          *reinterpret_cast<uint32_t*>(dxp + static_cast<size_t>(c0) * 3 * H +
                                       k * H + j) = pack2(v[0][k], v[1][k]);
        if (c2 < B)
          *reinterpret_cast<uint32_t*>(dxp + static_cast<size_t>(c2) * 3 * H +
                                       k * H + j) = pack2(v[2][k], v[3][k]);
      }
    }
  }
}

// dst[i] = dt(v[i]) at the thread's fragment positions of a [H, B] tensor
__device__ __forceinline__ void store_frag(bf16* dst, const float (&v)[MAXP][4],
                                           const Warp& w, const Tiles& tl,
                                           int r, int Hc, int B, int col0) {
#pragma unroll
  for (int i = 0; i < MAXP; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = r * Hc + w.col(tl.nt[i] * 8, q), col = col0 + w.row(q);
      if (tl.on[i] && col < B)
        dst[static_cast<size_t>(j) * B + col] = __float2bfloat16_rn(v[i][q]);
    }
}

// dh[i][q] at the thread's fragment positions of a [H, B] tensor (zero
// past B)
__device__ __forceinline__ void load_frag(float (&dh)[MAXP][4], const bf16* src,
                                          const Warp& w, const Tiles& tl,
                                          int r, int Hc, int B, int col0) {
#pragma unroll
  for (int i = 0; i < MAXP; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = r * Hc + w.col(tl.nt[i] * 8, q), col = col0 + w.row(q);
      dh[i][q] = tl.on[i] && col < B
                     ? b2f(src[static_cast<size_t>(j) * B + col]) : 0.0f;
    }
}

// The tile's bias partials of one sweep: bp summed over the lanes of a
// column and then over the warps' m16 tiles in order, into
// part[k H + r Hc + jj] for the bundle's four rows k.
__device__ __forceinline__ void reduce_bias(const float (&bp)[4][MAXP][2],
                                            float* red, float* part,
                                            const Warp& w, const Tiles& tl,
                                            int r, int Hc, int H, int BT) {
  const int nwm = BT / 16, wm = w.m0 / 16;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < MAXP; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = bp[k][i][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (w.g == 0 && tl.on[i])
          red[(wm * 4 + k) * Hc + w.col(tl.nt[i] * 8, e)] = v;
      }
  __syncthreads();
  for (int e = threadIdx.x; e < 4 * Hc; e += NTH) {
    const int k = e / Hc, jj = e % Hc;
    float a = 0.0f;
    for (int m = 0; m < nwm; ++m) a += red[(m * 4 + k) * Hc + jj];
    part[k * H + r * Hc + jj] = a;
  }
  __syncthreads();
}

// ---------------------------------------------------------- weight grads

constexpr int GTM = 128;        // output tile rows
constexpr int GTN = 64;         // output tile columns
constexpr int GK = 32;          // columns per chunk
constexpr int GTH = 256;        // threads per block (8 warps of 32 x 32)

// A gradient sum over levels and columns: out [M, N] = sum_{l, b}
// left[l][row(m)][b] right[l + shift][n][b], both bf16 (the left factor
// already rounded), row(m) = m for m < split, m + gap after; the right
// operand's level outside 0..L-1 is edge [N, B].
struct GJob {
  const bf16* a; size_t a_lvl; int split, gap;
  const bf16* b; size_t b_lvl; int shift; const bf16* edge;
  bf16* out; int M, N;
};

// 16 values of row src[0..] from column b0 into registers, zero past B
__device__ __forceinline__ void fetch16(uint4 (&r)[2], const bf16* src,
                                        int b0, int B, bool ok, bool vec) {
  if (ok && vec && b0 + 16 <= B) {
    r[0] = *reinterpret_cast<const uint4*>(src + b0);
    r[1] = *reinterpret_cast<const uint4*>(src + b0 + 8);
    return;
  }
  unsigned short u[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    u[k] = ok && b0 + k < B
               ? *reinterpret_cast<const unsigned short*>(src + b0 + k) : 0;
  r[0] = make_uint4(u[0] | (u[1] << 16), u[2] | (u[3] << 16),
                    u[4] | (u[5] << 16), u[6] | (u[7] << 16));
  r[1] = make_uint4(u[8] | (u[9] << 16), u[10] | (u[11] << 16),
                    u[12] | (u[13] << 16), u[14] | (u[15] << 16));
}

// Each block one GTM x GTN output tile over one of S fixed ranges of the
// L x B contraction (GK-column chunks fetched a chunk ahead), its f32
// partial sums into part[s]
__global__ void __launch_bounds__(GTH)
wgrad_mma_kernel(GJob jb, int L, int B, int S, int vec, float* part) {
  __shared__ __align__(16) bf16 As[GTM * (GK + PAD)];
  __shared__ __align__(16) bf16 Bs[GTN * (GK + PAD)];
  constexpr int LD = GK + PAD;
  const int ntn = (jb.N + GTN - 1) / GTN;
  const int m0 = (blockIdx.x / ntn) * GTM, n0 = (blockIdx.x % ntn) * GTN;
  const int s = blockIdx.y;
  const long nbc = (B + GK - 1) / GK;
  const long total = L * nbc;
  const long first = total * s / S, last = total * (s + 1) / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  // thread (row, half) fetches 16 columns of A's row and, in the first
  // 2 GTN threads, of B's
  const int row = tid >> 1, half = (tid & 1) * 16;
  const bool brow = row < GTN;
  const int m = m0 + row, n = n0 + row;
  const int arow = m < jb.split ? m : m + jb.gap;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  // chunk ch's two 16-value rows, fetched into registers a chunk ahead
  uint4 ra[2], rb[2];
  const auto fetch = [&](long ch) {
    const int l = static_cast<int>(ch / nbc);
    const int b0 = static_cast<int>(ch % nbc) * GK + half;
    const int lb = l + jb.shift;
    const bf16* Bl = (lb >= 0 && lb < L) ? jb.b + lb * jb.b_lvl : jb.edge;
    fetch16(ra, jb.a + l * jb.a_lvl + static_cast<size_t>(arow) * B, b0, B,
            m < jb.M, vec);
    if (brow)
      fetch16(rb, Bl + static_cast<size_t>(n) * B, b0, B, n < jb.N, vec);
  };
  if (first < last) fetch(first);
  for (long ch = first; ch < last; ++ch) {
    uint4* da = reinterpret_cast<uint4*>(As + row * LD + half);
    uint4* db = reinterpret_cast<uint4*>(Bs + row * LD + half);
    da[0] = ra[0];
    da[1] = ra[1];
    if (brow) {
      db[0] = rb[0];
      db[1] = rb[1];
    }
    __syncthreads();
    if (ch + 1 < last) fetch(ch + 1);
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm4(a[i], As + (wm + i * 16 + (lane & 15)) * LD + kk + ((lane >> 4) << 3));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldsm2(b[j], Bs + (wn + j * 8 + (lane & 7)) * LD + kk +
                        (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int mm = m0 + wm + i * 16 + g + 8 * (q >> 1);
        const int nn = n0 + wn + j * 8 + 2 * t + (q & 1);
        if (mm < jb.M && nn < jb.N)
          part[(static_cast<size_t>(s) * jb.M + mm) * jb.N + nn] = acc[i][j][q];
      }
}

// the bias gradients from the tiles' partials [tiles, 8H + nm + ny]: each
// sum over the tiles in order (an output pointer may be null: not wanted)
__global__ void bias_sum_kernel(const float* part, int tiles, int H, int nm,
                                int ny, bf16* dbin1, bf16* dbhh_up,
                                bf16* dbin2, bf16* dbhh_dn, bf16* dblat,
                                bf16* dbout) {
  const int PW = 8 * H + nm + ny;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= PW) return;
  float a = 0.0f;
  for (int t = 0; t < tiles; ++t) a += part[static_cast<size_t>(t) * PW + i];
  const bf16 v = __float2bfloat16_rn(a);
  if (i < 8 * H) {
    const int sw = i / (4 * H), k = (i % (4 * H)) / H, j = i % H;
    bf16* dbin = sw == 0 ? dbin1 : dbin2;
    bf16* dbhh = sw == 0 ? dbhh_up : dbhh_dn;
    // d_xp = [dar; daz; dan], d_hh = [dar; daz; dhn]
    if (k < 3 && dbin != nullptr) dbin[k * H + j] = v;
    if (k < 2) dbhh[k * H + j] = v;
    if (k == 3) dbhh[2 * H + j] = v;
  } else if (i < 8 * H + nm) {
    dblat[i - 8 * H] = v;
  } else {
    dbout[i - 8 * H - nm] = v;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One weight gradient: the GEMM split into S_job fixed column ranges (at
// least S; more for a gradient of few output tiles, so that ~4 blocks a
// SM run, within the work capacity cap = S x the largest gradient), then
// the fixed-order sum of the partials. S_job depends on the shapes alone.
inline int gemm(const GJob& jb, int L, int B, int S, size_t cap, float* work,
                cudaStream_t st) {
  if (jb.M == 0 || jb.N == 0) return 0;
  const bool vec = B % 8 == 0 && aligned16(jb.a) && aligned16(jb.b) &&
                   (jb.edge == nullptr || aligned16(jb.edge)) &&
                   jb.a_lvl % 8 == 0 && jb.b_lvl % 8 == 0;
  const int tiles = ((jb.M + GTM - 1) / GTM) * ((jb.N + GTN - 1) / GTN);
  const size_t MN = static_cast<size_t>(jb.M) * jb.N;
  int sj = (4 * 132 + tiles - 1) / tiles;
  if (sj < S) sj = S;
  if (static_cast<size_t>(sj) * MN > cap) sj = static_cast<int>(cap / MN);
  S = sj;
  wgrad_mma_kernel<<<dim3(tiles, S), GTH, 0, st>>>(jb, L, B, S, vec ? 1 : 0,
                                                   work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bigru::sum_parts_kernel<bf16><<<static_cast<int>((MN + 255) / 256), 256, 0,
                                  st>>>(work, S, static_cast<int>(MN),
                                        jb.out);
  return static_cast<int>(cudaGetLastError());
}

// The jobs' GEMMs with a work buffer of S x the largest gradient
template <int N>
int gemms(const GJob (&jobs)[N], int L, int B, int S, float* work,
          cudaStream_t st) {
  size_t cap = 0;
  for (const GJob& jb : jobs) {
    const size_t MN = static_cast<size_t>(jb.M) * jb.N;
    if (MN * S > cap) cap = MN * S;
  }
  for (const GJob& jb : jobs) {
    const int rc = gemm(jb, L, B, S, cap, work, st);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace bmma
