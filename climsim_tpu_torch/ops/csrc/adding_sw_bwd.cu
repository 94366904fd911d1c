// SW two-stream adding solver backward: the gradients of (flux_up,
// flux_dn_diffuse, flux_dn_direct) with respect to all eight inputs, for
// the conservative form of the forward (adding_sw.cu).
//
// Replaces the TPU kernel climsim_tpu/ops/pallas_radiation.py::
// _adding_sw_bwd_kernel (wrapper adding_sw_bwd_fused).
//
// Per column b and g-point g (layer arrays [B, nlev, ng], surface arrays
// [B, ng], half-level arrays [B, nlev+1, ng], level 0 = TOA, all f32), as
// the TPU body:
//   replay the up sweep (albedos alb, albdir below every half-level) and
//     the down sweep (fdir, fdiff at every half-level);
//   galb[j] = dfup[j] fdiff[j], galbdir[j] = dfup[j] fdir[j] (from
//     fup[j] = fdir[j] albdir[j] + fdiff[j] alb[j]);
//   down sweep backward, j = nlev-1 .. 0, carrying the total gradients on
//     (fdir[j+1], fdiff[j+1]): the gradients of R, T, tdd and tdir from the
//     diffuse and direct steps, and the down sweep's share of galb[j+1],
//     galbdir[j+1]; dtoa is the carry on fdir[0] (the gradient on the
//     constant fdiff[0] is dropped);
//   up sweep backward, j = 0 .. nlev-1, carrying the total gradients on
//     (alb[j], albdir[j]): drd, and the up sweep's shares of dR, dT, dtdd,
//     dtdir; dad and dadir are the carries on alb[nlev], albdir[nlev].
//
// What bounds it on an H100 at the physics model's shapes (B 21,600,
// nlev 60, ng 8): 5 layer and 3 surface inputs and 3 half-level
// cotangents read once (336 MB), 5 layer and 3 surface gradients written
// once (210 MB): 546 MB, 0.163 ms at 3.35 TB/s, against ~100 operations
// per element. So it is bound by bytes.
//
// What this design does about it: the four sweeps become two passes over
// the levels, so each input is read twice at most and each gradient
// written once, and the replay never leaves the SM.
//   * The down sweep backward needs of the replay only the albedos, not
//     the fluxes: its carries (gdir, gdiff) update from alb and albdir at
//     j and j+1. So it runs in the same descending pass as the up sweep's
//     replay, one level behind it (pass 1).
//   * The fluxes fdir and fdiff are replayed ascending inside the up sweep
//     backward (pass 2), which walks the levels in the order the forward
//     computed them: the same operations in the same order.
//   * Pass 2 needs at each layer what pass 1 had there: the albedos below
//     it (alb[j+1], albdir[j+1]) and the down sweep backward's carries
//     (gdiff, gdir). Parking all four for every level (960 B an item at
//     nlev 60) holds a SM to 7 warps, too few to keep the card's memory
//     busy; so pass 1 parks them only at the top of every chunk of K
//     levels, and pass 2, chunk by chunk from the top, first re-runs pass
//     1's steps over the chunk from its parked state into registers, then
//     walks the chunk ascending. Pass 2 adds the down sweep's terms of
//     dR, dT, dtdd, dtdir and galb, galbdir to the up sweep's and writes
//     each gradient once.
// A block is one warp of 32 items (4 columns x 8 g-points, so each
// level's load is 4 full 32-byte sectors) with its parked chunks in
// shared memory, [nlev / K][4][32] floats (7.5 KB at nlev 60). No device
// scratch. Each pass loads the next chunk's inputs into registers while
// it runs the current one, so the loads stay out of the serial chain;
// pass 2 reads all eight inputs of a chunk once for both of its walks.
// The loads ask L2 for the whole 128-byte line (4 levels of one column's
// 8 g-points), so the next chunk's levels are already there. K 4 with the
// registers capped at 128 (16 blocks a SM) was the fastest of the chunk
// depths and caps tried on an H100 (K 8 spills; deeper L2 prefetches
// were slower); what still bounds it is the latency of the loads against
// the short chain of a chunk (PERF.md §7).
//
// The first design, kept as adding_sw_bwd_scratch to time it against this
// one: one thread walks one item through the four sweeps, its replay in a
// [4, B, nlev+1, ng] device scratch, re-reading the inputs in every sweep
// and writing dR, dT, dtdd, dtdir twice (about 4x the bound's bytes).
#include <cuda_runtime.h>

namespace {

constexpr int NTH = 32;           // items a block: one warp
constexpr int K = 4;              // levels a chunk
constexpr int MIN_BLOCKS = 16;    // blocks a SM: 128 registers a thread
constexpr int NTH_SCRATCH = 256;  // the first design's block
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block

// a read-only load that has L2 fetch the whole 128-byte line
__device__ __forceinline__ float ld_line(const float* p) {
  float v;
  asm("ld.global.nc.L2::128B.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// N arrays of one item at the U levels of a chunk, in registers: level
// j0 + u (kDesc: j0 - u), zero outside [0, n)
template <int N, int U, bool kDesc>
struct Chunk {
  float v[N][U];
  __device__ __forceinline__ void load(const float* const (&a)[N],
                                       int j0, int n, int ng) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = kDesc ? j0 - u : j0 + u;
      const bool ok = j >= 0 && j < n;
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i][u] = ok ? ld_line(a[i] + static_cast<size_t>(j) * ng) : 0.0f;
    }
  }
};

// One step of pass 1 at layer j (R, T, rd, tdd, tdir of the layer; dfup,
// dfdiff, dfdir at half-level j): the up sweep's replay from (alb,
// albdir) = alb[j+1], albdir[j+1] to alb[j], albdir[j], and the down
// sweep backward's carries (gdiff, gdir) from layer j+1's to layer j-1's
struct Pass1 {
  float alb, albdir, gdiff, gdir;
  __device__ __forceinline__ void step(float Rj, float Tj, float rdj,
                                       float tddj, float tdj, float dfup0,
                                       float dfdiff0, float dfdir0) {
    const float inv = 1.0f / (1.0f - alb * Rj);
    const float adir0 = rdj + (tdj * albdir + tddj * alb) * Tj * inv;
    const float alb0 = Rj + Tj * Tj * alb * inv;
    const float denom = 1.0f - Rj * alb;
    const float Kj = tdj * albdir * Rj + tddj;
    const float dN = gdiff / denom;
    const float gdir_next = gdir * tdj + dN * Kj + dfdir0 + dfup0 * adir0;
    gdiff = dN * Tj + dfdiff0 + dfup0 * alb0;
    gdir = gdir_next;
    alb = alb0;
    albdir = adir0;
  }
};

__global__ void __launch_bounds__(NTH, MIN_BLOCKS) adding_sw_bwd_kernel(
    const float* __restrict__ toa, const float* __restrict__ ad,
    const float* __restrict__ adir, const float* __restrict__ R,
    const float* __restrict__ T, const float* __restrict__ rd,
    const float* __restrict__ tdd, const float* __restrict__ tdir,
    const float* __restrict__ dfup, const float* __restrict__ dfdiff,
    const float* __restrict__ dfdir, float* __restrict__ dtoa,
    float* __restrict__ dad, float* __restrict__ dadir,
    float* __restrict__ dR, float* __restrict__ dT,
    float* __restrict__ drd, float* __restrict__ dtdd,
    float* __restrict__ dtdir, int B, int nlev, int ng) {
  // pass 1's state at the top of chunk c, [c][alb, albdir, gdiff, gdir]
  extern __shared__ float park[];
  const long long t = static_cast<long long>(blockIdx.x) * NTH + threadIdx.x;
  if (t >= static_cast<long long>(B) * ng) return;
  const long long b = t / ng;
  const int g = static_cast<int>(t % ng);
  const size_t lay = static_cast<size_t>(b) * nlev * ng + g;     // + j ng
  const size_t half = static_cast<size_t>(b) * (nlev + 1) * ng + g;
  float* pk = park + threadIdx.x;               // [(4 c + s) NTH]
  const int nc = (nlev + K - 1) / K;

  // ---- pass 1, chunks from the surface up, each j = cK + K - 1 .. cK:
  // the up sweep's replay and, one level behind it, the down sweep
  // backward; the carry holds the total gradients on (fdir[j+1],
  // fdiff[j+1])
  {
    const size_t N = static_cast<size_t>(nlev) * ng;
    const float* const src[8] = {R + lay, T + lay, rd + lay, tdd + lay,
                                 tdir + lay, dfup + half, dfdiff + half,
                                 dfdir + half};
    Pass1 p;
    p.alb = __ldg(ad + t);
    p.albdir = __ldg(adir + t);
    const float dfupN = __ldg(dfup + half + N);
    p.gdir = __ldg(dfdir + half + N) + dfupN * p.albdir;
    p.gdiff = __ldg(dfdiff + half + N) + dfupN * p.alb;
    Chunk<8, K, true> cur, nxt;
    cur.load(src, (nc - 1) * K + K - 1, nlev, ng);
    for (int c = nc - 1; c >= 0; --c) {
      if (c > 0) nxt.load(src, c * K - 1, nlev, ng);
      pk[(4 * c) * NTH] = p.alb;
      pk[(4 * c + 1) * NTH] = p.albdir;
      pk[(4 * c + 2) * NTH] = p.gdiff;
      pk[(4 * c + 3) * NTH] = p.gdir;
#pragma unroll
      for (int u = 0; u < K; ++u) {
        if (c * K + K - 1 - u >= nlev) continue;
        p.step(cur.v[0][u], cur.v[1][u], cur.v[2][u], cur.v[3][u],
               cur.v[4][u], cur.v[5][u], cur.v[6][u], cur.v[7][u]);
      }
      cur = nxt;
    }
    dtoa[t] = p.gdir;
  }

  // ---- pass 2, chunks from the top of the atmosphere down, each: pass
  // 1's steps over the chunk again from its parked state, keeping each
  // layer's (alb[j+1], albdir[j+1], gdiff, gdir); then j = cK .. cK + K -
  // 1: the down sweep's replay (fdir, fdiff) and the up sweep backward;
  // the carry holds the total gradients on (alb[j], albdir[j]), from
  // galb[0] = dfup[0] fdiff[0], galbdir[0]
  float fdir = __ldg(toa + t), fdiff = 0.0f;
  const float dfup_0 = __ldg(dfup + half);
  float ga = dfup_0 * fdiff, gd = dfup_0 * fdir;
  const float* const src2[7] = {R + lay, T + lay, rd + lay, tdd + lay,
                                tdir + lay, dfdiff + half, dfdir + half};
  const float* const hsrc[1] = {dfup + half};
  Chunk<7, K, false> cur, nxt;        // levels cK + u
  Chunk<1, K + 1, false> hcur, hnxt;  // dfup at half-levels cK + u
  cur.load(src2, 0, nlev, ng);
  hcur.load(hsrc, 0, nlev + 1, ng);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      nxt.load(src2, (c + 1) * K, nlev, ng);
      hnxt.load(hsrc, (c + 1) * K, nlev + 1, ng);
    }
    Pass1 p;
    p.alb = pk[(4 * c) * NTH];
    p.albdir = pk[(4 * c + 1) * NTH];
    p.gdiff = pk[(4 * c + 2) * NTH];
    p.gdir = pk[(4 * c + 3) * NTH];
    float A1[K], Ad1[K], GF[K], GR[K];
#pragma unroll
    for (int u = K - 1; u >= 0; --u) {
      A1[u] = p.alb;
      Ad1[u] = p.albdir;
      GF[u] = p.gdiff;
      GR[u] = p.gdir;
      if (c * K + u >= nlev) continue;
      p.step(cur.v[0][u], cur.v[1][u], cur.v[2][u], cur.v[3][u],
             cur.v[4][u], hcur.v[0][u], cur.v[5][u], cur.v[6][u]);
    }
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int j = c * K + u;
      if (j >= nlev) break;
      const float Rj = cur.v[0][u], Tj = cur.v[1][u], tddj = cur.v[3][u],
                  tdj = cur.v[4][u], dfup1 = hcur.v[0][u + 1];
      const float A = A1[u], Adir1 = Ad1[u], gdiff = GF[u], gdir = GR[u];
      // the down sweep's replay to half-level j+1
      const float denom = 1.0f - Rj * A;
      const float Kj = tdj * Adir1 * Rj + tddj;
      const float fdiff1 = (Tj * fdiff + fdir * Kj) / denom;
      const float fdir1 = fdir * tdj;
      // the down sweep backward's terms at layer j
      const float dN = gdiff / denom;
      float dTj = dN * fdiff;
      float dtddj = dN * fdir;
      float dtdirj = gdir * fdir + dN * fdir * Adir1 * Rj;
      float dRj = dN * fdir * tdj * Adir1 + gdiff * fdiff1 * A / denom;
      const float galb1 = dfup1 * fdiff1 + gdiff * fdiff1 * Rj / denom;
      const float galbdir1 = dfup1 * fdir1 + dN * fdir * tdj * Rj;
      // the up sweep backward's terms
      const float inv = 1.0f / (1.0f - A * Rj);
      const float M = tdj * Adir1 + tddj * A;
      dtdirj += gd * Adir1 * Tj * inv;
      dtddj += gd * A * Tj * inv;
      dTj += ga * 2.0f * Tj * A * inv + gd * M * inv;
      const float TAinv = Tj * A * inv;
      dRj += ga * (1.0f + TAinv * TAinv) + gd * M * Tj * A * inv * inv;
      const size_t i = lay + static_cast<size_t>(j) * ng;
      drd[i] = gd;
      dtdir[i] = dtdirj;
      dtdd[i] = dtddj;
      dT[i] = dTj;
      dR[i] = dRj;
      const float Tinv = Tj * inv;
      const float gA1 = ga * Tj * Tinv * inv
                        + gd * (tddj * Tinv + M * Tinv * Rj * inv);
      const float gAdir1 = gd * tdj * Tinv;
      ga = gA1 + galb1;
      gd = gAdir1 + galbdir1;
      fdiff = fdiff1;
      fdir = fdir1;
    }
    cur = nxt;
    hcur = hnxt;
  }
  dad[t] = ga;
  dadir[t] = gd;
}

__global__ void __launch_bounds__(NTH_SCRATCH) adding_sw_bwd_scratch_kernel(
    const float* __restrict__ toa, const float* __restrict__ ad,
    const float* __restrict__ adir, const float* __restrict__ R,
    const float* __restrict__ T, const float* __restrict__ rd,
    const float* __restrict__ tdd, const float* __restrict__ tdir,
    const float* __restrict__ dfup, const float* __restrict__ dfdiff,
    const float* __restrict__ dfdir, float* __restrict__ dtoa,
    float* __restrict__ dad, float* __restrict__ dadir, float* dR,
    float* dT, float* __restrict__ drd, float* dtdd, float* dtdir,
    float* scr, int B, int nlev, int ng) {
  const long long t =
      static_cast<long long>(blockIdx.x) * NTH_SCRATCH + threadIdx.x;
  if (t >= static_cast<long long>(B) * ng) return;
  const long long b = t / ng;
  const int g = static_cast<int>(t % ng);
  const size_t lay = static_cast<size_t>(b) * nlev * ng + g;     // + j ng
  const size_t half = static_cast<size_t>(b) * (nlev + 1) * ng + g;
  const size_t plane = static_cast<size_t>(B) * (nlev + 1) * ng;
  float* albs = scr + half;                 // alb[j] at albs[j ng]
  float* albdirs = albs + plane;
  float* fdiffs = albdirs + plane;          // fdiff[j], then galb[j]
  float* fdirs = fdiffs + plane;            // fdir[j], then galbdir[j]
  const float* dfup_h = dfup + half;
  const float* dfdiff_h = dfdiff + half;
  const float* dfdir_h = dfdir + half;
  const size_t N = static_cast<size_t>(nlev) * ng;

  // ---- replay the up sweep
  float alb = __ldg(ad + t), albdir = __ldg(adir + t);
  albs[N] = alb;
  albdirs[N] = albdir;
  for (int j = nlev - 1; j >= 0; --j) {
    const size_t i = lay + static_cast<size_t>(j) * ng;
    const float Rj = __ldg(R + i), Tj = __ldg(T + i);
    const float inv = 1.0f / (1.0f - alb * Rj);
    albdir = __ldg(rd + i) + (__ldg(tdir + i) * albdir
                              + __ldg(tdd + i) * alb) * Tj * inv;
    alb = Rj + Tj * Tj * alb * inv;
    albs[j * ng] = alb;
    albdirs[j * ng] = albdir;
  }

  // ---- replay the down sweep
  float fdir = __ldg(toa + t), fdiff = 0.0f;
  fdirs[0] = fdir;
  fdiffs[0] = fdiff;
  for (int j = 0; j < nlev; ++j) {
    const size_t i = lay + static_cast<size_t>(j) * ng;
    const size_t o1 = static_cast<size_t>(j + 1) * ng;
    const float Rj = __ldg(R + i), Tj = __ldg(T + i), tdj = __ldg(tdir + i);
    fdiff = (Tj * fdiff + fdir * (tdj * albdirs[o1] * Rj + __ldg(tdd + i)))
            / (1.0f - Rj * albs[o1]);
    fdir = fdir * tdj;
    fdiffs[o1] = fdiff;
    fdirs[o1] = fdir;
  }

  // ---- down sweep backward; the carry holds the total gradients on
  // (fdir[j+1], fdiff[j+1])
  float gdir = __ldg(dfdir_h + N) + __ldg(dfup_h + N) * albdirs[N];
  float gdiff = __ldg(dfdiff_h + N) + __ldg(dfup_h + N) * albs[N];
  for (int j = nlev - 1; j >= 0; --j) {
    const size_t i = lay + static_cast<size_t>(j) * ng;
    const size_t o = static_cast<size_t>(j) * ng, o1 = o + ng;
    const float Rj = __ldg(R + i), Tj = __ldg(T + i), tdj = __ldg(tdir + i),
                tddj = __ldg(tdd + i);
    const float alb1 = albs[o1], adir1 = albdirs[o1];
    const float denom = 1.0f - Rj * alb1;
    const float fdirj = fdirs[o], fdiffj = fdiffs[o], fdiff1 = fdiffs[o1];
    const float fdir1 = fdirj * tdj;
    const float K = tdj * adir1 * Rj + tddj;
    const float dN = gdiff / denom;
    dT[i] = dN * fdiffj;
    dtdd[i] = dN * fdirj;
    dtdir[i] = gdir * fdirj + dN * fdirj * adir1 * Rj;
    dR[i] = dN * fdirj * tdj * adir1 + gdiff * fdiff1 * alb1 / denom;
    // galb[j+1] and galbdir[j+1] are complete after this step
    const float dfup1 = __ldg(dfup_h + o1);
    fdiffs[o1] = dfup1 * fdiff1 + gdiff * fdiff1 * Rj / denom;
    fdirs[o1] = dfup1 * fdir1 + dN * fdirj * tdj * Rj;
    const float dfup0 = __ldg(dfup_h + o);
    const float gdir_next = gdir * tdj + dN * K + __ldg(dfdir_h + o)
                            + dfup0 * albdirs[o];
    gdiff = dN * Tj + __ldg(dfdiff_h + o) + dfup0 * albs[o];
    gdir = gdir_next;
  }
  dtoa[t] = gdir;

  // ---- up sweep backward; the carry holds the total gradients on
  // (alb[j], albdir[j]), from galb[0] = dfup[0] fdiff[0], galbdir[0]
  float ga = __ldg(dfup_h) * fdiffs[0], gd = __ldg(dfup_h) * fdirs[0];
  for (int j = 0; j < nlev; ++j) {
    const size_t i = lay + static_cast<size_t>(j) * ng;
    const size_t o1 = static_cast<size_t>(j + 1) * ng;
    const float Rj = __ldg(R + i), Tj = __ldg(T + i), tdj = __ldg(tdir + i),
                tddj = __ldg(tdd + i);
    const float A1 = albs[o1], Adir1 = albdirs[o1];
    const float inv = 1.0f / (1.0f - A1 * Rj);
    const float M = tdj * Adir1 + tddj * A1;
    drd[i] = gd;
    dtdir[i] += gd * Adir1 * Tj * inv;
    dtdd[i] += gd * A1 * Tj * inv;
    dT[i] += ga * 2.0f * Tj * A1 * inv + gd * M * inv;
    const float TAinv = Tj * A1 * inv;
    dR[i] += ga * (1.0f + TAinv * TAinv) + gd * M * Tj * A1 * inv * inv;
    const float Tinv = Tj * inv;
    const float gA1 = ga * Tj * Tinv * inv
                      + gd * (tddj * Tinv + M * Tinv * Rj * inv);
    const float gAdir1 = gd * tdj * Tinv;
    ga = gA1 + fdiffs[o1];
    gd = gAdir1 + fdirs[o1];
  }
  dad[t] = ga;
  dadir[t] = gd;
}

}  // namespace

// Every array f32 and contiguous: toa, ad, adir [B, ng]; R, T, rd, tdd,
// tdir [B, nlev, ng]; the cotangents dfup, dfdiff, dfdir [B, nlev+1, ng];
// the gradients dtoa, dad, dadir [B, ng] and dR, dT, drd, dtdd, dtdir
// [B, nlev, ng]. Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue where the parked chunks of a block, 512 bytes for
// each K levels, exceed its shared memory: nlev above 1,816).
extern "C" int adding_sw_bwd(const void* toa, const void* ad,
                             const void* adir, const void* R, const void* T,
                             const void* rd, const void* tdd,
                             const void* tdir, const void* dfup,
                             const void* dfdiff, const void* dfdir,
                             void* dtoa, void* dad, void* dadir, void* dR,
                             void* dT, void* drd, void* dtdd, void* dtdir,
                             int B, int nlev, int ng, void* stream) {
  const long long n = static_cast<long long>(B) * ng;
  if (n == 0) return 0;
  const size_t smem =
      sizeof(float) * 4 * static_cast<size_t>((nlev + K - 1) / K) * NTH;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      adding_sw_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((n + NTH - 1) / NTH);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  adding_sw_bwd_kernel<<<blocks, NTH, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      f(toa), f(ad), f(adir), f(R), f(T), f(rd), f(tdd), f(tdir), f(dfup),
      f(dfdiff), f(dfdir), w(dtoa), w(dad), w(dadir), w(dR), w(dT), w(drd),
      w(dtdd), w(dtdir), B, nlev, ng);
  return static_cast<int>(cudaGetLastError());
}

// The first design, kept to time it against this one; no wrapper selects
// it. Every array f32 and contiguous: toa, ad, adir [B, ng]; R, T, rd,
// tdd, tdir [B, nlev, ng]; the cotangents dfup, dfdiff, dfdir [B, nlev+1, ng];
// the gradients dtoa, dad, dadir [B, ng] and dR, dT, drd, dtdd, dtdir
// [B, nlev, ng]; scratch [4, B, nlev+1, ng]. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int adding_sw_bwd_scratch(
    const void* toa, const void* ad, const void* adir, const void* R,
    const void* T, const void* rd, const void* tdd, const void* tdir,
    const void* dfup, const void* dfdiff, const void* dfdir, void* dtoa,
    void* dad, void* dadir, void* dR, void* dT, void* drd, void* dtdd,
    void* dtdir, void* scratch, int B, int nlev, int ng, void* stream) {
  const long long n = static_cast<long long>(B) * ng;
  if (n == 0) return 0;
  const int blocks = static_cast<int>((n + NTH_SCRATCH - 1) / NTH_SCRATCH);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  adding_sw_bwd_scratch_kernel<<<blocks, NTH_SCRATCH, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      f(toa), f(ad), f(adir), f(R), f(T), f(rd), f(tdd), f(tdir), f(dfup),
      f(dfdiff), f(dfdir), w(dtoa), w(dad), w(dadir), w(dR), w(dT), w(drd),
      w(dtdd), w(dtdir), w(scratch), B, nlev, ng);
  return static_cast<int>(cudaGetLastError());
}
