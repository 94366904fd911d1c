// SW two-stream adding solver: the up sweep builds the albedos of the
// system below every half-level, the down sweep carries the direct and
// diffuse downwelling fluxes (ecRad-TripleClouds form, with the
// energy-conserving direct-reflection term tdir*albdir*R).
//
// Replaces the TPU kernel climsim_tpu/ops/pallas_radiation.py::
// _adding_sw_kernel (wrapper adding_sw_fused, conservative=True).
//
// Per column b and g-point g (layer arrays [B, nlev, ng], surface arrays
// [B, ng], outputs [B, nlev+1, ng], level 0 = TOA, all f32):
//   alb[nlev] = ad, albdir[nlev] = adir
//   j = nlev-1 .. 0:  inv = 1 / (1 - alb R_j)
//     albdir <- rd_j + (tdir_j albdir + tdd_j alb) T_j inv
//     alb    <- R_j + T_j T_j alb inv
//   fup[0] = toa albdir[0]; fdiff[0] = 0; fdir[0] = toa
//   j = 0 .. nlev-1:
//     fdiff <- (T_j fdiff + fdir (tdir_j albdir[j+1] R_j + tdd_j))
//              / (1 - R_j alb[j+1])
//     fdir  <- fdir tdir_j
//     fup[j+1] = fdir albdir[j+1] + fdiff alb[j+1]
//
// What bounds it on an H100 at the physics model's shapes (B 21,600,
// nlev 60, ng 8): about 20 operations per element against 5 layer and 3
// surface inputs read once and 3 half-level outputs written once, 336 MB,
// 0.10 ms at 3.35 TB/s; the operations take a few microseconds at the f32
// rate. So it is bound by bytes.
//
// The second design (adding_sw_staged, chosen by pallas_radiation.py::
// rad_design): the staged tile of rad_tile.cuh. A persistent CTA copies
// the 5 layer and 3 surface arrays of C whole columns into its stage of
// shared memory with bulk copies; one thread an item runs the up sweep
// out of the stage, parks the 61 albedo pairs in the CTA's replay buffer
// (never in an output), then runs the down sweep and writes each flux
// once, from a register, through __restrict__ pointers. Each input leaves
// device memory once and no load sits in the serial chain. What is left
// in the chain is the arithmetic: the up sweep's reciprocal, and the down
// sweep's division, which becomes a multiplication by that same
// reciprocal (sw_item; a deliberate departure from the plain version's
// operations, ROADMAP's port rules). The stage holds ~14 KB a column at
// (60, 8), so a SM holds few items; several CTAs a SM, each copying while
// the others compute, overlap the copies with the sweeps.
//
// The first design (adding_sw, kept to time the second against it and
// for the shapes the stage does not take, ng % 4 != 0 or unaligned
// tensors): one thread walks one (column, g-point) through both sweeps,
// reading the [B, nlev, ng] layout directly (the 32 threads of a warp
// cover 4 columns x 8 g-points, so each level's load is 4 full 32-byte
// sectors). Its 61 albedo pairs are parked in the fdiff/fdir outputs,
// which the down sweep reads back and overwrites; as the outputs are not
// __restrict__, every level costs a round trip to device memory.
#include <cuda_runtime.h>

#include "rad_tile.cuh"

namespace {

constexpr int NTH = 256;

__global__ void __launch_bounds__(NTH) adding_sw_kernel(
    const float* __restrict__ toa, const float* __restrict__ ad,
    const float* __restrict__ adir, const float* __restrict__ R,
    const float* __restrict__ T, const float* __restrict__ rd,
    const float* __restrict__ tdd, const float* __restrict__ tdir,
    float* fup, float* fdiff, float* fdir, int B, int nlev, int ng) {
  const long long t = static_cast<long long>(blockIdx.x) * NTH + threadIdx.x;
  if (t >= static_cast<long long>(B) * ng) return;
  const long long b = t / ng;
  const int g = static_cast<int>(t % ng);
  const size_t lay = static_cast<size_t>(b) * nlev * ng + g;     // + j ng
  const size_t half = static_cast<size_t>(b) * (nlev + 1) * ng + g;

  // ---- up sweep: system albedo below every half-level
  float alb = __ldg(ad + t), albdir = __ldg(adir + t);
  fdiff[half + static_cast<size_t>(nlev) * ng] = alb;
  fdir[half + static_cast<size_t>(nlev) * ng] = albdir;
  for (int j = nlev - 1; j >= 0; --j) {
    const size_t i = lay + static_cast<size_t>(j) * ng;
    const float Rj = __ldg(R + i), Tj = __ldg(T + i);
    const float inv = 1.0f / (1.0f - alb * Rj);
    albdir = __ldg(rd + i) + (__ldg(tdir + i) * albdir
                              + __ldg(tdd + i) * alb) * Tj * inv;
    alb = Rj + Tj * Tj * alb * inv;
    fdiff[half + static_cast<size_t>(j) * ng] = alb;
    fdir[half + static_cast<size_t>(j) * ng] = albdir;
  }

  // ---- down sweep; albdir holds the albedo below half-level 0
  float fdndir = __ldg(toa + t), fdndiff = 0.0f;
  fup[half] = fdndir * albdir;
  fdiff[half] = 0.0f;
  fdir[half] = fdndir;
  for (int j = 0; j < nlev; ++j) {
    const size_t i = lay + static_cast<size_t>(j) * ng;
    const size_t o = half + static_cast<size_t>(j + 1) * ng;
    const float alb1 = fdiff[o], adir1 = fdir[o];
    const float Rj = __ldg(R + i), Tj = __ldg(T + i), tdj = __ldg(tdir + i);
    fdndiff = (Tj * fdndiff + fdndir * (tdj * adir1 * Rj + __ldg(tdd + i)))
              / (1.0f - Rj * alb1);
    fdndir = fdndir * tdj;
    fup[o] = fdndir * adir1 + fdndiff * alb1;
    fdiff[o] = fdndiff;
    fdir[o] = fdndir;
  }
}

// The second design's item t of a tile whose stage is st: column b of the
// arrays, c = t / ng of the tile. Inputs staged: toa, ad, adir (surface),
// R, T, rd, tdd, tdir (layer); the replay rep is [nlev+1][C ng] of
// (alb, albdir). The up sweep leaves in the stage what the down sweep
// needs of each layer beside T and tdir: K_j = tdir_j albdir[j+1] R_j +
// tdd_j over tdd_j, and inv_j = 1 / (1 - alb[j+1] R_j) over R_j. So the
// down sweep's denominator is the up sweep's reciprocal (the plain
// version's 1 / (1 - R_j alb[j+1]), rounded once) and its division a
// multiplication: num inv_j is within 1.5 ulp of num / (1 - R_j alb[j+1]),
// where the division is within 0.5. The division's IEEE slow path, which
// the many zero or tiny fluxes under thick cloud take, set the pace of
// an instance that divided: 0.3179 ms against 0.1512 ms at (21,600, 60, 8)
// on the H100 (PERF.md §6).
__device__ __forceinline__ void sw_item(
    const rad::Geom& G, float* __restrict__ st, float2* __restrict__ rep,
    int t, size_t b, float* __restrict__ fup, float* __restrict__ fdiff,
    float* __restrict__ fdir) {
  const int nlev = G.nlev, ng = G.ng, NT = G.items();
  const int c = t / ng, g = t - c * ng;
  const int o = c * G.str_lay() + g;              // + j ng
  float *R = G.lay(st, 0) + o, *T = G.lay(st, 1) + o, *rd = G.lay(st, 2) + o,
        *tdd = G.lay(st, 3) + o, *tdir = G.lay(st, 4) + o;
  // ---- up sweep: system albedo below every half-level
  float alb = G.sfc(st, 1)[t], albdir = G.sfc(st, 2)[t];
  rep[nlev * NT + t] = make_float2(alb, albdir);
#pragma unroll 4
  for (int j = nlev - 1; j >= 0; --j) {
    const float Rj = R[j * ng], Tj = T[j * ng], tddj = tdd[j * ng],
                tdj = tdir[j * ng];
    const float inv = 1.0f / (1.0f - alb * Rj);
    tdd[j * ng] = tdj * albdir * Rj + tddj;       // K_j
    R[j * ng] = inv;
    albdir = rd[j * ng] + (tdj * albdir + tddj * alb) * Tj * inv;
    alb = Rj + Tj * Tj * alb * inv;
    if (j > 0) rep[j * NT + t] = make_float2(alb, albdir);
  }
  // ---- down sweep; albdir holds the albedo below half-level 0
  const size_t half = b * (nlev + 1) * ng + g;    // + j ng
  float fdndir = G.sfc(st, 0)[t], fdndiff = 0.0f;
  fup[half] = fdndir * albdir;
  fdiff[half] = 0.0f;
  fdir[half] = fdndir;
#pragma unroll 4
  for (int j = 0; j < nlev; ++j) {
    const float2 a1 = rep[(j + 1) * NT + t];      // (alb, albdir)[j+1]
    const float Tj = T[j * ng], tdj = tdir[j * ng];
    fdndiff = (Tj * fdndiff + fdndir * tdd[j * ng]) * R[j * ng];
    fdndir = fdndir * tdj;
    const size_t i = half + static_cast<size_t>(j + 1) * ng;
    fup[i] = fdndir * a1.y + fdndiff * a1.x;
    fdiff[i] = fdndiff;
    fdir[i] = fdndir;
  }
}

// The second design: one thread an item of a tile of C columns, every
// sweep out of the tile's stage.
__global__ void __launch_bounds__(rad::MAX_THREADS) adding_sw_staged_kernel(
    rad::Srcs src, float* __restrict__ fup, float* __restrict__ fdiff,
    float* __restrict__ fdir, int B, int nlev, int ng, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const rad::Geom G{nlev, ng, C, 3, 5, 0};
  const rad::Tile tl(G, smem, B);
  const int t = threadIdx.x;
  tl.start(src);
  for (int k = 0, tile = blockIdx.x; tile < tl.ntiles;
       ++k, tile += gridDim.x) {
    float* st = tl.wait(k);
    if (t < tl.cols(tile) * ng)
      sw_item(G, st, tl.replay, t, static_cast<size_t>(tile) * C + t / ng,
              fup, fdiff, fdir);
    tl.refill(src, tile);
  }
}

}  // namespace

// Every array f32 and contiguous: toa, ad, adir [B, ng]; R, T, rd, tdd,
// tdir [B, nlev, ng]; fup, fdiff, fdir [B, nlev+1, ng]. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int adding_sw(const void* toa, const void* ad, const void* adir,
                         const void* R, const void* T, const void* rd,
                         const void* tdd, const void* tdir, void* fup,
                         void* fdiff, void* fdir, int B, int nlev, int ng,
                         void* stream) {
  const long long n = static_cast<long long>(B) * ng;
  if (n == 0) return 0;
  const int blocks = static_cast<int>((n + NTH - 1) / NTH);
  adding_sw_kernel<<<blocks, NTH, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(toa), static_cast<const float*>(ad),
      static_cast<const float*>(adir), static_cast<const float*>(R),
      static_cast<const float*>(T), static_cast<const float*>(rd),
      static_cast<const float*>(tdd), static_cast<const float*>(tdir),
      static_cast<float*>(fup), static_cast<float*>(fdiff),
      static_cast<float*>(fdir), B, nlev, ng);
  return static_cast<int>(cudaGetLastError());
}

// The second design. The same arrays as adding_sw, then the tile
// geometry: C columns a tile, `blocks` persistent CTAs (from
// pallas_radiation.py::rad_design). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a geometry the stage does not take:
// ng % 4 != 0, or its shared memory past 232,448 bytes).
extern "C" int adding_sw_staged(const void* toa, const void* ad,
                                const void* adir, const void* R,
                                const void* T, const void* rd,
                                const void* tdd, const void* tdir, void* fup,
                                void* fdiff, void* fdir, int B, int nlev,
                                int ng, int C, int blocks, void* stream) {
  if (B == 0) return 0;
  const rad::Geom G{nlev, ng, C, 3, 5, 0};
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  const rad::Srcs src{{f(toa), f(ad), f(adir), f(R), f(T), f(rd), f(tdd),
                       f(tdir)}};
  return rad::launch_staged(adding_sw_staged_kernel, G, blocks,
                            static_cast<cudaStream_t>(stream), src, w(fup),
                            w(fdiff), w(fdir), B, nlev, ng, C);
}

// The shared memory adding_sw_staged asks for at this geometry.
extern "C" long long adding_sw_staged_smem(int nlev, int ng, int C) {
  return static_cast<long long>(rad::Geom{nlev, ng, C, 3, 5, 0}.smem());
}
