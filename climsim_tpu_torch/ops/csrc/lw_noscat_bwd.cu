// LW no-scattering solver backward: the gradients of (flux_dn, flux_up)
// with respect to all five inputs.
//
// Replaces the TPU kernel climsim_tpu/ops/pallas_radiation.py::
// _lw_noscat_bwd_kernel (wrapper lw_solver_noscat_bwd_fused).
//
// Per column b and g-point g (layer arrays [B, nlev, ng], surface arrays
// [B, ng], half-level arrays [B, nlev+1, ng], level 0 = TOA, all f32),
// with the forward fdn[j+1] = trans_j fdn[j] + sdn_j (fdn[0] = 0),
// fup[nlev] = emis ssfc + (1 - emis) fdn[nlev], fup[j] = trans_j fup[j+1]
// + sup_j:
//   replay both accumulations;
//   up accumulation backward, j = 0 .. nlev-1, from g = dfup[0]:
//     dsup_j = g;  dtrans_j = g fup[j+1];  g <- dfup[j+1] + g trans_j
//   demis = g (ssfc - fdn[nlev]);  dssfc = g emis
//   down accumulation backward, j = nlev-1 .. 0, from h = dfdn[nlev] +
//     g (1 - emis):  dsdn_j = h;  dtrans_j += h fdn[j];  h <- dfdn[j] + h
//     trans_j  (the gradient on the constant fdn[0] is dropped).
//
// What bounds it on an H100 at the physics model's shapes (B 21,600,
// nlev 60, ng 8): 3 layer and 2 surface inputs and 2 half-level cotangents
// read once (210 MB), 3 layer and 2 surface gradients written once
// (126 MB): 336 MB, 0.100 ms at 3.35 TB/s, against ~8 operations per
// element. So it is bound by bytes.
//
// The four sweeps fold into two passes: the up backward's carry g
// depends on dfup and trans only, not on fup, so it runs ascending beside
// the replay of fdn (pass 1, which writes dsup_j = g_j), and the replay
// of fup runs descending beside the down backward (pass 2, which writes
// dsdn_j = h_j and dtrans_j = g_j fup[j+1] + h_j fdn[j]), each gradient
// written once. Pass 2 needs pass 1's (fdn[j], g_j) at every layer.
//
// The second design (lw_noscat_bwd_staged, chosen by pallas_radiation.py
// ::rad_design): the staged tile of rad_tile.cuh. A persistent CTA copies
// the 3 layer, 2 surface and 2 half-level arrays of C whole columns into
// its stage of shared memory with bulk copies; one thread an item runs
// both passes out of the stage with pass 1's pairs in the CTA's replay
// buffer, so each input leaves device memory once and each gradient is
// written once from a register, through __restrict__ pointers. Several
// CTAs a SM, each copying while the others compute, overlap the copies
// with the passes; what is left is the copies' pace. (B13's two-pass
// register schedule, pass 1 parking (fdn, g) every 4 levels and pass 2
// re-running each chunk from its park, was slower on the H100: PERF.md
// §6.)
//
// The first design (lw_noscat_bwd, kept to time the second against it
// and for the shapes the stage does not take, ng % 4 != 0 or unaligned
// tensors): one thread walks one (column, g-point) through the replay and
// both backward sweeps, four sweeps, on the [B, nlev, ng] layout (a warp
// covers 4 columns x 8 g-points: full 32-byte sectors). The 2 x 61
// replayed fluxes are parked in the outputs, no scratch: fdn[j+1] in
// dsdn_j, which the down backward reads (as fdn[j] from dsdn_{j-1}) before
// it writes dsdn_{j-1}; fup[j+1] in dtrans_j, which the up backward reads
// and overwrites in the same step. Each thread reads back only what it
// wrote itself; the dependent round trips to device memory set its pace.
#include <cuda_runtime.h>

#include "rad_tile.cuh"

namespace {

constexpr int NTH = 256;

__global__ void __launch_bounds__(NTH) lw_noscat_bwd_kernel(
    const float* __restrict__ trans, const float* __restrict__ sdn,
    const float* __restrict__ sup, const float* __restrict__ ssfc,
    const float* __restrict__ emis, const float* __restrict__ dfdn,
    const float* __restrict__ dfup, float* dtrans, float* dsdn,
    float* __restrict__ dsup, float* __restrict__ dssfc,
    float* __restrict__ demis, int B, int nlev, int ng) {
  const long long t = static_cast<long long>(blockIdx.x) * NTH + threadIdx.x;
  if (t >= static_cast<long long>(B) * ng) return;
  const long long b = t / ng;
  const int g = static_cast<int>(t % ng);
  const size_t lay = static_cast<size_t>(b) * nlev * ng + g;     // + j ng
  const size_t half = static_cast<size_t>(b) * (nlev + 1) * ng + g;

  // ---- replay; fdn[j+1] is parked in dsdn_j, fup[j+1] in dtrans_j
  float f = 0.0f;
  for (int j = 0; j < nlev; ++j) {
    const size_t i = lay + static_cast<size_t>(j) * ng;
    f = __ldg(trans + i) * f + __ldg(sdn + i);
    dsdn[i] = f;
  }
  const float e = __ldg(emis + t), s = __ldg(ssfc + t);
  float u = e * s + (1.0f - e) * f;
  for (int j = nlev - 1; j >= 0; --j) {
    const size_t i = lay + static_cast<size_t>(j) * ng;
    dtrans[i] = u;
    u = __ldg(trans + i) * u + __ldg(sup + i);
  }

  // ---- up accumulation backward (ascending)
  float gu = __ldg(dfup + half);
  for (int j = 0; j < nlev; ++j) {
    const size_t i = lay + static_cast<size_t>(j) * ng;
    dsup[i] = gu;
    dtrans[i] = gu * dtrans[i];
    gu = __ldg(dfup + half + static_cast<size_t>(j + 1) * ng)
         + gu * __ldg(trans + i);
  }
  demis[t] = gu * (s - f);
  dssfc[t] = gu * e;

  // ---- down accumulation backward (descending)
  float h = __ldg(dfdn + half + static_cast<size_t>(nlev) * ng)
            + gu * (1.0f - e);
  for (int j = nlev - 1; j >= 0; --j) {
    const size_t i = lay + static_cast<size_t>(j) * ng;
    const float fdn_j = j > 0 ? dsdn[i - ng] : 0.0f;
    dsdn[i] = h;
    dtrans[i] += h * fdn_j;
    h = __ldg(dfdn + half + static_cast<size_t>(j) * ng)
        + h * __ldg(trans + i);
  }
}

// The second design's item t of a tile whose stage is st: column b of the
// arrays, c = t / ng of the tile. Inputs staged: ssfc, emis (surface),
// trans, sdn, sup (layer), dfdn, dfup (half-level); the replay rep is
// [nlev][C ng] of pass 1's (fdn[j], g_j).
__device__ __forceinline__ void lw_bwd_item(
    const rad::Geom& G, const float* __restrict__ st,
    float2* __restrict__ rep, int t, size_t b, float* __restrict__ dtrans,
    float* __restrict__ dsdn, float* __restrict__ dsup,
    float* __restrict__ dssfc, float* __restrict__ demis) {
  const int nlev = G.nlev, ng = G.ng, NT = G.items();
  const int c = t / ng, g = t - c * ng;
  const int o = c * G.str_lay() + g, oh = c * G.str_half() + g;
  const float *trans = G.lay(st, 0) + o, *sdn = G.lay(st, 1) + o,
              *sup = G.lay(st, 2) + o;
  const float *dfdn = G.half(st, 0) + oh, *dfup = G.half(st, 1) + oh;
  const size_t lay = b * nlev * ng + g;           // + j ng
  // ---- pass 1 (ascending): the replay of fdn and the up backward
  float f = 0.0f, gu = dfup[0];
#pragma unroll 4
  for (int j = 0; j < nlev; ++j) {
    rep[j * NT + t] = make_float2(f, gu);
    dsup[lay + static_cast<size_t>(j) * ng] = gu;
    const float tj = trans[j * ng];
    gu = dfup[(j + 1) * ng] + gu * tj;
    f = tj * f + sdn[j * ng];
  }
  const float e = G.sfc(st, 1)[t], s = G.sfc(st, 0)[t];
  demis[b * ng + g] = gu * (s - f);
  dssfc[b * ng + g] = gu * e;
  // ---- pass 2 (descending): the replay of fup and the down backward
  float u = e * s + (1.0f - e) * f;
  float h = dfdn[nlev * ng] + gu * (1.0f - e);
#pragma unroll 4
  for (int j = nlev - 1; j >= 0; --j) {
    const float2 p = rep[j * NT + t];             // (fdn[j], g_j)
    const size_t i = lay + static_cast<size_t>(j) * ng;
    dtrans[i] = p.y * u + h * p.x;
    dsdn[i] = h;
    const float tj = trans[j * ng];
    u = tj * u + sup[j * ng];
    h = dfdn[j * ng] + h * tj;
  }
}

// The second design: one thread an item of a tile of C columns, both
// passes out of the tile's stage.
__global__ void __launch_bounds__(rad::MAX_THREADS)
lw_noscat_bwd_staged_kernel(
    rad::Srcs src, float* __restrict__ dtrans, float* __restrict__ dsdn,
    float* __restrict__ dsup, float* __restrict__ dssfc,
    float* __restrict__ demis, int B, int nlev, int ng, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const rad::Geom G{nlev, ng, C, 2, 3, 2};
  const rad::Tile tl(G, smem, B);
  const int t = threadIdx.x;
  tl.start(src);
  for (int k = 0, tile = blockIdx.x; tile < tl.ntiles;
       ++k, tile += gridDim.x) {
    const float* st = tl.wait(k);
    if (t < tl.cols(tile) * ng)
      lw_bwd_item(G, st, tl.replay, t,
                  static_cast<size_t>(tile) * C + t / ng, dtrans, dsdn, dsup,
                  dssfc, demis);
    tl.refill(src, tile);
  }
}

}  // namespace

// Every array f32 and contiguous: trans, sdn, sup [B, nlev, ng]; ssfc,
// emis [B, ng]; the cotangents dfdn, dfup [B, nlev+1, ng]; the gradients
// dtrans, dsdn, dsup [B, nlev, ng], dssfc, demis [B, ng]. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int lw_noscat_bwd(const void* trans, const void* sdn,
                             const void* sup, const void* ssfc,
                             const void* emis, const void* dfdn,
                             const void* dfup, void* dtrans, void* dsdn,
                             void* dsup, void* dssfc, void* demis, int B,
                             int nlev, int ng, void* stream) {
  const long long n = static_cast<long long>(B) * ng;
  if (n == 0) return 0;
  const int blocks = static_cast<int>((n + NTH - 1) / NTH);
  lw_noscat_bwd_kernel<<<blocks, NTH, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(trans), static_cast<const float*>(sdn),
      static_cast<const float*>(sup), static_cast<const float*>(ssfc),
      static_cast<const float*>(emis), static_cast<const float*>(dfdn),
      static_cast<const float*>(dfup), static_cast<float*>(dtrans),
      static_cast<float*>(dsdn), static_cast<float*>(dsup),
      static_cast<float*>(dssfc), static_cast<float*>(demis), B, nlev, ng);
  return static_cast<int>(cudaGetLastError());
}

// The second design. The same arrays as lw_noscat_bwd, then the tile
// geometry: C columns a tile, `blocks` persistent CTAs (from
// pallas_radiation.py::rad_design). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a geometry the stage does not take:
// ng % 4 != 0, or its shared memory past 232,448 bytes).
extern "C" int lw_noscat_bwd_staged(const void* trans, const void* sdn,
                                    const void* sup, const void* ssfc,
                                    const void* emis, const void* dfdn,
                                    const void* dfup, void* dtrans,
                                    void* dsdn, void* dsup, void* dssfc,
                                    void* demis, int B, int nlev, int ng,
                                    int C, int blocks, void* stream) {
  if (B == 0) return 0;
  const rad::Geom G{nlev, ng, C, 2, 3, 2};
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  const rad::Srcs src{{f(ssfc), f(emis), f(trans), f(sdn), f(sup), f(dfdn),
                       f(dfup)}};
  return rad::launch_staged(lw_noscat_bwd_staged_kernel, G, blocks,
                            static_cast<cudaStream_t>(stream), src,
                            w(dtrans), w(dsdn), w(dsup), w(dssfc), w(demis),
                            B, nlev, ng, C);
}

// The shared memory lw_noscat_bwd_staged asks for at this geometry.
extern "C" long long lw_noscat_bwd_staged_smem(int nlev, int ng, int C) {
  return static_cast<long long>(rad::Geom{nlev, ng, C, 2, 3, 2}.smem());
}
