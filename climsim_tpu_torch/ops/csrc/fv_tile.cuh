// The band tile of the second designs of B2 (fv_tracers_sphere.cu), B5
// and B6 (fv_tracers_flat.cu): the MC-limited flux-form FV step, zonal sweep
// (periodic) then meridional sweep (clamped pole ghosts), on one (band of
// R interior rows, level) at a time.
//
// What bounds the step on an H100: each input read once and each output
// written once (B2 at (6, 60, 120, 180): 72.6 MB, 21.7 us at 3.35 TB/s;
// B6 at (60, 120, 180): 20.7 MB, 6.2 us). But the limiter costs
// instruction slots too: a zonal cell takes two face fluxes of two MC
// slopes each, a third of the instructions on the half-rate ALU pipe
// (compares, selects, min/max), over the band's R+4 rows; the first
// measurements of this tile (PERF.md §6) were held by instruction slots
// and their latency, not by the copies. So the design spends its effort on doing
// each slope and face once and on keeping warps in flight.
//
// Tiles and copies. The rows a band needs, r0-2 .. r0+R+1 clipped to
// [0, nlat), are one contiguous span of a [nlat, nlon] plane, and so are
// the rows r0 .. min(r0+R, nlat-1) whose v its faces take. A persistent
// CTA walks tiles (tile index blockIdx.x + n gridDim.x; tile = lev bands +
// band, so the bands of a level run side by side and share their halo
// rows in L2). Thread 0 copies a tile's u span, v span and every tracer's
// span into the CTA's stage with one cp.async.bulk each, all completing
// on the stage's mbarrier (expect_tx of their bytes). The pole ghost rows
// are not copied: the compute reads row min(max(g, 0), nlat-1). One stage
// a CTA and several CTAs a SM, each copying while the others compute,
// beat a ring of 2-3 stages, which fits fewer CTAs (PERF.md §6).
//
// A thread a pair of columns, sweeps in registers. The threads form
// `groups` groups, group k taking tracers k, k + groups, ...; in a group,
// thread p streams down columns 2p and 2p+1 of the band. The zonal sweep
// of a row reads the pair and the pairs each side of it (float2 loads,
// neighbouring lanes on neighbouring words, the wrapped pair indices
// formed once): 4 slopes and 3 faces for 2 cells. The meridional sweep
// consumes the post-zonal pairs as they come, keeping a window of three
// pairs, two slopes and one face in registers. So no post-zonal field is
// stored anywhere, no barrier separates the sweeps, each clamped pole
// row's zonal sweep runs once, and each meridional slope and face is
// formed once. The outputs leave as coalesced float2 stores.
//
// Flux forms (the template parameter Form): Sphere, Courant units clipped
// at cfl with face weights wf and cell weights wc, whose clipped Courant
// numbers are formed once a tile over the stage's u and v rows (prepare,
// one barrier); Flat, velocity units with constant dt/dx and dt/dy and no
// flux through the pole faces. The arithmetic is the plain version's, in
// its order (online/advection.py); nvcc contracts a*b+c into FMAs, as in
// the first designs; mc_slope and upwind say where an operation is
// written differently with the same value.
//
// Layout of the dynamic shared memory: BAR_BYTES for the mbarrier, then
// the stage of stage_floats(): u's R+4 rows (global row g at row
// g - r0 + 2), v's R+1 rows (face f at row f - r0), then each tracer's
// R+4 rows (as u's). The host's copy of smem() is
// pallas_stencil.py::fv_tile_smem; each tile source exports this one
// (<entry>_smem) so the two can be compared on the card.
#pragma once
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "bulk_copy.cuh"

namespace fv {

constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block
constexpr int BAR_BYTES = 128;     // the mbarrier, padded to a 128-byte line
constexpr int MAX_THREADS = 512;

// monotonized-central slope limiter (jnp.sign semantics: sign(0) = 0).
// Where the limiter keeps the slope (dqp dqm > 0), qp - qm is nonzero and
// has dqc's sign, so sign(dqc) mag is copysignf(mag, dqc): one bit
// operation in place of two comparisons, two selects and a product.
__device__ __forceinline__ float mc_slope(float qm, float q0, float qp) {
  const float dqc = 0.5f * (qp - qm);
  const float dqp = qp - q0;
  const float dqm = q0 - qm;
  const float mag = fminf(fabsf(dqc), 2.0f * fminf(fabsf(dqp), fabsf(dqm)));
  return dqp * dqm > 0.0f ? copysignf(mag, dqc) : 0.0f;
}

// upwind face value times the face speed w (c: its Courant number) at the
// face between the cells holding qm (slope sm) and q0 (slope s0):
// w >= 0 ? w (qm + 0.5 (1 - c) sm) : w (q0 - 0.5 (1 + c) s0), with the
// operands selected first (1 - c = 1 + (-c), and q0 - x s0 = q0 + x (-s0)
// exactly), so one branch is computed, not two
__device__ __forceinline__ float upwind(float w, float c, float qm, float q0,
                                        float sm, float s0) {
  const bool pos = w >= 0.0f;
  const float k = 0.5f * (1.0f + (pos ? -c : c));
  return w * ((pos ? qm : q0) + k * (pos ? sm : -s0));
}

__device__ __forceinline__ float clip(float x, float lim) {
  return fminf(fmaxf(x, -lim), lim);
}

struct Geom {
  int ntrac, L, nlat, nlon, R, groups;
  __host__ __device__ int bands() const { return (nlat + R - 1) / R; }
  __host__ __device__ int tiles() const { return bands() * L; }
  __host__ __device__ size_t stage_floats() const {
    return static_cast<size_t>(nlon) * ((R + 4) * (1 + ntrac) + R + 1);
  }
  __host__ __device__ size_t smem() const {
    return BAR_BYTES + sizeof(float) * stage_floats();
  }
  // threads of a group: one a pair of columns, in passes of at most
  // MAX_THREADS, rounded up to warps
  __host__ __device__ int group_threads() const {
    const int pairs = nlon / 2;
    const int passes = (pairs + MAX_THREADS - 1) / MAX_THREADS;
    return ((pairs + passes - 1) / passes + 31) / 32 * 32;
  }
  __host__ __device__ int threads() const { return groups * group_threads(); }
};

// the rows of tile `tile`: level, first interior row r0 and count nrow,
// the copied span lo .. hi of u and the tracers, and v's last row vhi
struct Band {
  int lev, r0, nrow, lo, hi, vhi;
  __device__ Band(const Geom& G, int tile) {
    const int nb = G.bands();
    lev = tile / nb;
    r0 = (tile - lev * nb) * G.R;
    nrow = min(G.R, G.nlat - r0);
    lo = max(r0 - 2, 0);
    hi = min(r0 + nrow + 1, G.nlat - 1);
    vhi = min(r0 + nrow, G.nlat - 1);
  }
};

// Thread 0: the bulk copies of tile `tile` into the stage `st`, on `bar`.
__device__ __forceinline__ void copy_tile(const Geom& G, const float* qs,
                                          const float* u, const float* v,
                                          float* st, uint64_t* bar,
                                          int tile) {
  const Band b(G, tile);
  const size_t plane = static_cast<size_t>(G.nlat) * G.nlon;
  const unsigned row = 4u * G.nlon;
  const unsigned span = (b.hi - b.lo + 1) * row;
  const unsigned vspan = (b.vhi - b.r0 + 1) * row;
  bulk::mbar_expect_tx(bar, (1 + G.ntrac) * span + vspan);
  const size_t off = b.lev * plane + static_cast<size_t>(b.lo) * G.nlon;
  const size_t lo_row = b.lo - b.r0 + 2;     // stage row of global row lo
  bulk::bulk_g2s(st + lo_row * G.nlon, u + off, span, bar);
  bulk::bulk_g2s(st + static_cast<size_t>(G.R + 4) * G.nlon,
                 v + b.lev * plane + static_cast<size_t>(b.r0) * G.nlon,
                 vspan, bar);
  for (int t = 0; t < G.ntrac; ++t)
    bulk::bulk_g2s(st + ((G.R + 4) * (1 + static_cast<size_t>(t)) + G.R
                         + 1 + lo_row) * G.nlon,
                   qs + static_cast<size_t>(t) * G.L * plane + off, span,
                   bar);
}

// Courant units: c = clip(u dtdx[g], cfl) zonally, clip(v[min(f, nlat-1)]
// cf_fac[f], cfl) at meridional face f, fluxes weighted by wf[f] and the
// update by wc[j].
struct Sphere {
  const float* __restrict__ dtdx;
  const float* __restrict__ cf_fac;
  const float* __restrict__ wf;
  const float* __restrict__ wc;
  float cfl;
  static constexpr bool kPrepare = true;

  // Column i of the stage's u rows becomes the clipped zonal Courant
  // numbers, and v's rows those of the band's faces r0 .. r0+nrow, in
  // descending order, so the north pole face (f = nlat) reads row nlat-1's
  // v before face nlat-1 overwrites it.
  __device__ void prepare(float* su, float* sv, const Band& b, int nlat,
                          int nlon, int i) const {
    for (int g = b.lo; g <= b.hi; ++g) {
      float* p = su + static_cast<size_t>(g - b.r0 + 2) * nlon + i;
      *p = clip(*p * __ldg(dtdx + g), cfl);
    }
    for (int s = b.nrow; s >= 0; --s) {
      const int f = b.r0 + s;
      const float w = sv[static_cast<size_t>(min(f, nlat - 1) - b.r0) * nlon
                         + i];
      sv[static_cast<size_t>(s) * nlon + i] = clip(w * __ldg(cf_fac + f),
                                                   cfl);
    }
  }
  __device__ float zonal_flux(float c, float qm, float q0, float sm,
                              float s0) const {
    return upwind(c, c, qm, q0, sm, s0);
  }
  __device__ float zonal_update(float q, float f0, float f1, float c0,
                                float c1) const {
    return q - ((f1 - f0) - q * (c1 - c0));
  }
  // v's stage row of face f
  __device__ int face_row(int f, int) const { return f; }
  // the face's weight, read once for the thread's pair
  __device__ float face_weight(int f) const { return __ldg(wf + f); }
  // (flux, constant-field flux) through face f of weight k
  __device__ float2 merid_face(int, float k, float c, float qm, float q0,
                               float sm, float s0) const {
    const float face = upwind(c, c, qm, q0, sm, s0);
    return make_float2(k * face, k * c);
  }
  __device__ float cell_weight(int j) const { return __ldg(wc + j); }
  __device__ float merid_update(float k, float q, float2 a, float2 b) const {
    return q - k * ((b.x - a.x) - q * (b.y - a.y));
  }
};

// Velocity units with constant dt/dx, dt/dy; no flux through the pole
// faces f = 0 and f = nlat.
struct Flat {
  float dt_dx, dt_dy;
  int nlat;
  static constexpr bool kPrepare = false;

  __device__ void prepare(float*, float*, const Band&, int, int, int) const {}
  __device__ float zonal_flux(float w, float qm, float q0, float sm,
                              float s0) const {
    return upwind(w, w * dt_dx, qm, q0, sm, s0);
  }
  __device__ float zonal_update(float q, float f0, float f1, float w0,
                                float w1) const {
    return q - dt_dx * ((f1 - f0) - q * (w1 - w0));
  }
  __device__ int face_row(int f, int n) const { return min(f, n - 1); }
  __device__ float face_weight(int) const { return 0.0f; }
  __device__ float2 merid_face(int f, float, float w, float qm, float q0,
                               float sm, float s0) const {
    const bool pole = f == 0 || f == nlat;
    return pole ? make_float2(0.0f, 0.0f)
                : make_float2(upwind(w, w * dt_dy, qm, q0, sm, s0), w);
  }
  __device__ float cell_weight(int) const { return dt_dy; }
  __device__ float merid_update(float k, float q, float2 a, float2 b) const {
    return q - k * ((b.x - a.x) - q * (b.y - a.y));
  }
};

__device__ __forceinline__ float2 pair(const float* row, int p) {
  return reinterpret_cast<const float2*>(row)[p];
}

__device__ __forceinline__ float2 slopes(float2 a, float2 b, float2 c) {
  return make_float2(mc_slope(a.x, b.x, c.x), mc_slope(a.y, b.y, c.y));
}

// The zonal sweep of one stage row (tracer q, speeds w) at columns 2p and
// 2p+1, from the pair and its wrapped neighbours pl and pr: the slopes of
// cells 2p-1 .. 2p+2 and the fluxes of faces 2p .. 2p+2, each once.
template <class Form>
__device__ __forceinline__ float2 zonal_pair(const Form& F, const float* q,
                                             const float* w, int p, int pl,
                                             int pr) {
  const float2 l = pair(q, pl), c = pair(q, p), r = pair(q, pr);
  const float2 wc = pair(w, p);
  const float wr = w[2 * pr];
  const float sl = mc_slope(l.x, l.y, c.x);    // cell 2p-1
  const float sa = mc_slope(l.y, c.x, c.y);    // cell 2p
  const float sb = mc_slope(c.x, c.y, r.x);    // cell 2p+1
  const float sr = mc_slope(c.y, r.x, r.y);    // cell 2p+2
  const float fa = F.zonal_flux(wc.x, l.y, c.x, sl, sa);    // face 2p
  const float fb = F.zonal_flux(wc.y, c.x, c.y, sa, sb);    // face 2p+1
  const float fr = F.zonal_flux(wr, c.y, r.x, sb, sr);      // face 2p+2
  return make_float2(F.zonal_update(c.x, fa, fb, wc.x, wc.y),
                     F.zonal_update(c.y, fb, fr, wc.y, wr));
}

// One tracer of band b at the thread's columns 2p and 2p+1: stream rows
// r0-2 .. r0+nrow+1 (each clamped row's zonal sweep once) and write the
// band's output rows to o.
template <class Form>
__device__ __forceinline__ void column_pair(const Form& F,
                                            const float* __restrict__ sq,
                                            const float* __restrict__ su,
                                            const float* __restrict__ sv,
                                            float* __restrict__ o,
                                            const Band& b, int nlat,
                                            int nlon, int p) {
  const int pairs = nlon / 2;
  const int pl = p == 0 ? pairs - 1 : p - 1;
  const int pr = p == pairs - 1 ? 0 : p + 1;
  const int base = 2 - b.r0;    // stage row of global row g: g + base
  auto zonal = [&](int g) {
    const size_t row = static_cast<size_t>(g + base) * nlon;
    return zonal_pair(F, sq + row, su + row, p, pl, pr);
  };
  // (flux, constant-field flux) through face f at columns 2p, 2p+1
  auto face = [&](int f, float2 qm, float2 q0, float2 sm, float2 s0,
                  float2* out) {
    const float2 w = pair(sv + static_cast<size_t>(F.face_row(f, nlat)
                                                   - b.r0) * nlon, p);
    const float k = F.face_weight(f);
    out[0] = F.merid_face(f, k, w.x, qm.x, q0.x, sm.x, s0.x);
    out[1] = F.merid_face(f, k, w.y, qm.y, q0.y, sm.y, s0.y);
  };
  const int r0 = b.r0;
  // post-zonal rows r0-2 .. r0+1 (clamped), the slopes of rows r0-1 and
  // r0, and face r0 (between rows r0-1 and r0)
  float2 zc = zonal(r0);
  const float2 zb = r0 >= 1 ? zonal(r0 - 1) : zc;
  const float2 za = r0 >= 2 ? zonal(r0 - 2) : zb;
  float2 zd = r0 + 1 < nlat ? zonal(r0 + 1) : zc;
  const float2 sb = slopes(za, zb, zc);
  float2 sc = slopes(zb, zc, zd);
  float2 fa[2], fb[2];
  face(r0, zb, zc, sb, sc, fa);
  // row j: zc = z[j], zd = z[j+1], sc = slope[j], fa = face j
  for (int j = r0; j < r0 + b.nrow; ++j) {
    const float2 ze = j + 2 < nlat ? zonal(j + 2) : zd;
    const float2 sd = slopes(zc, zd, ze);
    face(j + 1, zc, zd, sc, sd, fb);
    const float k = F.cell_weight(j);
    reinterpret_cast<float2*>(o + static_cast<size_t>(j) * nlon)[p] =
        make_float2(F.merid_update(k, zc.x, fa[0], fb[0]),
                    F.merid_update(k, zc.y, fa[1], fb[1]));
    fa[0] = fb[0];
    fa[1] = fb[1];
    zc = zd;
    zd = ze;
    sc = sd;
  }
}

// Every tile of G, each CTA walking tiles blockIdx.x + n gridDim.x; its
// threads form G.groups groups of G.group_threads(), group k taking
// tracers k, k + groups, ...
template <class Form>
__global__ void __launch_bounds__(MAX_THREADS)
fv_tile_kernel(const float* __restrict__ qs, const float* __restrict__ u,
               const float* __restrict__ v, float* __restrict__ out, Geom G,
               Form F) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* su = reinterpret_cast<float*>(smem + BAR_BYTES);
  const int nlon = G.nlon, ntiles = G.tiles(), pairs = nlon / 2;
  float* sv = su + static_cast<size_t>(G.R + 4) * nlon;
  const size_t plane = static_cast<size_t>(G.nlat) * nlon;
  const int tpg = G.group_threads();
  const int grp = threadIdx.x / tpg, lane = threadIdx.x - grp * tpg;
  if (threadIdx.x == 0) {
    bulk::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x < ntiles)
    copy_tile(G, qs, u, v, su, bar, blockIdx.x);
  for (int n = 0, tile = blockIdx.x; tile < ntiles;
       ++n, tile += gridDim.x) {
    bulk::mbar_wait(bar, n & 1);
    const Band b(G, tile);
    if constexpr (Form::kPrepare) {
      for (int i = threadIdx.x; i < nlon; i += blockDim.x)
        F.prepare(su, sv, b, G.nlat, nlon, i);
      __syncthreads();
    }
    for (int t = grp; t < G.ntrac; t += G.groups) {
      const float* sq = sv + static_cast<size_t>(G.R + 1 + t * (G.R + 4))
                        * nlon;
      float* o = out + (static_cast<size_t>(t) * G.L + b.lev) * plane;
      for (int p = lane; p < pairs; p += tpg)
        column_pair(F, sq, su, sv, o, b, G.nlat, nlon, p);
    }
    // refill the stage with this CTA's next tile, once every thread is
    // done with it (the proxy fence orders the threads' accesses to the
    // stage before the bulk copy's writes)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const int next = tile + gridDim.x;
    if (threadIdx.x == 0 && next < ntiles)
      copy_tile(G, qs, u, v, su, bar, next);
  }
}

// Launch the tile kernel of form F at geometry G on `blocks` CTAs.
// Returns a cudaError_t.
template <class Form>
int launch_tile(const float* qs, const float* u, const float* v, float* out,
                const Geom& G, int blocks, cudaStream_t stream,
                const Form& F) {
  const size_t smem = G.smem();
  if (G.nlon % 4 != 0 || G.R < 1 || G.ntrac < 1 || G.L < 1 || G.nlat < 1
      || G.groups < 1 || G.threads() > MAX_THREADS || smem > SMEM_MAX
      || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fv_tile_kernel<Form>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fv_tile_kernel<Form><<<blocks, G.threads(), smem, stream>>>(qs, u, v, out,
                                                              G, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fv
