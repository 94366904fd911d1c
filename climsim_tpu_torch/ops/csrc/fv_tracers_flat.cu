// Flat-raster multi-tracer finite-volume transport: for every (tracer,
// level) an MC-limited (van Leer) flux-form step with constant dt/dx and
// dt/dy, zonal sweep (periodic in longitude) then meridional sweep (two
// clamped ghost rows at each pole, zero flux through the pole faces), both
// in the advective (free-stream-preserving) form. Fluxes are in velocity
// units: F = u * q_face, and the update is q - dt_dx ((F_{i+1} - F_i) -
// q (u_{i+1} - u_i)). There is no Courant clip and no metric.
//
// Replaces two TPU kernels of climsim_tpu/ops/pallas_stencil.py that
// compute the same per-field function: _fv_tracers_kernel (wrapper
// _fv_advect_tracers_fwd_impl, all tracers of a level per program) and
// _fv_level_kernel (wrapper fv_advect_levels, one field per level). Here
// both are this kernel, launched through the same entry points: with
// every tracer for B5, with one field (ntrac 1) for B6. The numerics are
// those of climsim_tpu/online/advection.py::fv_advect_2d.
//
// What bounds it on an H100 at the main path's shapes (6 tracers, 60
// levels, 120 x 180, f32): it must read qs, u and v once (41.5 MB) and
// write the result once (31.1 MB): 72.6 MB, 21.7 us at 3.35 TB/s, against
// ~80 flops per element. So it is bound by bytes; one field per level
// (B6) reads u and v once per field, 20.7 MB for a [60, 120, 180] field.
//
// The second design (fv_tracers_flat_tile, chosen by pallas_stencil.py::
// fv_design): the band tile of fv_tile.cuh in velocity units (its Flat
// form). B6 runs it with one field, its u, v and q spans copied at once so
// a tile waits one latency, not three; B5 with every tracer in the tile,
// its threads in tracer groups (at the main shapes 3 groups of 96
// threads, each taking every third tracer), as B2's spherical form does.
// Tracer t of B5 runs the arithmetic B6 runs on that field alone, in the
// same compiled kernel, so the two agree bit for bit.
//
// The first design (fv_tracers_flat): as the spherical kernel's first
// design (fv_tracers_sphere.cu), a block owns one (band of R rows, level)
// and all tracers, stages the band plus a 2-row clamped halo on each side
// in shared memory (the zonal winds once, then one tracer at a time), so
// the post-zonal field never goes to device memory and q is read about
// (R + 4) / R times from L2, once from DRAM. 15 bands x 60 levels = 900
// blocks fill the 132 SMs. nvcc contracts a*b+c into
// FMAs, so results differ from the plain PyTorch version by a few ulps.
#include <cuda_runtime.h>

#include "fv_tile.cuh"

namespace {

constexpr int R = 8;        // interior rows per block
constexpr int NT = 256;     // threads per block

__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}

// monotonized-central slope limiter (jnp.sign semantics: sign(0) = 0)
__device__ __forceinline__ float mc_slope(float qm, float q0, float qp) {
  const float dqc = 0.5f * (qp - qm);
  const float dqp = qp - q0;
  const float dqm = q0 - qm;
  const float mag = fminf(fabsf(dqc), 2.0f * fminf(fabsf(dqp), fabsf(dqm)));
  return dqp * dqm > 0.0f ? sgn(dqc) * mag : 0.0f;
}

// upwind flux in velocity units at the face between the cells holding qm
// (left / below) and q0 (right / above), face velocity w, c = w * dt_d
__device__ __forceinline__ float face_flux(float w, float dt_d, float qmm,
                                           float qm, float q0, float qp) {
  const float c = w * dt_d;
  const float sm = mc_slope(qmm, qm, q0);
  const float s0 = mc_slope(qm, q0, qp);
  return w >= 0.0f ? w * (qm + 0.5f * (1.0f - c) * sm)
                   : w * (q0 - 0.5f * (1.0f + c) * s0);
}

__global__ void __launch_bounds__(NT)
fv_tracers_flat_kernel(const float* __restrict__ qs,
                       const float* __restrict__ u,
                       const float* __restrict__ v, float* __restrict__ out,
                       int ntrac, int L, int nlat, int nlon, float dt_dx,
                       float dt_dy) {
  const int lev = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const int nrow = min(R, nlat - r0);     // interior rows of this band
  const int next = nrow + 4;              // with 2 halo rows each side
  const int tid = threadIdx.x;

  extern __shared__ float sm[];
  float* s_u = sm;                        // [next][nlon] zonal wind
  float* s_q = s_u + (R + 4) * nlon;      // [next][nlon] tracer
  float* s_z = s_q + (R + 4) * nlon;      // [next][nlon] post-zonal

  // extended row rr holds global row r0 - 2 + rr, clamped to the grid
  const size_t plane = static_cast<size_t>(nlat) * nlon;
  for (int e = tid; e < next * nlon; e += NT) {
    const int rr = e / nlon, i = e % nlon;
    const int g = min(max(r0 - 2 + rr, 0), nlat - 1);
    s_u[e] = u[lev * plane + static_cast<size_t>(g) * nlon + i];
  }

  for (int t = 0; t < ntrac; ++t) {
    const float* q = qs + (static_cast<size_t>(t) * L + lev) * plane;
    for (int e = tid; e < next * nlon; e += NT) {
      const int rr = e / nlon, i = e % nlon;
      const int g = min(max(r0 - 2 + rr, 0), nlat - 1);
      s_q[e] = q[static_cast<size_t>(g) * nlon + i];
    }
    __syncthreads();

    // zonal sweep on every extended row (periodic in longitude); u[i] is
    // the velocity at the left face of cell i
    for (int e = tid; e < next * nlon; e += NT) {
      const int rr = e / nlon, i = e % nlon;
      const float* qr = s_q + rr * nlon;
      const float* ur = s_u + rr * nlon;
      const int im2 = (i + nlon - 2) % nlon, im1 = (i + nlon - 1) % nlon;
      const int ip1 = (i + 1) % nlon, ip2 = (i + 2) % nlon;
      const float f0 =
          face_flux(ur[i], dt_dx, qr[im2], qr[im1], qr[i], qr[ip1]);
      const float f1 =
          face_flux(ur[ip1], dt_dx, qr[im1], qr[i], qr[ip1], qr[ip2]);
      s_z[e] = qr[i] - dt_dx * ((f1 - f0) - qr[i] * (ur[ip1] - ur[i]));
    }
    __syncthreads();

    // meridional sweep on the interior rows; face f lies between rows f-1
    // and f, takes the velocity of row min(f, nlat-1), and carries no flux
    // at the poles (f = 0 and f = nlat)
    float* o = out + (static_cast<size_t>(t) * L + lev) * plane;
    for (int e = tid; e < nrow * nlon; e += NT) {
      const int jj = e / nlon, i = e % nlon;
      const int j = r0 + jj;
      const float* z = s_z + i;           // column i of the band
      float fl[2], fv[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int f = j + s;              // global face index
        const int rr = jj + s;            // extended row of f - 2
        const bool pole = f == 0 || f == nlat;
        const float vf =
            v[lev * plane + static_cast<size_t>(min(f, nlat - 1)) * nlon + i];
        fl[s] = pole ? 0.0f
                     : face_flux(vf, dt_dy, z[rr * nlon], z[(rr + 1) * nlon],
                                 z[(rr + 2) * nlon], z[(rr + 3) * nlon]);
        fv[s] = pole ? 0.0f : vf;
      }
      const float qz = z[(jj + 2) * nlon];
      o[static_cast<size_t>(j) * nlon + i] =
          qz - dt_dy * ((fl[1] - fl[0]) - qz * (fv[1] - fv[0]));
    }
    __syncthreads();
  }
}

int launch(const void* qs, const void* u, const void* v, void* out,
           int ntrac, int L, int nlat, int nlon, float dt_dx, float dt_dy,
           void* stream) {
  const size_t smem = sizeof(float) * 3 * (R + 4) * static_cast<size_t>(nlon);
  cudaError_t err = cudaFuncSetAttribute(
      fv_tracers_flat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nlat + R - 1) / R, L);
  fv_tracers_flat_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(
      stream)>>>(static_cast<const float*>(qs), static_cast<const float*>(u),
                 static_cast<const float*>(v), static_cast<float*>(out),
                 ntrac, L, nlat, nlon, dt_dx, dt_dy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qs [ntrac, L, nlat, nlon] (B6: ntrac 1), u/v [L, nlat, nlon], out like
// qs; all float32 and contiguous. Returns the cudaError_t of the launch (0
// on success).
extern "C" int fv_tracers_flat(const void* qs, const void* u, const void* v,
                               void* out, int ntrac, int L, int nlat,
                               int nlon, float dt_dx, float dt_dy,
                               void* stream) {
  return launch(qs, u, v, out, ntrac, L, nlat, nlon, dt_dx, dt_dy, stream);
}

// The second design (fv_tracers_flat_tile): the band tile of fv_tile.cuh
// in velocity units, every tracer in the tile. The arguments as
// fv_tracers_flat's, then the band's rows R, the tracer groups and the
// CTAs, as pallas_stencil.py::fv_design gives them.
extern "C" int fv_tracers_flat_tile(const void* qs, const void* u,
                                    const void* v, void* out, int ntrac,
                                    int L, int nlat, int nlon, float dt_dx,
                                    float dt_dy, int R, int groups,
                                    int blocks, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const fv::Geom G{ntrac, L, nlat, nlon, R, groups};
  const fv::Flat F{dt_dx, dt_dy, nlat};
  return fv::launch_tile(f(qs), f(u), f(v), static_cast<float*>(out), G,
                         blocks, static_cast<cudaStream_t>(stream), F);
}

// The shared memory fv_tracers_flat_tile asks for at this geometry.
extern "C" long long fv_tracers_flat_tile_smem(int ntrac, int nlon, int R) {
  return static_cast<long long>(fv::Geom{ntrac, 1, 1, nlon, R, 1}.smem());
}
