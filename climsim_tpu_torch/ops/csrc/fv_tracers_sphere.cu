// Spherical multi-tracer finite-volume transport: for every (tracer,
// level) an MC-limited (van Leer) flux-form step in Courant units, zonal
// sweep (periodic in longitude) then meridional sweep (two clamped ghost
// rows at each pole, cos(phi) face weights, zero flux through the pole
// faces), both in the advective (free-stream-preserving) form.
//
// Replaces the TPU kernel climsim_tpu/ops/pallas_stencil.py::
// _fv_tracers_sphere_kernel (wrapper _fv_sphere_fwd_impl); the numerics
// are those of climsim_tpu/online/advection.py::fv_advect_2d_sphere.
//
// What bounds it on an H100 at the main path's shapes (6 tracers, 60
// levels, 120 x 180, f32): it must read qs, u and v once (41.5 MB) and
// write the result once (31.1 MB): 72.6 MB, 21.7 us at 3.35 TB/s, against
// ~70 flops per element. So it is bound by bytes.
//
// The second design (fv_tracers_sphere_tile, chosen by pallas_stencil.py::
// fv_design): the band tile of fv_tile.cuh in Courant units. A
// persistent CTA copies a band's spans of u, v and every tracer into
// shared memory with bulk copies on one mbarrier, forms the clipped
// Courant numbers once a tile, and its threads, a pair of columns each
// and in groups that share the tracers, stream down the band with both
// sweeps in registers.
//
// The first design (fv_tracers_sphere, kept to time the second against it
// and for the shapes the tile does not take: nlon % 4 != 0 or unaligned
// tensors): one TPU program held a whole level (6 tracers + u + v = 691
// KB) in VMEM, which does not fit one SM. Here a block owns one (band of
// R rows, level) and all tracers: it stages the band plus a 2-row halo on
// each side in shared memory (zonal Courant numbers once, then one tracer
// at a time), so the post-zonal field never goes to device memory and q
// is read about (R + 4) / R times from L2, once from DRAM. 15 bands x 60
// levels = 900 blocks fill the 132 SMs. nvcc contracts a*b+c into FMAs,
// so results differ from the plain PyTorch version by a few ulps.
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

// upwind face value times the Courant number c at the face between the
// cells holding qm (left / below) and q0 (right / above)
__device__ __forceinline__ float face_flux(float c, float qmm, float qm,
                                           float q0, float qp) {
  const float sm = mc_slope(qmm, qm, q0);
  const float s0 = mc_slope(qm, q0, qp);
  return c >= 0.0f ? c * (qm + 0.5f * (1.0f - c) * sm)
                   : c * (q0 - 0.5f * (1.0f + c) * s0);
}

__device__ __forceinline__ float clip(float x, float lim) {
  return fminf(fmaxf(x, -lim), lim);
}

__global__ void __launch_bounds__(NT)
fv_tracers_sphere_kernel(const float* __restrict__ qs,
                         const float* __restrict__ u,
                         const float* __restrict__ v,
                         const float* __restrict__ dtdx,
                         const float* __restrict__ cf_fac,
                         const float* __restrict__ wf,
                         const float* __restrict__ wc,
                         float* __restrict__ out, int ntrac, int L,
                         int nlat, int nlon, float cfl) {
  const int lev = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const int nrow = min(R, nlat - r0);     // interior rows of this band
  const int next = nrow + 4;              // with 2 halo rows each side
  const int tid = threadIdx.x;

  extern __shared__ float sm[];
  float* s_c = sm;                        // [next][nlon] zonal courant
  float* s_q = s_c + (R + 4) * nlon;      // [next][nlon] tracer
  float* s_z = s_q + (R + 4) * nlon;      // [next][nlon] post-zonal

  // extended row rr holds global row r0 - 2 + rr, clamped to the grid
  const size_t plane = static_cast<size_t>(nlat) * nlon;
  for (int e = tid; e < next * nlon; e += NT) {
    const int rr = e / nlon, i = e % nlon;
    const int g = min(max(r0 - 2 + rr, 0), nlat - 1);
    s_c[e] = clip(u[lev * plane + static_cast<size_t>(g) * nlon + i] *
                      dtdx[g], cfl);
  }

  for (int t = 0; t < ntrac; ++t) {
    const float* q = qs + (static_cast<size_t>(t) * L + lev) * plane;
    for (int e = tid; e < next * nlon; e += NT) {
      const int rr = e / nlon, i = e % nlon;
      const int g = min(max(r0 - 2 + rr, 0), nlat - 1);
      s_q[e] = q[static_cast<size_t>(g) * nlon + i];
    }
    __syncthreads();

    // zonal sweep on every extended row (periodic in longitude)
    for (int e = tid; e < next * nlon; e += NT) {
      const int rr = e / nlon, i = e % nlon;
      const float* qr = s_q + rr * nlon;
      const float* cr = s_c + rr * nlon;
      const int im2 = (i + nlon - 2) % nlon, im1 = (i + nlon - 1) % nlon;
      const int ip1 = (i + 1) % nlon, ip2 = (i + 2) % nlon;
      const float f0 = face_flux(cr[i], qr[im2], qr[im1], qr[i], qr[ip1]);
      const float f1 = face_flux(cr[ip1], qr[im1], qr[i], qr[ip1], qr[ip2]);
      s_z[e] = qr[i] - ((f1 - f0) - qr[i] * (cr[ip1] - cr[i]));
    }
    __syncthreads();

    // meridional sweep on the interior rows; face f lies between rows
    // f-1 and f and takes the velocity of row min(f, nlat-1)
    float* o = out + (static_cast<size_t>(t) * L + lev) * plane;
    for (int e = tid; e < nrow * nlon; e += NT) {
      const int jj = e / nlon, i = e % nlon;
      const int j = r0 + jj;
      const float* z = s_z + i;           // column i of the band
      float fl[2], fc[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int f = j + s;              // global face index
        const int rr = jj + s;            // extended row of f - 2
        const float vf =
            v[lev * plane + static_cast<size_t>(min(f, nlat - 1)) * nlon + i];
        const float c = clip(vf * cf_fac[f], cfl);
        const float face = face_flux(c, z[rr * nlon], z[(rr + 1) * nlon],
                                     z[(rr + 2) * nlon], z[(rr + 3) * nlon]);
        fl[s] = wf[f] * face;
        fc[s] = wf[f] * c;
      }
      const float qz = z[(jj + 2) * nlon];
      o[static_cast<size_t>(j) * nlon + i] =
          qz - wc[j] * ((fl[1] - fl[0]) - qz * (fc[1] - fc[0]));
    }
    __syncthreads();
  }
}

}  // namespace

// qs [ntrac, L, nlat, nlon], u/v [L, nlat, nlon], dtdx/wc [nlat],
// cf_fac/wf [nlat+1], out like qs; all float32 and contiguous. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fv_tracers_sphere(const void* qs, const void* u,
                                 const void* v, const void* dtdx,
                                 const void* cf_fac, const void* wf,
                                 const void* wc, void* out, int ntrac,
                                 int L, int nlat, int nlon, float cfl,
                                 void* stream) {
  const size_t smem = sizeof(float) * 3 * (R + 4) * static_cast<size_t>(nlon);
  cudaError_t err = cudaFuncSetAttribute(
      fv_tracers_sphere_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nlat + R - 1) / R, L);
  fv_tracers_sphere_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(
      stream)>>>(
      static_cast<const float*>(qs), static_cast<const float*>(u),
      static_cast<const float*>(v), static_cast<const float*>(dtdx),
      static_cast<const float*>(cf_fac), static_cast<const float*>(wf),
      static_cast<const float*>(wc), static_cast<float*>(out), ntrac, L,
      nlat, nlon, cfl);
  return static_cast<int>(cudaGetLastError());
}

// The second design (fv_tracers_sphere_tile): the band tile of
// fv_tile.cuh in Courant units. The arguments as fv_tracers_sphere's, then
// the band's rows R, the CTAs and the thread groups (each taking every
// groups-th tracer), as pallas_stencil.py::fv_design gives them.
extern "C" int fv_tracers_sphere_tile(const void* qs, const void* u,
                                      const void* v, const void* dtdx,
                                      const void* cf_fac, const void* wf,
                                      const void* wc, void* out, int ntrac,
                                      int L, int nlat, int nlon, float cfl,
                                      int R, int blocks, int groups,
                                      void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const fv::Geom G{ntrac, L, nlat, nlon, R, groups};
  const fv::Sphere F{f(dtdx), f(cf_fac), f(wf), f(wc), cfl};
  return fv::launch_tile(f(qs), f(u), f(v), static_cast<float*>(out), G,
                         blocks, static_cast<cudaStream_t>(stream), F);
}

// The shared memory fv_tracers_sphere_tile asks for at this geometry.
extern "C" long long fv_tracers_sphere_tile_smem(int ntrac, int nlon,
                                                 int R) {
  return static_cast<long long>(fv::Geom{ntrac, 1, 1, nlon, R, 1}.smem());
}
