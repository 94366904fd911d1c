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
// What this design does about it: the recurrences are serial in the
// level and independent across (b, g), so one thread walks one
// (column, g-point) through both sweeps. The TPU wrapper transposed to
// [nlev, ng, B] for its lanes; here the [B, nlev, ng] layout is read
// directly: the 32 threads of a warp cover 4 columns x 8 g-points, so
// each level's load is 4 full 32-byte sectors. The 61 albedo pairs of
// the up sweep are parked in the fdiff/fdir outputs, which the down sweep
// overwrites level by level after reading them; each thread reads back
// only what it wrote itself. No shared memory, no synchronisation.
#include <cuda_runtime.h>

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
