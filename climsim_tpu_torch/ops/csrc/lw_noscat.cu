// LW no-scattering solver: downward accumulation, surface reflection,
// upward accumulation.
//
// Replaces the TPU kernel climsim_tpu/ops/pallas_radiation.py::
// _lw_noscat_kernel (wrapper lw_solver_noscat_fused).
//
// Per column b and g-point g (layer arrays [B, nlev, ng], surface arrays
// [B, ng], outputs [B, nlev+1, ng], level 0 = TOA, all f32):
//   fdn[0] = 0;  j = 0 .. nlev-1:  fdn[j+1] = trans_j fdn[j] + sdn_j
//   fup[nlev] = emis ssfc + (1 - emis) fdn[nlev]
//   j = nlev-1 .. 0:  fup[j] = trans_j fup[j+1] + sup_j
//
// What bounds it on an H100 at the physics model's shapes (B 21,600,
// nlev 60, ng 8): 3 layer and 2 surface inputs read once and 2 half-level
// outputs written once, 210 MB, 0.063 ms at 3.35 TB/s, against 4
// operations per element. So it is bound by bytes.
//
// What this design does about it: one thread walks one (column, g-point)
// through both recurrences, reading and writing the [B, nlev, ng] layout
// directly (a warp covers 4 columns x 8 g-points: full 32-byte sectors);
// the TPU wrapper's transposes to [nlev, ng, B] are gone. The carries
// live in registers; no shared memory, no synchronisation.
#include <cuda_runtime.h>

namespace {

constexpr int NTH = 256;

__global__ void __launch_bounds__(NTH) lw_noscat_kernel(
    const float* __restrict__ trans, const float* __restrict__ sdn,
    const float* __restrict__ sup, const float* __restrict__ ssfc,
    const float* __restrict__ emis, float* __restrict__ fdn,
    float* __restrict__ fup, int B, int nlev, int ng) {
  const long long t = static_cast<long long>(blockIdx.x) * NTH + threadIdx.x;
  if (t >= static_cast<long long>(B) * ng) return;
  const long long b = t / ng;
  const int g = static_cast<int>(t % ng);
  const size_t lay = static_cast<size_t>(b) * nlev * ng + g;     // + j ng
  const size_t half = static_cast<size_t>(b) * (nlev + 1) * ng + g;

  float f = 0.0f;
  fdn[half] = f;
  for (int j = 0; j < nlev; ++j) {
    const size_t i = lay + static_cast<size_t>(j) * ng;
    f = __ldg(trans + i) * f + __ldg(sdn + i);
    fdn[half + static_cast<size_t>(j + 1) * ng] = f;
  }
  const float e = __ldg(emis + t);
  float u = e * __ldg(ssfc + t) + (1.0f - e) * f;
  fup[half + static_cast<size_t>(nlev) * ng] = u;
  for (int j = nlev - 1; j >= 0; --j) {
    const size_t i = lay + static_cast<size_t>(j) * ng;
    u = __ldg(trans + i) * u + __ldg(sup + i);
    fup[half + static_cast<size_t>(j) * ng] = u;
  }
}

}  // namespace

// Every array f32 and contiguous: trans, sdn, sup [B, nlev, ng]; ssfc,
// emis [B, ng]; fdn, fup [B, nlev+1, ng]. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int lw_noscat(const void* trans, const void* sdn,
                         const void* sup, const void* ssfc,
                         const void* emis, void* fdn, void* fup, int B,
                         int nlev, int ng, void* stream) {
  const long long n = static_cast<long long>(B) * ng;
  if (n == 0) return 0;
  const int blocks = static_cast<int>((n + NTH - 1) / NTH);
  lw_noscat_kernel<<<blocks, NTH, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(trans), static_cast<const float*>(sdn),
      static_cast<const float*>(sup), static_cast<const float*>(ssfc),
      static_cast<const float*>(emis), static_cast<float*>(fdn),
      static_cast<float*>(fup), B, nlev, ng);
  return static_cast<int>(cudaGetLastError());
}
