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
// What this design does about it: one thread walks one (column, g-point)
// through the replay and both backward sweeps, on the [B, nlev, ng] layout
// (a warp covers 4 columns x 8 g-points: full 32-byte sectors). The 2 x 61
// replayed fluxes are parked in the outputs, no scratch: fdn[j+1] in
// dsdn_j, which the down backward reads (as fdn[j] from dsdn_{j-1}) before
// it writes dsdn_{j-1}; fup[j+1] in dtrans_j, which the up backward reads
// and overwrites in the same step. Each thread reads back only what it
// wrote itself. No shared memory, no synchronisation.
#include <cuda_runtime.h>

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
