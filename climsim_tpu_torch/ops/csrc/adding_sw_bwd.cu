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
// What this design does about it: one thread walks one (column, g-point)
// through the replay and both backward sweeps, on the [B, nlev, ng] layout
// (a warp covers 4 columns x 8 g-points: full 32-byte sectors). The TPU
// kept six [nlev+1] replay arrays per lane in VMEM; here four live in
// device scratch [4, B, nlev+1, ng] that the wrapper allocates (alb,
// albdir, and fdiff and fdir, which the down-sweep backward overwrites
// with galb and galbdir once it has read them: fdir[j+1] = fdir[j] tdir_j
// is recomputed exactly where it is needed). Each thread reads back only
// what it wrote itself. No shared memory, no synchronisation.
#include <cuda_runtime.h>

namespace {

constexpr int NTH = 256;

__global__ void __launch_bounds__(NTH) adding_sw_bwd_kernel(
    const float* __restrict__ toa, const float* __restrict__ ad,
    const float* __restrict__ adir, const float* __restrict__ R,
    const float* __restrict__ T, const float* __restrict__ rd,
    const float* __restrict__ tdd, const float* __restrict__ tdir,
    const float* __restrict__ dfup, const float* __restrict__ dfdiff,
    const float* __restrict__ dfdir, float* __restrict__ dtoa,
    float* __restrict__ dad, float* __restrict__ dadir, float* dR,
    float* dT, float* __restrict__ drd, float* dtdd, float* dtdir,
    float* scr, int B, int nlev, int ng) {
  const long long t = static_cast<long long>(blockIdx.x) * NTH + threadIdx.x;
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
// [B, nlev, ng]; scratch [4, B, nlev+1, ng]. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int adding_sw_bwd(const void* toa, const void* ad,
                             const void* adir, const void* R, const void* T,
                             const void* rd, const void* tdd,
                             const void* tdir, const void* dfup,
                             const void* dfdiff, const void* dfdir,
                             void* dtoa, void* dad, void* dadir, void* dR,
                             void* dT, void* drd, void* dtdd, void* dtdir,
                             void* scratch, int B, int nlev, int ng,
                             void* stream) {
  const long long n = static_cast<long long>(B) * ng;
  if (n == 0) return 0;
  const int blocks = static_cast<int>((n + NTH - 1) / NTH);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  adding_sw_bwd_kernel<<<blocks, NTH, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      f(toa), f(ad), f(adir), f(R), f(T), f(rd), f(tdd), f(tdir), f(dfup),
      f(dfdiff), f(dfdir), w(dtoa), w(dad), w(dadir), w(dR), w(dT), w(drd),
      w(dtdd), w(dtdir), w(scratch), B, nlev, ng);
  return static_cast<int>(cudaGetLastError());
}
