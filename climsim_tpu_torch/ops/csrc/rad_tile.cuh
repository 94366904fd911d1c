// The staged tile of the second designs of B11 (adding_sw.cu) and B14
// (lw_noscat_bwd.cu).
//
// The solvers run, for every (column, g-point) item, serial recurrences
// over the levels of the [B, nlev, ng] f32 layout. In that layout the
// arrays of C whole columns are contiguous spans: C nlev ng floats for a
// layer array, C (nlev+1) ng for a half-level one, C ng for a surface one.
//
// A persistent CTA walks tiles of C columns (tile index blockIdx.x +
// k gridDim.x). Warp 0 copies a tile's inputs from device memory into the
// CTA's stage of shared memory with cp.async.bulk (one copy per column of
// every layer and half-level array, one per surface array), all
// completing on the stage's mbarrier (expect_tx of the tile's bytes). The
// consumer threads, one an item, wait on the barrier, run every sweep out
// of the stage (overwriting what they no longer need of it), and keep
// what a later sweep replays in a per-CTA replay buffer of (nlev+1) pairs
// an item; then the CTA synchronises once and warp 0 refills the stage
// with its next tile. So each input leaves device memory once, and the
// serial chains touch only shared memory and registers. The copies
// overlap the sweeps across CTAs: several CTAs share a SM, each copying
// while the others compute. (A ring of 2 or 3 stages a CTA, which fits
// fewer CTAs a SM, was slower on the H100: PERF.md §6.)
//
// Bank conflicts: in the stage, a column of a layer or half-level array
// starts every str floats, with str the column's length rounded up to
// the next count = ng (mod 32), and a multiple of 4 floats (16 bytes, as
// the bulk copy needs) when ng % 4 == 0. Item t = c ng + g then reads
// level j at c str + j ng + g = t + j ng (mod 32): the 32 lanes of a warp
// hit 32 banks. The replay is [nlev+1][C ng] float2, lane-contiguous.
//
// Layout of the dynamic shared memory: BAR_BYTES for the mbarrier, the
// stage of stage_floats() ([surface arrays][C ng] | [layer arrays][C]
// [str_lay] | [half-level arrays][C][str_half]), then the replay. The
// host's copy of smem() is pallas_radiation.py::rad_tile_smem; each
// staged source exports this one (<kernel>_smem) so the two can be
// compared on the card.
#pragma once
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "bulk_copy.cuh"

namespace rad {

constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block
constexpr int BAR_BYTES = 128;     // the mbarrier, padded to a 128-byte line
constexpr int MAX_THREADS = 512;   // C ng consumer items, rounded to warps
constexpr int MAX_ARRAYS = 8;

// n floats rounded up to the next count = ng (mod 32)
__host__ __device__ inline int pad_stride(int n, int ng) {
  return n + (((ng - n) % 32) + 32) % 32;
}

// The tile geometry of a kernel that stages nsfc surface, nlay layer and
// nhalf half-level arrays.
struct Geom {
  int nlev, ng, C, nsfc, nlay, nhalf;
  __host__ __device__ int str_lay() const { return pad_stride(nlev * ng, ng); }
  __host__ __device__ int str_half() const {
    return pad_stride((nlev + 1) * ng, ng);
  }
  __host__ __device__ int items() const { return C * ng; }
  __host__ __device__ int stage_floats() const {
    return nsfc * C * ng + nlay * C * str_lay() + nhalf * C * str_half();
  }
  __host__ __device__ int replay_floats() const {
    return 2 * (nlev + 1) * C * ng;
  }
  __host__ __device__ size_t smem() const {
    return BAR_BYTES + sizeof(float) * (static_cast<size_t>(stage_floats())
                                        + replay_floats());
  }
  __host__ __device__ int threads() const {
    return (items() + 31) / 32 * 32;
  }
  // the stage's layer array a, half-level array a, surface array a
  template <class P>
  __device__ P lay(P st, int a) const {
    return st + nsfc * C * ng + a * C * str_lay();
  }
  template <class P>
  __device__ P half(P st, int a) const {
    return st + nsfc * C * ng + nlay * C * str_lay() + a * C * str_half();
  }
  template <class P>
  __device__ P sfc(P st, int a) const {
    return st + a * C * ng;
  }
};

// the arrays a tile stages, surface ones first, then layer, then half-level
struct Srcs {
  const float* p[MAX_ARRAYS];
};

using bulk::bulk_g2s;
using bulk::mbar_expect_tx;
using bulk::mbar_init;
using bulk::mbar_wait;

// The CTA's stage and replay over the dynamic shared memory `smem`.
struct Tile {
  Geom G;
  uint64_t* bar;
  float* stage;
  float2* replay;
  int B, ntiles;

  __device__ Tile(const Geom& g, unsigned char* smem, int B_)
      : G(g), bar(reinterpret_cast<uint64_t*>(smem)),
        stage(reinterpret_cast<float*>(smem + BAR_BYTES)),
        replay(reinterpret_cast<float2*>(stage + g.stage_floats())),
        B(B_), ntiles((B_ + g.C - 1) / g.C) {}

  // columns of tile `tile` (the last one ragged)
  __device__ int cols(int tile) const {
    return min(G.C, B - tile * G.C);
  }

  // Warp 0 (every lane): copy tile `tile`'s arrays into the stage.
  __device__ void copy(const Srcs& src, int tile) const {
    const int lane = threadIdx.x;
    const int ng = G.ng, nlev = G.nlev, C = G.C;
    const int Cl = cols(tile);
    const size_t b0 = static_cast<size_t>(tile) * C;
    const unsigned lay_b = 4u * nlev * ng, half_b = 4u * (nlev + 1) * ng,
                   sfc_b = 4u * Cl * ng;
    if (lane == 0)
      mbar_expect_tx(bar, G.nsfc * sfc_b
                     + Cl * (G.nlay * lay_b + G.nhalf * half_b));
    __syncwarp();
    const int n = G.nsfc + Cl * (G.nlay + G.nhalf);
    for (int i = lane; i < n; i += 32) {
      float* dst;
      const float* from;
      unsigned bytes;
      if (i < G.nsfc) {
        dst = stage + i * C * ng;
        from = src.p[i] + b0 * ng;
        bytes = sfc_b;
      } else {
        const int r = i - G.nsfc, a = r / Cl, c = r % Cl;
        if (a < G.nlay) {
          dst = stage + G.nsfc * C * ng + (a * C + c) * G.str_lay();
          from = src.p[G.nsfc + a] + (b0 + c) * nlev * ng;
          bytes = lay_b;
        } else {
          const int h = a - G.nlay;
          dst = stage + G.nsfc * C * ng + G.nlay * C * G.str_lay()
                + (h * C + c) * G.str_half();
          from = src.p[G.nsfc + a] + (b0 + c) * (nlev + 1) * ng;
          bytes = half_b;
        }
      }
      bulk_g2s(dst, from, bytes, bar);
    }
  }

  // Before the walk (every thread): the barrier, and the copy of this
  // CTA's first tile. The walk is
  //   for (k = 0, tile = blockIdx.x; tile < ntiles; ++k, tile += gridDim.x)
  //     { st = wait(k); ...the items of tile on st...; refill(tile); }
  __device__ void start(const Srcs& src) const {
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    const int tile = blockIdx.x;
    if (threadIdx.x < 32 && tile < ntiles) copy(src, tile);
  }
  // the stage, once the copies of this CTA's k-th tile have landed (the
  // items may overwrite what they no longer need of it)
  __device__ float* wait(int k) const {
    mbar_wait(bar, k & 1);
    return stage;
  }
  // after a tile (every thread): refill the stage with this CTA's next
  // tile, once every item is done with it (the proxy fence orders the
  // items' writes to the stage before the bulk copy's)
  __device__ void refill(const Srcs& src, int tile) const {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const int next = tile + gridDim.x;
    if (threadIdx.x < 32 && next < ntiles) copy(src, next);
  }
};

// Launch a staged kernel: the shared memory and grid of geometry G on
// `blocks` CTAs. Returns a cudaError_t.
template <class Kernel, class... Args>
int launch_staged(Kernel kernel, const Geom& G, int blocks,
                  cudaStream_t stream, Args... args) {
  const size_t smem = G.smem();
  if (G.ng % 4 != 0 || G.C < 1 || smem > SMEM_MAX
      || G.threads() > MAX_THREADS
      || G.nsfc + G.nlay + G.nhalf > MAX_ARRAYS || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, G.threads(), smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rad
