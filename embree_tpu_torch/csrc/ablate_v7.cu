// Hopper kernel of the v7 traversal ablation: the counterpart of
// perf/ablate_v7.py::traverse (pallas_call :336, make_kernel :39). Its
// steps, what bounds it and the design are in ablate.cuh.
//
// Every variant but one_trip runs persistent warps (abl::run_warp over
// abl::V7<F>): rays taken from a global counter, each until it retires or
// reaches the pinned step count, leaves dealt across the warp, stacks in
// shared memory. The rays a pass finishes raise their programs' most steps
// (programs of 2048 rays, the harness's UGRP = 16 sub-groups of 128) with
// one atomicMax per program among them (abl::raise_prog_steps), since a
// warp now holds rays of several programs; for v7 that is the pinned count
// wherever a ray ran that long, as the harness's lockstep count is.
//
// one_trip keeps its lockstep block of 128 threads, one harness sub-group
// (ablate.cuh says why): each step the block reduces the smallest node tile
// and leaf tile its rays need, and only the rays that need those fetch.
// The fetch trips the harness counts (steps rows 1-2) are left to the
// plain version: a per-step reduction would distort the timing the kernel
// exists for.
//
// Build (with ablate_v5.cu, in parallel, linked into one library):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xcompiler -fPIC -c ablate_v7.cu -o ablate_v7.o
#include <cuda_runtime.h>

#include "ablate.cuh"
#include "launch.cuh"

namespace {

constexpr int kBlock = abl::kLane;
constexpr int kWarps = kBlock / 32;

// one_trip's block: 128 rays in lockstep for max_steps steps.
__device__ void one_trip(const abl::Params& p, int32_t* smem,
                         unsigned long long* counts) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  abl::State s;
  abl::start(p, i, s);
  int32_t nidx = -1, lidx = -1;
  const trav::Stack<kBlock> stk{smem + threadIdx.x};
  __shared__ int part[2][kWarps];
  const int warp = threadIdx.x >> 5;
  for (int it = 0; it < p.max_steps; ++it) {
    const int tn = abl::node_tile(s, p.n_node_tiles);
    const int tl = abl::leaf_tile(s, p.n_leaf_tiles);
    const int wn = __reduce_min_sync(0xffffffffu, tn);
    const int wl = __reduce_min_sync(0xffffffffu, tl);
    if ((threadIdx.x & 31) == 0) {
      part[0][warp] = wn;
      part[1][warp] = wl;
    }
    __syncthreads();
    int mn = part[0][0], ml = part[1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      mn = min(mn, part[0][w]);
      ml = min(ml, part[1][w]);
    }
    __syncthreads();
    if (s.live) abl::one_trip_step(p, s, stk, nidx, lidx, tn == mn, tl == ml);
  }
  abl::finish(p, s);
  // a warp's 32 rays are of one program (128 | prog_rays)
  const unsigned mine = static_cast<unsigned>(s.n_node + s.n_leaf);
  const unsigned steps = __reduce_add_sync(0xffffffffu, mine);
  const unsigned most = __reduce_max_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(p.out_prog_steps + i / p.prog_rays, static_cast<int>(most));
    atomicAdd(counts, 32ull * static_cast<unsigned>(p.max_steps));
    atomicAdd(counts + 1, static_cast<unsigned long long>(steps));
    atomicAdd(counts + 2, 32ull);
  }
}

// counts: abl::run_warp's; [3] gets warps_per_sm. At least trav::kMinBlocks
// resident blocks, as the traversal kernels (ptxas then allocates up to 128
// registers).
template <int F>
__global__ void __launch_bounds__(kBlock, trav::kMinBlocks)
    v7_kernel(abl::Params p, int32_t* next_ray, unsigned long long* counts,
              int warps_per_sm) {
  extern __shared__ int32_t smem[];
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[3] = warps_per_sm;
  if constexpr ((F & abl::kOneTrip) != 0) {
    static_assert(F == 0x7F, "one_trip runs with every phase on");
    one_trip(p, smem, counts);
  } else {
    const trav::CudaScratchWarp w{
        {smem + threadIdx.x, static_cast<int>(threadIdx.x & 31)},
        smem + abl::kStack * kBlock + (threadIdx.x >> 5) * abl::kScratchWords};
    abl::run_warp<trav::CudaScratchWarp, abl::V7<F>>(p, w, next_ray, counts);
  }
}

template <int F>
void launch(const abl::Params& p, int32_t* next_ray,
            unsigned long long* counts, cudaStream_t st) {
  if constexpr ((F & abl::kOneTrip) != 0) {
    const size_t smem = abl::kStack * kBlock * sizeof(int32_t);
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, v7_kernel<F>, kBlock, smem) != cudaSuccess) {
      return;
    }
    v7_kernel<F><<<p.n_rays / kBlock, kBlock, smem, st>>>(
        p, next_ray, counts, per_sm * kWarps);
  } else {
    abl::launch_persistent(v7_kernel<F>, p, next_ray, counts, st);
  }
}

}  // namespace

// next_ray: one int32, zero; counts: seven int64, zero (abl::run_warp's;
// one_trip fills [0]-[3]). Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for a flags word that is no harness
// variant or a launch the kernel does not take.
extern "C" int ablate_v7_launch(const int32_t* nodes, int n_node_tiles,
                                const int32_t* leaves, int n_leaf_tiles,
                                const float* org, const float* dir,
                                const float* tnear, const float* tfar,
                                const int32_t* mask, int n_rays,
                                int prog_rays, int max_steps, float* out_t,
                                int32_t* out_best, int32_t* out_visits,
                                int32_t* out_prog_steps, int32_t* next_ray,
                                int64_t* counts, int flags, void* stream) {
  const abl::Params p{nodes, n_node_tiles, leaves,  n_leaf_tiles, org,
                      dir,   tnear,        tfar,    mask,         n_rays,
                      prog_rays, max_steps, out_t, out_best, out_visits,
                      out_prog_steps};
  if (abl::bad_launch(p, (flags & abl::kOneTrip) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  switch (flags) {
#define ABL_CASE(F)                \
  case F:                          \
    launch<F>(p, next_ray, c, st); \
    break;
    ABL_V7_VARIANTS(ABL_CASE)
#undef ABL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
