// Hopper kernel of the v5 traversal ablation: the counterpart of
// perf/kernel_ablate.py::traverse (pallas_call :310, make_kernel :32). Its
// steps, what bounds it and the design are in ablate.cuh.
//
// Persistent warps (abl::run_warp over abl::V5<F>): rays taken from a
// global counter, each walking until it retires (or to the pinned
// max_steps, else the runaway guard), its leaves' 4 slots dealt across the
// warp, 8 leaves a round, stacks in shared memory. The rays a pass
// finishes raise their programs' most steps with one atomicMax per program
// among them (abl::raise_prog_steps), since a warp now holds rays of
// several programs (UGRP x 128 rays, UGRP 16, 8 or 4): the harness's
// lockstep count it_final. The fetch trips the harness counts
// (steps rows 1-2) are left to the plain version: a per-step reduction
// over the program would distort the timing the kernel exists for.
//
// Build (with ablate_v7.cu, in parallel, linked into one library):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xcompiler -fPIC -c ablate_v5.cu -o ablate_v5.o
//   nvcc -gencode arch=compute_90a,code=sm_90a -shared ablate_v7.o
//        ablate_v5.o -o libablate_cuda.so
#include <cuda_runtime.h>

#include "ablate.cuh"
#include "launch.cuh"

namespace {

constexpr int kBlock = abl::kLane;

// counts: abl::run_warp's; [3] gets warps_per_sm. At least trav::kMinBlocks
// resident blocks, as the traversal kernels.
template <int F>
__global__ void __launch_bounds__(kBlock, trav::kMinBlocks)
    v5_kernel(abl::Params p, int32_t* next_ray, unsigned long long* counts,
              int warps_per_sm) {
  extern __shared__ int32_t smem[];
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[3] = warps_per_sm;
  const trav::CudaScratchWarp w{
      {smem + threadIdx.x, static_cast<int>(threadIdx.x & 31)},
      smem + abl::kStack * kBlock + (threadIdx.x >> 5) * abl::kScratchWords};
  abl::run_warp<trav::CudaScratchWarp, abl::V5<F>>(p, w, next_ray, counts);
}

}  // namespace

// Same arguments and returns as ablate_v7_launch (ablate_v7.cu); max_steps
// is the pinned count or the runaway guard.
extern "C" int ablate_v5_launch(const int32_t* nodes, int n_node_tiles,
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
  if (abl::bad_launch(p, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  switch (flags) {
#define ABL_CASE(F)                                                  \
  case F:                                                            \
    abl::launch_persistent(v5_kernel<F>, p, next_ray, c, st);        \
    break;
    ABL_V5_VARIANTS(ABL_CASE)
#undef ABL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
