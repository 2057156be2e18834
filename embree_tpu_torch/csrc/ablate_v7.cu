// Hopper kernel of the v7 traversal ablation, one ray per thread: the
// counterpart of perf/ablate_v7.py::traverse (make_kernel, :39). The
// per-ray step, its flags and what bounds it are in ablate.cuh.
//
// Programs of 2048 rays (UGRP = 16 sub-groups of 128) are the harness's;
// a 128-thread block is one sub-group. A ray runs until it retires or the
// pinned step count ends, and the block's warps report each program's
// most steps with an atomicMax (the harness's lockstep count is the step
// limit itself). one_trip keeps the whole block in step: each step the
// block reduces the smallest node tile and leaf tile its rays need, and
// only the rays that need those fetch. The fetch trips the harness counts
// (steps rows 1-2) are left to the plain version: a per-step block
// reduction would distort the timing the kernel exists for.
//
// Build (with ablate_v5.cu, in parallel, linked into one library):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xcompiler -fPIC -c ablate_v7.cu -o ablate_v7.o
#include <cuda_runtime.h>

#include "ablate.cuh"

namespace {

constexpr int kBlock = abl::kLane;
constexpr int kWarps = kBlock / 32;

__device__ void program_max(const abl::Params& p, int i, int steps) {
  const int m = __reduce_max_sync(0xffffffffu, steps);
  if ((threadIdx.x & 31) == 0) atomicMax(p.out_prog_steps + i / p.prog_rays, m);
}

template <int F>
__global__ void __launch_bounds__(kBlock) v7_kernel(abl::Params p) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const abl::ARay r = abl::load_ray(p, i);
  abl::State s;
  abl::init_state(p, i, s);
  if constexpr ((F & abl::kOneTrip) == 0) {
    for (int it = 0; it < p.max_steps && s.act; ++it) {
      abl::v7_step<F>(p, r, s, true, true);
    }
  } else {
    __shared__ int part[2][kWarps];
    const int warp = threadIdx.x >> 5;
    for (int it = 0; it < p.max_steps; ++it) {
      const int tn = (F & abl::kFNode) ? abl::node_tile(s, p.n_node_tiles)
                                       : abl::kNoTile;
      const int tl = (F & abl::kFLeaf) ? abl::leaf_tile(s, p.n_leaf_tiles)
                                       : abl::kNoTile;
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
      if (s.act) abl::v7_step<F>(p, r, s, tn == mn, tl == ml);
    }
  }
  abl::finish(p, i, s);
  program_max(p, i, s.n_node + s.n_leaf);
}

template <int F>
void launch(const abl::Params& p, cudaStream_t st) {
  v7_kernel<F><<<p.n_rays / kBlock, kBlock, 0, st>>>(p);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a flags word that is no harness variant or a
// launch shape the kernel does not take.
extern "C" int ablate_v7_launch(const int32_t* nodes, int n_node_tiles,
                                const int32_t* leaves, int n_leaf_tiles,
                                const float* org, const float* dir,
                                const float* tnear, const float* tfar,
                                const int32_t* mask, int n_rays,
                                int prog_rays, int max_steps, float* out_t,
                                int32_t* out_best, int32_t* out_visits,
                                int32_t* out_prog_steps, int flags,
                                void* stream) {
  const abl::Params p{nodes, n_node_tiles, leaves,  n_leaf_tiles, org,
                      dir,   tnear,        tfar,    mask,         n_rays,
                      prog_rays, max_steps, out_t, out_best, out_visits,
                      out_prog_steps};
  if (abl::bad_launch(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (flags) {
#define ABL_CASE(F)    \
  case F:              \
    launch<F>(p, st);  \
    break;
    ABL_V7_VARIANTS(ABL_CASE)
#undef ABL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
