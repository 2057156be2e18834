// Hopper kernel of the v5 traversal ablation, one ray per thread: the
// counterpart of perf/kernel_ablate.py::traverse (make_kernel, :32). The
// per-ray step, its flags and what bounds it are in ablate.cuh.
//
// Programs of UGRP x 128 rays (UGRP 16, 8 or 4) are the harness's. Every
// ray walks until it retires (or to the pinned max_steps), then the warps
// report each program's most steps with an atomicMax: the harness's
// lockstep count it_final. The fetch trips the harness counts (steps rows
// 1-2) are left to the plain version: a per-step reduction over the
// program would distort the timing the kernel exists for.
//
// Build (with ablate_v7.cu, in parallel, linked into one library):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xcompiler -fPIC -c ablate_v5.cu -o ablate_v5.o
//   nvcc -gencode arch=compute_90a,code=sm_90a -shared ablate_v7.o
//        ablate_v5.o -o libablate_cuda.so
#include <cuda_runtime.h>

#include "ablate.cuh"

namespace {

constexpr int kBlock = abl::kLane;

template <int F>
__global__ void __launch_bounds__(kBlock) v5_kernel(abl::Params p) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const abl::ARay r = abl::load_ray(p, i);
  abl::State s;
  abl::init_state(p, i, s);
  for (int it = 0; it < p.max_steps && s.act; ++it) abl::v5_step<F>(p, r, s);
  abl::finish(p, i, s);
  const int m = __reduce_max_sync(0xffffffffu, s.n_node + s.n_leaf);
  if ((threadIdx.x & 31) == 0) atomicMax(p.out_prog_steps + i / p.prog_rays, m);
}

template <int F>
void launch(const abl::Params& p, cudaStream_t st) {
  v5_kernel<F><<<p.n_rays / kBlock, kBlock, 0, st>>>(p);
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
    ABL_V5_VARIANTS(ABL_CASE)
#undef ABL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
