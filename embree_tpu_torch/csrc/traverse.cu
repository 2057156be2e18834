// Hopper kernel for BVH8 traversal, one ray per thread.
//
// Replaces embree_tpu/accel/traverse_pallas.py::_kernel: triangles (B1),
// robust mode (B2), kind tags (B3), points (B4), lines (B5) and motion blur
// (B6). The per-ray logic, what bounds it on the card and what this design
// does about it are in traverse.cuh.
// Also folds in the Pallas kernel's streamed-table specialization
// (traverse_pallas.py:347-426): global loads through L2 serve a table of any
// size, so there is no tile cache to manage.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC traverse.cu -o libtraverse_cuda.so
#include <cuda_runtime.h>

#include "traverse.cuh"

namespace {

constexpr int kBlock = 128;

template <bool OCCLUSION, bool WANT_ATTRS, bool HAS_MASK, bool ROBUST,
          bool KINDS, bool MOTION>
__global__ void __launch_bounds__(kBlock)
    traverse_kernel(trav::Params p, int32_t* out_overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_rays) return;
  if (trav::trace_ray<OCCLUSION, WANT_ATTRS, HAS_MASK, ROBUST, KINDS, MOTION>(
          p, i)) {
    atomicAdd(out_overflow, 1);
  }
}

template <bool OCCLUSION, bool WANT_ATTRS, bool HAS_MASK, bool ROBUST,
          bool KINDS, bool MOTION>
void launch(const trav::Params& p, int32_t* ovf, cudaStream_t s) {
  const dim3 grid((p.n_rays + kBlock - 1) / kBlock), block(kBlock);
  traverse_kernel<OCCLUSION, WANT_ATTRS, HAS_MASK, ROBUST, KINDS, MOTION>
      <<<grid, block, 0, s>>>(p, ovf);
}

// Instantiated variants (40): triangles-only x {closest with attrs,
// closest, occluded} and mixed classes x {closest, occluded}, each x {mask
// chunk or not} x {robust or not} x {static or moving}. Time windows are a
// uniform runtime branch of the moving variants (Params::has_win).
template <bool OCCLUSION, bool WANT_ATTRS, bool KINDS, bool MOTION>
void launch_flags(const trav::Params& p, int has_mask, int robust,
                  int32_t* ovf, cudaStream_t s) {
  constexpr bool O = OCCLUSION, A = WANT_ATTRS, K = KINDS, M = MOTION;
  if (has_mask) {
    if (robust) launch<O, A, true, true, K, M>(p, ovf, s);
    else launch<O, A, true, false, K, M>(p, ovf, s);
  } else {
    if (robust) launch<O, A, false, true, K, M>(p, ovf, s);
    else launch<O, A, false, false, K, M>(p, ovf, s);
  }
}

template <bool OCCLUSION, bool WANT_ATTRS, bool KINDS>
void launch_motion(const trav::Params& p, int has_mask, int robust,
                   int has_motion, int32_t* ovf, cudaStream_t s) {
  if (has_motion) {
    launch_flags<OCCLUSION, WANT_ATTRS, KINDS, true>(p, has_mask, robust, ovf,
                                                     s);
  } else {
    launch_flags<OCCLUSION, WANT_ATTRS, KINDS, false>(p, has_mask, robust,
                                                      ovf, s);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a variant that does not exist (attributes with
// kind tags, windows without motion, motion without times).
extern "C" int traverse_launch(const int32_t* nodes, int n_nodes,
                               const int32_t* leaves, int n_leaves,
                               int leaf_stride, const float* org,
                               const float* dir, const float* tnear,
                               const float* tfar, const int32_t* mask,
                               const float* time, int n_rays, float* out_t,
                               int32_t* out_best, int32_t* out_visits,
                               float* out_attr, int32_t* out_overflow,
                               int occlusion, int want_attrs, int has_mask,
                               int robust, int has_kinds, int kind_classes,
                               int has_motion, int has_win, void* stream) {
  if (n_rays <= 0) return 0;
  if ((has_kinds && want_attrs && !occlusion) || (has_win && !has_motion) ||
      (has_motion && time == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const trav::Params p{nodes,  n_nodes,  leaves,     n_leaves, leaf_stride,
                       org,    dir,      tnear,      tfar,     mask,
                       n_rays, out_t,    out_best,   out_visits, out_attr,
                       kind_classes, time, has_win};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = has_motion;
  int32_t* ovf = out_overflow;
  if (has_kinds) {
    if (occlusion) {
      launch_motion<true, false, true>(p, has_mask, robust, m, ovf, s);
    } else {
      launch_motion<false, false, true>(p, has_mask, robust, m, ovf, s);
    }
  } else if (occlusion) {
    launch_motion<true, false, false>(p, has_mask, robust, m, ovf, s);
  } else if (want_attrs) {
    launch_motion<false, true, false>(p, has_mask, robust, m, ovf, s);
  } else {
    launch_motion<false, false, false>(p, has_mask, robust, m, ovf, s);
  }
  return static_cast<int>(cudaGetLastError());
}
