// Hopper kernel for BVH8 traversal, one ray per thread.
//
// Replaces embree_tpu/accel/traverse_pallas.py::_kernel for static scenes:
// triangles (B1), robust mode (B2), kind tags (B3), points (B4) and lines
// (B5). The per-ray logic, what bounds it on the card and what this design
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
          bool KINDS>
__global__ void __launch_bounds__(kBlock)
    traverse_kernel(trav::Params p, int32_t* out_overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_rays) return;
  if (trav::trace_ray<OCCLUSION, WANT_ATTRS, HAS_MASK, ROBUST, KINDS>(p, i)) {
    atomicAdd(out_overflow, 1);
  }
}

template <bool OCCLUSION, bool WANT_ATTRS, bool HAS_MASK, bool ROBUST,
          bool KINDS>
void launch(const trav::Params& p, int32_t* ovf, cudaStream_t s) {
  const dim3 grid((p.n_rays + kBlock - 1) / kBlock), block(kBlock);
  traverse_kernel<OCCLUSION, WANT_ATTRS, HAS_MASK, ROBUST, KINDS>
      <<<grid, block, 0, s>>>(p, ovf);
}

// Instantiated variants: triangles-only x {closest with attrs, closest,
// occluded} and mixed classes x {closest, occluded}, each x {mask chunk or
// not} x {robust or not}.
template <bool OCCLUSION, bool WANT_ATTRS, bool KINDS>
void launch_flags(const trav::Params& p, int has_mask, int robust,
                  int32_t* ovf, cudaStream_t s) {
  if (has_mask) {
    if (robust) launch<OCCLUSION, WANT_ATTRS, true, true, KINDS>(p, ovf, s);
    else launch<OCCLUSION, WANT_ATTRS, true, false, KINDS>(p, ovf, s);
  } else {
    if (robust) launch<OCCLUSION, WANT_ATTRS, false, true, KINDS>(p, ovf, s);
    else launch<OCCLUSION, WANT_ATTRS, false, false, KINDS>(p, ovf, s);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a variant that does not exist (attributes with
// kind tags).
extern "C" int traverse_launch(const int32_t* nodes, int n_nodes,
                               const int32_t* leaves, int n_leaves,
                               int leaf_stride, const float* org,
                               const float* dir, const float* tnear,
                               const float* tfar, const int32_t* mask,
                               int n_rays, float* out_t, int32_t* out_best,
                               int32_t* out_visits, float* out_attr,
                               int32_t* out_overflow, int occlusion,
                               int want_attrs, int has_mask, int robust,
                               int has_kinds, int kind_classes,
                               void* stream) {
  if (n_rays <= 0) return 0;
  if (has_kinds && want_attrs && !occlusion) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const trav::Params p{nodes, n_nodes, leaves, n_leaves, leaf_stride,
                       org,   dir,     tnear,  tfar,     mask,
                       n_rays, out_t,  out_best, out_visits, out_attr,
                       kind_classes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_kinds) {
    if (occlusion) {
      launch_flags<true, false, true>(p, has_mask, robust, out_overflow, s);
    } else {
      launch_flags<false, false, true>(p, has_mask, robust, out_overflow, s);
    }
  } else if (occlusion) {
    launch_flags<true, false, false>(p, has_mask, robust, out_overflow, s);
  } else if (want_attrs) {
    launch_flags<false, true, false>(p, has_mask, robust, out_overflow, s);
  } else {
    launch_flags<false, false, false>(p, has_mask, robust, out_overflow, s);
  }
  return static_cast<int>(cudaGetLastError());
}
