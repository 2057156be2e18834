// The kernel entry and its launch dispatch over the template flags, shared
// by traverse.cu (B1-B6 and the C entry point), traverse_curves.cu (B7) and
// traverse_round.cu (B8 beside B7), which nvcc compiles in parallel into
// objects of one library.
#pragma once

#include <cuda_runtime.h>

#include "traverse.cuh"

namespace trav {

constexpr int kBlock = 128;

template <bool OCCLUSION, bool WANT_ATTRS, bool HAS_MASK, bool ROBUST,
          bool KINDS, bool MOTION, bool CURVES, bool ROUND>
__global__ void __launch_bounds__(kBlock)
    traverse_kernel(Params p, int32_t* out_overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_rays) return;
  if (trace_ray<OCCLUSION, WANT_ATTRS, HAS_MASK, ROBUST, KINDS, MOTION,
                CURVES, ROUND>(p, i)) {
    atomicAdd(out_overflow, 1);
  }
}

template <bool OCCLUSION, bool WANT_ATTRS, bool HAS_MASK, bool ROBUST,
          bool KINDS, bool MOTION, bool CURVES, bool ROUND>
void launch(const Params& p, int32_t* ovf, cudaStream_t s) {
  const dim3 grid((p.n_rays + kBlock - 1) / kBlock), block(kBlock);
  traverse_kernel<OCCLUSION, WANT_ATTRS, HAS_MASK, ROBUST, KINDS, MOTION,
                  CURVES, ROUND><<<grid, block, 0, s>>>(p, ovf);
}

// {mask chunk or not} x {robust or not}; time windows are a uniform
// runtime branch of the moving variants (Params::has_win).
template <bool OCCLUSION, bool WANT_ATTRS, bool KINDS, bool MOTION,
          bool CURVES, bool ROUND>
void launch_flags(const Params& p, int has_mask, int robust, int32_t* ovf,
                  cudaStream_t s) {
  constexpr bool O = OCCLUSION, A = WANT_ATTRS, K = KINDS, M = MOTION,
                 C = CURVES, R = ROUND;
  if (has_mask) {
    if (robust) launch<O, A, true, true, K, M, C, R>(p, ovf, s);
    else launch<O, A, true, false, K, M, C, R>(p, ovf, s);
  } else {
    if (robust) launch<O, A, false, true, K, M, C, R>(p, ovf, s);
    else launch<O, A, false, false, K, M, C, R>(p, ovf, s);
  }
}

template <bool OCCLUSION, bool WANT_ATTRS, bool KINDS, bool CURVES,
          bool ROUND = false>
void launch_motion(const Params& p, int has_mask, int robust, int has_motion,
                   int32_t* ovf, cudaStream_t s) {
  if (has_motion) {
    launch_flags<OCCLUSION, WANT_ATTRS, KINDS, true, CURVES, ROUND>(
        p, has_mask, robust, ovf, s);
  } else {
    launch_flags<OCCLUSION, WANT_ATTRS, KINDS, false, CURVES, ROUND>(
        p, has_mask, robust, ovf, s);
  }
}

// The 16 flat curve variants (traverse_curves.cu) and the 16 round ones
// (traverse_round.cu, scenes with round slots): {closest, occluded} x {mask
// chunk or not} x {robust or not} x {static or moving}.
void launch_curves(const Params& p, int occlusion, int has_mask, int robust,
                   int has_motion, int32_t* ovf, cudaStream_t s);
void launch_round(const Params& p, int occlusion, int has_mask, int robust,
                  int has_motion, int32_t* ovf, cudaStream_t s);

}  // namespace trav
