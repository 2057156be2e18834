// Hopper kernels for BVH8 traversal: the C entry point and the variants of
// scenes without curves.
//
// Replaces embree_tpu/accel/traverse_pallas.py::_kernel: triangles (B1),
// robust mode (B2), kind tags (B3), points (B4), lines (B5) and motion blur
// (B6); traverse_curves.cu holds flat curves (B7), traverse_round.cu round
// curves (B8). Every variant runs persistent warps that refill finished
// lanes (launch.cuh); the per-ray logic, what bounds it on the card and
// what each design does about it are in traverse.cuh and launch.cuh.
// Also folds in the Pallas kernel's streamed-table specialization
// (traverse_pallas.py:347-426): global loads through L2 serve a table of any
// size, so there is no tile cache to manage.
//
// Build (the three sources compile in parallel, then link into one library):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xcompiler -fPIC -c traverse.cu -o traverse.o   (and traverse_curves,
//        traverse_round)
//   nvcc -gencode arch=compute_90a,code=sm_90a -shared traverse.o
//        traverse_curves.o traverse_round.o -o libtraverse_cuda.so
#include "launch.cuh"

// Instantiated variants here (40): triangles-only x {closest with attrs,
// closest, occluded} and mixed classes x {closest, occluded}, each x {mask
// chunk or not} x {robust or not} x {static or moving}; scenes with the
// curve tags go to trav::launch_curves (flat only) or trav::launch_round.
// next_ray: one int32, zero before the launch (the persistent warps' ray
// counter); counts: seven int64, zero before the launch, which the warps
// fill (run_warp in traverse.cuh, persistent_kernel in launch.cuh).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a variant that does not exist (trav::
// bad_variant).
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
                               int has_motion, int has_win, int nf,
                               int curve_rate, const float* curve_w,
                               int32_t* next_ray, int64_t* counts,
                               void* stream) {
  using trav::launch_motion;
  if (n_rays <= 0) return 0;
  if (trav::bad_variant(occlusion, want_attrs, has_kinds, kind_classes,
                        has_motion, has_win, time, nf, curve_rate, curve_w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const trav::Params p{nodes,  n_nodes,  leaves,     n_leaves, leaf_stride,
                       org,    dir,      tnear,      tfar,     mask,
                       n_rays, out_t,    out_best,   out_visits, out_attr,
                       kind_classes, time, has_win, curve_rate, curve_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = has_motion;
  const trav::Counters c{out_overflow, next_ray,
                           reinterpret_cast<unsigned long long*>(counts)};
  if ((kind_classes >> trav::kTagRound) & 1) {
    trav::launch_round(p, occlusion, has_mask, robust, m, c, s);
  } else if ((kind_classes >> trav::kTagCurve) & 1) {
    trav::launch_curves(p, occlusion, has_mask, robust, m, c, s);
  } else if (has_kinds) {
    if (occlusion) {
      launch_motion<true, false, true, false>(p, has_mask, robust, m, c, s);
    } else {
      launch_motion<false, false, true, false>(p, has_mask, robust, m, c,
                                               s);
    }
  } else if (occlusion) {
    launch_motion<true, false, false, false>(p, has_mask, robust, m, c, s);
  } else if (want_attrs) {
    launch_motion<false, true, false, false>(p, has_mask, robust, m, c, s);
  } else {
    launch_motion<false, false, false, false>(p, has_mask, robust, m, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}
