// Hopper kernel for BVH8 traversal, persistent warps whose leaf passes deal
// slots across the warp: the variants of scenes with native flat curves and
// no round ones (16-field slots).
//
// Replaces embree_tpu/accel/traverse_pallas.py::_kernel's flat curve
// specialization (B7: the ribbon, :719-856, with the curve ray frame,
// :194-221), with every other class of a kind-tagged scene beside it;
// traverse_round.cu holds the variants of scenes with round curves (B8).
// What bounds it on the card and what this design does about it are in
// traverse.cuh. A source of its own so that nvcc compiles it beside
// traverse.cu; the objects link into one library (build line there), whose
// traverse_launch calls launch_curves for flat curve scenes.
#include "launch.cuh"

namespace trav {

void launch_curves(const Params& p, int occlusion, int has_mask, int robust,
                   int has_motion, Counters c, cudaStream_t s) {
  if (occlusion) {
    launch_motion<true, false, true, true>(p, has_mask, robust, has_motion,
                                           c, s);
  } else {
    launch_motion<false, false, true, true>(p, has_mask, robust, has_motion,
                                            c, s);
  }
}

}  // namespace trav
