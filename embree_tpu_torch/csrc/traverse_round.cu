// Hopper kernel for BVH8 traversal, persistent warps whose leaf passes deal
// slots across the warp and polish round-curve candidates 32 at a time: the
// variants of scenes with native round curves (16-field slots).
//
// Replaces embree_tpu/accel/traverse_pallas.py::_kernel's round curve
// specialization (B8: the swept circle, :858-1046), with flat curves (B7)
// and every other class of a kind-tagged scene beside it. Instantiations of
// their own (ROUND) so that flat curve scenes do not carry the round test's
// registers (traverse.cuh). What bounds it on the card and what this design
// does about it are in traverse.cuh. The object links into one library with
// traverse.cu's (build line there), whose traverse_launch calls
// launch_round for scenes with round slots.
#include "launch.cuh"

namespace trav {

void launch_round(const Params& p, int occlusion, int has_mask, int robust,
                  int has_motion, Counters c, cudaStream_t s) {
  if (occlusion) {
    launch_motion<true, false, true, true, true>(p, has_mask, robust,
                                                 has_motion, c, s);
  } else {
    launch_motion<false, false, true, true, true>(p, has_mask, robust,
                                                  has_motion, c, s);
  }
}

}  // namespace trav
