// CPU twin of the Hopper traversal kernels (test-only).
//
// Compiles the kernels' per-ray logic and the persistent warps of every
// variant (traverse.cuh: the scheduler, the curve leaf pass, which deals
// slots across the warp and queues round-curve candidates, and the static
// variants' leaf pass) for the host with g++ and -ffp-contract=off, so a
// machine
// without a GPU can hold the kernels' arithmetic and bookkeeping against
// the plain PyTorch version bit for bit. Never on the main path.
//
// Build: g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC traverse_cpu.cpp
//        -o libtraverse_twin.so
#include <vector>

#include "traverse.cuh"

namespace {

using trav::HostWarp;

template <bool OCCLUSION, bool WANT_ATTRS, bool HAS_MASK, bool ROBUST,
          bool KINDS, bool MOTION, bool CURVES, bool ROUND>
void run(const trav::Params& p, int32_t* ovf, unsigned long long* counts) {
  // one persistent warp takes every ray
  std::vector<int32_t> stacks(HostWarp::kLanes * trav::kStack);
  std::vector<int32_t> scratch(
      CURVES || !MOTION ? trav::curve_scratch_words(p.kind_classes) : 0);
  int32_t next_ray = 0;
  trav::run_warp<HostWarp, OCCLUSION, WANT_ATTRS, HAS_MASK, ROBUST, KINDS,
                 MOTION, CURVES, ROUND>(
      p, HostWarp{stacks.data(), scratch.data()}, &next_ray, ovf, counts,
      p.curve_w);
  counts[3] = 1;
}

template <bool OCCLUSION, bool WANT_ATTRS, bool KINDS, bool MOTION,
          bool CURVES, bool ROUND>
void run_flags(const trav::Params& p, int has_mask, int robust, int32_t* o,
               unsigned long long* c) {
  constexpr bool O = OCCLUSION, A = WANT_ATTRS, K = KINDS, M = MOTION,
                 C = CURVES, R = ROUND;
  if (has_mask) {
    if (robust) run<O, A, true, true, K, M, C, R>(p, o, c);
    else run<O, A, true, false, K, M, C, R>(p, o, c);
  } else {
    if (robust) run<O, A, false, true, K, M, C, R>(p, o, c);
    else run<O, A, false, false, K, M, C, R>(p, o, c);
  }
}

template <bool OCCLUSION, bool WANT_ATTRS, bool KINDS, bool CURVES = false,
          bool ROUND = false>
void run_motion(const trav::Params& p, int has_mask, int robust,
                int has_motion, int32_t* o, unsigned long long* c) {
  if (has_motion) {
    run_flags<OCCLUSION, WANT_ATTRS, KINDS, true, CURVES, ROUND>(
        p, has_mask, robust, o, c);
  } else {
    run_flags<OCCLUSION, WANT_ATTRS, KINDS, false, CURVES, ROUND>(
        p, has_mask, robust, o, c);
  }
}

}  // namespace

// Same arguments as traverse_launch (traverse.cu) without the ray counter
// and the stream; host pointers. counts: seven int64 (zero before the
// call), filled as on the card, with [3] = 1 (one warp).
// Returns 0, or 1 for a variant that does not exist.
extern "C" int traverse_twin(const int32_t* nodes, int n_nodes,
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
                             int64_t* counts) {
  if (trav::bad_variant(occlusion, want_attrs, has_kinds, kind_classes,
                        has_motion, has_win, time, nf, curve_rate, curve_w)) {
    return 1;
  }
  const trav::Params p{nodes,  n_nodes,  leaves,     n_leaves, leaf_stride,
                       org,    dir,      tnear,      tfar,     mask,
                       n_rays, out_t,    out_best,   out_visits, out_attr,
                       kind_classes, time, has_win, curve_rate, curve_w};
  const int k = has_mask, r = robust, m = has_motion;
  int32_t* o = out_overflow;
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  if ((kind_classes >> trav::kTagRound) & 1) {
    if (occlusion) run_motion<true, false, true, true, true>(p, k, r, m, o, c);
    else run_motion<false, false, true, true, true>(p, k, r, m, o, c);
  } else if ((kind_classes >> trav::kTagCurve) & 1) {
    if (occlusion) run_motion<true, false, true, true>(p, k, r, m, o, c);
    else run_motion<false, false, true, true>(p, k, r, m, o, c);
  } else if (has_kinds) {
    if (occlusion) run_motion<true, false, true>(p, k, r, m, o, c);
    else run_motion<false, false, true>(p, k, r, m, o, c);
  } else if (occlusion) {
    run_motion<true, false, false>(p, k, r, m, o, c);
  } else if (want_attrs) {
    run_motion<false, true, false>(p, k, r, m, o, c);
  } else {
    run_motion<false, false, false>(p, k, r, m, o, c);
  }
  return 0;
}
