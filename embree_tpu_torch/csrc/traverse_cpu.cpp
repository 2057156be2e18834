// CPU twin of the Hopper traversal kernel (test-only).
//
// Compiles the kernel's per-ray logic (traverse.cuh) for the host with g++
// and -ffp-contract=off, so a machine without a GPU can hold the kernel's
// arithmetic against the plain PyTorch version bit for bit. Never on the main
// path.
//
// Build: g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC traverse_cpu.cpp
//        -o libtraverse_twin.so
#include "traverse.cuh"

namespace {

template <bool OCCLUSION, bool WANT_ATTRS, bool HAS_MASK, bool ROBUST,
          bool KINDS, bool MOTION, bool CURVES, bool ROUND>
int run(const trav::Params& p) {
  int overflow = 0;
  for (int i = 0; i < p.n_rays; ++i) {
    overflow += trav::trace_ray<OCCLUSION, WANT_ATTRS, HAS_MASK, ROBUST,
                                KINDS, MOTION, CURVES, ROUND>(p, i)
                    ? 1
                    : 0;
  }
  return overflow;
}

template <bool OCCLUSION, bool WANT_ATTRS, bool KINDS, bool MOTION,
          bool CURVES, bool ROUND>
int run_flags(const trav::Params& p, int has_mask, int robust) {
  constexpr bool O = OCCLUSION, A = WANT_ATTRS, K = KINDS, M = MOTION,
                 C = CURVES, R = ROUND;
  if (has_mask) {
    return robust ? run<O, A, true, true, K, M, C, R>(p)
                  : run<O, A, true, false, K, M, C, R>(p);
  }
  return robust ? run<O, A, false, true, K, M, C, R>(p)
                : run<O, A, false, false, K, M, C, R>(p);
}

template <bool OCCLUSION, bool WANT_ATTRS, bool KINDS, bool CURVES = false,
          bool ROUND = false>
int run_motion(const trav::Params& p, int has_mask, int robust,
               int has_motion) {
  return has_motion
             ? run_flags<OCCLUSION, WANT_ATTRS, KINDS, true, CURVES, ROUND>(
                   p, has_mask, robust)
             : run_flags<OCCLUSION, WANT_ATTRS, KINDS, false, CURVES, ROUND>(
                   p, has_mask, robust);
}

}  // namespace

// Same arguments as traverse_launch (traverse.cu) without the stream; host
// pointers. Returns 0, or 1 for a variant that does not exist.
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
                             int curve_rate, const float* curve_w) {
  if (trav::bad_variant(occlusion, want_attrs, has_kinds, kind_classes,
                        has_motion, has_win, time, nf, curve_rate, curve_w)) {
    return 1;
  }
  const trav::Params p{nodes,  n_nodes,  leaves,     n_leaves, leaf_stride,
                       org,    dir,      tnear,      tfar,     mask,
                       n_rays, out_t,    out_best,   out_visits, out_attr,
                       kind_classes, time, has_win, curve_rate, curve_w};
  const int m = has_motion;
  int ovf;
  if ((kind_classes >> trav::kTagRound) & 1) {
    ovf = occlusion
              ? run_motion<true, false, true, true, true>(p, has_mask, robust,
                                                          m)
              : run_motion<false, false, true, true, true>(p, has_mask,
                                                           robust, m);
  } else if ((kind_classes >> trav::kTagCurve) & 1) {
    ovf = occlusion
              ? run_motion<true, false, true, true>(p, has_mask, robust, m)
              : run_motion<false, false, true, true>(p, has_mask, robust, m);
  } else if (has_kinds) {
    ovf = occlusion ? run_motion<true, false, true>(p, has_mask, robust, m)
                    : run_motion<false, false, true>(p, has_mask, robust, m);
  } else if (occlusion) {
    ovf = run_motion<true, false, false>(p, has_mask, robust, m);
  } else if (want_attrs) {
    ovf = run_motion<false, true, false>(p, has_mask, robust, m);
  } else {
    ovf = run_motion<false, false, false>(p, has_mask, robust, m);
  }
  out_overflow[0] += ovf;
  return 0;
}
