// CPU twin of the two traversal ablation kernels (test-only).
//
// Compiles their walk (ablate.cuh: the per-ray steps, the leaf passes that
// deal items across the warp and the persistent warps' scheduler) for the
// host with g++ and -ffp-contract=off, so a machine without a GPU can hold
// the kernels' arithmetic and bookkeeping against the plain PyTorch
// version bit for bit. One persistent warp of 32 emulated lanes
// (HostWarp, traverse.cuh) takes every ray, as each of the card's warps
// takes its share; one_trip runs each 128-ray sub-group in lockstep with
// its smallest needed tiles, as the kernel's block does. Never on the main
// path.
//
// Build: g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC ablate_cpu.cpp
//        -o libablate_twin.so
#include <algorithm>
#include <vector>

#include "ablate.cuh"

namespace {

using trav::HostWarp;

template <class UNIT>
void scheduled(const abl::Params& p, int32_t* next_ray,
               unsigned long long* counts) {
  std::vector<int32_t> stacks(HostWarp::kLanes * abl::kStack);
  std::vector<int32_t> scratch(abl::kScratchWords);
  abl::run_warp<HostWarp, UNIT>(p, HostWarp{stacks.data(), scratch.data()},
                                next_ray, counts);
  counts[3] = 1;
}

void one_trip(const abl::Params& p, unsigned long long* counts) {
  constexpr int B = abl::kLane;
  std::vector<abl::State> st(B);
  std::vector<int32_t> stacks(B * abl::kStack), nidx(B), lidx(B), tn(B),
      tl(B);
  for (int b0 = 0; b0 < p.n_rays; b0 += B) {
    for (int l = 0; l < B; ++l) {
      abl::start(p, b0 + l, st[l]);
      nidx[l] = lidx[l] = -1;
    }
    for (int it = 0; it < p.max_steps; ++it) {
      int mn = abl::kNoTile, ml = abl::kNoTile;
      for (int l = 0; l < B; ++l) {
        tn[l] = abl::node_tile(st[l], p.n_node_tiles);
        tl[l] = abl::leaf_tile(st[l], p.n_leaf_tiles);
        mn = std::min(mn, tn[l]);
        ml = std::min(ml, tl[l]);
      }
      for (int l = 0; l < B; ++l) {
        if (st[l].live) {
          abl::one_trip_step(p, st[l],
                             trav::Stack<1>{stacks.data() + l * abl::kStack},
                             nidx[l], lidx[l], tn[l] == mn, tl[l] == ml);
        }
      }
    }
    for (int l = 0; l < B; ++l) {
      abl::finish(p, st[l]);
      const int32_t steps = st[l].n_node + st[l].n_leaf;
      int32_t& most = p.out_prog_steps[(b0 + l) / p.prog_rays];
      most = std::max(most, steps);
      counts[1] += steps;
    }
    counts[0] += static_cast<unsigned long long>(B) * p.max_steps;
    counts[2] += B;
  }
  counts[3] = 1;
}

template <int F>
void run_v7(const abl::Params& p, int32_t* next_ray,
            unsigned long long* counts) {
  if constexpr ((F & abl::kOneTrip) != 0) {
    one_trip(p, counts);
  } else {
    scheduled<abl::V7<F>>(p, next_ray, counts);
  }
}

template <int F>
void run_v5(const abl::Params& p, int32_t* next_ray,
            unsigned long long* counts) {
  scheduled<abl::V5<F>>(p, next_ray, counts);
}

}  // namespace

// Same arguments as ablate_v7_launch / ablate_v5_launch (ablate_v7.cu,
// ablate_v5.cu) without the stream; host pointers, next_ray, counts and
// out_prog_steps zeroed; counts as on the card, with [3] = 1 (one warp).
// Return 0, or 1 for a flags word that is no harness variant or a launch
// the kernels do not take.
#define ABL_TWIN(UNIT, VARIANTS)                                              \
  extern "C" int ablate_##UNIT##_twin(                                        \
      const int32_t* nodes, int n_node_tiles, const int32_t* leaves,          \
      int n_leaf_tiles, const float* org, const float* dir,                   \
      const float* tnear, const float* tfar, const int32_t* mask, int n_rays, \
      int prog_rays, int max_steps, float* out_t, int32_t* out_best,          \
      int32_t* out_visits, int32_t* out_prog_steps, int32_t* next_ray,        \
      int64_t* counts, int flags) {                                           \
    const abl::Params p{nodes,     n_node_tiles, leaves,   n_leaf_tiles,      \
                        org,       dir,          tnear,    tfar,              \
                        mask,      n_rays,       prog_rays, max_steps,        \
                        out_t,     out_best,     out_visits, out_prog_steps}; \
    if (abl::bad_launch(p, (flags & abl::kOneTrip) != 0)) return 1;          \
    auto* c = reinterpret_cast<unsigned long long*>(counts);                  \
    switch (flags) {                                                          \
      VARIANTS(ABL_TWIN_CASE_##UNIT)                                          \
      default:                                                                \
        return 1;                                                             \
    }                                                                         \
    return 0;                                                                 \
  }

#define ABL_TWIN_CASE(UNIT, F)     \
  case F:                          \
    run_##UNIT<F>(p, next_ray, c); \
    break;
#define ABL_TWIN_CASE_v7(F) ABL_TWIN_CASE(v7, F)
#define ABL_TWIN_CASE_v5(F) ABL_TWIN_CASE(v5, F)

ABL_TWIN(v7, ABL_V7_VARIANTS)
ABL_TWIN(v5, ABL_V5_VARIANTS)
