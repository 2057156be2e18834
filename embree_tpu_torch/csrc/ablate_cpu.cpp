// CPU twin of the two traversal ablation kernels (test-only).
//
// Compiles their per-ray step (ablate.cuh) for the host with g++ and
// -ffp-contract=off, so a machine without a GPU can hold the kernels'
// arithmetic against the plain PyTorch version bit for bit. Rays run one
// after another, as the kernels' threads run them, and one_trip runs each
// 128-ray sub-group in lockstep with its smallest needed tiles, as the
// kernel's block does. Never on the main path.
//
// Build: g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC ablate_cpu.cpp
//        -o libablate_twin.so
#include <algorithm>
#include <vector>

#include "ablate.cuh"

namespace {

void program_max(const abl::Params& p, int i, const abl::State& s) {
  int32_t& m = p.out_prog_steps[i / p.prog_rays];
  m = std::max(m, s.n_node + s.n_leaf);
}

template <int F>
void v7_run(const abl::Params& p) {
  std::vector<abl::State> st(abl::kLane);
  std::vector<abl::ARay> rays(abl::kLane);
  for (int b0 = 0; b0 < p.n_rays; b0 += abl::kLane) {
    for (int l = 0; l < abl::kLane; ++l) {
      rays[l] = abl::load_ray(p, b0 + l);
      abl::init_state(p, b0 + l, st[l]);
    }
    if ((F & abl::kOneTrip) == 0) {
      for (int l = 0; l < abl::kLane; ++l) {
        for (int it = 0; it < p.max_steps && st[l].act; ++it) {
          abl::v7_step<F>(p, rays[l], st[l], true, true);
        }
      }
    } else {
      for (int it = 0; it < p.max_steps; ++it) {
        int mn = abl::kNoTile, ml = abl::kNoTile;
        std::vector<int32_t> tn(abl::kLane), tl(abl::kLane);
        for (int l = 0; l < abl::kLane; ++l) {
          tn[l] = (F & abl::kFNode) ? abl::node_tile(st[l], p.n_node_tiles)
                                    : abl::kNoTile;
          tl[l] = (F & abl::kFLeaf) ? abl::leaf_tile(st[l], p.n_leaf_tiles)
                                    : abl::kNoTile;
          mn = std::min(mn, tn[l]);
          ml = std::min(ml, tl[l]);
        }
        for (int l = 0; l < abl::kLane; ++l) {
          if (st[l].act) {
            abl::v7_step<F>(p, rays[l], st[l], tn[l] == mn, tl[l] == ml);
          }
        }
      }
    }
    for (int l = 0; l < abl::kLane; ++l) {
      abl::finish(p, b0 + l, st[l]);
      program_max(p, b0 + l, st[l]);
    }
  }
}

template <int F>
void v5_run(const abl::Params& p) {
  for (int i = 0; i < p.n_rays; ++i) {
    const abl::ARay r = abl::load_ray(p, i);
    abl::State s;
    abl::init_state(p, i, s);
    for (int it = 0; it < p.max_steps && s.act; ++it) abl::v5_step<F>(p, r, s);
    abl::finish(p, i, s);
    program_max(p, i, s);
  }
}

}  // namespace

// Same arguments as ablate_v7_launch / ablate_v5_launch (ablate_v7.cu,
// ablate_v5.cu) without the stream; host pointers, out_prog_steps zeroed.
// Return 0, or 1 for a flags word that is no harness variant or a launch
// the kernels do not take.
#define ABL_TWIN(UNIT, VARIANTS)                                              \
  extern "C" int ablate_##UNIT##_twin(                                        \
      const int32_t* nodes, int n_node_tiles, const int32_t* leaves,          \
      int n_leaf_tiles, const float* org, const float* dir,                   \
      const float* tnear, const float* tfar, const int32_t* mask, int n_rays, \
      int prog_rays, int max_steps, float* out_t, int32_t* out_best,          \
      int32_t* out_visits, int32_t* out_prog_steps, int flags) {              \
    const abl::Params p{nodes,     n_node_tiles, leaves,   n_leaf_tiles,      \
                        org,       dir,          tnear,    tfar,              \
                        mask,      n_rays,       prog_rays, max_steps,        \
                        out_t,     out_best,     out_visits, out_prog_steps}; \
    if (abl::bad_launch(p)) return 1;                                         \
    switch (flags) {                                                          \
      VARIANTS(ABL_TWIN_CASE_##UNIT)                                          \
      default:                                                                \
        return 1;                                                             \
    }                                                                         \
    return 0;                                                                 \
  }

#define ABL_TWIN_CASE_v7(F) \
  case F:                   \
    v7_run<F>(p);           \
    break;
#define ABL_TWIN_CASE_v5(F) \
  case F:                   \
    v5_run<F>(p);           \
    break;

ABL_TWIN(v7, ABL_V7_VARIANTS)
ABL_TWIN(v5, ABL_V5_VARIANTS)
