// Hopper kernel of the loop probes of perf/micro_expand.py (bench, :23; the
// probe bodies :52-95): one block of 128 threads carries the (8,128) int32
// tile, thread l its lane column l, rows 0-7 in registers. x is (128,128);
// each probe reads x + it, a fresh operand every iteration. Layout,
// arithmetic and what bounds a probe: micro.cuh.
//
// The probes compute a (16,128) or (128,128) operand and keep its rows 0-7
// ([0:8]); the rest is dropped, so the kernel computes rows 0-7 only, and
// the (16,128) and (128,128) forms of the masked min and the select are one
// function each. The 10x add multiplies its sum by 0: nvcc folds it, and
// the probe reads as the baseline.
//
// H100 primitive each TPU op becomes:
//   reshape-broadcast and pltpu.repeat expands, the strided extract, the
//     selects, the adds and the block sum: reads of x staged in shared
//     memory at fixed addresses, then registers;
//   masked min along the lanes: warp reductions (__reduce_min_sync) and
//     shared memory across the four warps;
//   one and sixteen 72-row group gathers: indexed reads of staged x.
//
// Build: see micro_v8.cu.
#include "micro.cuh"

namespace {

using namespace micro;

// the (8,128) tile in one block of 128 threads, x of (128,128)
struct Expand {
  static constexpr int kRowsIn = 128;
  static constexpr int kRows = 8;
  static constexpr int kBlock = kLane;
  static constexpr int kScratchWords = 4 * kRows;   // the warps' minima

  // probe ids: embree_tpu_torch/perf/micro_expand.py::PROBES
  enum : int {
    kBase, kExpandBcast, kExpandRepeat, kStrided, kMinR, kMinU, kSelR,
    kSelU, kAdd10, kBlockSum, kGather72, kGather72x16, kProbes
  };

  // rows of x the probe reads (from shared memory)
  __host__ __device__ static constexpr int staged_rows(int p) {
    return p == kBase                            ? 0
           : p == kExpandBcast                   ? 1
           : p == kStrided                       ? 57
           : p == kBlockSum                      ? 64
           : p == kGather72 || p == kGather72x16 ? 72
                                                 : 8;
  }

  template <int P>
  __device__ __forceinline__ static void step(int32_t (&a)[kRows], int it,
                                              const int32_t* __restrict__,
                                              const int32_t* xs,
                                              int32_t* red) {
    const int l = threadIdx.x;
    int32_t n[kRows];
    // x + it at row r of this lane
    auto u = [&](int r) { return wadd(xs[r * kLane + l], it); };
    if constexpr (P == kBase) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) n[r] = wadd(a[r], 1);
    } else if constexpr (P == kExpandBcast) {
      // row r of the expand is the operand's row r >> 3 = 0
      const int32_t v = u(0);
#pragma unroll
      for (int r = 0; r < kRows; ++r) n[r] = wadd(a[r], v);
    } else if constexpr (P == kExpandRepeat) {
      // pltpu.repeat tiles: row r is the operand's row r
#pragma unroll
      for (int r = 0; r < kRows; ++r) n[r] = wadd(a[r], u(r));
    } else if constexpr (P == kStrided) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) n[r] = wadd(a[r], u(8 * r));
    } else if constexpr (P == kMinR || P == kMinU) {
      int32_t w[kRows], m[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int32_t v = u(r);
        w[r] = v > 0 ? v : 999;
      }
      lane_min(w, m, red);
#pragma unroll
      for (int r = 0; r < kRows; ++r) n[r] = wadd(a[r], m[r]);
    } else if constexpr (P == kSelR || P == kSelU) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int32_t v = u(r);
        n[r] = wadd(a[r], v > 32 ? v : wadd(v, 1));
      }
    } else if constexpr (P == kAdd10) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        int32_t s = 0;
#pragma unroll
        for (int k = 0; k < 10; ++k) s = wadd(s, wadd(u(r), k));
        n[r] = wadd(wadd(wadd(a[r], wmul(s, 0)), wmul(a[r], 0)), 1);
      }
    } else if constexpr (P == kBlockSum) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        int32_t s = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) s = wadd(s, u(8 * r + k));
        n[r] = wadd(a[r], s);
      }
    } else if constexpr (P == kGather72) {
      const int i = u(0) & 127;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        n[r] = wadd(a[r], wadd(xs[r * kLane + i], it));
    } else if constexpr (P == kGather72x16) {
      int32_t s[kRows] = {};
#pragma unroll
      for (int g = 0; g < 16; ++g) {
        const int i = u(g) & 127;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          s[r] = wadd(s[r], wadd(xs[r * kLane + i], it));
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) n[r] = wadd(a[r], s[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) a[r] = n[r];
  }
};

}  // namespace

extern "C" int micro_expand(int probe, const int32_t* x, int rows,
                            int32_t* out, int iters, void* stream) {
  return run_probe<Expand>(probe, x, rows, out, iters, stream);
}
