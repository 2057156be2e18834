// Hopper kernel of the loop probes of perf/micro_ops.py (run, :41; the
// probe bodies :56-135): one block of 128 threads carries the (8,128) int32
// tile, thread l its lane column l, rows 0-7 in registers. x is (512,128).
// Layout, arithmetic and what bounds a probe: micro.cuh.
//
// H100 primitive each TPU op becomes:
//   add, select, roll (sublane, within the 8 rows), 10x f32 mul-add:
//     registers (fp32 as separate __fmul_rn / __fadd_rn, no FMA);
//   lane gathers of (8/32/48/256,128) operands and the inner while's
//     gather: indexed reads of x staged in shared memory (rows 0-7, 0-31,
//     0-47, 0-255);
//   sublane gathers (8 and 32 rows): indexed reads of staged x;
//   scalar extract + dynamic-slice load: acc[0,0] through shared memory
//     and a barrier, then x's rows g*32 .. g*32+7 read from device memory
//     through L1: the probe can reach row 487, and x's 256 KB do not fit
//     in the 227 KB of shared memory;
//   scalar and row min: warp reductions (__reduce_min_sync) and shared
//     memory across the four warps.
//
// Build: see micro_v8.cu.
#include "micro.cuh"

namespace {

using namespace micro;

// the (8,128) tile in one block of 128 threads, x of (512,128)
struct Ops {
  static constexpr int kRowsIn = 512;
  static constexpr int kRows = 8;
  static constexpr int kBlock = kLane;
  static constexpr int kScratchWords = 4 * kRows;   // the warps' minima

  // probe ids: embree_tpu_torch/perf/micro_ops.py::PROBES, in the
  // harness's order
  enum : int {
    kAdd, kLane8, kLane32, kLane48, kLane256, kSub8, kSub32, kRoll,
    kDynSlice, kScalarMin, kRowMin, kSelect, kFma, kWhile, kProbes
  };

  // rows of x the probe reads from shared memory
  __host__ __device__ static constexpr int staged_rows(int p) {
    return p == kLane8 || p == kSub8 || p == kWhile ? 8
           : p == kLane32 || p == kSub32            ? 32
           : p == kLane48                           ? 48
           : p == kLane256                          ? 256
                                                    : 0;
  }

  template <int P>
  __device__ __forceinline__ static void step(int32_t (&a)[kRows], int it,
                                              const int32_t* __restrict__ x,
                                              const int32_t* xs,
                                              int32_t* red) {
    const int l = threadIdx.x;
    int32_t n[kRows];
    if constexpr (P == kAdd) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) n[r] = wadd(a[r], 1);
    } else if constexpr (P == kLane8) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        n[r] = wadd(a[r], xs[r * kLane + (a[r] & 127)]);
    } else if constexpr (P == kLane32) {
      // idx = acc[0:1] & 127: row 0 of this lane, held by this thread
      const int i = a[0] & 127;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        n[r] = wadd(wadd(wadd(wadd(a[r], xs[r * kLane + i]),
                              xs[(r + 8) * kLane + i]),
                         xs[(r + 16) * kLane + i]),
                    xs[(r + 24) * kLane + i]);
      }
    } else if constexpr (P == kLane48 || P == kLane256) {
      constexpr int hi = P == kLane48 ? 40 : 248;
      const int i = a[0] & 127;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        n[r] = wadd(wadd(a[r], xs[r * kLane + i]), xs[(r + hi) * kLane + i]);
    } else if constexpr (P == kSub8 || P == kSub32) {
      constexpr int m = P == kSub8 ? 7 : 31;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        n[r] = wadd(a[r], xs[(a[r] & m) * kLane + l]);
    } else if constexpr (P == kRoll) {
      // pltpu.roll(acc, 1, axis=0): row r gets row r - 1
#pragma unroll
      for (int r = 0; r < kRows; ++r) n[r] = wadd(a[r], a[(r + 7) & 7]);
    } else if constexpr (P == kDynSlice) {
      if (l == 0) *red = a[0];
      __syncthreads();
      const int g = *red & 15;
      const int32_t* t = x + g * 32 * kLane + l;
#pragma unroll
      for (int r = 0; r < kRows; ++r) n[r] = wadd(a[r], t[r * kLane]);
    } else if constexpr (P == kScalarMin) {
      int32_t m = a[0];
#pragma unroll
      for (int r = 1; r < kRows; ++r) m = min(m, a[r]);
      m = block_min(m, red);
#pragma unroll
      for (int r = 0; r < kRows; ++r) n[r] = wadd(a[r], m);
    } else if constexpr (P == kRowMin) {
      int32_t m[kRows];
      lane_min(a, m, red);
#pragma unroll
      for (int r = 0; r < kRows; ++r) n[r] = wadd(a[r], m[r]);
    } else if constexpr (P == kSelect) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        n[r] = a[r] > it ? wadd(a[r], 1) : a[r];
    } else if constexpr (P == kFma) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float f = __int2float_rn(a[r]);
#pragma unroll
        for (int k = 0; k < 10; ++k)
          f = __fadd_rn(__fmul_rn(f, 1.000001f), 0.5f);
        n[r] = wadd(a[r], f2i(f));
      }
    } else if constexpr (P == kWhile) {
      // a loop of 4 trips, kept a loop as the harness's while_loop
#pragma unroll
      for (int r = 0; r < kRows; ++r) n[r] = a[r];
#pragma unroll 1
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          n[r] = wadd(n[r], xs[r * kLane + (n[r] & 127)]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) a[r] = n[r];
  }
};

}  // namespace

extern "C" int micro_ops(int probe, const int32_t* x, int rows, int32_t* out,
                         int iters, void* stream) {
  return run_probe<Ops>(probe, x, rows, out, iters, stream);
}
