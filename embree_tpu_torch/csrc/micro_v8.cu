// Hopper kernel of the loop probes of perf/micro_v8.py (run, :21; the probe
// bodies :52-204): one block of 1024 threads carries the (128,128) int32
// tile, thread t the lane column t & 127 of rows 16g .. 16g + 15 (g = t >>
// 7: two whole 8-row blocks) in registers. x is (512,128). Layout,
// arithmetic and what bounds a probe: micro.cuh.
//
// H100 primitive each TPU op becomes:
//   elementwise chain, select, the 5-op compact chain: registers;
//   static XOR-4 gather, the roll-form block XOR, the block-sum butterfly,
//     the block reduce, and all four 6-stage bitonic networks (gather and
//     roll form, key only and key + ref, per group): registers, every
//     partner row in the same thread's 8-row block;
//   dynamic block-local sublane gather (acc & 7 per element): a select
//     network over the block's 8 registers (micro::pick8), no local memory;
//   (16,128) -> (128,128) expand and the compact chain's concat x8: rows
//     0-15 through shared memory (group 0 writes, one barrier);
//   72-row lane gathers (with and without a dynamic slice, the 9x (8,128)
//     form, the gather + select merge): acc[0:1] (or acc[0:8]) through
//     shared memory, then indexed reads of x staged in shared memory (rows
//     0-71, 0-287, 0-255, 0-143).
// The roll form's partner rows (r + j or r - j, picked by row & j) are row
// r ^ j, so the roll and gather forms of a network are one body: on the
// card a sublane roll inside a thread's block is free.
//
// Build (one library of the three units, compiled in parallel):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xptxas -v -Xcompiler -fPIC -c micro_v8.cu -o micro_v8.o
//   (likewise micro_ops.cu and micro_expand.cu)
//   nvcc -gencode arch=compute_90a,code=sm_90a -shared micro_ops.o
//        micro_expand.o micro_v8.o -o libmicro_cuda.so
#include "micro.cuh"

namespace {

using namespace micro;

// the (128,128) tile in one block of 1024 threads, x of (512,128)
struct V8 {
  static constexpr int kRowsIn = 512;
  static constexpr int kRows = 16;            // rows a thread holds
  static constexpr int kBlock = 1024;
  // rows 0 .. 15 of the tile, which group 0 holds, as every thread reads
  // them
  static constexpr int kScratchWords = 16 * kLane;

  // probe ids: embree_tpu_torch/perf/micro_v8.py::PROBES
  enum : int {
    kBase, kChain, kSelect, kXor4, kDynBlock, kXorRoll, kButterfly,
    kExpand16, kReduceRows, kGather72, kDyn72, kDyn32, kMerge72, kGather8x9,
    kCompact, kBitonicGather, kBitonicRoll, kBitonicRef, kBitonicGroup,
    kProbes
  };

  // rows of x the probe reads (from shared memory)
  __host__ __device__ static constexpr int staged_rows(int p) {
    return p == kGather72 || p == kGather8x9 ? 72
           : p == kDyn72                     ? 288
           : p == kDyn32                     ? 256
           : p == kMerge72                   ? 144
                                             : 0;
  }

  // rows 0 .. N-1 (group 0's) written to buf for every thread, then a
  // barrier
  template <int N>
  __device__ __forceinline__ static const int32_t* share(
      const int32_t (&a)[kRows], int32_t* buf) {
    if (threadIdx.x < kLane) {
#pragma unroll
      for (int j = 0; j < N; ++j) buf[j * kLane + threadIdx.x] = a[j];
    }
    __syncthreads();
    return buf;
  }

  // One compare-exchange stage (k, j) of micro_v8.py's bitonic networks on
  // both 8-row blocks, with the harness's rule: swap = (partner < key) ==
  // keepmin, so on equal keys exactly one side of a pair takes the
  // partner's ref. The partner is row r ^ j, which is also what the roll
  // form reads (rows r + j and r - j, picked by row & j).
  template <int K, int J, bool REF>
  __device__ __forceinline__ static void bitonic_stage(
      int32_t (&key)[kRows], int32_t (&ref)[kRows]) {
    int32_t nk[kRows], nr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int rc = i & 7;
      const int p = i ^ J;
      const bool keepmin = ((rc & K) == 0) == ((rc & J) == 0);
      const bool swap = (key[p] < key[i]) == keepmin;
      nk[i] = swap ? key[p] : key[i];
      if (REF) nr[i] = swap ? ref[p] : ref[i];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      key[i] = nk[i];
      if (REF) ref[i] = nr[i];
    }
  }

  template <bool REF>
  __device__ __forceinline__ static void bitonic6(int32_t (&key)[kRows],
                                                  int32_t (&ref)[kRows]) {
    bitonic_stage<2, 1, REF>(key, ref);
    bitonic_stage<4, 2, REF>(key, ref);
    bitonic_stage<4, 1, REF>(key, ref);
    bitonic_stage<8, 4, REF>(key, ref);
    bitonic_stage<8, 2, REF>(key, ref);
    bitonic_stage<8, 1, REF>(key, ref);
  }

  template <int P>
  __device__ __forceinline__ static void step(int32_t (&a)[kRows], int it,
                                              const int32_t* __restrict__,
                                              const int32_t* xs,
                                              int32_t* buf) {
    const int l = threadIdx.x & (kLane - 1);
    const int g = threadIdx.x >> 7;
    int32_t n[kRows];
    // row of the 72-row operand that tile row 16g + i reads:
    // concatenate([got, got[0:56]])
    auto r72 = [&](int i) {
      const int r = 16 * g + i;
      return r < 72 ? r : r - 72;
    };
    if constexpr (P == kBase) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) n[i] = wadd(a[i], 1);
    } else if constexpr (P == kChain) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int32_t v = a[i];
        n[i] = wadd(v, wmul(wadd(wmul(v, 3), 1) ^ (v >> 2), wadd(v | 1, it)));
      }
    } else if constexpr (P == kSelect) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        n[i] = a[i] > it ? wadd(a[i], 1) : wsub(a[i], 1);
    } else if constexpr (P == kXor4) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) n[i] = wadd(a[i], a[i ^ 4]);
    } else if constexpr (P == kDynBlock) {
      // row (r & ~7) | ((r ^ acc) & 7) of the tile: in this thread's block
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        n[i] = wadd(a[i], pick8(a + (i & 8), (i ^ a[i]) & 7));
    } else if constexpr (P == kXorRoll) {
      // rolls by 128 - 4 and 4, then the select keeps the in-block row
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        n[i] = wadd(a[i], (i & 4) == 0 ? a[i + 4] : a[i - 4]);
    } else if constexpr (P == kButterfly) {
      int32_t b[kRows], c[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) b[i] = a[i];
#pragma unroll
      for (int s = 1; s <= 4; s <<= 1) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          c[i] = wadd(b[i], (i & s) == 0 ? b[i + s] : b[i - s]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) b[i] = c[i];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) n[i] = wadd(a[i], b[i]);
    } else if constexpr (P == kExpand16) {
      // row r of the expand is acc's row r >> 3
      const int32_t* s = share<16>(a, buf);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        n[i] = wadd(a[i], s[(2 * g + (i >> 3)) * kLane + l]);
    } else if constexpr (P == kReduceRows) {
      int32_t s[2] = {0, 0};
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i >> 3] = wadd(s[i >> 3], a[i]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) n[i] = wadd(a[i], s[i >> 3]);
    } else if constexpr (P == kGather72 || P == kDyn72 || P == kDyn32 ||
                         P == kMerge72) {
      const int32_t* s = share<1>(a, buf);
      const int32_t row0 = s[l];
      const int idx = row0 & 127;
      // the dynamic slice's start: acc[0, 0] & 3 (x 72) or & 7 (x 32)
      const int base = P == kDyn72 ? (s[0] & 3) * 72
                       : P == kDyn32 ? (s[0] & 7) * 32
                                     : 0;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        // concatenate([got] * 4) for the 32-row slice
        const int r = P == kDyn32 ? ((16 * g + i) & 31) : r72(i);
        int32_t v = xs[(base + r) * kLane + idx];
        if constexpr (P == kMerge72) {
          if ((row0 & 1) == 0) v = xs[(72 + r) * kLane + l];
        }
        n[i] = wadd(a[i], v);
      }
    } else if constexpr (P == kGather8x9) {
      // record k's 8 rows gathered by acc[0:8] & 127
      const int32_t* s = share<8>(a, buf);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r72(i);
        n[i] = wadd(a[i], xs[r * kLane + (s[(r & 7) * kLane + l] & 127)]);
      }
    } else if constexpr (P == kCompact) {
      // group 0 updates the compact (16,128) state, every thread reads it
      // back concatenated x8: tile row 16g + i gets compact row i
      if (threadIdx.x < kLane) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int32_t c = a[i];
          buf[i * kLane + l] = wadd(wmul(c > it ? wadd(c, 1) : wsub(c, 1), 3),
                                    c >> 1);
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kRows; ++i) n[i] = wadd(a[i], buf[i * kLane + l]);
    } else if constexpr (P == kBitonicGather || P == kBitonicRoll) {
      int32_t key[kRows], ref[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) key[i] = a[i];
      bitonic6<false>(key, ref);
#pragma unroll
      for (int i = 0; i < kRows; ++i) n[i] = wadd(key[i], 1);
    } else if constexpr (P == kBitonicRef || P == kBitonicGroup) {
      // the tile-parallel form and the per-group form (16 groups of 8 rows)
      // are one function: every stage stays inside an 8-row block
      int32_t key[kRows], ref[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        key[i] = a[i];
        ref[i] = a[i] ^ 12345;
      }
      bitonic6<true>(key, ref);
#pragma unroll
      for (int i = 0; i < kRows; ++i) n[i] = wadd(key[i], ref[i]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = n[i];
  }
};

static_assert(V8::kRows * (V8::kBlock / kLane) == 128, "tile rows");

}  // namespace

extern "C" int micro_v8(int probe, const int32_t* x, int rows, int32_t* out,
                        int iters, void* stream) {
  return run_probe<V8>(probe, x, rows, out, iters, stream);
}
