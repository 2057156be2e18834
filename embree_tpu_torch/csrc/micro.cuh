// What the three loop-probe kernels share (micro_ops.cu, micro_expand.cu,
// micro_v8.cu).
//
// Replaces the loop of the TPU measurement harnesses perf/micro_ops.py::run
// (:41), perf/micro_expand.py::bench (:23) and perf/micro_v8.py::run (:21):
// one Pallas program carries an int32 tile through `iters` iterations of a
// probe body, acc = body(acc, it, x), acc starting as x's first rows, and
// writes the tile out. Each probe is a template instantiation here; each
// launch is one block on one SM, as the harness is one program on one
// TensorCore.
//
// Layout: a thread holds one lane column of whole 8-row blocks of the
// tile in registers (an (8,128) tile is 128 threads of 8 rows; a (128,128)
// tile 1024 threads of 16 rows). Elementwise ops, selects and every
// sublane op inside an 8-row block (static and dynamic XOR gathers, rolls,
// bitonic stages, block sums) stay in registers. A row or scalar another
// thread holds (acc[0:1], acc[0:1, 0:1], acc[0:16]) goes through shared
// memory and one barrier; lane reductions are warp reductions plus shared
// memory across the warps. Every lane gather reads x, which is staged in
// shared memory once before the loop, as x sits in VMEM before the TPU
// kernel starts (except where the probe reads more than fits: see
// micro_ops.cu).
//
// What bounds a probe on an H100: the one SM's int32 rate (64 results per
// clock), fp32 rate (128) or shared-memory bandwidth (128 bytes per
// clock), and the latency of a loop that one warp per scheduler carries.
// The design keeps the loop: `iters` is a runtime argument, the loop runs
// one trip per iteration (#pragma unroll 1: an unrolled loop let ptxas fold
// four iterations of acc + 1 into acc + 4), and keep() pins each carried
// value at the end of every iteration, so no iteration is folded into
// another (nvcc still drops work whose result a probe itself discards, as
// in micro_expand's 10x add, whose sum is multiplied by 0, and shares
// work within an iteration, as the static XOR gather's pair sums).
//
// int32 arithmetic wraps, as XLA's does: +, - and * are computed in
// uint32_t (signed overflow is undefined in C++). float -> int32 is
// __float2int_rz: toward zero, saturated, NaN -> 0, as XLA converts.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace micro {

constexpr int kLane = 128;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

// XLA's f32 -> s32 convert
__device__ __forceinline__ int32_t f2i(float f) { return __float2int_rz(f); }

// The carried value at the end of an iteration: opaque to the optimizer,
// so each iteration is computed on its own.
__device__ __forceinline__ void keep(int32_t& v) {
  asm volatile("" : "+r"(v));
}

template <int N>
__device__ __forceinline__ void keep_all(int32_t (&a)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) keep(a[r]);
}

// Copy the first n words of x into shared memory, then a barrier.
__device__ __forceinline__ void stage(const int32_t* __restrict__ x,
                                      int32_t* xs, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = x[i];
  __syncthreads();
}

// Select among the 8 registers b[0..7] by a 3-bit index: a select network
// (7 selects), so a dynamic index needs no local memory.
__device__ __forceinline__ int32_t pick8(const int32_t* b, int idx) {
  const int32_t s0 = (idx & 1) ? b[1] : b[0];
  const int32_t s1 = (idx & 1) ? b[3] : b[2];
  const int32_t s2 = (idx & 1) ? b[5] : b[4];
  const int32_t s3 = (idx & 1) ? b[7] : b[6];
  const int32_t t0 = (idx & 2) ? s1 : s0;
  const int32_t t1 = (idx & 2) ? s3 : s2;
  return (idx & 4) ? t1 : t0;
}

// Minimum over the block of one value per thread: a warp reduction, the
// warps' minima in red[0 .. warps) (a buffer the caller alternates between
// iterations, so one barrier suffices), then every thread reads them all.
__device__ __forceinline__ int32_t block_min(int32_t v, int32_t* red) {
  const int warps = blockDim.x >> 5;
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int32_t m = red[0];
  for (int w = 1; w < warps; ++w) m = min(m, red[w]);
  return m;
}

// Minimum along the 128 lanes of each of the R rows a thread holds, for a
// block whose threads 0-127 hold the lanes (four warps): red holds 4 x R
// words and alternates between iterations.
template <int R>
__device__ __forceinline__ void lane_min(const int32_t (&v)[R],
                                         int32_t (&m)[R], int32_t* red) {
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int32_t s = __reduce_min_sync(0xffffffffu, v[r]);
    if ((threadIdx.x & 31) == 0) red[r * 4 + w] = s;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = min(min(red[r * 4], red[r * 4 + 1]),
               min(red[r * 4 + 2], red[r * 4 + 3]));
  }
}

// Shared memory above the 48 KB default needs the kernel's opt-in.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The loop of every probe. Unit (one per harness) gives the tile: kBlock
// threads, kRows rows a thread (thread t holds lane t & 127 of rows
// kRows * (t >> 7) on), x of kRowsIn rows; the rows of x probe P reads
// from shared memory (staged_rows); the scratch words an iteration uses
// (kScratchWords, in two halves that alternate between iterations, so one
// barrier an iteration suffices); and the probe's body, step<P>(a, it, x,
// staged x, scratch), which replaces a with the next iteration's tile.
template <class Unit, int P>
__global__ void __launch_bounds__(Unit::kBlock)
    loop_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                int iters) {
  constexpr int kRows = Unit::kRows;
  constexpr int kStaged = Unit::staged_rows(P) * kLane;
  extern __shared__ int32_t smem[];
  const int l = threadIdx.x & (kLane - 1);
  const int row0 = kRows * (threadIdx.x >> 7);
  if constexpr (kStaged > 0) stage(x, smem, kStaged);
  int32_t a[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) a[i] = x[(row0 + i) * kLane + l];
  // one trip per iteration: nvcc would unroll, and ptxas then fold the
  // unrolled iterations' arithmetic into one
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    Unit::template step<P>(a, it, x, smem,
                           smem + kStaged + (it & 1) * Unit::kScratchWords);
    keep_all(a);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) out[(row0 + i) * kLane + l] = a[i];
}

template <class Unit, int P>
cudaError_t launch_probe(const int32_t* x, int32_t* out, int iters,
                         cudaStream_t st) {
  const size_t smem =
      (Unit::staged_rows(P) * kLane + 2 * Unit::kScratchWords) *
      sizeof(int32_t);
  const cudaError_t e = allow_smem(loop_kernel<Unit, P>, smem);
  if (e != cudaSuccess) return e;
  loop_kernel<Unit, P><<<1, Unit::kBlock, smem, st>>>(x, out, iters);
  return cudaGetLastError();
}

template <class Unit, int... P>
cudaError_t dispatch(int probe, const int32_t* x, int32_t* out, int iters,
                     cudaStream_t st, std::integer_sequence<int, P...>) {
  cudaError_t e = cudaErrorInvalidValue;
  ((probe == P ? (e = launch_probe<Unit, P>(x, out, iters, st), 0) : 0),
   ...);
  return e;
}

// A harness's plain-C entry: the tile after `iters` iterations of probe
// `probe` on x (rows x 128 int32, rows = Unit::kRowsIn), written to out
// (kRows * kBlock / 128 rows); returns the launch's CUDA error
// (cudaErrorInvalidValue for an unknown probe or shape).
template <class Unit>
int run_probe(int probe, const int32_t* x, int rows, int32_t* out,
              int iters, void* stream) {
  if (rows != Unit::kRowsIn || iters < 0 || x == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      dispatch<Unit>(probe, x, out, iters, static_cast<cudaStream_t>(stream),
                     std::make_integer_sequence<int, Unit::kProbes>{}));
}

}  // namespace micro
