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
// What bounds a probe on an H100 (perf/micro.py::bound_ms): the one SM's
// integer ALU (64 results a clock: logic, shifts, compares, selects, min,
// max, three-input adds), its int32 rate over the ALU and the FMA pipe
// together (128: IMAD takes adds and multiplies), fp32 (128), shared-memory
// bandwidth (128 bytes, one wavefront, a clock), and, where a probe's tile
// is small, the latency of the chain that one iteration carries.
//
// Each probe runs in the layout in which its least-work implementation (its
// Cost) needs the fewest exchanges: a thread holds lane columns of whole
// 8-row blocks, as many rows as the probe's data flow wants (the (128,128)
// tile in 128 threads of 128 rows where rows 0-15 feed every row, in
// 128-512 threads, the fastest measured, where 8-row blocks stand alone),
// or part of a row (a row in a warp or a half warp: the row minima). A
// value that evolves on its own (acc[0,0] of a dynamic slice, a row's
// least word with x + it > 0) is carried by every thread that needs
// it; x, or a table of x, is held in registers or staged in shared memory
// before the loop. Each probe is written once, against a block `B` (Dev:
// one CUDA thread; Host: every thread of the block in turn, for the g++
// twin in micro_cpu.cpp), as per-thread passes (B::each) between barriers
// (B::sync) and warp reductions (B::warp_min).
//
// The loop (loop()): `iters` is a runtime argument, and keep() pins each
// carried value at the end of every iteration, so no iteration is folded
// into another. Most probes run one trip an iteration (#pragma unroll 1):
// an unrolled loop let ptxas fold four iterations of acc + 1 into acc + 4,
// and merge the adds of acc + m (m not from acc) in pairs, since keep() is
// an empty asm that ptxas does not see; where a probe's body cannot fold
// (a gather, a compare against `it`, a select), the trip loop is unrolled
// by kUnroll with keep() between iterations and a remainder loop, which
// takes the counter and branch (that the bound does not count) off most
// iterations. A probe that carries less than the tile (the XOR-4 pair
// sums) peels its first iteration (kPeel); one whose operand moves only at
// some iterations may run the loop itself (kOwnLoop: micro_expand's masked
// min and select, in stretches between the iterations at which a word's
// x + it crosses the probe's threshold).
//
// probe_kernel asks for one block an SM (__launch_bounds__(threads, 1)):
// without it ptxas capped 512-thread probes at 40 registers and spilled.
//
// int32 arithmetic wraps, as XLA's does: +, - and * are computed in
// uint32_t (signed overflow is undefined in C++). float -> int32 is
// __float2int_rz: toward zero, saturated, NaN -> 0, as XLA converts.
#pragma once

#include <stdint.h>

#include <cstring>
#include <utility>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MICRO_HD __host__ __device__ __forceinline__
#else
#define MICRO_HD inline
#endif

namespace micro {

constexpr int kLane = 128;

MICRO_HD int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

MICRO_HD int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

MICRO_HD int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

MICRO_HD int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }
MICRO_HD int32_t imax(int32_t a, int32_t b) { return a < b ? b : a; }

// XLA's f32 -> s32 convert
MICRO_HD int32_t f2i(float f) {
#ifdef __CUDA_ARCH__
  return __float2int_rz(f);
#else
  if (f != f) return 0;
  if (f >= 2147483648.0f) return INT32_MAX;
  if (f < -2147483648.0f) return INT32_MIN;
  return static_cast<int32_t>(f);
#endif
}

MICRO_HD float i2f(int32_t v) {
#ifdef __CUDA_ARCH__
  return __int2float_rn(v);
#else
  return static_cast<float>(v);
#endif
}

// a * b and a + b in fp32, rounded each, never contracted into an FMA
MICRO_HD float fmul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

MICRO_HD float fadd(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

// v = p[0..3], one 16-byte read (p 16-byte aligned)
MICRO_HD void load4(const int32_t* p, int32_t (&v)[4]) {
#ifdef __CUDA_ARCH__
  const int4 w = *reinterpret_cast<const int4*>(p);
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
#else
  std::memcpy(v, p, sizeof(v));
#endif
}

// The word `bytes` bytes past p, p in shared memory: the address as a
// 32-bit shared-window offset, so that (i & m) << s + p is one LOP3 and one
// LEA before the load
MICRO_HD int32_t load_at(const int32_t* p, uint32_t bytes) {
#ifdef __CUDA_ARCH__
  const uint32_t a =
      static_cast<uint32_t>(__cvta_generic_to_shared(p)) + bytes;
  int32_t v;
  asm("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
#else
  return p[bytes / sizeof(int32_t)];
#endif
}

// The carried value at the end of an iteration: opaque to the optimizer,
// so each iteration is computed on its own.
MICRO_HD void keep(int32_t& v) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(v));
#else
  (void)v;
#endif
}

template <int N>
MICRO_HD void keep_all(int32_t (&a)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) keep(a[r]);
}

// One compare-exchange: lo takes the minimum, hi the maximum.
MICRO_HD void cx(int32_t& lo, int32_t& hi) {
  const int32_t l = imin(lo, hi);
  hi = imax(lo, hi);
  lo = l;
}

// k[0..7] sorted ascending by an optimal network of 19 compare-exchanges
// in 6 layers (Knuth, TAOCP vol. 3, 5.3.4): any sorting network gives the
// sorted keys, as the harness's 24-exchange bitonic network does.
MICRO_HD void sort8(int32_t* k) {
  cx(k[0], k[2]); cx(k[1], k[3]); cx(k[4], k[6]); cx(k[5], k[7]);
  cx(k[0], k[4]); cx(k[1], k[5]); cx(k[2], k[6]); cx(k[3], k[7]);
  cx(k[0], k[1]); cx(k[2], k[3]); cx(k[4], k[5]); cx(k[6], k[7]);
  cx(k[2], k[4]); cx(k[3], k[5]);
  cx(k[1], k[4]); cx(k[3], k[6]);
  cx(k[1], k[2]); cx(k[3], k[4]); cx(k[5], k[6]);
}

// ---------------------------------------------------------------------------
// the block a probe is written against
// ---------------------------------------------------------------------------

// On the card: one thread, whose state is slot 0 of the probe's state
// array.
struct Dev {
  template <class F>
  MICRO_HD void each(F f) const {
#ifdef __CUDA_ARCH__
    f(static_cast<int>(threadIdx.x), 0);
#else
    (void)f;
#endif
  }

  MICRO_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }

  // get(state) is a word of every lane; each lane's becomes the warp's
  // minimum
  template <class S, class G>
  MICRO_HD void warp_min(S* s, G get) const {
#ifdef __CUDA_ARCH__
    int32_t& v = get(s[0]);
    v = __reduce_min_sync(0xFFFFFFFFu, v);
#else
    (void)s;
    (void)get;
#endif
  }
};

#ifndef __CUDACC__
// On the host (the g++ twin): the block's threads one after another, slot
// t for thread t. A pass sees the shared words that earlier passes wrote,
// as the card's threads do after a barrier; a warp reduction takes the
// minimum over each 32 slots in lockstep.
struct Host {
  int threads;

  template <class F>
  void each(F f) const {
    for (int t = 0; t < threads; ++t) f(t, t);
  }

  void sync() const {}

  template <class S, class G>
  void warp_min(S* s, G get) const {
    for (int w = 0; w < threads; w += 32) {
      int32_t m = get(s[w]);
      for (int l = 1; l < 32; ++l) m = imin(m, get(s[w + l]));
      for (int l = 0; l < 32; ++l) get(s[w + l]) = m;
    }
  }
};
#endif

// ---------------------------------------------------------------------------
// the probes' loop
// ---------------------------------------------------------------------------

// What a probe leaves to the defaults: no shared memory, no peeled first
// iteration, one trip an iteration, the trips run by loop().
struct ProbeBase {
  static constexpr int kSmemWords = 0;
  static constexpr bool kPeel = false;
  static constexpr int kUnroll = 1;
  static constexpr bool kOwnLoop = false;

  template <class B, class S>
  MICRO_HD static void store_aux(const B&, S*, int32_t*) {}
};

template <class Pr, class B, class S>
MICRO_HD void keep_state(const B& b, S* s) {
  b.each([&](int, int k) { Pr::keep(s[k]); });
}

// `iters` iterations of probe Pr on the state s (its smem words staged by
// init): the first peeled where Pr::kPeel, then Pr::kUnroll iterations a
// trip (keep() after each), then the remainder one a trip. A probe may run
// the iterations itself (Pr::kOwnLoop: Pr::run), keep() after each.
template <class Pr, class B, class S>
MICRO_HD void loop(const B& b, S* s, int iters, int32_t* smem) {
  if constexpr (Pr::kOwnLoop) {
    Pr::run(b, s, iters, smem);
  } else {
    int it = 0;
    if constexpr (Pr::kPeel) {
      if (iters > 0) {
        Pr::first(b, s, smem);
        keep_state<Pr>(b, s);
        it = 1;
      }
    }
    if constexpr (Pr::kUnroll > 1) {
#pragma unroll 1
      for (; it + Pr::kUnroll <= iters; it += Pr::kUnroll) {
#pragma unroll
        for (int u = 0; u < Pr::kUnroll; ++u) {
          Pr::step(b, s, it + u, smem);
          keep_state<Pr>(b, s);
        }
      }
    }
#pragma unroll 1
    for (; it < iters; ++it) {
      Pr::step(b, s, it, smem);
      keep_state<Pr>(b, s);
    }
  }
}

// Copy words [0, n) of x into shared memory, strided over the block's
// threads (the caller's barrier follows).
template <int T, class B>
MICRO_HD void stage_rows(const B& b, const int32_t* x, int32_t* xs, int n) {
  b.each([&](int t, int) {
    for (int i = t; i < n; i += T) xs[i] = x[i];
  });
}

#ifdef __CUDACC__
// The loop of every probe: Unit::Probe<P> gives the block (kBlock threads),
// the state a thread carries, its shared words and its passes.
template <class Unit, int P>
__global__ void __launch_bounds__(Unit::template Probe<P>::kBlock, 1)
    probe_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                 int iters) {
  using Pr = typename Unit::template Probe<P>;
  extern __shared__ __align__(16) int32_t probe_smem[];
  const Dev b;
  typename Pr::State s[1];
  Pr::init(b, s, x, probe_smem);
  loop<Pr>(b, s, iters, probe_smem);
  Pr::store(b, s, out, iters);
}

// Shared memory above the 48 KB default needs the kernel's opt-in.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <class Unit, int P>
cudaError_t launch_probe(const int32_t* x, int32_t* out, int iters,
                         cudaStream_t st) {
  using Pr = typename Unit::template Probe<P>;
  const size_t smem = Pr::kSmemWords * sizeof(int32_t);
  const cudaError_t e = allow_smem(probe_kernel<Unit, P>, smem);
  if (e != cudaSuccess) return e;
  probe_kernel<Unit, P><<<1, Pr::kBlock, smem, st>>>(x, out, iters);
  return cudaGetLastError();
}

template <class Unit, int... P>
cudaError_t dispatch_probe(int probe, const int32_t* x, int32_t* out,
                           int iters, cudaStream_t st,
                           std::integer_sequence<int, P...>) {
  cudaError_t e = cudaErrorInvalidValue;
  ((probe == P ? (e = launch_probe<Unit, P>(x, out, iters, st), 0) : 0),
   ...);
  return e;
}

// A harness's plain-C entry: the tile after `iters` iterations of probe
// `probe` on x (rows x 128 int32, rows = Unit::kRowsIn), written to out;
// returns the launch's CUDA error (cudaErrorInvalidValue for an unknown
// probe or shape).
template <class Unit>
int run_unit(int probe, const int32_t* x, int rows, int32_t* out, int iters,
             void* stream) {
  if (rows != Unit::kRowsIn || iters < 0 || x == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_probe<Unit>(
      probe, x, out, iters, static_cast<cudaStream_t>(stream),
      std::make_integer_sequence<int, Unit::kProbes>{}));
}

#else
// The twin's entry for a unit: probe `probe` run over Host on x, the tile
// written to out, and where aux is not null, the words a probe carries
// beside the tile (its copies of acc[0, 0], one a thread) to aux; returns
// 0, or 1 for an unknown probe or shape.
template <class Unit, int P>
void twin_probe(const int32_t* x, int32_t* out, int iters, int32_t* aux) {
  using Pr = typename Unit::template Probe<P>;
  const Host b{Pr::kBlock};
  typename Pr::State* s = new typename Pr::State[Pr::kBlock]();
  int32_t* smem = new int32_t[Pr::kSmemWords + 1]();
  Pr::init(b, s, x, smem);
  loop<Pr>(b, s, iters, smem);
  Pr::store(b, s, out, iters);
  if (aux != nullptr) Pr::store_aux(b, s, aux);
  delete[] smem;
  delete[] s;
}

template <class Unit, int... P>
int twin_dispatch(int probe, const int32_t* x, int32_t* out, int iters,
                  int32_t* aux, std::integer_sequence<int, P...>) {
  int e = 1;
  ((probe == P ? (twin_probe<Unit, P>(x, out, iters, aux), e = 0) : 0), ...);
  return e;
}

template <class Unit>
int twin_unit(int probe, const int32_t* x, int rows, int32_t* out, int iters,
              int32_t* aux) {
  if (rows != Unit::kRowsIn || iters < 0 || x == nullptr || out == nullptr)
    return 1;
  return twin_dispatch<Unit>(probe, x, out, iters, aux,
                             std::make_integer_sequence<int, Unit::kProbes>{});
}
#endif

}  // namespace micro
