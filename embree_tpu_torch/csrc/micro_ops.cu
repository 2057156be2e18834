// Hopper kernel of the loop probes of perf/micro_ops.py (run, :41; the
// probe bodies :56-135): one block carries the (8,128) int32 tile in
// registers; x is (512,128). What bounds a probe, the loop and the block
// abstraction: micro.cuh.
//
// 1,024 elements do not fill an SM: most probes hold one lane column a
// thread (128 threads of 8 rows, a warp a scheduler), and an iteration
// waits on the last one's result, so a probe's floor is the latency of the
// chain from acc to acc' (and of the loop's counter and branch, which the
// probes whose bodies cannot fold take off most iterations by unrolling).
// Each probe runs the implementation its Cost (perf/micro_ops.py) counts:
//   add, select, roll (sublane, within the 8 rows), 10x f32 mul-add:
//     registers (fp32 as separate mul and add, no FMA);
//   lane gather of (8,128) and the inner while's gather: indexed reads of x
//     staged in shared memory (rows 0-7);
//   lane gathers of (32/48/256,128) operands summed to (8,128): one gather
//     of a table of x's rows summed once before the loop (8 rows in shared
//     memory), at acc[0, l] & 127, the thread's own row 0;
//   sublane gathers (8 and 32 rows): indexed reads of staged x (bank =
//     lane, no conflict);
//   scalar extract + dynamic-slice load: the 128 rows 32g + r (g < 16, r <
//     8) the slice can reach staged in shared memory (64 KB), and every
//     thread carries its copy of acc[0,0], which evolves on its own
//     (acc[0,0] + x[32 (acc[0,0] & 15), 0]): no device-memory read and no
//     barrier in the loop;
//   scalar min: the lane's 8 rows, a warp reduction (__reduce_min_sync),
//     the four warps' minima through shared memory read as one 16-byte
//     vector after the iteration's one barrier;
//   row min: warp w holds rows 2w and 2w + 1 (a thread 4 lanes of each), so
//     a row's minimum is 3 mins and a warp reduction: no barrier, no shared
//     memory.
//
// Build: see micro_v8.cu.
#include "micro.cuh"

namespace ops {

// probe ids: embree_tpu_torch/perf/micro_ops.py::PROBES, in the harness's
// order
enum : int {
  kAdd, kLane8, kLane32, kLane48, kLane256, kSub8, kSub32, kRoll,
  kDynSlice, kScalarMin, kRowMin, kSelect, kFma, kWhile, kProbes
};

using namespace micro;

constexpr int kRows = 8;

// the trip loop's unrolling for bodies that cannot fold
constexpr int kUnrolled = 4;



// 128 threads, thread l lane l's 8 rows
struct Lanes : ProbeBase {
  static constexpr int kBlock = kLane;

  struct State {
    int32_t a[kRows];
  };

  template <class B, class S>
  MICRO_HD static void init(const B& b, S* s, const int32_t* x, int32_t*) {
    b.each([&](int t, int k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[k].a[r] = x[r * kLane + t];
    });
  }

  template <class B, class S>
  MICRO_HD static void store(const B& b, S* s, int32_t* out, int) {
    b.each([&](int t, int k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) out[r * kLane + t] = s[k].a[r];
    });
  }

  template <class S>
  MICRO_HD static void keep(S& s) {
    keep_all(s.a);
  }
};

// Lanes with x's rows 0 .. ROWS-1 in shared memory
template <int ROWS>
struct Staged : Lanes {
  static constexpr int kSmemWords = ROWS * kLane;
  static constexpr int kUnroll = kUnrolled;

  template <class B, class S>
  MICRO_HD static void init(const B& b, S* s, const int32_t* x,
                            int32_t* xs) {
    Lanes::init(b, s, x, xs);
    stage_rows<kBlock>(b, x, xs, kSmemWords);
    b.sync();
  }
};

template <int P>
struct Probe;

template <>
struct Probe<kAdd> : Lanes {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t*) {
    b.each([&](int, int k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[k].a[r] = wadd(s[k].a[r], 1);
    });
  }
};

template <>
struct Probe<kLane8> : Staged<8> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t* xs) {
    b.each([&](int, int k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int32_t v = s[k].a[r];
        s[k].a[r] = wadd(v, xs[r * kLane + (v & (kLane - 1))]);
      }
    });
  }
};

// x's rows summed once into an (8,128) table: row r is x[r] + x[r + HI]
// (48 rows: HI = 40; 256 rows: 248), or for HI = 0 the four rows r + 8k of
// 32; an iteration gathers it at acc[0, l] & 127
template <int HI>
struct SummedTable : Lanes {
  static constexpr int kSmemWords = kRows * kLane;
  static constexpr int kUnroll = kUnrolled;

  template <class B, class S>
  MICRO_HD static void init(const B& b, S* s, const int32_t* x,
                            int32_t* table) {
    Lanes::init(b, s, x, table);
    b.each([&](int t, int) {
      for (int i = t; i < kSmemWords; i += kBlock) {
        int32_t v = x[i];
        if (HI == 0) {
          for (int k = 1; k < 4; ++k) v = wadd(v, x[i + 8 * k * kLane]);
        } else {
          v = wadd(v, x[i + HI * kLane]);
        }
        table[i] = v;
      }
    });
    b.sync();
  }

  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t* table) {
    b.each([&](int, int k) {
      const int idx = s[k].a[0] & (kLane - 1);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        s[k].a[r] = wadd(s[k].a[r], table[r * kLane + idx]);
    });
  }
};

template <>
struct Probe<kLane32> : SummedTable<0> {};

template <>
struct Probe<kLane48> : SummedTable<40> {};

template <>
struct Probe<kLane256> : SummedTable<248> {};

// x[acc & M, l]: row-major x, bank = lane; the address (acc & M) * 512
// bytes past the thread's column, one LOP3 and one LEA before the load,
// which is the chain an iteration carries
template <int M>
struct SublaneGather : Staged<M + 1> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t* xs) {
    b.each([&](int t, int k) {
      const int32_t* col = xs + t;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int32_t v = s[k].a[r];
        s[k].a[r] = wadd(v, load_at(col, static_cast<uint32_t>(v & M) << 9));
      }
    });
  }
};

template <>
struct Probe<kSub8> : SublaneGather<7> {};

template <>
struct Probe<kSub32> : SublaneGather<31> {};

// pltpu.roll(acc, 1, axis=0): row r plus row r - 1 (rows updated from the
// last down, so row r - 1 is still the old one)
template <>
struct Probe<kRoll> : Lanes {
  static constexpr int kUnroll = kUnrolled;

  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t*) {
    b.each([&](int, int k) {
      int32_t* a = s[k].a;
      const int32_t last = a[kRows - 1];
#pragma unroll
      for (int r = kRows - 1; r > 0; --r) a[r] = wadd(a[r], a[r - 1]);
      a[0] = wadd(a[0], last);
    });
  }
};

// x[32g : 32g + 8] for g = acc[0,0] & 15: x's rows 32g + r staged as row
// 8g + r; z, each thread's copy of acc[0,0], evolves by acc[0,0] +
// x[32g, 0]
template <>
struct Probe<kDynSlice> : Lanes {
  static constexpr int kSmemWords = 16 * kRows * kLane;
  static constexpr int kUnroll = kUnrolled;

  struct State {
    int32_t a[kRows];
    int32_t z;
  };

  template <class B, class S>
  MICRO_HD static void init(const B& b, S* s, const int32_t* x,
                            int32_t* xs) {
    Lanes::init(b, s, x, xs);
    b.each([&](int t, int k) {
      s[k].z = x[0];
      for (int i = t; i < kSmemWords; i += kBlock) {
        const int row = i / kLane;
        xs[i] = x[((row >> 3) * 32 + (row & 7)) * kLane + (i & (kLane - 1))];
      }
    });
    b.sync();
  }

  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t* xs) {
    b.each([&](int t, int k) {
      const int32_t z = s[k].z;
      const int32_t* slice = xs + (z & 15) * kRows * kLane;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        s[k].a[r] = wadd(s[k].a[r], slice[r * kLane + t]);
      s[k].z = wadd(z, slice[0]);
    });
  }

  MICRO_HD static void keep(State& s) {
    keep_all(s.a);
    micro::keep(s.z);
  }

  template <class B, class S>
  MICRO_HD static void store_aux(const B& b, S* s, int32_t* aux) {
    b.each([&](int t, int k) { aux[t] = s[k].z; });
  }
};

// the lane's 8 rows, the warp's minimum, then the four warps' minima
// (two buffers of 4 words, so one barrier an iteration)
template <>
struct Probe<kScalarMin> : Lanes {
  static constexpr int kSmemWords = 8;

  struct State {
    int32_t a[kRows];
    int32_t m;
  };

  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int it, int32_t* smem) {
    int32_t* red = smem + (it & 1) * 4;
    b.each([&](int, int k) {
      const int32_t* a = s[k].a;
      s[k].m = imin(imin(imin(a[0], a[1]), imin(a[2], a[3])),
                    imin(imin(a[4], a[5]), imin(a[6], a[7])));
    });
    b.warp_min(s, [](S& q) -> int32_t& { return q.m; });
    b.each([&](int t, int k) { red[t >> 5] = s[k].m; });
    b.sync();
    b.each([&](int, int k) {
      int32_t w[4];
      load4(red, w);
      const int32_t m = imin(imin(w[0], w[1]), imin(w[2], w[3]));
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[k].a[r] = wadd(s[k].a[r], m);
    });
  }

  MICRO_HD static void keep(State& s) { keep_all(s.a); }
};

// warp w holds rows 2w and 2w + 1, thread q of it lanes q + 32j (j < 4) of
// each, at a[4h + j] for row 2w + h
template <>
struct Probe<kRowMin> : ProbeBase {
  static constexpr int kBlock = kLane;

  struct State {
    int32_t a[kRows];
    int32_t m[2];
  };

  MICRO_HD static int at(int t, int i) {
    return (2 * (t >> 5) + (i >> 2)) * kLane + (t & 31) + 32 * (i & 3);
  }

  template <class B, class S>
  MICRO_HD static void init(const B& b, S* s, const int32_t* x, int32_t*) {
    b.each([&](int t, int k) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[k].a[i] = x[at(t, i)];
    });
  }

  template <class B, class S>
  MICRO_HD static void store(const B& b, S* s, int32_t* out, int) {
    b.each([&](int t, int k) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) out[at(t, i)] = s[k].a[i];
    });
  }

  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t*) {
    b.each([&](int, int k) {
      const int32_t* a = s[k].a;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        s[k].m[h] = imin(imin(a[4 * h], a[4 * h + 1]),
                         imin(a[4 * h + 2], a[4 * h + 3]));
    });
    b.warp_min(s, [](S& q) -> int32_t& { return q.m[0]; });
    b.warp_min(s, [](S& q) -> int32_t& { return q.m[1]; });
    b.each([&](int, int k) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        s[k].a[i] = wadd(s[k].a[i], s[k].m[i >> 2]);
    });
  }

  MICRO_HD static void keep(State& s) { keep_all(s.a); }
};

template <>
struct Probe<kSelect> : Lanes {
  static constexpr int kUnroll = kUnrolled;

  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int it, int32_t*) {
    b.each([&](int, int k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int32_t v = s[k].a[r];
        s[k].a[r] = v > it ? wadd(v, 1) : v;
      }
    });
  }
};

template <>
struct Probe<kFma> : Lanes {
  static constexpr int kUnroll = kUnrolled;

  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t*) {
    b.each([&](int, int k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float f = i2f(s[k].a[r]);
#pragma unroll
        for (int j = 0; j < 10; ++j) f = fadd(fmul(f, 1.000001f), 0.5f);
        s[k].a[r] = wadd(s[k].a[r], f2i(f));
      }
    });
  }
};

// the harness's while_loop of 4 trips, each a gather of x[0:8] at acc & 127
template <>
struct Probe<kWhile> : Staged<8> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t* xs) {
    b.each([&](int, int k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int32_t v = s[k].a[r];
          s[k].a[r] = wadd(v, xs[r * kLane + (v & (kLane - 1))]);
        }
      }
    });
  }
};

struct Ops {
  static constexpr int kRowsIn = 512;
  static constexpr int kProbes = ops::kProbes;
  template <int P>
  using Probe = ops::Probe<P>;
};

}  // namespace ops

#ifdef __CUDACC__
// The SM clock against the global timer, which CUDA events read: one thread
// spins `cycles` clock64() cycles; out = {cycles counted, ns elapsed}.
__global__ void sm_clock_kernel(long long* out, long long cycles) {
  long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  const long long c0 = clock64();
  long long c = c0;
  while (c - c0 < cycles) c = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  out[0] = c - c0;
  out[1] = t1 - t0;
}

extern "C" int micro_sm_clock(long long* out, long long cycles,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sm_clock_kernel<<<1, 1, 0, st>>>(out, cycles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int micro_ops(int probe, const int32_t* x, int rows, int32_t* out,
                         int iters, void* stream) {
  return micro::run_unit<ops::Ops>(probe, x, rows, out, iters, stream);
}
#endif
