// Hopper kernel of the loop probes of perf/micro_expand.py (bench, :23; the
// probe bodies :52-95): one block of 128 threads carries the (8,128) int32
// tile in registers; x is (128,128), and each probe reads x + it, a fresh
// operand every iteration. What bounds a probe, the loop and the block
// abstraction: micro.cuh.
//
// The probes compute a (16,128) or (128,128) operand and keep its rows 0-7
// ([0:8]), so the kernel computes rows 0-7 only, and the (16,128) and
// (128,128) forms of the masked min and the select are one function each.
// 1,024 elements do not fill an SM: where a probe's operand does not depend
// on acc, acc + operand could fold across unrolled iterations (ptxas merges
// such adds in pairs), so those probes run one trip an iteration and their
// floor is the loop's counter, compare and branch. Each probe runs the
// implementation its Cost (perf/micro_expand.py) counts; what it reads of x
// is the thread's own registers, or shared memory, from before the loop:
//   add, and the 10x add (its sum is multiplied by 0: acc + 1): registers;
//   reshape-broadcast and pltpu.repeat expands, the strided extract: acc +
//     x[row] + it, one three-input add an element, x's rows 0, 0-7 or 0,
//     8, .., 56 of the thread's lane held in registers;
//   block sum: each row's sum of x's 8-row block taken once, then acc + S
//     + 8 it;
//   select and masked min along the lanes: x + it > T (T = 32, 0) changes
//     only where it crosses T or wraps, at most twice a word in 2^31
//     iterations (Crossings), so the block runs its iterations in
//     stretches between the crossings of any of its words, with no
//     reduction, barrier, exchange or branch but the loop's own in an
//     iteration:
//       select: thread l x's rows 0-7 of lane l, acc + (x + c - 1) + (it +
//         1), c = [x + it <= 32] re-derived at each crossing;
//       masked min: a row in a half warp (thread t lanes (t & 15) + 16 j of
//         row t >> 4), the row's minimum min(lo + it, cap), lo the least
//         word with x + it > 0 and cap 999 where some word has none (else
//         none), both taken from the row in shared memory at each crossing;
//   one and sixteen 72-row group gathers: x's rows 0-7 staged transposed
//     (word i * 12 + r; 8 rows padded to 12 words, so that a quarter warp's
//     16-byte reads at 8 consecutive indices meet 8 bank quads: fewer
//     wavefronts than row-major x or a stride of 8 on distinct rows, as few
//     on the harness's), two 16-byte reads an index, the index (x[g, l] +
//     it) & 127 from the thread's own rows of x; trips unrolled x4, so that
//     several iterations' reads are in flight.
// Beside the probes, id kMinRowForm runs the masked min as a reduction
// every iteration, in micro_ops' row-min layout (perf/micro_expand.py::
// ROW_MIN_FORM): the price of a masked lane minimum whose operand is new
// each iteration, which the crossings do not give.
//
// Build: see micro_v8.cu.
#include "micro.cuh"

namespace expand {

// probe ids: embree_tpu_torch/perf/micro_expand.py::PROBES, in the
// harness's order
enum : int {
  kBase, kExpandBcast, kExpandRepeat, kStrided, kMinR, kMinU, kSelR,
  kSelU, kAdd10, kBlockSum, kGather72, kGather72x16, kProbes
};

// the masked min as a per-iteration reduction, after the probes
constexpr int kMinRowForm = kProbes;

using namespace micro;

constexpr int kRows = 8;
constexpr int kTileWords = kRows * kLane;

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

// Lanes, with word r (r < 8) of a table of the thread's lane of x,
// T::word(x, r, l), held in registers from before the loop
template <class T>
struct Held : Lanes {
  struct State {
    int32_t a[kRows];
    int32_t x[kRows];
  };

  template <class B, class S>
  MICRO_HD static void init(const B& b, S* s, const int32_t* x, int32_t*) {
    b.each([&](int t, int k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[k].a[r] = x[r * kLane + t];
        s[k].x[r] = T::word(x, r, t);
      }
      // opaque, so that no sum of x's words is taken again in the loop
      keep_all(s[k].x);
    });
  }
};

// x's row STRIDE * r at tile row r, less D
template <int STRIDE, int D = 0>
struct RowOf {
  MICRO_HD static int32_t word(const int32_t* x, int r, int l) {
    return wsub(x[STRIDE * r * kLane + l], D);
  }
};

// the sum of x's rows 8r .. 8r + 7
struct BlockOf {
  MICRO_HD static int32_t word(const int32_t* x, int r, int l) {
    int32_t v = 0;
    for (int k = 0; k < 8; ++k) v = wadd(v, x[(8 * r + k) * kLane + l]);
    return v;
  }
};

template <int P>
struct Probe;

template <>
struct Probe<kBase> : Lanes {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t*) {
    b.each([&](int, int k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[k].a[r] = wadd(s[k].a[r], 1);
    });
  }
};

// the 10x add's sum is multiplied by 0: acc + 1
template <>
struct Probe<kAdd10> : Probe<kBase> {};

// acc + x[STRIDE * r] + it: the broadcast expand's row r >> 3 is row 0, the
// repeat tiles (row r), the strided extract takes every 8th row. The thread
// holds x - 1 and adds it + 1, opaque, so that it is not the loop's
// counter: adding the counter itself put its increment after the adds (45
// clocks an iteration, against 30), and a visible it + 1 went back onto
// x's side.
template <int STRIDE>
struct PlusRow : Held<RowOf<STRIDE, 1>> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int it, int32_t*) {
    int v = wadd(it, 1);
    micro::keep(v);
    b.each([&](int, int k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        s[k].a[r] = wadd(wadd(s[k].a[r], s[k].x[r]), v);
    });
  }
};

template <>
struct Probe<kExpandBcast> : PlusRow<0> {};

template <>
struct Probe<kExpandRepeat> : PlusRow<1> {};

template <>
struct Probe<kStrided> : PlusRow<8> {};

// the 8 rows of x's block summed once: acc + S + 8 it, 8 it opaque (a
// visible one became each row's own S + 8 it, stepped by 8: twice the
// adds)
template <>
struct Probe<kBlockSum> : Held<BlockOf> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int it, int32_t*) {
    int it8 = wmul(it, 8);
    micro::keep(it8);
    b.each([&](int, int k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        s[k].a[r] = wadd(wadd(s[k].a[r], s[k].x[r]), it8);
    });
  }
};

// The first iteration after `it` at which x + it > T changes, INT32_MAX if
// none comes before 2^31: the two iterations at which it can, counted mod
// 2^32, are T + 1 - x (x + it reaches T + 1) and 2^31 - x (x + it wraps
// from INT_MAX to INT_MIN).
MICRO_HD int32_t next_crossing(int32_t x, int32_t T, int it) {
  const uint32_t up = static_cast<uint32_t>(T) + 1u - static_cast<uint32_t>(x);
  const uint32_t wrap = 0x80000000u - static_cast<uint32_t>(x);
  const uint32_t i = static_cast<uint32_t>(it);
  uint32_t n = INT32_MAX;
  if (up > i && up < n) n = up;
  if (wrap > i && wrap < n) n = wrap;
  return static_cast<int32_t>(n);
}

// A probe whose operand moves only where a word's x + it crosses its
// threshold runs its iterations in stretches (kOwnLoop), the same for the
// whole block, so that no warp diverges: P::refresh(z, t, smem, it)
// re-derives each thread's operand at `it` and sets z.next, the first
// iteration after it at which the thread's operand moves; the block takes
// the least of those (a warp reduction and the 4 warps' minima through
// P::kSmemWords' last 4 words) and runs P::add to it, or to the last
// iteration, one trip an iteration (unrolled, ptxas merged the adds of two
// iterations into one), keep() after each. (Stretches a thread's own, on
// the harness's x, split the select's warps at its lanes' 33 crossings and
// ran 66 clocks an iteration.)
template <class P, class Base = ProbeBase>
struct Crossings : Base {
  static constexpr bool kOwnLoop = true;

  template <class B, class S>
  MICRO_HD static void run(const B& b, S* s, int iters, int32_t* smem) {
    int32_t* w = smem + P::kSmemWords - 4;
    for (int it = 0; it < iters;) {
      b.each([&](int t, int k) { P::refresh(s[k], t, smem, it); });
      b.warp_min(s, [](S& q) -> int32_t& { return q.next; });
      b.each([&](int t, int k) {
        if ((t & 31) == 0) w[t >> 5] = s[k].next;
      });
      b.sync();
      const int end = imin(imin(imin(w[0], w[1]), imin(w[2], w[3])), iters);
      b.sync();
      b.each([&](int, int k) {
#pragma unroll 1
        for (int i = it; i < end; ++i) {
          P::add(s[k], i);
          P::keep(s[k]);
        }
      });
      it = end;
    }
  }
};

// v = x + it; acc + (v > 32 ? v : v + 1) = acc + (x + c - 1) + (it + 1),
// c = [x + it <= 32]; it + 1 opaque, as PlusRow's
struct Select : Crossings<Select, Lanes> {
  static constexpr int kSmemWords = 4;

  struct State {
    int32_t a[kRows];
    int32_t x[kRows];
    int32_t y[kRows];  // x + c - 1
    int32_t next;
  };

  template <class B, class S>
  MICRO_HD static void init(const B& b, S* s, const int32_t* x, int32_t*) {
    b.each([&](int t, int k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        s[k].a[r] = s[k].x[r] = x[r * kLane + t];
    });
  }

  template <class S>
  MICRO_HD static void refresh(S& z, int, const int32_t*, int it) {
    z.next = INT32_MAX;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int32_t c = wadd(z.x[r], it) <= 32;
      z.y[r] = wsub(wadd(z.x[r], c), 1);
      z.next = imin(z.next, next_crossing(z.x[r], 32, it));
    }
  }

  template <class S>
  MICRO_HD static void add(S& z, int it) {
    int v = wadd(it, 1);
    micro::keep(v);
#pragma unroll
    for (int r = 0; r < kRows; ++r) z.a[r] = wadd(wadd(z.a[r], z.y[r]), v);
  }
};

template <>
struct Probe<kSelR> : Select {};

template <>
struct Probe<kSelU> : Select {};

constexpr uint32_t kNone = 0xFFFFFFFFu;

// thread t holds lanes (t & 15) + 16 j (j < 8) of row t >> 4; shared memory
// holds x's rows 0-7
struct MaskedMin : Crossings<MaskedMin> {
  static constexpr int kBlock = kLane;
  static constexpr int kSmemWords = kTileWords + 4;

  struct State {
    int32_t a[kRows];
    uint32_t lo;    // the least word with x + it > 0, or 999 for none
    uint32_t cap;   // 999 where a word has x + it <= 0, else kNone
    int32_t next;
  };

  MICRO_HD static int row(int t) { return t >> 4; }
  MICRO_HD static int lane(int t, int j) { return (t & 15) + 16 * j; }

  template <class B, class S>
  MICRO_HD static void init(const B& b, S* s, const int32_t* x,
                            int32_t* smem) {
    b.each([&](int t, int k) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        s[k].a[j] = x[row(t) * kLane + lane(t, j)];
    });
    stage_rows<kBlock>(b, x, smem, kTileWords);
    b.sync();
  }

  // x + it > 0 exactly for x in [1 - it, INT_MAX - it], where x + it does
  // not wrap: the row's masked minimum is lo + it, or 999 if less
  template <class S>
  MICRO_HD static void refresh(S& z, int t, const int32_t* smem, int it) {
    const int32_t* xr = smem + row(t) * kLane;
    int32_t lo = INT32_MAX;
    int in = 0;
    z.next = INT32_MAX;
    for (int m = 0; m < kLane; ++m) {
      const int32_t w = xr[m];
      if (wadd(w, it) > 0) {
        lo = imin(lo, w);
        ++in;
      }
      z.next = imin(z.next, next_crossing(w, 0, it));
    }
    z.lo = in > 0 ? static_cast<uint32_t>(lo) : 999u;
    z.cap = in < kLane ? 999u : kNone;
  }

  // acc + min(lo + it, cap)
  template <class S>
  MICRO_HD static void add(S& z, int it) {
    const uint32_t v = z.lo + static_cast<uint32_t>(it);
    const int32_t m = static_cast<int32_t>(v < z.cap ? v : z.cap);
#pragma unroll
    for (int j = 0; j < kRows; ++j) z.a[j] = wadd(z.a[j], m);
  }

  template <class B, class S>
  MICRO_HD static void store(const B& b, S* s, int32_t* out, int) {
    b.each([&](int t, int k) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        out[row(t) * kLane + lane(t, j)] = s[k].a[j];
    });
  }

  template <class S>
  MICRO_HD static void keep(S& s) {
    keep_all(s.a);
  }
};

template <>
struct Probe<kMinR> : MaskedMin {};

template <>
struct Probe<kMinU> : MaskedMin {};

// The masked min reduced every iteration, in micro_ops' row-min layout:
// warp w holds rows 2w and 2w + 1 of x and acc, thread q of it lanes q +
// 32j (j < 4) of each, at [4h + j] for row 2w + h; a row's minimum is 3
// mins and a warp reduction, trips unrolled x4 (the reductions do not wait
// on acc)
template <>
struct Probe<kMinRowForm> : ProbeBase {
  static constexpr int kBlock = kLane;
  static constexpr int kUnroll = kUnrolled;

  struct State {
    int32_t a[kRows];
    int32_t x[kRows];
    int32_t m[2];
  };

  MICRO_HD static int at(int t, int i) {
    return (2 * (t >> 5) + (i >> 2)) * kLane + (t & 31) + 32 * (i & 3);
  }

  template <class B, class S>
  MICRO_HD static void init(const B& b, S* s, const int32_t* x, int32_t*) {
    b.each([&](int t, int k) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[k].a[i] = s[k].x[i] = x[at(t, i)];
      keep_all(s[k].x);
    });
  }

  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int it, int32_t*) {
    b.each([&](int, int k) {
      int32_t w[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int32_t v = wadd(s[k].x[i], it);
        w[i] = v > 0 ? v : 999;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        s[k].m[h] = imin(imin(w[4 * h], w[4 * h + 1]),
                         imin(w[4 * h + 2], w[4 * h + 3]));
    });
    b.warp_min(s, [](S& q) -> int32_t& { return q.m[0]; });
    b.warp_min(s, [](S& q) -> int32_t& { return q.m[1]; });
    b.each([&](int, int k) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        s[k].a[i] = wadd(s[k].a[i], s[k].m[i >> 2]);
    });
  }

  template <class B, class S>
  MICRO_HD static void store(const B& b, S* s, int32_t* out, int) {
    b.each([&](int t, int k) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) out[at(t, i)] = s[k].a[i];
    });
  }

  template <class S>
  MICRO_HD static void keep(S& s) {
    keep_all(s.a);
  }
};

// G indices a lane, (x[g, l] + it) & 127 for g < G (the thread's own rows
// of x), each gathering x's rows 0-7 from their transposed copy (word
// i * kStride + r): acc + the G gathered words + G it
template <int G>
struct Gather : Lanes {
  static constexpr int kStride = 12;
  static constexpr int kSmemWords = kLane * kStride;
  static constexpr int kUnroll = kUnrolled;

  struct State {
    int32_t a[kRows];
    int32_t x[G];
  };

  template <class B, class S>
  MICRO_HD static void init(const B& b, S* s, const int32_t* x,
                            int32_t* xs) {
    b.each([&](int t, int k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[k].a[r] = x[r * kLane + t];
#pragma unroll
      for (int g = 0; g < G; ++g) s[k].x[g] = x[g * kLane + t];
      for (int i = t; i < kTileWords; i += kBlock)
        xs[(i & (kLane - 1)) * kStride + i / kLane] = x[i];
    });
    b.sync();
  }

  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int it, int32_t* xs) {
    b.each([&](int, int k) {
      int32_t sum[kRows] = {};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int i = wadd(s[k].x[g], it) & (kLane - 1);
        const int32_t* col = xs + i * kStride;
#pragma unroll
        for (int h = 0; h < kRows; h += 4) {
          int32_t v[4];
          load4(col + h, v);
#pragma unroll
          for (int j = 0; j < 4; ++j) sum[h + j] = wadd(sum[h + j], v[j]);
        }
      }
      const int32_t its = wmul(it, G);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        s[k].a[r] = wadd(wadd(s[k].a[r], sum[r]), its);
    });
  }
};

template <>
struct Probe<kGather72> : Gather<1> {};

template <>
struct Probe<kGather72x16> : Gather<16> {};

// the (8,128) tile over x of (128,128); the kernels are the probes and the
// masked min's row-min form
struct Expand {
  static constexpr int kRowsIn = 128;
  static constexpr int kProbes = kMinRowForm + 1;
  template <int P>
  using Probe = expand::Probe<P>;
};

}  // namespace expand

#ifdef __CUDACC__
extern "C" int micro_expand(int probe, const int32_t* x, int rows,
                            int32_t* out, int iters, void* stream) {
  return micro::run_unit<expand::Expand>(probe, x, rows, out, iters, stream);
}
#endif
