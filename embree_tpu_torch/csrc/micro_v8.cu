// Hopper kernel of the loop probes of perf/micro_v8.py (run, :21; the probe
// bodies :52-204): one block carries the (128,128) int32 tile in registers,
// thread t the lane column t & 127 of whole 8-row blocks; x is (512,128).
// What bounds a probe, the loop and the block abstraction: micro.cuh.
//
// Each probe runs the implementation its Cost (perf/micro_v8.py) counts, in
// the layout that implementation needs (threads x rows a thread; the
// thread counts are the fastest of 128-1024 measured on an H100, PERF.md):
//   add (128 x 128), elementwise chain (512 x 32), select (256 x 64):
//     registers, the loop's counter and branch once per 32-128 rows;
//   static XOR-4 gather and its roll form (128 x 128): rows r and r ^ 4
//     get the same sum, and equal rows stay equal, so after the first
//     (peeled) iteration a thread carries the 64 pair sums and doubles
//     them;
//   block-sum butterfly and block reduce (128 x 128): one function, each
//     row plus its 8-row block's sum;
//   dynamic block-local sublane gather (512 x 32): the tile through shared
//     memory (written at row r, lane l; read at the dynamic row: bank =
//     lane, no conflict), two buffers, one barrier an iteration: cheaper
//     than a select network over the block's 8 registers (7 selects an
//     element);
//   (16,128) -> (128,128) expand, 72-row lane gathers, the 9x (8,128) form,
//     the gather + select merge and the compact chain (128 x 128): rows
//     0-15, the index row acc[0:1] and acc[0:8] are the thread's own
//     registers, so no exchange and no barrier; rows r and r + 72 of a
//     72-row operand are read once; the dynamic slices' start, acc[0,0],
//     evolves on its own (acc[0,0] + x[start, acc[0,0] & 127]), so every
//     thread carries a copy; the merge's lane bit picks where the thread
//     reads its 72 rows (16-byte reads of x staged transposed);
//   the four bitonic probes (512 x 32): each 8-row block sorted by a
//     19-exchange min/max network (micro::sort8; the six bitonic stages
//     take 24); key + ref adds key ^ 12345 after the sort, as the ref
//     travels with its key through the harness's network (its one-sided
//     tie rule swaps equal keys' equal refs), so both key + ref forms are
//     one function.
//
// Build (one library of the three units, compiled in parallel):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xptxas -v -Xcompiler -fPIC -c micro_v8.cu -o micro_v8.o
//   (likewise micro_ops.cu and micro_expand.cu)
//   nvcc -gencode arch=compute_90a,code=sm_90a -shared micro_ops.o
//        micro_expand.o micro_v8.o -o libmicro_cuda.so
// micro_cpu.cpp compiles the same probes for the host (the tests' twin).
#include "micro.cuh"

namespace v8 {

// probe ids: embree_tpu_torch/perf/micro_v8.py::PROBES
enum : int {
  kBase, kChain, kSelect, kXor4, kDynBlock, kXorRoll, kButterfly,
  kExpand16, kReduceRows, kGather72, kDyn72, kDyn32, kMerge72, kGather8x9,
  kCompact, kBitonicGather, kBitonicRoll, kBitonicRef, kBitonicGroup,
  kProbes
};

using namespace micro;

constexpr int kTileRows = 128;

// T threads over the tile: thread t holds lane t & 127 of the kRows =
// 16,384 / T rows from kRows * (t >> 7), whole 8-row blocks.
template <int T>
struct Cols : ProbeBase {
  static constexpr int kBlock = T;
  static constexpr int kRows = kTileRows * kLane / T;

  struct State {
    int32_t a[kRows];
  };

  MICRO_HD static int lane(int t) { return t & (kLane - 1); }
  MICRO_HD static int row0(int t) { return kRows * (t >> 7); }

  template <class B, class S>
  MICRO_HD static void load(const B& b, S* s, const int32_t* x) {
    b.each([&](int t, int k) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        s[k].a[i] = x[(row0(t) + i) * kLane + lane(t)];
    });
  }

  template <class B, class S>
  MICRO_HD static void init(const B& b, S* s, const int32_t* x, int32_t*) {
    load(b, s, x);
  }

  template <class B, class S>
  MICRO_HD static void store(const B& b, S* s, int32_t* out, int) {
    b.each([&](int t, int k) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        out[(row0(t) + i) * kLane + lane(t)] = s[k].a[i];
    });
  }

  template <class S>
  MICRO_HD static void keep(S& s) {
    keep_all(s.a);
  }
};

// Cols<128> with the first ROWS rows of x in shared memory
template <int ROWS>
struct Staged : Cols<128> {
  static constexpr int kSmemWords = ROWS * kLane;

  template <class B, class S>
  MICRO_HD static void init(const B& b, S* s, const int32_t* x,
                            int32_t* xs) {
    load(b, s, x);
    stage_rows<kBlock>(b, x, xs, kSmemWords);
    b.sync();
  }
};

template <int P>
struct Probe;

template <>
struct Probe<kBase> : Cols<128> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t*) {
    b.each([&](int, int k) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[k].a[i] = wadd(s[k].a[i], 1);
    });
  }
};

// IMAD (3v + 1), shift, xor, or, + it, IMAD (p q + v)
template <>
struct Probe<kChain> : Cols<512> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int it, int32_t*) {
    b.each([&](int, int k) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int32_t v = s[k].a[i];
        s[k].a[i] = wadd(v, wmul(wadd(wmul(v, 3), 1) ^ (v >> 2),
                                 wadd(v | 1, it)));
      }
    });
  }
};

template <>
struct Probe<kSelect> : Cols<256> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int it, int32_t*) {
    b.each([&](int, int k) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int32_t v = s[k].a[i];
        s[k].a[i] = v > it ? wadd(v, 1) : wsub(v, 1);
      }
    });
  }
};

// Rows r and r ^ 4 of a block get the same sum a[r] + a[r ^ 4], so from the
// first iteration on they stay equal and each pair doubles: the first
// iteration is peeled, then the thread carries rows 0-3 of each block.
template <>
struct Probe<kXor4> : Cols<128> {
  static constexpr bool kPeel = true;

  MICRO_HD static constexpr bool carried(int i) { return (i & 4) == 0; }

  template <class B, class S>
  MICRO_HD static void first(const B& b, S* s, int32_t*) {
    b.each([&](int, int k) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (carried(i)) s[k].a[i] = wadd(s[k].a[i], s[k].a[i + 4]);
    });
  }

  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t*) {
    b.each([&](int, int k) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (carried(i)) s[k].a[i] = wadd(s[k].a[i], s[k].a[i]);
    });
  }

  template <class S>
  MICRO_HD static void keep(S& s) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (carried(i)) micro::keep(s.a[i]);
  }

  // after an iteration, row r ^ 4 equals row r
  template <class B, class S>
  MICRO_HD static void store(const B& b, S* s, int32_t* out, int iters) {
    b.each([&](int t, int k) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        out[(row0(t) + i) * kLane + lane(t)] =
            iters > 0 ? s[k].a[i & ~4] : s[k].a[i];
    });
  }
};

// rolls by 128 - 4 and 4, then the select keeps the in-block row: row r ^ 4
template <>
struct Probe<kXorRoll> : Probe<kXor4> {};

// the tile through shared memory, read back at row (r & ~7) | ((r ^ acc)
// & 7): two buffers, so one barrier an iteration
template <>
struct Probe<kDynBlock> : Cols<512> {
  static constexpr int kTileWords = kTileRows * kLane;
  static constexpr int kSmemWords = 2 * kTileWords;

  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int it, int32_t* smem) {
    int32_t* buf = smem + (it & 1) * kTileWords;
    b.each([&](int t, int k) {
      int32_t* col = buf + row0(t) * kLane + lane(t);
#pragma unroll
      for (int i = 0; i < kRows; ++i) col[i * kLane] = s[k].a[i];
    });
    b.sync();
    b.each([&](int t, int k) {
      const int32_t* col = buf + row0(t) * kLane + lane(t);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int32_t v = s[k].a[i];
        s[k].a[i] = wadd(v, col[((i & ~7) + ((i ^ v) & 7)) * kLane]);
      }
    });
  }
};

// each row plus its 8-row block's sum (the butterfly's three roll stages
// leave the sum in every row; the block reduce expands it back)
template <>
struct Probe<kButterfly> : Cols<128> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t*) {
    b.each([&](int, int k) {
      int32_t* a = s[k].a;
#pragma unroll
      for (int u = 0; u < kRows; u += 8) {
        const int32_t sum =
            wadd(wadd(wadd(a[u], a[u + 1]), wadd(a[u + 2], a[u + 3])),
                 wadd(wadd(a[u + 4], a[u + 5]), wadd(a[u + 6], a[u + 7])));
#pragma unroll
        for (int i = 0; i < 8; ++i) a[u + i] = wadd(a[u + i], sum);
      }
    });
  }
};

template <>
struct Probe<kReduceRows> : Probe<kButterfly> {};

// row R plus row R >> 3, all in the thread: rows updated from the last
// down, so row R >> 3 (< R) is still the old one
template <>
struct Probe<kExpand16> : Cols<128> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t*) {
    b.each([&](int, int k) {
      int32_t* a = s[k].a;
#pragma unroll
      for (int R = kRows - 1; R >= 0; --R) a[R] = wadd(a[R], a[R >> 3]);
    });
  }
};

// the 72 rows gathered at acc[0, l] & 127 (row 0 is the thread's own), each
// added to tile rows r and r + 72
template <>
struct Probe<kGather72> : Staged<72> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t* xs) {
    b.each([&](int, int k) {
      int32_t* a = s[k].a;
      const int idx = a[0] & (kLane - 1);
#pragma unroll
      for (int r = 0; r < 72; ++r) {
        const int32_t v = xs[r * kLane + idx];
        a[r] = wadd(a[r], v);
        if (r < kTileRows - 72) a[r + 72] = wadd(a[r + 72], v);
      }
    });
  }
};

// the dynamic slice x[SPAN * (acc[0,0] & MASK) :][:SPAN] gathered at
// acc[0, l] & 127; tile row R reads row R % SPAN of it (concatenate x4 of
// 32 rows; rows 72-127 repeat 0-55 of 72). acc[0,0] evolves on its own,
// acc[0,0] + x[start, acc[0,0] & 127], and z is every thread's copy of it.
template <int SPAN, int MASK>
struct DynSlice : Staged<SPAN*(MASK + 1)> {
  using Base = Staged<SPAN*(MASK + 1)>;

  struct State {
    int32_t a[kTileRows];
    int32_t z;
  };

  template <class B, class S>
  MICRO_HD static void init(const B& b, S* s, const int32_t* x,
                            int32_t* xs) {
    b.each([&](int, int k) { s[k].z = x[0]; });
    Base::init(b, s, x, xs);
  }

  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t* xs) {
    b.each([&](int, int k) {
      int32_t* a = s[k].a;
      const int32_t z = s[k].z;
      const int32_t* t = xs + (z & MASK) * SPAN * kLane;
      const int idx = a[0] & (kLane - 1);
#pragma unroll
      for (int r = 0; r < SPAN; ++r) {
        const int32_t v = t[r * kLane + idx];
#pragma unroll
        for (int R = r; R < kTileRows; R += SPAN) a[R] = wadd(a[R], v);
      }
      s[k].z = wadd(z, t[z & (kLane - 1)]);
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

template <>
struct Probe<kDyn72> : DynSlice<72, 3> {};

template <>
struct Probe<kDyn32> : DynSlice<32, 7> {};

// where(acc[0:1] & 1, x[0:72] gathered at acc[0:1] & 127, x[72:144]): one
// bit a lane, which picks where the thread reads its 72 rows: at its index
// in x[0:72], or its own lane of x[72:144]. Both halves are staged
// transposed (word idx * 76 + r, and (128 + l) * 76 + r: 72 rows padded to
// 16 bytes), so the bit only picks the base address, and the thread reads
// 4 rows a 16-byte load, with no branch and no select. Held in registers,
// x[72:144]'s rows (56 or 72 of them beside the 128-row tile) spilled, and
// 24-48 of them ran slower than this (PERF.md).
template <>
struct Probe<kMerge72> : Cols<128> {
  static constexpr int kStride = 76;
  static constexpr int kSmemWords = 2 * kLane * kStride;

  template <class B, class S>
  MICRO_HD static void init(const B& b, S* s, const int32_t* x,
                            int32_t* xs) {
    load(b, s, x);
    b.each([&](int t, int) {
      for (int i = t; i < 144 * kLane; i += kBlock) {
        const int r = i / kLane, l = i & (kLane - 1);
        xs[(r < 72 ? l : kLane + l) * kStride + r % 72] = x[i];
      }
    });
    b.sync();
  }

  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t* xs) {
    b.each([&](int t, int k) {
      int32_t* a = s[k].a;
      const int from = (a[0] & 1) != 0 ? a[0] & (kLane - 1) : kLane + t;
      const int32_t* rows = xs + from * kStride;
#pragma unroll
      for (int q = 0; q < 72; q += 4) {
        int32_t v[4];
        load4(rows + q, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = q + j;
          a[r] = wadd(a[r], v[j]);
          if (r < kTileRows - 72) a[r + 72] = wadd(a[r + 72], v[j]);
        }
      }
    });
  }
};

// rows 8k + j of the 9 gathered (8,128) records: x[8k + j] at acc[j, l] &
// 127, the thread's own rows 0-7
template <>
struct Probe<kGather8x9> : Staged<72> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t* xs) {
    b.each([&](int, int k) {
      int32_t* a = s[k].a;
      int idx[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) idx[j] = a[j] & (kLane - 1);
#pragma unroll
      for (int r = 0; r < 72; ++r) {
        const int32_t v = xs[r * kLane + idx[r & 7]];
        a[r] = wadd(a[r], v);
        if (r < kTileRows - 72) a[r + 72] = wadd(a[r + 72], v);
      }
    });
  }
};

// the (16,128) state's 5-op chain on the thread's own rows 0-15, each added
// to tile rows i, i + 16, ..., i + 112
template <>
struct Probe<kCompact> : Cols<128> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int it, int32_t*) {
    b.each([&](int, int k) {
      int32_t* a = s[k].a;
      int32_t c[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int32_t v = a[i];
        c[i] = wadd(wmul(v > it ? wadd(v, 1) : wsub(v, 1), 3), v >> 1);
      }
#pragma unroll
      for (int R = 0; R < kTileRows; ++R) a[R] = wadd(a[R], c[R & 15]);
    });
  }
};

// each 8-row block sorted, then + 1
template <>
struct Probe<kBitonicGather> : Cols<512> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t*) {
    b.each([&](int, int k) {
      int32_t* a = s[k].a;
#pragma unroll
      for (int u = 0; u < kRows; u += 8) sort8(a + u);
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = wadd(a[i], 1);
    });
  }
};

template <>
struct Probe<kBitonicRoll> : Probe<kBitonicGather> {};

// each 8-row block sorted, then key + (key ^ 12345): the ref recomputed
template <>
struct Probe<kBitonicRef> : Cols<512> {
  template <class B, class S>
  MICRO_HD static void step(const B& b, S* s, int, int32_t*) {
    b.each([&](int, int k) {
      int32_t* a = s[k].a;
#pragma unroll
      for (int u = 0; u < kRows; u += 8) sort8(a + u);
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = wadd(a[i], a[i] ^ 12345);
    });
  }
};

// the per-group form (16 groups of 8 rows) is the same function
template <>
struct Probe<kBitonicGroup> : Probe<kBitonicRef> {};

struct V8 {
  static constexpr int kRowsIn = 512;
  static constexpr int kProbes = v8::kProbes;
  template <int P>
  using Probe = v8::Probe<P>;
};

}  // namespace v8

#ifdef __CUDACC__
extern "C" int micro_v8(int probe, const int32_t* x, int rows, int32_t* out,
                        int iters, void* stream) {
  return micro::run_unit<v8::V8>(probe, x, rows, out, iters, stream);
}
#endif
