// Per-ray step of the two traversal ablation kernels, one ray per thread.
//
// Replaces the TPU measurement harnesses perf/ablate_v7.py::traverse
// (make_kernel, :39) and perf/kernel_ablate.py::traverse (make_kernel,
// :32): BVH8 traversals of a triangle table whose phases can be switched
// off one at a time to see what each costs. Every toggle is a template
// flag, so an ablated phase is compiled out, not branched around:
//   v7: node fetch, leaf fetch, node math (slab test and keys), leaf math
//       (Moeller over 8 slots, key (t bits & ~7) | slot, the winning slot's
//       exact t), child sort, stack; one_trip (one tile fetch round per
//       step and 128-ray sub-group); pinned at max_steps steps;
//   v5: fetch (node and leaf), sort, stack, leaf math (Moeller over 4
//       slots, the smallest t, the lowest slot among equal t, per-slot
//       geometry masks), node math; runs to completion or to max_steps.
// Each ray walks exactly the records, keys, stack entries and hits the
// harness gives its lane, ablated variants included (they read the zero
// record a harness's buffers start with; without node math v7 takes every
// non-empty child as hit and v5 none). A variant that fetches a record
// but skips its math still loads all of it, as the harness's fetch
// gathers every row (load_record's KEEP). The harness's per-program fetch
// loop only delays a lane (every lane that needs a record gets it before
// the step's math), so it has no counterpart here, except in one_trip,
// where the rays that need another tile than their sub-group's smallest
// keep the record they fetched last: the kernel reduces the sub-group's
// smallest tile each step (a 128-thread block is the sub-group) and the
// ray keeps the index of its last record, not the record. Stack: 64
// entries in local memory; the ninth 8-entry block the harness can reach
// is an XLA-clamped dynamic slice, so entries 64-71 alias 56-63 and later
// ones are dropped (read as 0).
//
// The record loads, slab test, bf16 decode, child sort, push order and
// Moeller test are traverse.cuh's (B1), so what the ablation measures is
// B1's code. What bounds it on an H100: like B1, dependent record reads
// through L2 (128 B a node, 288 B a v7 leaf, 192 B a v5 leaf) and the
// divergence of rays of one warp in depth and record kind. This design does
// nothing about either: it is the measurement, not the cure.
//
// The same file is compiled by nvcc into the kernels (ablate_v7.cu,
// ablate_v5.cu) and by g++ into a CPU twin (ablate_cpu.cpp) that the tests
// hold against the plain PyTorch version (embree_tpu_torch/perf/); neither
// build contracts to FMA.
#pragma once

#include "traverse.cuh"

namespace abl {

constexpr int kLane = 128;
constexpr int kStack = 64;         // STACK_BLOCKS * 8 (v7), STACK_ROWS (v5)
constexpr int kStackReach = 72;    // entries 64-71 alias 56-63
constexpr int kV7LeafWords = 72;   // 9 fields x 8 slots
constexpr int kV5LeafWords = 48;   // count, 4 ids, 3 zero, 9 x 4 fields, masks
constexpr int kV5Slots = 4;
constexpr int kNoTile = 0x7FFFFFFF;

// v7 flags: bits of the launch's flags word (embree_tpu_torch/perf/
// ablate_v7.py::flag_bits)
constexpr int kFNode = 1, kFLeaf = 2, kMNode = 4, kMLeaf = 8, kSort = 16,
              kStackOn = 32, kOneTrip = 64;
// v5 flags (perf/kernel_ablate.py::flag_bits)
constexpr int kFetch = 1, kV5Sort = 2, kV5Stack = 4, kV5Leaf = 8,
              kV5Node = 16;

// The harnesses' variants (ablate_v7.py:386-401, kernel_ablate.py:374-385),
// the only flag words instantiated: full, one_trip, no node fetch, no leaf
// fetch, no fetch (= compute only), no node math, no leaf math, no sort, no
// stack, fetch only, bare.
#define ABL_V7_VARIANTS(X)                                               \
  X(0x3F) X(0x7F) X(0x3E) X(0x3D) X(0x3C) X(0x3B) X(0x37) X(0x2F) X(0x1F) \
  X(0x03) X(0x00)
// full, nofetch, nonode, noleaf, nostack, nosort, fetchonly
#define ABL_V5_VARIANTS(X) \
  X(0x1F) X(0x1E) X(0x0F) X(0x17) X(0x1B) X(0x1D) X(0x03)

struct Params {
  const int32_t* nodes;     // (n_node_tiles * 128, 32) node records
  int32_t n_node_tiles;
  const int32_t* leaves;    // (n_leaf_tiles * 128, 72 or 48) float32 bits
  int32_t n_leaf_tiles;
  const float* org;         // (n_rays, 3)
  const float* dir;         // (n_rays, 3)
  const float* tnear;       // (n_rays,)
  const float* tfar;        // (n_rays,)
  const int32_t* mask;      // (n_rays,) ray mask bits (v5)
  int32_t n_rays;           // whole programs: a multiple of prog_rays
  int32_t prog_rays;        // UGRP * 128: one harness program
  int32_t max_steps;        // step limit of every ray
  float* out_t;             // (n_rays,) t of the best hit, else tfar
  int32_t* out_best;        // (n_rays,) v7 slot id, v5 prim id; -1 = miss
  int32_t* out_visits;      // (2, n_rays) steps at a node, at a leaf
  int32_t* out_prog_steps;  // (n_rays / prog_rays,) the most steps any
                            // ray of the program took (zeroed by the caller)
};

struct ARay {
  float ox, oy, oz, dx, dy, dz, rdx, rdy, rdz, tnear;
  int32_t mask;
};

// One ray's walk. The stack is not cleared: an entry is read only after a
// push wrote it (entries from 72 on, never written, read as 0).
struct State {
  float tf;
  int32_t cur, best, sp;
  bool act;
  int32_t nidx, lidx;       // record in the ray's node / leaf buffer, -1:
                            // none yet (the zeroed buffer)
  int32_t n_node, n_leaf;
  int32_t stack[kStack];
};

TRAV_HD ARay load_ray(const Params& p, int i) {
  const float dx = p.dir[3 * i], dy = p.dir[3 * i + 1], dz = p.dir[3 * i + 2];
  return ARay{p.org[3 * i], p.org[3 * i + 1], p.org[3 * i + 2], dx, dy, dz,
              trav::rcp_safe(dx), trav::rcp_safe(dy), trav::rcp_safe(dz),
              p.tnear[i], p.mask[i]};
}

TRAV_HD void init_state(const Params& p, int i, State& s) {
  s.tf = p.tfar[i];
  s.cur = 0;
  s.best = -1;
  s.sp = 0;
  s.act = p.tnear[i] <= s.tf;
  s.nidx = -1;
  s.lidx = -1;
  s.n_node = 0;
  s.n_leaf = 0;
}

TRAV_HD void finish(const Params& p, int i, const State& s) {
  p.out_t[i] = s.tf;
  p.out_best[i] = s.best;
  p.out_visits[i] = s.n_node;
  p.out_visits[p.n_rays + i] = s.n_leaf;
}

// Leaf record id of a negative ref, -(ref) - 1 with int32 wrap-around.
TRAV_HD int32_t leaf_id(int32_t ref) {
  return static_cast<int32_t>(~static_cast<uint32_t>(ref));
}

// Tile of record id rec >= 0 as the TPU fetch clamps it.
TRAV_HD int32_t tile_of(int32_t rec, int32_t n_tiles) {
  const int32_t g = rec >> 7;
  return g < n_tiles - 1 ? g : n_tiles - 1;
}

TRAV_HD int32_t rec_index(int32_t rec, int32_t n_tiles) {
  return tile_of(rec, n_tiles) * kLane + (rec & (kLane - 1));
}

// The tile a ray's step needs (kNoTile: none), for one_trip's reduction.
TRAV_HD int32_t node_tile(const State& s, int32_t n_tiles) {
  return s.act && s.cur >= 0 ? tile_of(s.cur, n_tiles) : kNoTile;
}

TRAV_HD int32_t leaf_tile(const State& s, int32_t n_tiles) {
  return s.act && s.cur < 0 ? tile_of(leaf_id(s.cur), n_tiles) : kNoTile;
}

// Record idx of a table of `words`-word records as words, zero for -1.
// KEEP: the variant fetches the record but its math reads few or none of
// the words; an empty asm takes each word, so the compiler keeps every
// load, as the harness's fetch gathers every row whatever the math uses.
template <int WORDS, bool KEEP = false>
TRAV_HD void load_record(const int32_t* table, int32_t idx, int32_t* w) {
  if (idx < 0) {
#pragma unroll
    for (int q = 0; q < WORDS; ++q) w[q] = 0;
    return;
  }
  const int32_t* rec = table + static_cast<size_t>(idx) * WORDS;
#pragma unroll
  for (int q = 0; q < WORDS / 4; ++q) {
    const trav::I4 v = trav::load4(rec + 4 * q);
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
#ifdef __CUDA_ARCH__
  if (KEEP) {
#pragma unroll
    for (int q = 0; q < WORDS; ++q) asm volatile("" : : "r"(w[q]));
  }
#endif
}

TRAV_HD void push(State& s, int32_t v) {
  if (s.sp < kStack) {
    s.stack[s.sp] = v;
  } else if (s.sp < kStackReach) {
    s.stack[s.sp - 8] = v;
  }
  ++s.sp;
}

// Pop, or retire the ray on an empty stack; without the stack the popped
// entry is 0 (the harness's zero8), the root.
template <bool STACK>
TRAV_HD void pop(State& s) {
  if (s.sp <= 0) {
    s.act = false;
    return;
  }
  --s.sp;
  if (!STACK || s.sp >= kStackReach) {
    s.cur = 0;
  } else {
    s.cur = s.stack[s.sp < kStack ? s.sp : s.sp - 8];
  }
}

enum class NodeMath { kSlab, kRefs, kNone };

// A step at a node: the record in the ray's buffer, the 8 children's keys,
// the sort, the pushes (farthest first), the nearest child next; a node
// without a hit child pops.
template <NodeMath MATH, bool SORT, bool STACK>
TRAV_HD void node_step(const Params& p, const ARay& r, State& s) {
  int32_t w[trav::kNodeWords];
  load_record<trav::kNodeWords, MATH != NodeMath::kSlab>(p.nodes, s.nidx, w);
  int32_t key[8], ref[8];
  int h = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    bool hit = false;
    int32_t k = c;
    if (MATH == NodeMath::kSlab) {
      const float tx0 = (trav::bf16_lo(w[8 + c]) - r.ox) * r.rdx;
      const float tx1 = (trav::bf16_hi(w[8 + c]) - r.ox) * r.rdx;
      const float ty0 = (trav::bf16_lo(w[16 + c]) - r.oy) * r.rdy;
      const float ty1 = (trav::bf16_hi(w[16 + c]) - r.oy) * r.rdy;
      const float tz0 = (trav::bf16_lo(w[24 + c]) - r.oz) * r.rdz;
      const float tz1 = (trav::bf16_hi(w[24 + c]) - r.oz) * r.rdz;
      const float tent =
          trav::jmax(trav::jmax(trav::jmin(tx0, tx1), trav::jmin(ty0, ty1)),
                     trav::jmax(trav::jmin(tz0, tz1), r.tnear));
      const float tex =
          trav::jmin(trav::jmin(trav::jmax(tx0, tx1), trav::jmax(ty0, ty1)),
                     trav::jmin(trav::jmax(tz0, tz1), s.tf));
      hit = tent <= tex && w[c] != trav::kInvalidRec;
      const int32_t kd = trav::as_int(trav::jmax(tent, 0.0f));
      k = hit ? ((kd & ~7) | c) : (trav::kInfBits | c);
    } else if (MATH == NodeMath::kRefs) {
      hit = w[c] != trav::kInvalidRec;
      k = hit ? c : (trav::kInfBits | c);
    }
    key[c] = k;
    ref[c] = w[c];
    h += hit ? 1 : 0;
  }
  if (SORT && MATH != NodeMath::kNone) trav::sort8(key, ref);
#pragma unroll
  for (int j = 7; j >= 1; --j) {
    if (j < h) {
      if (STACK) {
        push(s, ref[j]);
      } else {
        ++s.sp;
      }
    }
  }
  if (h > 0) {
    s.cur = ref[0];
    return;
  }
  pop<STACK>(s);
}

TRAV_HD trav::Ray leaf_ray(const ARay& r) {
  return trav::Ray{r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tnear, 0.0f};
}

// v7's leaf (ablate_v7.py:181-197, :256-262): the best key over 8 slots
// wins, then its slot's exact (clamped) t if strictly nearer. Then pop.
// Without leaf math a fetched record is still read.
template <bool FETCH, bool MATH, bool STACK>
TRAV_HD void leaf_v7(const Params& p, const ARay& r, State& s) {
  if (FETCH && !MATH) {
    int32_t w[kV7LeafWords];
    load_record<kV7LeafWords, true>(p.leaves, s.lidx, w);
  }
  if (MATH) {
    int32_t w[kV7LeafWords];
    load_record<kV7LeafWords>(p.leaves, s.lidx, w);
    float f[kV7LeafWords];
#pragma unroll
    for (int q = 0; q < kV7LeafWords; ++q) f[q] = trav::as_float(w[q]);
    const trav::Ray ray = leaf_ray(r);
    int32_t best_key = 0x7FFFFFFF, best_tb = 0;
#pragma unroll
    for (int sl = 0; sl < 8; ++sl) {
      float tt, uu, vv;
      const bool valid = trav::leaf_moeller(trav::slot_fields(f, sl), ray,
                                            s.tf, tt, uu, vv);
      const int32_t tb = trav::as_int(trav::jmax(tt, 0.0f));
      const int32_t k = valid ? ((tb & ~7) | sl) : (trav::kInfBits | sl);
      if (k < best_key) {
        best_key = k;
        best_tb = tb;
      }
    }
    const float t_new = trav::as_float(best_tb);
    if (best_key < trav::kInfBits && t_new < s.tf) {
      s.tf = t_new;
      s.best = static_cast<int32_t>(
          static_cast<uint32_t>(leaf_id(s.cur)) * 8u +
          static_cast<uint32_t>(best_key & 7));
    }
  }
  pop<STACK>(s);
}

// v5's leaf (kernel_ablate.py:194-233): the smallest t over the record's
// count of 4 slots, masked by slot mask & ray mask, the lowest slot among
// equal t, accepted if strictly nearer; its prim id from the record. Then
// pop.
template <bool FETCH, bool MATH, bool STACK>
TRAV_HD void leaf_v5(const Params& p, const ARay& r, State& s) {
  if (FETCH && !MATH) {
    int32_t w[kV5LeafWords];
    load_record<kV5LeafWords, true>(p.leaves, s.lidx, w);
  }
  if (MATH) {
    int32_t w[kV5LeafWords];
    load_record<kV5LeafWords>(p.leaves, s.lidx, w);
    const trav::Ray ray = leaf_ray(r);
    const float inf = trav::as_float(trav::kInfBits);
    float tmin = inf;
    int32_t pid = 0;
#pragma unroll
    for (int sl = 0; sl < kV5Slots; ++sl) {
      float f[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) f[k] = trav::as_float(w[8 + 4 * k + sl]);
      const trav::Slot q{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
      float tt, uu, vv;
      const bool valid = sl < w[0] &&
                         trav::leaf_moeller(q, ray, s.tf, tt, uu, vv) &&
                         (w[44 + sl] & r.mask) != 0;
      const float tl = valid ? tt : inf;
      if (tl < tmin) {
        tmin = tl;
        pid = w[1 + sl];
      }
    }
    if (tmin < s.tf) {
      s.tf = tmin;
      s.best = pid;
    }
  }
  pop<STACK>(s);
}

// One step of an active v7 ray. serve_n / serve_l: whether the fetch round
// of this step brings the ray its record (always, but in one_trip).
template <int F>
TRAV_HD void v7_step(const Params& p, const ARay& r, State& s, bool serve_n,
                     bool serve_l) {
  constexpr bool kStackF = (F & kStackOn) != 0;
  if (s.cur >= 0) {
    ++s.n_node;
    if ((F & kFNode) && serve_n) s.nidx = rec_index(s.cur, p.n_node_tiles);
    node_step<(F & kMNode) ? NodeMath::kSlab : NodeMath::kRefs,
              (F & kSort) != 0, kStackF>(p, r, s);
  } else {
    ++s.n_leaf;
    if ((F & kFLeaf) && serve_l) {
      s.lidx = rec_index(leaf_id(s.cur), p.n_leaf_tiles);
    }
    leaf_v7<(F & kFLeaf) != 0, (F & kMLeaf) != 0, kStackF>(p, r, s);
  }
}

// One step of an active v5 ray.
template <int F>
TRAV_HD void v5_step(const Params& p, const ARay& r, State& s) {
  constexpr bool kStackF = (F & kV5Stack) != 0;
  if (s.cur >= 0) {
    ++s.n_node;
    if (F & kFetch) s.nidx = rec_index(s.cur, p.n_node_tiles);
    node_step<(F & kV5Node) ? NodeMath::kSlab : NodeMath::kNone,
              (F & kV5Sort) != 0, kStackF>(p, r, s);
  } else {
    ++s.n_leaf;
    if (F & kFetch) s.lidx = rec_index(leaf_id(s.cur), p.n_leaf_tiles);
    leaf_v5<(F & kFetch) != 0, (F & kV5Leaf) != 0, kStackF>(p, r, s);
  }
}

// A launch the kernels do not take: rays not in whole programs of whole
// 128-thread blocks, or empty tables.
inline bool bad_launch(const Params& p) {
  return p.n_rays <= 0 || p.prog_rays <= 0 || p.prog_rays % kLane != 0 ||
         p.n_rays % p.prog_rays != 0 || p.n_node_tiles < 1 ||
         p.n_leaf_tiles < 1 || p.max_steps < 0;
}

}  // namespace abl
