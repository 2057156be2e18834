// The walk of the two traversal ablation kernels: the per-ray steps of the
// harnesses and the persistent warps that run them.
//
// Replaces the TPU measurement harnesses perf/ablate_v7.py::traverse
// (pallas_call :336, make_kernel :39) and perf/kernel_ablate.py::traverse
// (pallas_call :310, make_kernel :32): BVH8 traversals of a triangle table
// whose phases can be switched off one at a time to see what each costs.
// Every toggle is a template flag, so an ablated phase is compiled out, not
// branched around:
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
// gathers every row (the KEEP loads). The harness's per-program fetch
// loop only delays a lane (every lane that needs a record gets it before
// the step's math), so it has no counterpart here, except in one_trip
// (below). Stack: 64 entries; the ninth 8-entry block the harness can
// reach is an XLA-clamped dynamic slice, so entries 64-71 alias 56-63 and
// later ones are dropped (read as 0, the root).
//
// What bounds it on an H100: as in B1, a chain of dependent record reads
// through L2, each step's record (128 B a node, 288 B a v7 leaf, 192 B a
// v5 leaf) waiting on the step before, and at the leaves the slot tests
// (8 Moeller tests a v7 leaf, 4 a v5 leaf, about 55 operations each).
// One ray per thread, the kernels' first design, added the warp's
// divergence to that: a warp held its lanes until its longest ray was
// done, ran node and leaf steps in one divergent warp with the whole leaf
// in registers, and kept the 64-entry stack in local memory.
//
// The design is B1's (traverse.cuh: run_warp and static_pass), so that
// what an ablation takes away is a phase of the kernel the queries run:
// persistent warps (as many blocks as stay resident) whose lanes take new
// rays from a global counter once kStaticRefillLanes are idle (a ray is
// done when it retires or reaches max_steps), each pass runs either the
// lanes at nodes or, once kStaticLeafLanes wait at one, the lanes at
// leaves, and a leaf pass deals the waiting lanes' (ray, slot) items
// across the warp (deal_pass), so that a leaf's slots are tested side by
// side and its lanes read each field as one sector: v7's 8-slot leaf is
// B1's record and item (4 leaves a round), v5's 4-slot leaf has an item of
// its own (8 leaves a round). Each lane's stack is a column of the block's
// shared memory. No leaf is held in registers and no stack in local
// memory, so more warps stay resident to hide the record reads.
//
// Shared with the traversal library: the lane bookkeeping (CudaScratchWarp
// on the card, launch.cuh; HostWarp in the twin, traverse.cuh), the ray
// state (RayState), the scratch rows and the waiting rays' words in them
// (curve_scratch, put_ray, get_ray), the key rule (slot_key), the bf16
// decode, the sort, the Moeller test and the scheduler's constants. The
// loop (run_warp below) repeats traverse.cuh::run_warp's form with the
// ablation's steps instead of being that function: making it generic over
// the steps would rebuild the traversal library's 72 instantiations, whose
// registers and SASS stay as they are (a renamed register once moved a B6
// kernel by 2%), so the sharing stops at the warp helpers.
//
// one_trip stays in lockstep, one 128-ray sub-group a block: each step the
// block fetches the smallest node tile and leaf tile its rays need, and a
// ray that needs another keeps the record it fetched last, so its output
// depends on which 128 rays share its block, and every ray runs all
// max_steps steps. Refilling would change the first and gains nothing on
// the second. Its stack is a column of shared memory too.
//
// The same file is compiled by nvcc into the kernels (ablate_v7.cu,
// ablate_v5.cu) and by g++ into a CPU twin (ablate_cpu.cpp, the scheduler
// over 32 emulated lanes) that the tests hold against the plain PyTorch
// version (embree_tpu_torch/perf/); neither build contracts to FMA.
#pragma once

#include "traverse.cuh"

namespace abl {

constexpr int kLane = 128;
constexpr int kStack = trav::kStack;  // STACK_BLOCKS * 8 (v7), STACK_ROWS (v5)
constexpr int kStackReach = 72;       // entries 64-71 alias 56-63
constexpr int kV7LeafWords = 72;      // 9 fields x 8 slots
constexpr int kV5LeafWords = 48;      // count, 4 ids, 3 zero, 9 x 4 fields,
                                      // masks
constexpr int kV5Slots = 4;
constexpr int kNoTile = 0x7FFFFFFF;
// a warp's scratch words for its leaf passes: the waiting rays' rows and
// two rows of item results (trav::curve_scratch_words of a scene without
// curves)
constexpr int kScratchWords = 32 * trav::kRayWords + 2 * 32;

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
  int32_t n_rays;
  int32_t prog_rays;        // UGRP * 128: one harness program
  int32_t max_steps;        // step limit of every ray
  float* out_t;             // (n_rays,) t of the best hit, else tfar
  int32_t* out_best;        // (n_rays,) v7 slot id, v5 prim id; -1 = miss
  int32_t* out_visits;      // (2, n_rays) steps at a node, at a leaf
  int32_t* out_prog_steps;  // (ceil(n_rays / prog_rays),) the most steps
                            // any ray of the program took (zeroed by the
                            // caller)
};

// One ray between two steps: the traversal kernel's RayState (the ray, its
// reciprocal direction, t, best, stack depth, record, step counts, live);
// best is v7's slot id or v5's prim id.
using State = trav::RayState;

TRAV_HD void start(const Params& p, int i, State& s) {
  const float dx = p.dir[3 * i], dy = p.dir[3 * i + 1], dz = p.dir[3 * i + 2];
  s.ray = trav::Ray{p.org[3 * i], p.org[3 * i + 1], p.org[3 * i + 2],
                    dx,           dy,               dz,
                    p.tnear[i],   0.0f};
  s.rdx = trav::rcp_safe(dx);
  s.rdy = trav::rcp_safe(dy);
  s.rdz = trav::rcp_safe(dz);
  s.rtime = 0.0f;
  s.tf = p.tfar[i];
  s.rmask = p.mask[i];
  s.i = i;
  s.best = -1;
  s.sp = 0;
  s.cur = 0;  // the root
  s.n_node = 0;
  s.n_leaf = 0;
  s.live = s.ray.tnear <= s.tf;
  s.overflow = false;
}

TRAV_HD bool running(const Params& p, const State& s) {
  return s.live && s.n_node + s.n_leaf < p.max_steps;
}

// A finished ray's outputs (its steps go into its program's most through
// raise_prog_steps).
TRAV_HD void finish(const Params& p, const State& s) {
  const int i = s.i;
  p.out_t[i] = s.tf;
  p.out_best[i] = s.best;
  p.out_visits[i] = s.n_node;
  p.out_visits[p.n_rays + i] = s.n_leaf;
}

// The steps of the rays a pass finished (ended[l] > 0: lane l's ray, which
// took that many) into their programs' most steps: on the card one
// atomicMax per program among them, of the warp's max over its lanes. A
// warp's rays are neighbours, mostly of one program, and an atomic per ray
// on the few programs in flight at once contended: on an H100, 16,777,216
// rays of one step each took 7.99 ms that way and 0.87 ms this way, and v5
// full at 1,048,576 rays ran 0.773 / 0.684 / 0.585 ms at UGRP 16 / 8 / 4
// (fewer rays a program, less contention) and 0.51 ms at each this way.
template <class WARP>
TRAV_HD void raise_prog_steps(const Params& p, const WARP& w,
                              const State* st, const int32_t* ended) {
#ifdef __CUDA_ARCH__
  const int32_t steps = ended[0];
  const int prog = st[0].i / p.prog_rays;
  uint32_t pending = __ballot_sync(0xFFFFFFFFu, steps > 0);
  while (pending != 0) {
    const int leader = __ffs(pending) - 1;
    const int lead_prog = __shfl_sync(0xFFFFFFFFu, prog, leader);
    const bool mine = steps > 0 && prog == lead_prog;
    const uint32_t group = __ballot_sync(0xFFFFFFFFu, mine);
    const int most = static_cast<int>(__reduce_max_sync(
        0xFFFFFFFFu, static_cast<unsigned>(mine ? steps : 0)));
    if (w.lane == leader) atomicMax(p.out_prog_steps + lead_prog, most);
    pending &= ~group;
  }
#else
  w.each([&](int l, int) {
    if (ended[l] <= 0) return;
    int32_t& most = p.out_prog_steps[st[l].i / p.prog_rays];
    if (ended[l] > most) most = ended[l];
  });
#endif
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

// A loaded word the variant's math does not read: an empty asm takes it,
// so the compiler keeps the load, as the harness's fetch gathers every row
// whatever the math uses.
TRAV_HD void keep(int32_t v) {
#ifdef __CUDA_ARCH__
  asm volatile("" : : "r"(v));
#else
  (void)v;
#endif
}

// Record idx of a table of `words`-word records as words, zero for -1;
// KEEP: every word kept (keep).
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
  if (KEEP) {
#pragma unroll
    for (int q = 0; q < WORDS; ++q) keep(w[q]);
  }
}

template <class STK>
TRAV_HD void push(State& s, STK stk, int32_t v) {
  if (s.sp < kStack) {
    stk[s.sp] = v;
  } else if (s.sp < kStackReach) {
    stk[s.sp - 8] = v;
  }
  ++s.sp;
}

// Pop, or retire the ray on an empty stack; without the stack the popped
// entry is 0 (the harness's zero8), the root. An entry is read only after
// this ray's push wrote it, so a lane's column needs no clearing between
// rays.
template <bool STACK, class STK>
TRAV_HD void pop(State& s, STK stk) {
  if (s.sp <= 0) {
    s.live = false;
    return;
  }
  --s.sp;
  if (!STACK || s.sp >= kStackReach) {
    s.cur = 0;
  } else {
    s.cur = stk[s.sp < kStack ? s.sp : s.sp - 8];
  }
}

enum class NodeMath { kSlab, kRefs, kNone };

// A step at a node: record nidx of the node table (-1: the zero record),
// the 8 children's keys, the sort, the pushes (farthest first), the
// nearest child next; a node without a hit child pops.
template <NodeMath MATH, bool SORT, bool STACK, class STK>
TRAV_HD void node_step(const Params& p, State& s, STK stk, int32_t nidx) {
  int32_t w[trav::kNodeWords];
  load_record<trav::kNodeWords, MATH != NodeMath::kSlab>(p.nodes, nidx, w);
  int32_t key[8], ref[8];
  int h = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    bool hit = false;
    int32_t k = c;
    if (MATH == NodeMath::kSlab) {
      const float tx0 = (trav::bf16_lo(w[8 + c]) - s.ray.ox) * s.rdx;
      const float tx1 = (trav::bf16_hi(w[8 + c]) - s.ray.ox) * s.rdx;
      const float ty0 = (trav::bf16_lo(w[16 + c]) - s.ray.oy) * s.rdy;
      const float ty1 = (trav::bf16_hi(w[16 + c]) - s.ray.oy) * s.rdy;
      const float tz0 = (trav::bf16_lo(w[24 + c]) - s.ray.oz) * s.rdz;
      const float tz1 = (trav::bf16_hi(w[24 + c]) - s.ray.oz) * s.rdz;
      const float tent =
          trav::jmax(trav::jmax(trav::jmin(tx0, tx1), trav::jmin(ty0, ty1)),
                     trav::jmax(trav::jmin(tz0, tz1), s.ray.tnear));
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
        push(s, stk, ref[j]);
      } else {
        ++s.sp;
      }
    }
  }
  if (h > 0) {
    s.cur = ref[0];
    return;
  }
  pop<STACK>(s, stk);
}

// v7's leaf result (ablate_v7.py:181-197, :256-262): the least key over 8
// slots wins, then its slot's exact (clamped) t if strictly nearer.
TRAV_HD void take_v7(State& s, int32_t key, int32_t tb) {
  const float t_new = trav::as_float(tb);
  if (key < trav::kInfBits && t_new < s.tf) {
    s.tf = t_new;
    s.best = static_cast<int32_t>(static_cast<uint32_t>(leaf_id(s.cur)) * 8u +
                                  static_cast<uint32_t>(key & 7));
  }
}

// v5's leaf result (kernel_ablate.py:194-233): the smallest t over the
// slots (the lowest slot among equal t) and its prim id, if strictly
// nearer.
TRAV_HD void take_v5(State& s, int32_t t_bits, int32_t pid) {
  const float t = trav::as_float(t_bits);
  if (t < s.tf) {
    s.tf = t;
    s.best = pid;
  }
}

// ---- the leaf passes: (ray, slot) items dealt across the warp ----

// Item: slot s of the v7 leaf of waiting ray r, into its key and t bits.
// FETCH: the record the fetch finds for the ray's leaf; else the zero
// record. Without MATH the slot's 9 words are only loaded (the leaf's 8
// items load all 72).
template <bool FETCH, bool MATH>
TRAV_HD void v7_item(const Params& p, const trav::ItemRay& r, int s,
                     int32_t& key, int32_t& tb) {
  float f[9];
  const int32_t* rec =
      p.leaves +
      static_cast<size_t>(rec_index(r.lid, p.n_leaf_tiles)) * kV7LeafWords +
      s;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int32_t v = FETCH ? trav::load1(rec + 8 * k) : 0;
    if (!MATH) keep(v);
    f[k] = trav::as_float(v);
  }
  if (MATH) {
    const trav::Slot q{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
    float tt, uu, vv;
    const bool valid = trav::leaf_moeller(q, r.ray, r.tf, tt, uu, vv);
    trav::slot_key(valid, tt, s, key, tb);
  }
}

// Item: slot s of the v5 leaf of waiting ray r (count, fields, mask, id),
// into its t (inf when not valid) as bits and its prim id. Without MATH the
// item loads words 12s to 12s + 11, so the leaf's 4 items load all 48.
template <bool FETCH, bool MATH>
TRAV_HD void v5_item(const Params& p, const trav::ItemRay& r, int s,
                     int32_t& t_bits, int32_t& pid) {
  const int32_t* rec =
      p.leaves +
      static_cast<size_t>(rec_index(r.lid, p.n_leaf_tiles)) * kV5LeafWords;
  if (!MATH) {
#pragma unroll
    for (int q = 0; q < 3 && FETCH; ++q) {
      const trav::I4 v = trav::load4(rec + 12 * s + 4 * q);
      keep(v.x);
      keep(v.y);
      keep(v.z);
      keep(v.w);
    }
    return;
  }
  auto word = [&](int q) { return FETCH ? trav::load1(rec + q) : 0; };
  float f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = trav::as_float(word(8 + 4 * k + s));
  const trav::Slot q{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
  float tt, uu, vv;
  const bool valid = s < word(0) &&
                     trav::leaf_moeller(q, r.ray, r.tf, tt, uu, vv) &&
                     (word(44 + s) & r.rmask) != 0;
  t_bits = valid ? trav::as_int(tt) : trav::kInfBits;
  pid = word(1 + s);
}

// One leaf pass over the waiting lanes go, in static_pass's form: each
// waiting lane publishes its ray by rank in the warp's scratch, the (ray,
// slot) items are dealt across the warp, 32 a round (32 / SLOTS leaves),
// and with REDUCE each waiting lane folds its SLOTS items' two result
// words in slot order: a item's first word replaces a[l] when better(it,
// a[l]), and b[l] takes its second. rounds counts the item rounds.
template <int SLOTS, bool REDUCE, class WARP, class ITEM, class BETTER>
TRAV_HD void deal_pass(const WARP& w, const State* st, uint32_t go,
                       ITEM item, BETTER better, int32_t* a, int32_t* b,
                       uint32_t& rounds) {
  constexpr int kLeaves = 32 / SLOTS;
  const trav::CurveScratch c = trav::curve_scratch(w.scratch(), 0);
  const int n = trav::popc(go);
  w.each([&](int l, int lane) {
    if ((go >> lane) & 1u) trav::put_ray(c, trav::rank(go, lane), st[l], false);
  });
  w.sync();
  const int n_rounds = (n + kLeaves - 1) / kLeaves;
  rounds += n_rounds;
  for (int r = 0; r < n_rounds; ++r) {
    w.each([&](int, int lane) {
      const int j = 32 * r + lane;
      int32_t x = 0, y = 0;
      if (j < SLOTS * n) item(trav::get_ray(c, j / SLOTS), j % SLOTS, x, y);
      if (REDUCE) {
        c.key[lane] = x;
        c.key[32 + lane] = y;
      }
    });
    w.sync();
    if (!REDUCE) continue;
    w.each([&](int l, int lane) {
      if (!((go >> lane) & 1u)) return;
      const int q = trav::rank(go, lane);
      if (q / kLeaves != r) return;
      const int first = SLOTS * (q % kLeaves);
      for (int k = 0; k < SLOTS; ++k) {
        const int32_t v = c.key[first + k];
        if (better(v, a[l])) {
          a[l] = v;
          b[l] = c.key[32 + first + k];
        }
      }
    });
    w.sync();
  }
}

// ---- the two ablations' steps, by flags word ----
//
// node(p, s, stk): a step of a ray at a node; leaf_pass(p, w, st, go, a,
// b, rounds): the leaf pass of the waiting lanes go, leaving each one's
// result in a[l], b[l]; take(s, a, b): a waiting ray takes it.

template <int F>
struct V7 {
  static constexpr bool kFetchL = (F & kFLeaf) != 0;
  static constexpr bool kMathL = (F & kMLeaf) != 0;
  static constexpr bool kStackF = (F & kStackOn) != 0;
  static_assert((F & kOneTrip) == 0, "one_trip runs in lockstep");

  template <class STK>
  TRAV_HD static void node(const Params& p, State& s, STK stk) {
    ++s.n_node;
    node_step<(F & kMNode) ? NodeMath::kSlab : NodeMath::kRefs,
              (F & kSort) != 0, kStackF>(
        p, s, stk, (F & kFNode) ? rec_index(s.cur, p.n_node_tiles) : -1);
  }

  template <class WARP>
  TRAV_HD static void leaf_pass(const Params& p, const WARP& w,
                                const State* st, uint32_t go, int32_t* key,
                                int32_t* tb, uint32_t& rounds) {
    if constexpr (!kFetchL && !kMathL) return;
    w.each([&](int l, int) {
      key[l] = 0x7FFFFFFF;
      tb[l] = 0;
    });
    deal_pass<8, kMathL>(
        w, st, go,
        [&](const trav::ItemRay& r, int s, int32_t& x, int32_t& y) {
          v7_item<kFetchL, kMathL>(p, r, s, x, y);
        },
        [](int32_t v, int32_t best) { return v < best; }, key, tb, rounds);
  }

  TRAV_HD static void take(State& s, int32_t key, int32_t tb) {
    if (kMathL) take_v7(s, key, tb);
  }
};

template <int F>
struct V5 {
  static constexpr bool kFetchF = (F & kFetch) != 0;
  static constexpr bool kMathL = (F & kV5Leaf) != 0;
  static constexpr bool kStackF = (F & kV5Stack) != 0;

  template <class STK>
  TRAV_HD static void node(const Params& p, State& s, STK stk) {
    ++s.n_node;
    node_step<(F & kV5Node) ? NodeMath::kSlab : NodeMath::kNone,
              (F & kV5Sort) != 0, kStackF>(
        p, s, stk, kFetchF ? rec_index(s.cur, p.n_node_tiles) : -1);
  }

  template <class WARP>
  TRAV_HD static void leaf_pass(const Params& p, const WARP& w,
                                const State* st, uint32_t go, int32_t* tl,
                                int32_t* pid, uint32_t& rounds) {
    if constexpr (!kFetchF && !kMathL) return;
    w.each([&](int l, int) {
      tl[l] = trav::kInfBits;
      pid[l] = 0;
    });
    deal_pass<kV5Slots, kMathL>(
        w, st, go,
        [&](const trav::ItemRay& r, int s, int32_t& x, int32_t& y) {
          v5_item<kFetchF, kMathL>(p, r, s, x, y);
        },
        [](int32_t v, int32_t best) {
          return trav::as_float(v) < trav::as_float(best);
        },
        tl, pid, rounds);
  }

  TRAV_HD static void take(State& s, int32_t tl, int32_t pid) {
    if (kMathL) take_v5(s, tl, pid);
  }
};

// ---- the persistent warps ----
//
// traverse.cuh::run_warp's loop (its refill, its choice of node or leaf
// pass, its counts) over UNIT's steps; a ray is done when it retires or
// reaches p.max_steps, and after each pass the rays it finished raise their
// programs' most steps (a ray done as it is taken took none). counts (int64, per launch): [0] lane slots (warp
// passes x 32), [1] lane steps that did work, [2] rays finished, [3] warps
// resident per SM (the kernel's), [4] lane slots of leaf passes, [5] lane
// steps of leaf passes, [6] item rounds x 32.
template <class WARP, class UNIT>
TRAV_HD void run_warp(const Params& p, const WARP& w, int32_t* next_ray,
                      unsigned long long* counts) {
  constexpr int L = WARP::kLanes;
  State st[L];
  bool busy[L];
  uint32_t finished[L];
  int32_t ended[L];  // steps of the ray the pass finished, else 0
  w.each([&](int l, int) {
    busy[l] = false;
    finished[l] = 0;
  });
  auto done = [&](int l) {
    finish(p, st[l]);
    ended[l] = st[l].n_node + st[l].n_leaf;
    ++finished[l];
    busy[l] = false;
  };
  bool more = true;  // rays left to take (uniform across the warp)
  uint32_t passes = 0, steps = 0, leaf_passes = 0, leaf_steps = 0,
           rounds = 0;
  auto flush = [&] {
    w.add_counts(counts, passes, steps, finished);
    w.add_leaf_counts(counts, leaf_passes, leaf_steps, rounds);
    passes = steps = leaf_passes = leaf_steps = rounds = 0;
    w.each([&](int l, int) { finished[l] = 0; });
  };
  for (;;) {
    if (more) {
      const uint32_t idle = w.ballot([&](int l) { return !busy[l]; });
      const int n_idle = trav::popc(idle);
      if (n_idle >= trav::kStaticRefillLanes) {
        const int base = w.take(next_ray, idle);
        more = base + n_idle < p.n_rays;
        w.each([&](int l, int lane) {
          const int i = base + trav::rank(idle, lane);
          if (!busy[l] && i < p.n_rays) {
            start(p, i, st[l]);
            busy[l] = true;
            if (!running(p, st[l])) done(l);
          }
        });
      }
    }
    const uint32_t at_node =
        w.ballot([&](int l) { return busy[l] && st[l].cur >= 0; });
    const uint32_t at_leaf =
        w.ballot([&](int l) { return busy[l] && st[l].cur < 0; });
    if ((at_node | at_leaf) == 0) {
      if (!more) break;
      continue;
    }
    const bool leaves =
        trav::popc(at_leaf) >= trav::kStaticLeafLanes || at_node == 0;
    const uint32_t go = leaves ? at_leaf : at_node;
    if (passes == trav::kFlushPasses) flush();
    ++passes;
    steps += trav::popc(go);
    w.each([&](int l, int) { ended[l] = 0; });
    if (leaves) {
      ++leaf_passes;
      leaf_steps += trav::popc(go);
      int32_t a[L], b[L];
      UNIT::leaf_pass(p, w, st, go, a, b, rounds);
      w.each([&](int l, int lane) {
        if (!((go >> lane) & 1u)) return;
        ++st[l].n_leaf;
        UNIT::take(st[l], a[l], b[l]);
        pop<UNIT::kStackF>(st[l], w.stack(l));
        if (!running(p, st[l])) done(l);
      });
    } else {
      w.each([&](int l, int lane) {
        if (!((go >> lane) & 1u)) return;
        UNIT::node(p, st[l], w.stack(l));
        if (!running(p, st[l])) done(l);
      });
    }
    raise_prog_steps(p, w, st, ended);
  }
  flush();
}

// ---- one_trip (v7 flags 0x7F: every phase on), in lockstep ----

// The tile a ray's step needs (kNoTile: none), for the block's reduction.
TRAV_HD int32_t node_tile(const State& s, int32_t n_tiles) {
  return s.live && s.cur >= 0 ? tile_of(s.cur, n_tiles) : kNoTile;
}

TRAV_HD int32_t leaf_tile(const State& s, int32_t n_tiles) {
  return s.live && s.cur < 0 ? tile_of(leaf_id(s.cur), n_tiles) : kNoTile;
}

// One step of a live ray of a one_trip block, after the block's fetch
// round: serve_n / serve_l tell whether that round brought the ray its
// record; otherwise it keeps the index of the last one it fetched (nidx,
// lidx; -1 before the first: the zeroed buffer). The leaf is the whole
// 8-slot record in the lane, in slot order.
template <class STK>
TRAV_HD void one_trip_step(const Params& p, State& s, STK stk, int32_t& nidx,
                           int32_t& lidx, bool serve_n, bool serve_l) {
  if (s.cur >= 0) {
    ++s.n_node;
    if (serve_n) nidx = rec_index(s.cur, p.n_node_tiles);
    node_step<NodeMath::kSlab, true, true>(p, s, stk, nidx);
    return;
  }
  ++s.n_leaf;
  if (serve_l) lidx = rec_index(leaf_id(s.cur), p.n_leaf_tiles);
  int32_t w[kV7LeafWords];
  load_record<kV7LeafWords>(p.leaves, lidx, w);
  float f[kV7LeafWords];
#pragma unroll
  for (int q = 0; q < kV7LeafWords; ++q) f[q] = trav::as_float(w[q]);
  int32_t best_key = 0x7FFFFFFF, best_tb = 0;
#pragma unroll
  for (int sl = 0; sl < 8; ++sl) {
    float tt, uu, vv;
    const bool valid = trav::leaf_moeller(trav::slot_fields(f, sl), s.ray,
                                          s.tf, tt, uu, vv);
    int32_t k, tb;
    trav::slot_key(valid, tt, sl, k, tb);
    if (k < best_key) {
      best_key = k;
      best_tb = tb;
    }
  }
  take_v7(s, best_key, best_tb);
  pop<true>(s, stk);
}

// A launch the kernels do not take: no rays, empty tables, or one_trip
// (whole_blocks) on rays that are no whole 128-ray sub-groups.
inline bool bad_launch(const Params& p, bool whole_blocks) {
  return p.n_rays <= 0 || p.prog_rays <= 0 || p.n_node_tiles < 1 ||
         p.n_leaf_tiles < 1 || p.max_steps < 0 ||
         (whole_blocks && p.n_rays % kLane != 0);
}

#ifdef __CUDACC__
// Dynamic shared memory of a block: the stacks (kStack x kLane, column
// per thread), then each warp's scratch (persistent kernels).
constexpr size_t kSmemWords = kStack * kLane + (kLane / 32) * kScratchWords;

// The persistent kernel on as many blocks as stay resident (at most the
// blocks the rays fill); a failed query leaves its error for the caller's
// cudaGetLastError.
template <class KERNEL>
void launch_persistent(KERNEL kernel, const Params& p, int32_t* next_ray,
                       unsigned long long* counts, cudaStream_t st) {
  const size_t smem = kSmemWords * sizeof(int32_t);
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLane,
                                                    smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return;
  }
  const int need = (p.n_rays + kLane - 1) / kLane;
  const int grid = per_sm * sms < need ? per_sm * sms : need;
  kernel<<<grid, kLane, smem, st>>>(p, next_ray, counts,
                                    per_sm * (kLane / 32));
}
#endif

}  // namespace abl
