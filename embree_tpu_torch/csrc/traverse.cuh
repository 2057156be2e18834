// Per-ray BVH8 traversal: closest hit or any hit of one ray against the
// port's packed records (embree_tpu_torch/accel/pack.py).
//
// Replaces embree_tpu/accel/traverse_pallas.py::_kernel: the triangle
// specialization (B1, resident or streamed table), robust mode (B2:
// +-3-ulp widened slabs, watertight Pluecker leaf, :469-479, :529-556),
// per-slot kind tags with quads as two triangle slots (B3, :1048-1057),
// points (B4: sphere, ray-facing disc, oriented disc, :582-621), lines (B5:
// round cone-sphere with the begin-cap flag, flat ray-facing, :622-717),
// motion blur (B6: every field lerped from step A to step B by the ray time,
// or by the window-local time with per-slot [t0, t1] windows in time-sliced
// scenes, :502-520, :1059-1060), flat curves (B7: the ribbon on 16-field
// slots holding 4 Bezier CPs as x, y, z, r, with the per-ray curve frame,
// :719-856, :194-221) and round curves (B8: the swept circle on the same
// slots, :858-1046). Each ray walks the exact sequence of records the
// Pallas kernel gives its lane: the same bf16 slab test, the same sort keys
// (t bits with the low 3 bits replaced by the slot), the same push order,
// the same strict `t < tfar` acceptance, and every leaf expression in the
// Pallas kernel's association order. The TPU kernel's fetch stalls and
// 16-group lockstep only delay a lane, never change its result, so they
// have no counterpart here. Where the Pallas kernel computes every class
// of a slot and selects by tag, this code switches on the tag: selection
// never mixes classes, so the result is the same.
//
// What bounds it on an H100: every step reads one record (128 B for a node,
// 288 B for a leaf, 512 B with curves, twice that with motion, +32 B for
// each mask or kind chunk, +64 B for the windows) through L2, dependent on
// the step before; rays of one warp diverge in depth, in record kind and,
// with kind tags, in primitive class (a round line costs ~190 operations, a
// disc ~30).
//
// Every variant runs the same per-ray steps under a scheduler (run_warp, at
// the end of this file; the kernel in launch.cuh): the moving ones (B6),
// every curve variant, static or moving (B7, B8), and the static triangles
// (B1), robust triangles (B2) and mixed classes (B3-B5), which have a leaf
// pass of their own (static_pass). Moving rays' times are not part of the
// coherence key, so a warp's rays differ in length by hundreds of steps (a
// ray grazing the swept boxes walks thousands). Against divergence:
// persistent warps whose lanes take a new ray as soon as enough of them are
// done, and leaves postponed until enough lanes wait at one, so the long leaf
// code runs converged. Against latency: 16-20 resident warps per SM instead
// of 12, since no whole leaf is held in registers (motion_leaf reads, lerps
// and tests kSlotGroup = 4 slots at a time, and closest + attrs recomputes
// the winner's u, v and Ng after the leaf), and the stack in shared memory (a
// column per lane, no bank conflicts), where a pop does not wait on an L1
// that leaf loads keep evicting. Four slots share each 16-byte load: one slot
// at a time reads every field with a 4-byte load of its own, each a wavefront
// of the L1 per lane, and ran about 3x slower (perf/sched_sweep.py).
//
// B7 is bound by operations, not bytes: a ribbon slot at rate 4 costs 884
// operations, 16x a triangle's (curve_slot_ops in chip_smoke.py counts them
// from this file), and a curve leaf visit about 14,000 against a node's
// 100, so with one ray per thread the lanes at nodes idled behind those at
// leaves. The curve variants' leaf pass (curve_pass) deals the waiting
// lanes' (ray, slot) items across the warp, 32 per round: each lane reads
// one slot's words (field k of slot s is word 8k+s, so the 8 lanes of a
// leaf read each field as one 32-byte sector), lerps them, and runs that
// slot's test, with its ray's constants and curve frame (computed once per
// ray) from the warp's scratch in shared memory, and the ribbon's knot
// weights from the block's copy there. Each waiting lane then takes the
// least of its slots' keys in slot order.
//
// B8 is bound by operations too, more than B7: a round slot at rate 4 (8
// cone segments) costs about 1,330 operations, and each candidate a
// segment yields about 1,300 more for its 5 Newton steps (round_slot_ops
// and ROUND_CANDIDATE_OPS in chip_smoke.py count them from this file).
// The Pallas kernel computes all 8 candidates, then polishes each; here a
// segment without a candidate is not polished (its result is masked out in
// Pallas), and the round slots of a leaf pass run their cone segments in
// step across the warp, queueing their candidates, which the warp polishes
// 32 at a time instead of in the one lane that found each. The knots'
// Bernstein weights follow the ribbon's in the weight table (curve_w).
// Scenes with round slots run 16 instantiations of their own (ROUND,
// traverse_round.cu), chosen from kind_classes bit 9, in which the slot's
// tag picks the ribbon or the swept circle. As a runtime branch of the flat
// variants the round test took their registers from 89-94 to 111-121 and
// slowed the flat hair kernel by 19% on an H100 (chip_smoke.py), though no
// flat scene runs it.
//
// The static triangles (B1), robust triangles (B2) and mixed classes
// (B3-B5) deal their leaves too (static_pass): one ray per thread left
// their lanes idle behind the warp's deepest ray, held the whole 288-byte
// leaf in registers and the stack in local memory, and, with kind tags,
// ran one class test after another in a warp whose lanes met different
// classes (a round line ~190 operations, a disc ~30). Dealt, a leaf's 8
// slots are tested side by side, each lane holds one slot, and the
// kernels keep 78-83 registers and 5 blocks per SM.
//
// The file is compiled by nvcc into the kernel (traverse.cu, and
// traverse_curves.cu and traverse_round.cu for the curve variants) and by
// g++ into a CPU twin (traverse_cpu.cpp), which runs the scheduler over 32
// emulated lanes, and which the tests hold against the plain PyTorch
// version. Both builds forbid FMA contraction, and both take 1/sqrt for the
// Pallas kernel's rsqrt, correctly rounded.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define TRAV_HD __host__ __device__ __forceinline__
#else
#include <math.h>
#include <string.h>
#define TRAV_HD inline
#endif

namespace trav {

constexpr int kStack = 64;             // STACK_BLOCKS * 8 in the Pallas kernel
constexpr int kMaxSteps = 200000;      // runaway guard (MAX_STEPS)
constexpr int32_t kInvalidRec = 0x40000000;
constexpr int32_t kInfBits = 0x7F800000;
constexpr int kNodeWords = 32;         // 8 child refs + 24 bf16 lo|hi words
constexpr int kLeafFields = 72;        // 9 fields x 8 slots, field-major
constexpr int kCurveFields = 16;       // per slot in curve scenes (B7)
constexpr int kTagCurve = 8;           // KIND_CURVE_FLAT
constexpr int kTagRound = 9;           // KIND_CURVE_ROUND
constexpr int kKnotWeights = 7;        // per ribbon knot: 4 cubic + 3 quadratic
constexpr int kRoundWeights = 4;       // per round knot: 4 cubic
constexpr int kRoundMinRate = 8;       // round segments: max(rate, 8) (:865)
constexpr int kRoundNewton = 5;        // Newton steps per candidate (:962)
constexpr float kMinWindow = 1e-9f;    // the window-width floor (:511)
// robust slab widening, rounded to float32 as the Pallas kernel does
constexpr float kRobustDown = static_cast<float>(1.0 - 3.0 * 1.19209290e-07);
constexpr float kRobustUp = static_cast<float>(1.0 + 3.0 * 1.19209290e-07);
constexpr float kUlp1 = 1.19209290e-07f;
constexpr float kBig = 3e38f;
// the ribbon's small-derivative threshold factor (:759), rounded as Pallas
constexpr float kRibbonEps = static_cast<float>(4.0 * 1.19209290e-07);
// the sweep's error-bound factor (:955, :998, :1020)
constexpr float kSweepErr = static_cast<float>(16.0 * 1.19209290e-07);

struct Params {
  const int32_t* nodes;    // (n_nodes, 32)
  int32_t n_nodes;
  const int32_t* leaves;   // (n_leaves, leaf_stride): A [B] [mask] [kind]
  int32_t n_leaves;        //   [t0 t1] (accel/pack.py)
  int32_t leaf_stride;     // 72, +72 with motion, +8 per mask/kind chunk,
                           // +16 with windows
  const float* org;        // (R, 3)
  const float* dir;        // (R, 3)
  const float* tnear;      // (R,)
  const float* tfar;       // (R,)
  const int32_t* mask;     // (R,) ray mask bit pattern
  int32_t n_rays;
  float* out_t;            // (R,)   t of the best hit, else tfar
  int32_t* out_best;       // (R,)   8 * leaf + slot of the best hit, else -1
  int32_t* out_visits;     // (2, R) node records, leaf records visited
  float* out_attr;         // (5, R) u, v, Ng of the best hit (WANT_ATTRS)
  int32_t kind_classes;    // bit k set: kind tag k occurs (KINDS)
  const float* time;       // (R,) ray times (MOTION)
  int32_t has_win;         // records carry per-slot windows (MOTION)
  int32_t curve_rate;      // ribbon segments per curve (CURVES)
  const float* curve_w;    // (curve_rate + 1, 7) ribbon knot weights, then
                           // (max(curve_rate, 8) + 1, 4) round (CURVES)
};

// A variant that does not exist: attributes with kind tags, windows
// without motion, motion without times, curves without kind tags, 16-field
// slots or knot weights.
inline bool bad_variant(int occlusion, int want_attrs, int has_kinds,
                        int kind_classes, int has_motion, int has_win,
                        const float* time, int nf, int curve_rate,
                        const float* curve_w) {
  const bool curves = ((kind_classes >> kTagCurve) & 3) != 0;
  return (has_kinds && want_attrs && !occlusion) || (has_win && !has_motion) ||
         (has_motion && time == nullptr) ||
         nf != (curves ? kCurveFields : 9) ||
         (curves && (!has_kinds || curve_rate < 1 || curve_w == nullptr));
}

struct I4 {
  int32_t x, y, z, w;
};

TRAV_HD float as_float(int32_t i) {
#ifdef __CUDA_ARCH__
  return __int_as_float(i);
#else
  float f;
  memcpy(&f, &i, 4);
  return f;
#endif
}

TRAV_HD int32_t as_int(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_int(f);
#else
  int32_t i;
  memcpy(&i, &f, 4);
  return i;
#endif
}

// One 16-byte load of a record (read-only path on the card).
TRAV_HD I4 load4(const int32_t* p) {
#ifdef __CUDA_ARCH__
  int4 v = __ldg(reinterpret_cast<const int4*>(p));
  return I4{v.x, v.y, v.z, v.w};
#else
  I4 v;
  memcpy(&v, p, 16);
  return v;
#endif
}

// One 4-byte load (read-only path on the card).
TRAV_HD int32_t load1(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

TRAV_HD float load1f(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// jnp.minimum / jnp.maximum: NaN in, NaN out (fminf/fmaxf would drop it and
// open boxes the reference closes), and -0 < +0.
TRAV_HD float jmin(float a, float b) {
  if (a != a || b != b) return a + b;
  if (a < b) return a;
  if (b < a) return b;
  return as_float(as_int(a) | as_int(b));
}

TRAV_HD float jmax(float a, float b) {
  if (a != a || b != b) return a + b;
  if (a > b) return a;
  if (b > a) return b;
  return as_float(as_int(a) & as_int(b));
}

TRAV_HD float rcp_safe(float x) {
  const float eps = 1e-18f;
  float y = fabsf(x) < eps ? (x >= 0.0f ? eps : -eps) : x;
  return 1.0f / y;
}

// bf16 pair decode: lo in the low 16 bits, hi in the high 16 bits. Shifts go
// through uint32_t (a left shift of a negative int is undefined).
TRAV_HD float bf16_lo(int32_t bits) {
  return as_float(static_cast<int32_t>(static_cast<uint32_t>(bits) << 16));
}

TRAV_HD float bf16_hi(int32_t bits) {
  return as_float(static_cast<int32_t>(static_cast<uint32_t>(bits) &
                                       0xFFFF0000u));
}

TRAV_HD int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

TRAV_HD void cswap(int32_t* k, int32_t* r, int a, int b) {
  if (k[b] < k[a]) {
    int32_t t = k[a];
    k[a] = k[b];
    k[b] = t;
    t = r[a];
    r[a] = r[b];
    r[b] = t;
  }
}

// Batcher's odd-even merge network for 8 keys (19 compare-exchanges). Keys
// are distinct (the slot rides in the low 3 bits), so any correct sort gives
// the Pallas kernel's bitonic order.
TRAV_HD void sort8(int32_t* k, int32_t* r) {
  cswap(k, r, 0, 1); cswap(k, r, 2, 3); cswap(k, r, 4, 5); cswap(k, r, 6, 7);
  cswap(k, r, 0, 2); cswap(k, r, 1, 3); cswap(k, r, 4, 6); cswap(k, r, 5, 7);
  cswap(k, r, 1, 2); cswap(k, r, 5, 6); cswap(k, r, 0, 4); cswap(k, r, 3, 7);
  cswap(k, r, 1, 5); cswap(k, r, 2, 6); cswap(k, r, 1, 4); cswap(k, r, 3, 6);
  cswap(k, r, 2, 4); cswap(k, r, 3, 5); cswap(k, r, 3, 4);
}

// One ray's constants for the leaf tests.
struct Ray {
  float ox, oy, oz, dx, dy, dz, tnear, ddot;
};

// The 9 fields of slot s of a leaf record (field-major words).
struct Slot {
  float f0, f1, f2, f3, f4, f5, f6, f7, f8;
};

TRAV_HD Slot slot_fields(const float* f, int s) {
  return Slot{f[s],      f[8 + s],  f[16 + s], f[24 + s], f[32 + s],
              f[40 + s], f[48 + s], f[56 + s], f[64 + s]};
}

// ---- class 0: Moeller-Trumbore (fields v0, e1, e2) ----
TRAV_HD bool leaf_moeller(const Slot& q, const Ray& r, float tf, float& tt,
                          float& uu, float& vv) {
  const float v0x = q.f0, v0y = q.f1, v0z = q.f2;
  const float e1x = q.f3, e1y = q.f4, e1z = q.f5;
  const float e2x = q.f6, e2y = q.f7, e2z = q.f8;
  const float dx = r.dx, dy = r.dy, dz = r.dz;
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool det_ok = fabsf(det) > 1e-24f;
  const float inv_det = det_ok ? 1.0f / det : 0.0f;
  const float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
  uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
  tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  return det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
         tt >= r.tnear && tt <= tf;
}

// ---- class 0 in robust mode, B2: watertight Pluecker test; u/v = U/S,
// V/S (:529-556) ----
TRAV_HD bool leaf_pluecker(const Slot& q, const Ray& r, float tf, float& tt,
                           float& uu, float& vv) {
  const float e1x = q.f3, e1y = q.f4, e1z = q.f5;
  const float e2x = q.f6, e2y = q.f7, e2z = q.f8;
  const float dx = r.dx, dy = r.dy, dz = r.dz;
  const float ax = q.f0 - r.ox, ay = q.f1 - r.oy, az = q.f2 - r.oz;
  const float bx = ax + e1x, by = ay + e1y, bz = az + e1z;
  const float cx = ax + e2x, cy = ay + e2y, cz = az + e2z;
  const float up = dx * (cy * bz - cz * by) + dy * (cz * bx - cx * bz) +
                   dz * (cx * by - cy * bx);
  const float vp = dx * (ay * cz - az * cy) + dy * (az * cx - ax * cz) +
                   dz * (ax * cy - ay * cx);
  const float wp = dx * (by * az - bz * ay) + dy * (bz * ax - bx * az) +
                   dz * (bx * ay - by * ax);
  const float min_uvw = jmin(jmin(up, vp), wp);
  const float max_uvw = jmax(jmax(up, vp), wp);
  const float ngx = e1y * e2z - e1z * e2y;
  const float ngy = e1z * e2x - e1x * e2z;
  const float ngz = e1x * e2y - e1y * e2x;
  const float den = ngx * dx + ngy * dy + ngz * dz;
  const bool den_ok = fabsf(den) > 1e-30f;
  const float inv_den = den_ok ? 1.0f / den : 0.0f;
  tt = (ngx * ax + ngy * ay + ngz * az) * inv_den;
  const float sum = up + vp + wp;
  const float rcp_s = fabsf(sum) > 1e-30f ? 1.0f / sum : 0.0f;
  uu = up * rcp_s;
  vv = vp * rcp_s;
  return (min_uvw >= 0.0f || max_uvw <= 0.0f) && den_ok && tt >= r.tnear &&
         tt <= tf;
}

// ---- class 2, B4: sphere point (center, radius; :585-598) ----
TRAV_HD bool leaf_sphere(const Slot& q, const Ray& r, float tf, float& tt) {
  const float ocx = r.ox - q.f0, ocy = r.oy - q.f1, ocz = r.oz - q.f2;
  const float rad = q.f3;
  const float bq = 2.0f * (ocx * r.dx + ocy * r.dy + ocz * r.dz);
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = bq * bq - 4.0f * r.ddot * cq;
  const float sq = sqrtf(jmax(disc, 0.0f));
  const float inv2a = 1.0f / jmax(2.0f * r.ddot, 1e-30f);
  const float st0 = (-bq - sq) * inv2a;
  const float st1 = (-bq + sq) * inv2a;
  const bool ok = disc >= 0.0f;
  const bool v0 = ok && st0 >= r.tnear && st0 <= tf;
  const bool v1 = ok && st1 >= r.tnear && st1 <= tf;
  tt = v0 ? st0 : st1;
  return v0 || v1;
}

TRAV_HD bool disc_hit(const Slot& q, const Ray& r, float tf, float td,
                      float cmox, float cmoy, float cmoz) {
  const float px = td * r.dx - cmox;
  const float py = td * r.dy - cmoy;
  const float pz = td * r.dz - cmoz;
  const float r2 = px * px + py * py + pz * pz;
  return td >= r.tnear && td <= tf && r2 <= q.f3 * q.f3;
}

// ---- class 3, B4: ray-facing disc (:600-608) ----
TRAV_HD bool leaf_disc(const Slot& q, const Ray& r, float tf, float& tt) {
  const float cmox = q.f0 - r.ox, cmoy = q.f1 - r.oy, cmoz = q.f2 - r.oz;
  const float d2 = jmax(r.ddot, 1e-30f);
  tt = (cmox * r.dx + cmoy * r.dy + cmoz * r.dz) / d2;
  return disc_hit(q, r, tf, tt, cmox, cmoy, cmoz);
}

// ---- class 4, B4: oriented disc (normal in fields 4-6; :610-620) ----
TRAV_HD bool leaf_oriented_disc(const Slot& q, const Ray& r, float tf,
                                float& tt) {
  const float cmox = q.f0 - r.ox, cmoy = q.f1 - r.oy, cmoz = q.f2 - r.oz;
  const float dn = r.dx * q.f4 + r.dy * q.f5 + r.dz * q.f6;
  const bool ok = fabsf(dn) > 1e-12f;
  tt = (cmox * q.f4 + cmoy * q.f5 + cmoz * q.f6) / (ok ? dn : 1.0f);
  return ok && disc_hit(q, r, tf, tt, cmox, cmoy, cmoz);
}

// ---- class 5, B5: round line, tangent cone + end spheres, CSG interval
// union; field 8 flags a joint whose begin sphere belongs to the previous
// segment (:622-691) ----
TRAV_HD bool leaf_round_line(const Slot& q, const Ray& r, float tf,
                             float& tt) {
  const float p0x = q.f0, p0y = q.f1, p0z = q.f2, r0 = q.f3;
  const float p1x = q.f4, p1y = q.f5, p1z = q.f6, r1 = q.f7;
  const float dx = r.dx, dy = r.dy, dz = r.dz, ddot = r.ddot;
  const float rcpdd = 1.0f / jmax(ddot, 1e-30f);
  const float ccx = 0.5f * (p0x + p1x), ccy = 0.5f * (p0y + p1y),
              ccz = 0.5f * (p0z + p1z);
  const float dtl =
      ((ccx - r.ox) * dx + (ccy - r.oy) * dy + (ccz - r.oz) * dz) * rcpdd;
  const float o2x = r.ox + dtl * dx, o2y = r.oy + dtl * dy,
              o2z = r.oz + dtl * dz;
  const float dpx = p1x - p0x, dpy = p1y - p0y, dpz = p1z - p0z;
  const float dpdp = dpx * dpx + dpy * dpy + dpz * dpz;
  const float drr = r1 - r0;
  const float r0dr = r0 * drr;
  const float gco = dpdp - drr * drr;
  const float oxx = o2x - p0x, oyy = o2y - p0y, ozz = o2z - p0z;
  const float odp = oxx * dpx + oyy * dpy + ozz * dpz;
  const float dodp = dx * dpx + dy * dpy + dz * dpz;
  const float ypc = odp + r0dr;
  const float oo = oxx * oxx + oyy * oyy + ozz * ozz;
  const float odo = dx * oxx + dy * oyy + dz * ozz;
  const float ac = gco * ddot - dodp * dodp;
  const float bc = 2.0f * (gco * odo - dodp * ypc);
  const float cc = gco * oo - odp * odp - r0 * r0 * dpdp - 2.0f * r0dr * odp;
  const float dc = bc * bc - 4.0f * ac * cc;
  const bool cone_ok = dc >= 0.0f && gco > 0.0f && fabsf(ac) > 1e-18f;
  const float qc = sqrtf(jmax(dc, 0.0f));
  const float rc2a = 1.0f / (cone_ok ? 2.0f * ac : 1.0f);
  const float tcf = (-bc - qc) * rc2a;
  const float tcb = (-bc + qc) * rc2a;
  const float ycf = ypc + tcf * dodp;
  const float ycb = ypc + tcb * dodp;
  const bool cf_ok = cone_ok && ycf > -kUlp1 && ycf <= gco;
  const bool cb_ok = cone_ok && ycb > -kUlp1 && ycb <= gco;
  // end spheres
  float ts0f, ts0b, ts1f, ts1b;
  bool s0ok, s1ok;
  {
    const float o1x = o2x - p0x, o1y = o2y - p0y, o1z = o2z - p0z;
    const float o1do = o1x * dx + o1y * dy + o1z * dz;
    const float h2 =
        o1do * o1do - ddot * (o1x * o1x + o1y * o1y + o1z * o1z - r0 * r0);
    const float rt = sqrtf(jmax(h2, 0.0f));
    s0ok = h2 >= 0.0f;
    ts0f = (-o1do - rt) * rcpdd;
    ts0b = (-o1do + rt) * rcpdd;
  }
  {
    const float o1x = o2x - p1x, o1y = o2y - p1y, o1z = o2z - p1z;
    const float o1do = o1x * dx + o1y * dy + o1z * dz;
    const float h2 =
        o1do * o1do - ddot * (o1x * o1x + o1y * o1y + o1z * o1z - r1 * r1);
    const float rt = sqrtf(jmax(h2, 0.0f));
    s1ok = h2 >= 0.0f;
    ts1f = (-o1do - rt) * rcpdd;
    ts1b = (-o1do + rt) * rcpdd;
  }
  s0ok = s0ok && q.f8 < 0.5f;
  const bool s0f = s0ok && ypc + ts0f * dodp < 0.0f;
  const bool s0b = s0ok && ypc + ts0b * dodp < 0.0f;
  const bool s1f = s1ok && ypc + ts1f * dodp > gco;
  const bool s1b = s1ok && ypc + ts1b * dodp > gco;
  const float t_lo = jmin(cf_ok ? tcf : kBig,
                          jmin(s0f ? ts0f : kBig, s1f ? ts1f : kBig));
  const float t_up = jmax(cb_ok ? tcb : -kBig,
                          jmax(s0b ? ts0b : -kBig, s1b ? ts1b : -kBig));
  const bool lo_ok =
      r.tnear <= dtl + t_lo && dtl + t_lo <= tf && t_lo < kBig;
  const bool up_ok =
      r.tnear <= dtl + t_up && dtl + t_up <= tf && t_up > -kBig;
  tt = dtl + (lo_ok ? t_lo : t_up);
  return lo_ok || up_ok;
}

// ---- class 6, B5: flat ray-facing line (:693-717) ----
TRAV_HD bool leaf_flat_line(const Slot& q, const Ray& r, float tf,
                            float& tt) {
  const float p0x = q.f0, p0y = q.f1, p0z = q.f2, r0 = q.f3;
  const float p1x = q.f4, p1y = q.f5, p1z = q.f6, r1 = q.f7;
  const float dx = r.dx, dy = r.dy, dz = r.dz;
  const float vx = p1x - p0x, vy = p1y - p0y, vz = p1z - p0z;
  const float wx = p0x - r.ox, wy = p0y - r.oy, wz = p0z - r.oz;
  const float dd = jmax(r.ddot, 1e-30f);
  const float invdd = 1.0f / dd;
  const float wd = wx * dx + wy * dy + wz * dz;
  const float vd = vx * dx + vy * dy + vz * dz;
  const float wv = (wx * vx + wy * vy + wz * vz) - wd * vd * invdd;
  const float vv2 = (vx * vx + vy * vy + vz * vz) - vd * vd * invdd;
  const bool okf = vv2 > 1e-20f;
  const float sf =
      jmin(1.0f, jmax(0.0f, okf ? -wv / (okf ? vv2 : 1.0f) : 0.0f));
  const float mx = wx + sf * vx, my = wy + sf * vy, mz = wz + sf * vz;
  const float md = mx * dx + my * dy + mz * dz;
  tt = md * invdd;
  const float d2f = mx * mx + my * my + mz * mz - md * md * invdd;
  const float rr = r0 + sf * (r1 - r0);
  return d2f <= rr * rr && tt >= r.tnear && tt <= tf &&
         tt > 2.0f * rr * (1.0f / sqrtf(dd)) &&
         (vx != 0.0f || vy != 0.0f || vz != 0.0f);
}

// ---- class 8, B7: the flat curve's ribbon (:739-856) ----

// The per-ray curve frame (:197-221): rows vx, vy and vz * ds of the ray
// space, and ds = 1 / |d|, from the unnormalized direction, with 1 / sqrt.
struct CurveFrame {
  float vx0, vx1, vx2, vy0, vy1, vy2, vz0, vz1, vz2, ds;
};

TRAV_HD CurveFrame curve_frame(float dx, float dy, float dz) {
  const float ds = 1.0f / sqrtf(jmax(dx * dx + dy * dy + dz * dz, 1e-36f));
  const float nx = dx * ds, ny = dy * ds, nz = dz * ds;
  const bool pick = (nz * nz + ny * ny) > (nz * nz + nx * nx);
  float fx0 = pick ? 0.0f : -nz;
  float fx1 = pick ? nz : 0.0f;
  float fx2 = pick ? -ny : nx;
  const float fl = 1.0f / sqrtf(jmax(fx0 * fx0 + fx1 * fx1 + fx2 * fx2,
                                     1e-36f));
  fx0 = fx0 * fl;
  fx1 = fx1 * fl;
  fx2 = fx2 * fl;
  const float fy0 = ny * fx2 - nz * fx1;
  const float fy1 = nz * fx0 - nx * fx2;
  const float fy2 = nx * fx1 - ny * fx0;
  const float fyl = 1.0f / sqrtf(jmax(fy0 * fy0 + fy1 * fy1 + fy2 * fy2,
                                      1e-36f));
  return CurveFrame{fx0,       fx1,       fx2,       fy0 * fyl, fy1 * fyl,
                    fy2 * fyl, nx * ds,   ny * ds,   nz * ds,   ds};
}

// One ribbon knot in ray space: position (x, y, z, r), the 2D derivative,
// and whether the derivative is too small to give a direction.
struct Knot {
  float px, py, pz, pr, dx, dy;
  bool small;
};

// The knot of weights w (4 cubic Bernstein weights, then 3 quadratic
// ones), with every product kept (zero weights at the end knots too).
TRAV_HD Knot ribbon_knot(const float* w, const float* cx, const float* cy,
                         const float* cz, const float* cr, float eps) {
  const float w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
  const float q0 = w[4], q1 = w[5], q2 = w[6];
  Knot k;
  k.px = w0 * cx[0] + w1 * cx[1] + w2 * cx[2] + w3 * cx[3];
  k.py = w0 * cy[0] + w1 * cy[1] + w2 * cy[2] + w3 * cy[3];
  k.pz = w0 * cz[0] + w1 * cz[1] + w2 * cz[2] + w3 * cz[3];
  k.pr = w0 * cr[0] + w1 * cr[1] + w2 * cr[2] + w3 * cr[3];
  k.dx = 3.0f * (q0 * (cx[1] - cx[0]) + q1 * (cx[2] - cx[1]) +
                 q2 * (cx[3] - cx[2]));
  k.dy = 3.0f * (q0 * (cy[1] - cy[0]) + q1 * (cy[2] - cy[1]) +
                 q2 * (cy[3] - cy[2]));
  const float dz = 3.0f * (q0 * (cz[1] - cz[0]) + q1 * (cz[2] - cz[1]) +
                           q2 * (cz[3] - cz[2]));
  k.small = jmax(jmax(fabsf(k.dx), fabsf(k.dy)), fabsf(dz)) < eps;
  return k;
}

// The ribbon of one slot: cf holds its 16 fields (CP j at 4j..4j+3 = x, y,
// z, r). CPs into the ray frame, `rate` ruled quads between the +-r offset
// curves, knot i + 1 computed, segment i tested, knots shifted; each quad
// a backface-culled 2D test with z riding along for t, rejected inside the
// self-intersection distance. tt is the nearest accepted t (strictly
// nearer, in segment order); the slot hits when any segment is accepted.
TRAV_HD bool leaf_ribbon(const float* cf, const Ray& r, const CurveFrame& fr,
                         float tf, int rate, const float* wt, float& tt) {
  float cx[4], cy[4], cz[4], cr[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float rx = cf[4 * j] - r.ox, ry = cf[4 * j + 1] - r.oy,
                rz = cf[4 * j + 2] - r.oz;
    cx[j] = rx * fr.vx0 + ry * fr.vx1 + rz * fr.vx2;
    cy[j] = rx * fr.vy0 + ry * fr.vy1 + rz * fr.vy2;
    cz[j] = rx * fr.vz0 + ry * fr.vz1 + rz * fr.vz2;
    cr[j] = cf[4 * j + 3];
  }
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    amax = jmax(amax, fabsf(cx[j]));
    amax = jmax(amax, fabsf(cy[j]));
    amax = jmax(amax, fabsf(cz[j]));
    amax = jmax(amax, fabsf(cr[j]));
  }
  const float eps = kRibbonEps * amax;
  float rib_t = as_float(kInfBits);
  bool rib_hit = false;
  Knot k0 = ribbon_knot(wt, cx, cy, cz, cr, eps);
  for (int i = 0; i < rate; ++i) {
    const Knot k1 =
        ribbon_knot(wt + kKnotWeights * (i + 1), cx, cy, cz, cr, eps);
    const float sdx = k1.px - k0.px, sdy = k1.py - k0.py;
    const float d0x = k0.small ? sdx : k0.dx, d0y = k0.small ? sdy : k0.dy;
    const float d1x = k1.small ? sdx : k1.dx, d1y = k1.small ? sdy : k1.dy;
    // cylinder culling against the 2D origin (ribbon.h:66-71)
    const float num = sdx * k0.py - sdy * k0.px;
    const float den2 = sdx * sdx + sdy * sdy;
    const float rmax = jmax(k0.pr, k1.pr);
    bool vseg = num * num <= rmax * rmax * den2;
    const float n0l = 1.0f / sqrtf(jmax(d0y * d0y + d0x * d0x, 1e-36f));
    const float n1l = 1.0f / sqrtf(jmax(d1y * d1y + d1x * d1x, 1e-36f));
    const float n0x = d0y * n0l, n0y = -d0x * n0l;
    const float n1x = d1y * n1l, n1y = -d1x * n1l;
    // quad (lp0, lp1, up1, up0) (quad_intersector.h:15-74)
    const float vax = k0.px + k0.pr * n0x, vay = k0.py + k0.pr * n0y;
    const float vbx = k1.px + k1.pr * n1x, vby = k1.py + k1.pr * n1y;
    const float vcx = k1.px - k1.pr * n1x, vcy = k1.py - k1.pr * n1y;
    const float vdx = k0.px - k0.pr * n0x, vdy = k0.py - k0.pr * n0y;
    const float edbx = vbx - vdx, edby = vby - vdy;
    const bool sel = vdx * edby - vdy * edbx <= 0.0f;
    const float v0x = sel ? vax : vcx, v0y = sel ? vay : vcy,
                v0z = sel ? k0.pz : k1.pz;
    const float v1x = sel ? vbx : vdx, v1y = sel ? vby : vdy,
                v1z = sel ? k1.pz : k0.pz;
    const float v2x = sel ? vdx : vbx, v2y = sel ? vdy : vby,
                v2z = sel ? k0.pz : k1.pz;
    const float e0x = v2x - v0x, e0y = v2y - v0y, e0z = v2z - v0z;
    const float e1x = v0x - v1x, e1y = v0y - v1y, e1z = v0z - v1z;
    const float uq = v0x * e0y - v0y * e0x;
    const float vq = v1x * e1y - v1y * e1x;
    vseg = vseg && jmax(uq, vq) <= 0.0f;
    const float ngx = e1y * e0z - e1z * e0y;
    const float ngy = e1z * e0x - e1x * e0z;
    const float ngz = e1x * e0y - e1y * e0x;
    const float rden = ngz != 0.0f ? 1.0f / (ngz == 0.0f ? 1.0f : ngz) : 0.0f;
    const float tq = rden * (v0x * ngx + v0y * ngy + v0z * ngz);
    vseg = vseg && r.tnear <= tq && tq <= tf && ngz != 0.0f;
    const float us = uq * rden;
    const float u = sel ? us : 1.0f - us;
    const float r_at = k0.pr * (1.0f - u) + k1.pr * u;
    // self-intersection avoidance (ribbon.h:117-120)
    vseg = vseg && tq > 2.0f * r_at * fr.ds;
    if (vseg && tq < rib_t) rib_t = tq;
    rib_hit = rib_hit || vseg;
    k0 = k1;
  }
  tt = rib_t;
  return rib_hit;
}

// ---- class 9, B8: the round curve's swept circle (:858-1046) ----

// A knot of the round curve in world space: position and radius.
struct RoundKnot {
  float x, y, z, r;
};

// The knot of the round weights w (4 per knot) on the 16 fields cf (CP j
// at 4j..4j+3 = x, y, z, r).
TRAV_HD RoundKnot round_knot(const float* w, const float* cf) {
  const float w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
  return RoundKnot{w0 * cf[0] + w1 * cf[4] + w2 * cf[8] + w3 * cf[12],
                   w0 * cf[1] + w1 * cf[5] + w2 * cf[9] + w3 * cf[13],
                   w0 * cf[2] + w1 * cf[6] + w2 * cf[10] + w3 * cf[14],
                   w0 * cf[3] + w1 * cf[7] + w2 * cf[11] + w3 * cf[15]};
}

// The Newton frame of one round slot: the CPs relative to the ray origin
// moved to the CP centroid's closest approach (dtc along the ray), the
// radii, and the error scales (:941-956).
struct Sweep {
  float rx[4], ry[4], rz[4], cr[4];
  float dtc, p_err, len_dir;
};

// The 5-step Jacobian-Newton polish of one candidate (:957-1035): from
// (u0, t0w) on the exact sweep equations f = dot(R, T) = 0 and g = |R x T| -
// r(u) = 0; returns whether a root converged inside [tnear, tf] and u in
// [0, 1] (its t in t_out, the first such step's).
TRAV_HD bool round_polish(const Sweep& s, const Ray& r, float tf, float un,
                          float t0w, float& t_out) {
  const float dx = r.dx, dy = r.dy, dz = r.dz;
  float tn = t0w - s.dtc;
  bool ok = false;
  t_out = t0w;
  for (int it = 0; it < kRoundNewton; ++it) {
    const float sm = 1.0f - un;
    const float w0 = sm * sm * sm, w1 = 3.0f * sm * sm * un,
                w2 = 3.0f * sm * un * un, w3 = un * un * un;
    const float px = w0 * s.rx[0] + w1 * s.rx[1] + w2 * s.rx[2] +
                     w3 * s.rx[3];
    const float py = w0 * s.ry[0] + w1 * s.ry[1] + w2 * s.ry[2] +
                     w3 * s.ry[3];
    const float pz = w0 * s.rz[0] + w1 * s.rz[1] + w2 * s.rz[2] +
                     w3 * s.rz[3];
    const float pr = w0 * s.cr[0] + w1 * s.cr[1] + w2 * s.cr[2] +
                     w3 * s.cr[3];
    const float b0 = sm * sm, b1 = 2.0f * sm * un, b2 = un * un;
    const float dpx = 3.0f * (b0 * (s.rx[1] - s.rx[0]) +
                              b1 * (s.rx[2] - s.rx[1]) +
                              b2 * (s.rx[3] - s.rx[2]));
    const float dpy = 3.0f * (b0 * (s.ry[1] - s.ry[0]) +
                              b1 * (s.ry[2] - s.ry[1]) +
                              b2 * (s.ry[3] - s.ry[2]));
    const float dpz = 3.0f * (b0 * (s.rz[1] - s.rz[0]) +
                              b1 * (s.rz[2] - s.rz[1]) +
                              b2 * (s.rz[3] - s.rz[2]));
    const float dpr = 3.0f * (b0 * (s.cr[1] - s.cr[0]) +
                              b1 * (s.cr[2] - s.cr[1]) +
                              b2 * (s.cr[3] - s.cr[2]));
    const float ddx =
        6.0f * ((1.0f - un) * (s.rx[2] - 2.0f * s.rx[1] + s.rx[0]) +
                un * (s.rx[3] - 2.0f * s.rx[2] + s.rx[1]));
    const float ddy =
        6.0f * ((1.0f - un) * (s.ry[2] - 2.0f * s.ry[1] + s.ry[0]) +
                un * (s.ry[3] - 2.0f * s.ry[2] + s.ry[1]));
    const float ddz =
        6.0f * ((1.0f - un) * (s.rz[2] - 2.0f * s.rz[1] + s.rz[0]) +
                un * (s.rz[3] - 2.0f * s.rz[2] + s.rz[1]));
    const float rx = tn * dx - px, ry = tn * dy - py, rz = tn * dz - pz;
    const float len_r = sqrtf(jmax(rx * rx + ry * ry + rz * rz, 0.0f));
    const float q_err = kSweepErr * s.len_dir * tn;
    const float r_err = jmax(q_err, s.p_err);
    const float dp2 = dpx * dpx + dpy * dpy + dpz * dpz;
    const float rl = 1.0f / sqrtf(jmax(dp2, 1e-36f));
    const float tx = dpx * rl, ty = dpy * rl, tz = dpz * rl;
    const float dd = dpx * ddx + dpy * ddy + dpz * ddz;
    const float rl3 = rl * rl * rl;
    const float dtx = (ddx * dp2 - dpx * dd) * rl3;
    const float dty = (ddy * dp2 - dpy * dd) * rl3;
    const float dtz = (ddz * dp2 - dpz * dd) * rl3;
    const float cos_err = s.p_err * rl;
    const float fv = rx * tx + ry * ty + rz * tz;
    const float f_err = len_r * s.p_err + r_err + cos_err * (1.0f + len_r);
    const float dfdu =
        -dpx * tx - dpy * ty - dpz * tz + rx * dtx + ry * dty + rz * dtz;
    const float dfdt = dx * tx + dy * ty + dz * tz;
    const float k = jmax(rx * rx + ry * ry + rz * rz - fv * fv, 0.0f);
    const float dkdu = (-rx * dpx - ry * dpy - rz * dpz) - fv * dfdu;
    const float dkdt = (rx * dx + ry * dy + rz * dz) - fv * dfdt;
    const float rsk = 1.0f / sqrtf(jmax(k, 1e-36f));
    const float gv = sqrtf(k) - pr;
    // the g bound's last term, 16 ulp of the box, is p_err itself
    const float g_err = r_err + f_err + s.p_err;
    const float dgdu = dkdu * rsk - dpr;
    const float dgdt = dkdt * rsk;
    const float det = dfdu * dgdt - dfdt * dgdu;
    const float rdet = fabsf(det) > 1e-30f ? 1.0f / det : 0.0f;
    const float du = (dgdt * fv - dfdt * gv) * rdet;
    const float dt = (-dgdu * fv + dfdu * gv) * rdet;
    const bool conv = fabsf(fv) < f_err && fabsf(gv) < g_err;
    const float tw = tn + s.dtc;
    const bool okn =
        conv && r.tnear <= tw && tw <= tf && un >= 0.0f && un <= 1.0f;
    if (okn && !ok) t_out = tw;
    ok = ok || okn;
    if (!ok) {
      un = un - du;
      tn = tn - dt;
    }
  }
  return ok;
}

// The round curve of one slot, in two parts. cf holds its 16 fields (CP j
// at 4j..4j+3 = x, y, z, r). round_sweep gives the slot's Newton frame;
// round_cone tests cone segment i of n, between knots k0 and k1 (the round
// line's tangent cone without end spheres, recentred at the segment's
// midpoint), and gives its candidate, the front root if it lies in [tnear,
// tf], else the back one, as (u_i, t_i) for round_polish. The slot's t is
// the nearest polished root over its candidates; a segment without one is
// not polished (its result is masked out in Pallas). rcpdd: 1 / max(|d|^2,
// 1e-30).
TRAV_HD Sweep round_sweep(const float* cf, const Ray& r, float rcpdd) {
  const float dx = r.dx, dy = r.dy, dz = r.dz;
  Sweep s;
  const float cenx = 0.25f * (cf[0] + cf[4] + cf[8] + cf[12]);
  const float ceny = 0.25f * (cf[1] + cf[5] + cf[9] + cf[13]);
  const float cenz = 0.25f * (cf[2] + cf[6] + cf[10] + cf[14]);
  s.dtc = ((cenx - r.ox) * dx + (ceny - r.oy) * dy + (cenz - r.oz) * dz) *
          rcpdd;
  float bmax = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s.rx[j] = cf[4 * j] - (r.ox + s.dtc * dx);
    s.ry[j] = cf[4 * j + 1] - (r.oy + s.dtc * dy);
    s.rz[j] = cf[4 * j + 2] - (r.oz + s.dtc * dz);
    s.cr[j] = cf[4 * j + 3];
    bmax = jmax(bmax, fabsf(s.rx[j]));
    bmax = jmax(bmax, fabsf(s.ry[j]));
    bmax = jmax(bmax, fabsf(s.rz[j]));
    bmax = jmax(bmax, fabsf(s.cr[j]));
  }
  s.p_err = kSweepErr * bmax;
  s.len_dir = sqrtf(jmax(r.ddot, 1e-36f));
  return s;
}

TRAV_HD bool round_cone(const RoundKnot& k0, const RoundKnot& k1,
                        const Ray& r, float tf, float rcpdd, int i, int n,
                        float& u_i, float& t_i) {
  const float dx = r.dx, dy = r.dy, dz = r.dz, ddot = r.ddot;
  const float ccx = 0.5f * (k0.x + k1.x), ccy = 0.5f * (k0.y + k1.y),
              ccz = 0.5f * (k0.z + k1.z);
  const float dtl =
      ((ccx - r.ox) * dx + (ccy - r.oy) * dy + (ccz - r.oz) * dz) * rcpdd;
  const float o2x = r.ox + dtl * dx, o2y = r.oy + dtl * dy,
              o2z = r.oz + dtl * dz;
  const float dpx = k1.x - k0.x, dpy = k1.y - k0.y, dpz = k1.z - k0.z;
  const float dpdp = dpx * dpx + dpy * dpy + dpz * dpz;
  const float drr = k1.r - k0.r;
  const float r0dr = k0.r * drr;
  const float gco = dpdp - drr * drr;
  const float oxx = o2x - k0.x, oyy = o2y - k0.y, ozz = o2z - k0.z;
  const float odp = oxx * dpx + oyy * dpy + ozz * dpz;
  const float dodp = dx * dpx + dy * dpy + dz * dpz;
  const float ypc = odp + r0dr;
  const float oo = oxx * oxx + oyy * oyy + ozz * ozz;
  const float odo = dx * oxx + dy * oyy + dz * ozz;
  const float ac = gco * ddot - dodp * dodp;
  const float bc = 2.0f * (gco * odo - dodp * ypc);
  const float cc =
      gco * oo - odp * odp - k0.r * k0.r * dpdp - 2.0f * r0dr * odp;
  const float dc = bc * bc - 4.0f * ac * cc;
  const bool cone_ok = dc >= 0.0f && gco > 0.0f && fabsf(ac) > 1e-18f;
  const float qc = sqrtf(jmax(dc, 0.0f));
  const float rc2a = 1.0f / (cone_ok ? 2.0f * ac : 1.0f);
  const float tcf = (-bc - qc) * rc2a;
  const float tcb = (-bc + qc) * rc2a;
  const float ycf = ypc + tcf * dodp;
  const float ycb = ypc + tcb * dodp;
  const bool cf_ok = cone_ok && ycf > 0.0f && ycf <= gco;
  const bool cb_ok = cone_ok && ycb > 0.0f && ycb <= gco;
  const float tlo = cf_ok ? tcf : kBig;
  const float tup = cb_ok ? tcb : -kBig;
  const bool lo_ok = r.tnear <= dtl + tlo && dtl + tlo <= tf && tlo < kBig;
  const bool up_ok = r.tnear <= dtl + tup && dtl + tup <= tf && tup > -kBig;
  t_i = dtl + (lo_ok ? tlo : tup);
  const float y_i = lo_ok ? ycf : ycb;
  u_i = (static_cast<float>(i) +
         jmin(jmax(y_i / jmax(gco, 1e-30f), 0.0f), 1.0f)) /
        static_cast<float>(n);
  return lo_ok || up_ok;
}

// Slot test of one class by its tag (the mixed-class kernel). Tags outside
// the scene's classes stay invalid, as an unmatched tag does in Pallas.
// Curve slots (tags 8 and 9) never come here: their 16 fields take
// curve_item.
template <bool ROBUST>
TRAV_HD bool leaf_by_tag(int32_t tag, int32_t classes, const Slot& q,
                         const Ray& r, float tf, float& tt) {
  tt = 0.0f;
  if (tag < 0 || tag > 6 || !((classes >> tag) & 1)) return false;
  float uu, vv;
  switch (tag) {
    case 0:
      return ROBUST ? leaf_pluecker(q, r, tf, tt, uu, vv)
                    : leaf_moeller(q, r, tf, tt, uu, vv);
    case 2:
      return leaf_sphere(q, r, tf, tt);
    case 3:
      return leaf_disc(q, r, tf, tt);
    case 4:
      return leaf_oriented_disc(q, r, tf, tt);
    case 5:
      return leaf_round_line(q, r, tf, tt);
    case 6:
      return leaf_flat_line(q, r, tf, tt);
    default:
      return false;
  }
}

// ---- the per-ray state machine: the persistent warps on the card and
// the twin walk a ray through these functions, so each ray takes the same
// steps in each ----

// A ray's stack: entry k at base[k * STRIDE]. A local array (STRIDE 1) in
// the twin; a column of the block's shared memory (STRIDE = the block's
// threads, so lanes at any depths hit distinct banks) on the card.
template <int STRIDE>
struct Stack {
  int32_t* base;
  TRAV_HD int32_t& operator[](int k) const { return base[k * STRIDE]; }
};

// One ray between two steps.
struct RayState {
  Ray ray;
  float rdx, rdy, rdz;
  float rtime;             // MOTION
  float tf;                // t of the best hit so far, else tfar
  int32_t rmask;
  int32_t i;               // the ray's index
  int32_t best;            // 8 * leaf + slot of the best hit, else -1
  int32_t sp;              // stack depth (entries past kStack are dropped)
  int32_t cur;             // the record: node >= 0, leaf -1 - id
  int32_t n_node, n_leaf;  // records visited
  float a_u, a_v, a_nx, a_ny, a_nz;  // u, v, Ng of the best hit (WANT_ATTRS)
  bool live;               // false once the stack ran dry or a hit ended it
  bool overflow;           // the stack grew past kStack (must not happen)
};

template <bool HAS_MASK, bool MOTION>
TRAV_HD void start_ray(const Params& p, int i, RayState& st) {
  const float ox = p.org[3 * i], oy = p.org[3 * i + 1], oz = p.org[3 * i + 2];
  const float dx = p.dir[3 * i], dy = p.dir[3 * i + 1], dz = p.dir[3 * i + 2];
  st.rdx = rcp_safe(dx);
  st.rdy = rcp_safe(dy);
  st.rdz = rcp_safe(dz);
  const float tnear = p.tnear[i];
  st.ray = Ray{ox, oy, oz, dx, dy, dz, tnear, dx * dx + dy * dy + dz * dz};
  st.rmask = p.mask[i];
  st.rtime = MOTION ? p.time[i] : 0.0f;
  st.tf = p.tfar[i];
  st.i = i;
  st.best = -1;
  st.sp = 0;
  st.cur = 0;  // the root
  st.n_node = 0;
  st.n_leaf = 0;
  st.a_u = st.a_v = st.a_nx = st.a_ny = st.a_nz = 0.0f;
  // mask-free scenes fold the ray mask into activation
  st.live = tnear <= st.tf;
  if (!HAS_MASK) st.live = st.live && st.rmask != 0;
  st.overflow = false;
}

TRAV_HD bool ray_running(const RayState& st) {
  return st.live && st.n_node + st.n_leaf < kMaxSteps;
}

// One node: the 8-wide slab test on outward-rounded bf16 bounds, the hit
// children sorted by entry t, all but the nearest pushed farthest first (so
// the second nearest ends on top). Returns true when it descends into the
// nearest; false when no child was hit (the caller pops).
template <bool ROBUST, class STACK>
TRAV_HD bool node_step(const Params& p, RayState& st, STACK stack) {
  ++st.n_node;
  const float ox = st.ray.ox, oy = st.ray.oy, oz = st.ray.oz;
  const float tnear = st.ray.tnear, tf = st.tf;
  const int32_t* rec =
      p.nodes +
      static_cast<size_t>(clampi(st.cur, 0, p.n_nodes - 1)) * kNodeWords;
  int32_t w[kNodeWords];
#pragma unroll
  for (int q = 0; q < kNodeWords / 4; ++q) {
    I4 v = load4(rec + 4 * q);
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
  int32_t key[8], ref[8];
  int h = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float tx0 = (bf16_lo(w[8 + c]) - ox) * st.rdx;
    const float tx1 = (bf16_hi(w[8 + c]) - ox) * st.rdx;
    const float ty0 = (bf16_lo(w[16 + c]) - oy) * st.rdy;
    const float ty1 = (bf16_hi(w[16 + c]) - oy) * st.rdy;
    const float tz0 = (bf16_lo(w[24 + c]) - oz) * st.rdz;
    const float tz1 = (bf16_hi(w[24 + c]) - oz) * st.rdz;
    float tent, tex;
    if (ROBUST) {
      // +-3-ulp widened slabs; tnear and tf stay unscaled
      tent = jmax(jmax(jmin(tx0, tx1) * kRobustDown,
                       jmin(ty0, ty1) * kRobustDown),
                  jmax(jmin(tz0, tz1) * kRobustDown, tnear));
      tex = jmin(jmin(jmax(tx0, tx1) * kRobustUp, jmax(ty0, ty1) * kRobustUp),
                 jmin(jmax(tz0, tz1) * kRobustUp, tf));
    } else {
      tent = jmax(jmax(jmin(tx0, tx1), jmin(ty0, ty1)),
                  jmax(jmin(tz0, tz1), tnear));
      tex = jmin(jmin(jmax(tx0, tx1), jmax(ty0, ty1)),
                 jmin(jmax(tz0, tz1), tf));
    }
    const bool hit = tent <= tex && w[c] != kInvalidRec;
    const int32_t kd = as_int(jmax(tent, 0.0f));
    key[c] = hit ? ((kd & ~7) | c) : (kInfBits | c);
    ref[c] = w[c];
    h += hit ? 1 : 0;
  }
  sort8(key, ref);
#pragma unroll
  for (int j = 7; j >= 1; --j) {
    if (j < h) {
      if (st.sp < kStack) stack[st.sp] = ref[j];
      ++st.sp;
    }
  }
  if (st.sp > kStack) st.overflow = true;
  if (h > 0) {
    st.cur = ref[0];
    return true;
  }
  return false;
}

// The next record from the stack (a dropped entry reads as the root), or
// the end of the ray when it is empty.
template <class STACK>
TRAV_HD void pop(RayState& st, STACK stack) {
  if (st.sp > 0) {
    --st.sp;
    st.cur = st.sp < kStack ? stack[st.sp] : 0;
  } else {
    st.live = false;
  }
}

// B6: the fields of G slots of a moving leaf, from slot g on, lerped by
// each slot's weight, a + w * (b - a): the weight is the ray time or, when
// the records carry windows, the clipped window-local time, and win_ok
// tells whether the ray time lies in the slot's window (both ends
// inclusive). Field k of slot s is word 8k + s of step A's block and word
// kLeafFields + 8k + s of step B's, so G = 4 reads each field of the group
// with one 16-byte load.
template <int G>
TRAV_HD void load_words(const int32_t* w, int32_t* out) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int j = 0; j < G; j += 4) {
      const I4 v = load4(w + j);
      out[j] = v.x;
      out[j + 1] = v.y;
      out[j + 2] = v.z;
      out[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) out[j] = load1(w + j);
  }
}

template <int G>
TRAV_HD void lerp_group(const Params& p, const int32_t* rec, int win_at,
                        int g, float rtime, float (*q)[G], bool* win_ok) {
  float w[G];
  if (p.has_win) {
    int32_t t0[G], t1[G];
    load_words<G>(rec + win_at + g, t0);
    load_words<G>(rec + win_at + 8 + g, t1);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float a = as_float(t0[j]), b = as_float(t1[j]);
      w[j] = jmin(jmax((rtime - a) / jmax(b - a, kMinWindow), 0.0f), 1.0f);
      win_ok[j] = rtime >= a && rtime <= b;
    }
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      w[j] = rtime;
      win_ok[j] = true;
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    int32_t a[G], b[G];
    load_words<G>(rec + 8 * k + g, a);
    load_words<G>(rec + kLeafFields + 8 * k + g, b);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float fa = as_float(a[j]);
      q[k][j] = fa + w[j] * (as_float(b[j]) - fa);
    }
  }
}

template <int G>
TRAV_HD Slot group_slot(const float (*q)[G], int j) {
  return Slot{q[0][j], q[1][j], q[2][j], q[3][j], q[4][j],
              q[5][j], q[6][j], q[7][j], q[8][j]};
}

// B6: the slots of one moving leaf of 9-field slots, into the leaf's best
// key, kSlotGroup slots at a time: no other slot's fields are live while a
// group is tested. Closest + attrs recomputes the winner's u, v and Ng
// afterwards (motion_attrs).
constexpr int kSlotGroup = 4;

template <bool HAS_MASK, bool ROBUST, bool KINDS>
TRAV_HD void motion_leaf(const Params& p, const int32_t* rec,
                         const RayState& st, int32_t& best_key,
                         int32_t& best_tb) {
  constexpr int G = kSlotGroup;
  constexpr int mask_at = 2 * kLeafFields;
  constexpr int kind_at = mask_at + (HAS_MASK ? 8 : 0);
  constexpr int win_at = kind_at + (KINDS ? 8 : 0);
#pragma unroll 1
  for (int g = 0; g < 8; g += G) {
    float q[9][G];
    bool win_ok[G];
    lerp_group<G>(p, rec, win_at, g, st.rtime, q, win_ok);
    int32_t tag[G], smask[G];
    if (KINDS) load_words<G>(rec + kind_at + g, tag);
    if (HAS_MASK) load_words<G>(rec + mask_at + g, smask);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const Slot sq = group_slot<G>(q, j);
      float tt, uu, vv;
      bool valid;
      if (KINDS) {
        valid = leaf_by_tag<ROBUST>(tag[j], p.kind_classes, sq, st.ray, st.tf,
                                    tt);
      } else if (ROBUST) {
        valid = leaf_pluecker(sq, st.ray, st.tf, tt, uu, vv);
      } else {
        valid = leaf_moeller(sq, st.ray, st.tf, tt, uu, vv);
      }
      valid = valid && win_ok[j];
      if (HAS_MASK) valid = valid && (smask[j] & st.rmask) != 0;
      const int32_t tb = as_int(jmax(tt, 0.0f));
      const int32_t k = valid ? ((tb & ~7) | (g + j)) : (kInfBits | (g + j));
      if (k < best_key) {
        best_key = k;
        best_tb = tb;
      }
    }
  }
}

// B6 closest + attrs: u, v and Ng of the winning slot sl, from its lerped
// fields by the expressions of its test, so the same bits as if they had
// been kept through the slot loop.
template <bool HAS_MASK, bool ROBUST>
TRAV_HD void motion_attrs(const Params& p, const int32_t* rec, int sl,
                          RayState& st) {
  constexpr int win_at = 2 * kLeafFields + (HAS_MASK ? 8 : 0);
  float q[9][1];
  bool win_ok;
  lerp_group<1>(p, rec, win_at, sl, st.rtime, q, &win_ok);
  const Slot sq = group_slot<1>(q, 0);
  float tt;
  if (ROBUST) {
    leaf_pluecker(sq, st.ray, st.tf, tt, st.a_u, st.a_v);
  } else {
    leaf_moeller(sq, st.ray, st.tf, tt, st.a_u, st.a_v);
  }
  st.a_nx = sq.f4 * sq.f8 - sq.f5 * sq.f7;
  st.a_ny = sq.f5 * sq.f6 - sq.f3 * sq.f8;
  st.a_nz = sq.f3 * sq.f7 - sq.f4 * sq.f6;
}

// B1 and B2 closest + attrs under the scheduler: u, v and Ng of the
// winning slot sl of a static leaf, from its 9 words by the expressions of
// its test (Moeller, or Pluecker when ROBUST), so the same bits as if they
// had been kept through the slot loop.
template <bool ROBUST>
TRAV_HD void static_attrs(const int32_t* rec, int sl, RayState& st) {
  float f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = as_float(load1(rec + 8 * k + sl));
  const Slot sq{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
  float tt;
  if (ROBUST) {
    leaf_pluecker(sq, st.ray, st.tf, tt, st.a_u, st.a_v);
  } else {
    leaf_moeller(sq, st.ray, st.tf, tt, st.a_u, st.a_v);
  }
  st.a_nx = sq.f4 * sq.f8 - sq.f5 * sq.f7;
  st.a_ny = sq.f5 * sq.f6 - sq.f3 * sq.f8;
  st.a_nz = sq.f3 * sq.f7 - sq.f4 * sq.f6;
}

// One moving leaf (B6): the 8 slots' tests, each slot's fields lerped by
// the ray time (p.has_win: per-slot windows, a uniform branch), kSlotGroup
// slots at a time (motion_leaf), the best slot key, and the winner
// accepted only if its exact (clamped) t is strictly nearer than the best
// so far. Returns true when the hit ends the ray (OCCLUSION).
// ROBUST: B2's leaf. KINDS: per-slot kind tags after the mask words, one
// class test per slot (B3-B5); without it every slot is a triangle. Static
// B1-B5 (static_pass) and curve scenes (B7, B8: curve_pass) deal their
// leaves across the warp instead.
template <bool OCCLUSION, bool WANT_ATTRS, bool HAS_MASK, bool ROBUST,
          bool KINDS>
TRAV_HD bool leaf_step(const Params& p, RayState& st) {
  static_assert(!(KINDS && WANT_ATTRS), "kernel attrs are triangle-only");
  ++st.n_leaf;
  const int32_t lid = -st.cur - 1;
  const int32_t* rec =
      p.leaves +
      static_cast<size_t>(clampi(lid, 0, p.n_leaves - 1)) * p.leaf_stride;
  int32_t best_key = 0x7FFFFFFF, best_tb = 0;
  motion_leaf<HAS_MASK, ROBUST, KINDS>(p, rec, st, best_key, best_tb);
  const float t_new = as_float(best_tb);
  if (best_key < kInfBits && t_new < st.tf) {
    st.tf = t_new;
    st.best = lid * 8 + (best_key & 7);
    if constexpr (WANT_ATTRS) {
      motion_attrs<HAS_MASK, ROBUST>(p, rec, best_key & 7, st);
    }
    if (OCCLUSION) {
      st.live = false;
      return true;
    }
  }
  return false;
}

// Write ray st.i's outputs; returns whether its stack overflowed.
template <bool WANT_ATTRS>
TRAV_HD bool finish_ray(const Params& p, const RayState& st) {
  const int i = st.i;
  p.out_t[i] = st.tf;
  p.out_best[i] = st.best;
  p.out_visits[i] = st.n_node;
  p.out_visits[p.n_rays + i] = st.n_leaf;
  if (WANT_ATTRS) {
    p.out_attr[i] = st.a_u;
    p.out_attr[p.n_rays + i] = st.a_v;
    p.out_attr[2 * p.n_rays + i] = st.a_nx;
    p.out_attr[3 * p.n_rays + i] = st.a_ny;
    p.out_attr[4 * p.n_rays + i] = st.a_nz;
  }
  return st.overflow;
}

// ---- persistent warps that refill finished lanes (B1-B8) ----
//
// Each warp loops until the rays run out. A lane whose ray is done writes
// its outputs and goes idle; once kRefillLanes lanes are idle, the warp
// takes that many ray indices at once from a global counter, in index
// order (the wrapper's coherence order), so a refill's rays are
// neighbours. Leaves are postponed: each pass runs either the lanes at
// nodes or the lanes at leaves, the leaves only once kLeafLanes lanes wait
// at one (or none is left at a node), so the longest code runs converged.
// Curve scenes take constants of their own (kCurveRefillLanes,
// kCurveLeafLanes) and a leaf pass of their own (curve_pass), and so do
// static B1-B5 (kStaticRefillLanes, kStaticLeafLanes, static_pass).
// WARP is the lane bookkeeping: CUDA intrinsics on the card (launch.cuh),
// 32 emulated lanes in the twin (traverse_cpu.cpp). It provides kLanes
// (lanes one thread holds), each(f) (f(slot, lane) for each of them),
// ballot(pred) (bit lane set where pred(slot)), take(counter, idle) (the
// first of popc(idle) new indices, one fetch-add for the warp), stack(slot),
// overflow(counter), add_counts(counts, passes, steps, finished), and for
// the leaf passes that deal items add_leaf_counts(counts, leaf passes,
// leaf steps, rounds),
// scratch() (the warp's scratch words), sync() (its lanes' scratch writes
// seen by all its lanes) and atomic_min(word, value).
constexpr int kRefillLanes = 8;   // idle lanes before a warp refills
constexpr int kLeafLanes = 8;     // lanes at leaves before they run

TRAV_HD int popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// the lanes of m below lane
TRAV_HD int rank(uint32_t m, int lane) {
  return popc(m & ((1u << lane) - 1u));
}

// ---- B7, B8: the curve variants' leaf pass ----
//
// The (waiting lane, slot) items of a leaf pass are dealt across the
// warp, 32 per round (4 leaves of 8 slots), so that the 8 lanes of one
// leaf read each field as one 32-byte sector (field k of slot s is word
// 8k + s). An item reads its ray's constants from the warp's scratch,
// where the waiting lanes publish them by rank with their curve frames
// (once per ray), reads its slot's words and lerps them by the slot's
// weight (MOTION), and runs the ribbon for a flat curve slot, the class
// test on the first 9 fields for any other, or, for a round slot (ROUND),
// the cone stage, segment by segment in step across the warp. Its
// candidates go to a ring in the scratch, which the warp polishes 32 at a
// time. A slot that the mask chunk or its window rejects is not tested:
// its key is invalid whatever the test gives. Each waiting lane then takes
// the least of its 8 slot keys in slot order with a strict <, the slot
// loop's own result: the keys are distinct (the slot rides in the low 3
// bits), tf does not change inside a leaf, and the t bits go with the key.
// A round slot's t is the least of its polished roots; each lies in
// [tnear, tf], so none is NaN and the least does not depend on the order
// of the polishes. The knot weights are read from the block's shared
// memory on the card (launch.cuh). The constants come from
// perf/sched_sweep.py on the hair cells: refill 1 and 8 leaf lanes beat
// (8, 4) by 3-5% (PERF.md also times the forms this design replaced: each
// lane its own ray's 8 slots, each candidate polished at once by its own
// lane).
constexpr int kCurveRefillLanes = 1;  // idle lanes before a warp refills
constexpr int kCurveLeafLanes = 8;    // lanes at leaves before they run

// A warp's scratch words (shared memory on the card), each row 32 wide:
// the waiting rays by rank (kRayWords rows: ox, oy, oz, dx, dy, dz, tnear,
// tf, rmask, rtime, leaf id) and their curve frames (kFrameWords rows, in
// scenes with flat curves); then either the items' keys and t bits after
// a round (2 rows) or, in scenes with round curves, the candidate ring
// (kQueue entries of item lane, u, t; the keys alias its start), each
// round item's Newton frame but len_dir (kSweepWords rows) and its least
// polished root as an ordered int (1 row).
constexpr int kRayWords = 11;
constexpr int kFrameWords = 10;
constexpr int kSweepWords = 18;
constexpr int kQueue = 64;              // holds 31 waiting + 32 pushed
constexpr int32_t kNoRoot = 0x7FFFFFFF;  // above every ordered float

struct CurveScratch {
  int32_t *ray, *frame, *key, *queue, *sweep, *root;
};

TRAV_HD bool has_class(int32_t classes, int tag) {
  return ((classes >> tag) & 1) != 0;
}

TRAV_HD int curve_scratch_words(int32_t classes) {
  return 32 * (kRayWords + (has_class(classes, kTagCurve) ? kFrameWords : 0)) +
         (has_class(classes, kTagRound) ? 3 * kQueue + 32 * (kSweepWords + 1)
                                        : 2 * 32);
}

TRAV_HD CurveScratch curve_scratch(int32_t* w, int32_t classes) {
  CurveScratch c;
  c.ray = w;
  w += 32 * kRayWords;
  c.frame = w;
  if (has_class(classes, kTagCurve)) w += 32 * kFrameWords;
  c.key = c.queue = w;
  w += has_class(classes, kTagRound) ? 3 * kQueue : 2 * 32;
  c.sweep = w;
  c.root = w + 32 * kSweepWords;
  return c;
}

// The knot-weight words of a curve scene at `rate` (curve_weights in
// accel/traverse.py): the ribbon's rate + 1 knots of 7, then the round
// curve's max(rate, 8) + 1 knots of 4.
TRAV_HD int curve_weight_words(int rate) {
  return kKnotWeights * (rate + 1) +
         kRoundWeights * ((rate > kRoundMinRate ? rate : kRoundMinRate) + 1);
}

// float <-> int32 in jmin's order of non-NaN values (-0 below +0)
TRAV_HD int32_t ordered(float f) {
  const int32_t b = as_int(f);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}

TRAV_HD float from_ordered(int32_t o) {
  return as_float(o >= 0 ? o : o ^ 0x7FFFFFFF);
}

// A waiting ray's constants as its items read them.
struct ItemRay {
  Ray ray;
  float tf, rtime;
  int32_t rmask, lid;
};

TRAV_HD void put_ray(const CurveScratch& c, int q, const RayState& s,
                     bool frame) {
  int32_t* r = c.ray + q;
  r[0] = as_int(s.ray.ox);
  r[32] = as_int(s.ray.oy);
  r[64] = as_int(s.ray.oz);
  r[96] = as_int(s.ray.dx);
  r[128] = as_int(s.ray.dy);
  r[160] = as_int(s.ray.dz);
  r[192] = as_int(s.ray.tnear);
  r[224] = as_int(s.tf);
  r[256] = s.rmask;
  r[288] = as_int(s.rtime);
  r[320] = -s.cur - 1;
  if (frame) {
    const CurveFrame fr = curve_frame(s.ray.dx, s.ray.dy, s.ray.dz);
    const float v[kFrameWords] = {fr.vx0, fr.vx1, fr.vx2, fr.vy0, fr.vy1,
                                  fr.vy2, fr.vz0, fr.vz1, fr.vz2, fr.ds};
#pragma unroll
    for (int k = 0; k < kFrameWords; ++k) c.frame[32 * k + q] = as_int(v[k]);
  }
}

// |d|^2 as start_ray computes it, so the same bits
TRAV_HD ItemRay get_ray(const CurveScratch& c, int q) {
  const int32_t* r = c.ray + q;
  const float dx = as_float(r[96]), dy = as_float(r[128]),
              dz = as_float(r[160]);
  ItemRay o;
  o.ray = Ray{as_float(r[0]), as_float(r[32]), as_float(r[64]), dx, dy, dz,
              as_float(r[192]), dx * dx + dy * dy + dz * dz};
  o.tf = as_float(r[224]);
  o.rmask = r[256];
  o.rtime = as_float(r[288]);
  o.lid = r[320];
  return o;
}

TRAV_HD CurveFrame get_frame(const CurveScratch& c, int q) {
  const int32_t* f = c.frame + q;
  return CurveFrame{as_float(f[0]),   as_float(f[32]),  as_float(f[64]),
                    as_float(f[96]),  as_float(f[128]), as_float(f[160]),
                    as_float(f[192]), as_float(f[224]), as_float(f[256]),
                    as_float(f[288])};
}

TRAV_HD void put_sweep(int32_t* w, const Sweep& s) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[32 * j] = as_int(s.rx[j]);
    w[32 * (4 + j)] = as_int(s.ry[j]);
    w[32 * (8 + j)] = as_int(s.rz[j]);
    w[32 * (12 + j)] = as_int(s.cr[j]);
  }
  w[32 * 16] = as_int(s.dtc);
  w[32 * 17] = as_int(s.p_err);
}

// len_dir as round_sweep computes it, from |d|^2
TRAV_HD Sweep get_sweep(const int32_t* w, float ddot) {
  Sweep s;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s.rx[j] = as_float(w[32 * j]);
    s.ry[j] = as_float(w[32 * (4 + j)]);
    s.rz[j] = as_float(w[32 * (8 + j)]);
    s.cr[j] = as_float(w[32 * (12 + j)]);
  }
  s.dtc = as_float(w[32 * 16]);
  s.p_err = as_float(w[32 * 17]);
  s.len_dir = sqrtf(jmax(ddot, 1e-36f));
  return s;
}

// The item of `lane` in round r of a leaf pass over n waiting lanes: its
// ray's rank q and its slot s; false for a lane without one.
TRAV_HD bool item_of(int n, int r, int lane, int& q, int& s) {
  const int j = 32 * r + lane;
  q = j >> 3;
  s = j & 7;
  return j < 8 * n;
}

// The rank q of the ray of item lane `item` in round r (item_of's q).
TRAV_HD int item_rank(int r, int item) { return 4 * r + (item >> 3); }

// N fields of slot s of a curve leaf record (field k is word 8k + s), each
// lerped by the slot's weight w to step B's block (MOTION).
template <bool MOTION, int N>
TRAV_HD void slot_words(const int32_t* rec, int s, float w, float* f) {
  constexpr int kBlk = kCurveFields * 8;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    f[k] = as_float(load1(rec + 8 * k + s));
    if (MOTION) {
      f[k] = f[k] + w * (as_float(load1(rec + kBlk + 8 * k + s)) - f[k]);
    }
  }
}

TRAV_HD void slot_key(bool valid, float tt, int s, int32_t& key,
                      int32_t& tb) {
  tb = as_int(jmax(tt, 0.0f));
  key = valid ? ((tb & ~7) | s) : (kInfBits | s);
}

// One item: slot s of the leaf of ray r (rank q), into its key and t bits.
// A round slot (ROUND) instead leaves its lerped fields in cf, stages its
// Newton frame at sweep and returns true: its key follows its polishes.
template <bool HAS_MASK, bool ROBUST, bool MOTION, bool ROUND>
TRAV_HD bool curve_item(const Params& p, const CurveScratch& c,
                        const ItemRay& r, int q, int s, const float* wt,
                        float* cf, int32_t* sweep, int32_t& key,
                        int32_t& tb) {
  constexpr int mask_at = kCurveFields * 8 * (MOTION ? 2 : 1);
  constexpr int kind_at = mask_at + (HAS_MASK ? 8 : 0);
  constexpr int win_at = kind_at + 8;
  const int32_t* rec =
      p.leaves +
      static_cast<size_t>(clampi(r.lid, 0, p.n_leaves - 1)) * p.leaf_stride;
  const int32_t tag = load1(rec + kind_at + s);
  float w = r.rtime;
  bool live = true;
  if (MOTION && p.has_win) {
    const float t0 = as_float(load1(rec + win_at + s));
    const float t1 = as_float(load1(rec + win_at + 8 + s));
    w = jmin(jmax((r.rtime - t0) / jmax(t1 - t0, kMinWindow), 0.0f), 1.0f);
    live = r.rtime >= t0 && r.rtime <= t1;
  }
  if (HAS_MASK) live = live && (load1(rec + mask_at + s) & r.rmask) != 0;
  float tt = 0.0f;
  bool valid = false;
  if (live) {
    if ((tag == kTagCurve || (ROUND && tag == kTagRound)) &&
        has_class(p.kind_classes, tag)) {
      slot_words<MOTION, kCurveFields>(rec, s, w, cf);
      if (ROUND && tag == kTagRound) {
        put_sweep(sweep, round_sweep(cf, r.ray, 1.0f / jmax(r.ray.ddot,
                                                             1e-30f)));
        return true;
      }
      valid = leaf_ribbon(cf, r.ray, get_frame(c, q), r.tf, p.curve_rate, wt,
                          tt);
    } else {
      float f[9];
      slot_words<MOTION, 9>(rec, s, w, f);
      const Slot sl{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
      valid = leaf_by_tag<ROBUST>(tag, p.kind_classes, sl, r.ray, r.tf, tt);
    }
  }
  slot_key(valid, tt, s, key, tb);
  return false;
}

// B8 in round r of a leaf pass: the cone stage
// of the round items (pend, their ray ranks q and slots s, their lerped
// fields cf), segment by segment in step across the warp, their candidates
// polished, then their keys. A lane reads only its own entries of these
// arrays (on the card it holds no other); the polisher of another lane's
// item finds its ray by item_rank.
template <class WARP>
TRAV_HD void round_stage(const Params& p, const WARP& w, const CurveScratch& c,
                         int r, const float* wt, const bool* pend,
                         const int* q, const int* s,
                         float (*cf)[kCurveFields], int32_t* key,
                         int32_t* tb) {
  constexpr int L = WARP::kLanes;
  if (w.ballot([&](int l) { return pend[l]; }) == 0) return;
  const int n_seg =
      p.curve_rate > kRoundMinRate ? p.curve_rate : kRoundMinRate;
  const float* w_round = wt + kKnotWeights * (p.curve_rate + 1);
  RoundKnot k0[L];
  w.each([&](int l, int lane) {
    if (!pend[l]) return;
    k0[l] = round_knot(w_round, cf[l]);
    c.root[lane] = kNoRoot;
  });
  // polish entries [head, head + m) of the ring, one per lane
  int head = 0, count = 0;
  auto polish = [&](int m) {
    w.sync();
    w.each([&](int, int lane) {
      if (lane >= m) return;
      const int at = (head + lane) & (kQueue - 1);
      const int item = c.queue[at];
      const ItemRay ir = get_ray(c, item_rank(r, item));
      float tp;
      if (round_polish(get_sweep(c.sweep + item, ir.ray.ddot), ir.ray, ir.tf,
                       as_float(c.queue[kQueue + at]),
                       as_float(c.queue[2 * kQueue + at]), tp)) {
        w.atomic_min(c.root + item, ordered(tp));
      }
    });
    w.sync();
    head = (head + m) & (kQueue - 1);
    count -= m;
  };
  for (int i = 0; i < n_seg; ++i) {
    bool cand[L];
    float u[L], t[L];
    w.each([&](int l, int lane) {
      cand[l] = false;
      if (!pend[l]) return;
      const ItemRay ir = get_ray(c, q[l]);
      const float rcpdd = 1.0f / jmax(ir.ray.ddot, 1e-30f);
      const RoundKnot k1 =
          round_knot(w_round + kRoundWeights * (i + 1), cf[l]);
      cand[l] = round_cone(k0[l], k1, ir.ray, ir.tf, rcpdd, i, n_seg, u[l],
                           t[l]);
      k0[l] = k1;
    });
    const uint32_t b = w.ballot([&](int l) { return cand[l]; });
    w.each([&](int l, int lane) {
      if (!cand[l]) return;
      const int at = (head + count + rank(b, lane)) & (kQueue - 1);
      c.queue[at] = lane;
      c.queue[kQueue + at] = as_int(u[l]);
      c.queue[2 * kQueue + at] = as_int(t[l]);
    });
    count += popc(b);
    if (count >= 32) polish(32);
  }
  if (count > 0) polish(count);
  w.sync();
  w.each([&](int l, int lane) {
    if (!pend[l]) return;
    const int32_t o = c.root[lane];
    slot_key(o != kNoRoot, o != kNoRoot ? from_ordered(o) : as_float(kInfBits),
             s[l], key[l], tb[l]);
  });
}

// One leaf pass over the waiting lanes go: each one's least slot key and
// its t bits, into best_key and best_tb; rounds counts the item rounds.
template <class WARP, bool HAS_MASK, bool ROBUST, bool MOTION, bool ROUND>
TRAV_HD void curve_pass(const Params& p, const WARP& w, const RayState* st,
                        uint32_t go, const float* wt, int32_t* best_key,
                        int32_t* best_tb, uint32_t& rounds) {
  constexpr int L = WARP::kLanes;
  const CurveScratch c = curve_scratch(w.scratch(), p.kind_classes);
  const bool frame = has_class(p.kind_classes, kTagCurve);
  const int n = popc(go);
  w.each([&](int l, int lane) {
    if (!((go >> lane) & 1u)) return;
    put_ray(c, rank(go, lane), st[l], frame);
    best_key[l] = 0x7FFFFFFF;
    best_tb[l] = 0;
  });
  w.sync();
  const int n_rounds = (n + 3) / 4;
  rounds += n_rounds;
  for (int r = 0; r < n_rounds; ++r) {
    int32_t key[L], tb[L];
    int q[L], s[L];
    bool pend[L];
    float cf[L][kCurveFields];
    w.each([&](int l, int lane) {
      key[l] = tb[l] = 0;
      pend[l] = item_of(n, r, lane, q[l], s[l]) &&
                curve_item<HAS_MASK, ROBUST, MOTION, ROUND>(
                    p, c, get_ray(c, q[l]), q[l], s[l], wt, cf[l],
                    c.sweep + lane, key[l], tb[l]);
    });
    if constexpr (ROUND) {
      round_stage(p, w, c, r, wt, pend, q, s, cf, key, tb);
    }
    w.each([&](int l, int lane) {
      c.key[lane] = key[l];
      c.key[32 + lane] = tb[l];
    });
    w.sync();
    w.each([&](int l, int lane) {
      if (!((go >> lane) & 1u)) return;
      const int qo = rank(go, lane);
      if ((qo >> 2) != r) return;
      const int first = 8 * (qo & 3);
      for (int k = 0; k < 8; ++k) {
        const int32_t kk = c.key[first + k];
        if (kk < best_key[l]) {
          best_key[l] = kk;
          best_tb[l] = c.key[32 + first + k];
        }
      }
    });
    w.sync();
  }
}

// ---- B1-B5: the static variants' leaf pass ----
//
// The static triangles (B1), robust triangles (B2) and mixed classes (B3-B5)
// run the persistent warps with constants of their own (kStaticRefillLanes,
// kStaticLeafLanes) and a leaf pass of their own: the waiting lanes' (ray,
// slot) items dealt across the warp, 4 leaves per round of 32, as in
// curve_pass, with the same scratch rows (a scene without curves has no frame
// rows). An item reads its ray's constants from the warp's scratch and its
// slot's 9 words (field k of slot s is word 8k + s, so the 8 lanes of a leaf
// read each field as one 32-byte sector), and runs its slot's class test (a
// triangle's Moeller test, or Pluecker's when robust); a slot that the mask
// chunk rejects is not tested and keeps the invalid key kInfBits | s, as the
// slot loop's own mask test gives it. Each waiting lane then takes the least of
// its 8 slot keys in slot order with a strict <, the slot loop's own result.
// B1's and B2's closest + attrs recompute the winner's u, v and Ng afterwards
// (static_attrs). perf/sched_sweep.py on the mixed cell and the robust sphere
// chose this form and the constants: on an H100, (refill 4, leaf lanes 4) beat
// (8, 8) by 1.8-5.0% in all five variants, and the forms it beat ran 1.11-1.65x
// as long: each lane its own ray's leaf, kSlotGroup slots per 16-byte load
// (more registers, divergent classes); only the items that the mask chunk and
// the scene's classes let through, listed by rank, and that list grouped by
// kind tag (the list's scratch left 4 blocks per SM instead of 5, and building
// it cost more than the tests it saved). On the main sphere, as is and masked,
// B1 keeps them: no other pair beat (4, 4) by 3% in all six variants, and each
// lane its own ray's whole leaf in registers (B1's old slot loop, 118-128
// registers, 16 warps per SM) ran 1.22-1.31x as long. PERF.md has the times.
constexpr int kStaticRefillLanes = 4;  // idle lanes before a warp refills
constexpr int kStaticLeafLanes = 4;    // lanes at leaves before they run

TRAV_HD const int32_t* leaf_record(const Params& p, int32_t lid) {
  return p.leaves +
         static_cast<size_t>(clampi(lid, 0, p.n_leaves - 1)) * p.leaf_stride;
}

// One item: slot s of the static leaf of ray r (rank q), into its key and
// t bits.
template <bool HAS_MASK, bool ROBUST, bool KINDS>
TRAV_HD void static_item(const Params& p, const ItemRay& r, int s,
                         int32_t& key, int32_t& tb) {
  constexpr int mask_at = kLeafFields;
  constexpr int kind_at = mask_at + (HAS_MASK ? 8 : 0);
  const int32_t* rec = leaf_record(p, r.lid);
  float tt = 0.0f;
  bool valid = false;
  if (!HAS_MASK || (load1(rec + mask_at + s) & r.rmask) != 0) {
    float f[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = as_float(load1(rec + 8 * k + s));
    const Slot q{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
    if (KINDS) {
      valid = leaf_by_tag<ROBUST>(load1(rec + kind_at + s), p.kind_classes,
                                  q, r.ray, r.tf, tt);
    } else {
      float uu, vv;
      valid = ROBUST ? leaf_pluecker(q, r.ray, r.tf, tt, uu, vv)
                     : leaf_moeller(q, r.ray, r.tf, tt, uu, vv);
    }
  }
  slot_key(valid, tt, s, key, tb);
}

// One leaf pass of B1-B5 over the waiting lanes go: each one's least slot
// key and its t bits, into best_key and best_tb; rounds counts the item
// rounds.
template <class WARP, bool HAS_MASK, bool ROBUST, bool KINDS>
TRAV_HD void static_pass(const Params& p, const WARP& w, const RayState* st,
                         uint32_t go, int32_t* best_key, int32_t* best_tb,
                         uint32_t& rounds) {
  constexpr int L = WARP::kLanes;
  const CurveScratch c = curve_scratch(w.scratch(), p.kind_classes);
  const int n = popc(go);
  w.each([&](int l, int lane) {
    if (!((go >> lane) & 1u)) return;
    put_ray(c, rank(go, lane), st[l], false);
    best_key[l] = 0x7FFFFFFF;
    best_tb[l] = 0;
  });
  w.sync();
  const int n_rounds = (n + 3) / 4;
  rounds += n_rounds;
  for (int r = 0; r < n_rounds; ++r) {
    int32_t key[L], tb[L];
    w.each([&](int l, int lane) {
      int q, s;
      key[l] = tb[l] = 0;
      if (item_of(n, r, lane, q, s)) {
        static_item<HAS_MASK, ROBUST, KINDS>(p, get_ray(c, q), s, key[l],
                                             tb[l]);
      }
      c.key[lane] = key[l];
      c.key[32 + lane] = tb[l];
    });
    w.sync();
    w.each([&](int l, int lane) {
      if (!((go >> lane) & 1u)) return;
      const int qo = rank(go, lane);
      if ((qo >> 2) != r) return;
      const int first = 8 * (qo & 3);
      for (int k = 0; k < 8; ++k) {
        const int32_t kk = c.key[first + k];
        if (kk < best_key[l]) {
          best_key[l] = kk;
          best_tb[l] = c.key[32 + first + k];
        }
      }
    });
    w.sync();
  }
}

// Take a leaf's best key if its t is strictly nearer than the ray's best
// so far; returns true when the hit ends the ray (OCCLUSION). leaf_step's
// acceptance, where closest + attrs (static B1, B2) recomputes the
// winner's u, v and Ng (static_attrs).
template <bool OCCLUSION, bool WANT_ATTRS, bool ROBUST>
TRAV_HD bool take_leaf_hit(const Params& p, RayState& st, int32_t key,
                           int32_t tb) {
  const int32_t lid = -st.cur - 1;
  const float t_new = as_float(tb);
  if (key < kInfBits && t_new < st.tf) {
    st.tf = t_new;
    st.best = lid * 8 + (key & 7);
    if (WANT_ATTRS) static_attrs<ROBUST>(leaf_record(p, lid), key & 7, st);
    if (OCCLUSION) {
      st.live = false;
      return true;
    }
  }
  return false;
}

// counts (int64, per launch): [0] lane slots (warp passes x 32), [1] lane
// steps that did work, [2] rays finished; curve scenes and the static
// variants also [4] lane slots of leaf passes, [5] lane steps of leaf
// passes, [6] item rounds x 32;
// out_overflow: rays whose stack overflowed. A warp keeps its counts in 32
// bits (64-bit ones cost ptxas a spill) and adds them to counts at its end,
// or every kFlushPasses passes, before they could wrap.
constexpr uint32_t kFlushPasses = 1u << 26;

// The persistent warps of the moving variants (B6: MOTION, scenes without
// curves), of the curve variants (B7, B8: CURVES, static or moving) and of
// the static triangles, robust triangles and mixed classes (B1-B5); wt:
// the knot weights (CURVES).
template <class WARP, bool OCCLUSION, bool WANT_ATTRS, bool HAS_MASK,
          bool ROBUST, bool KINDS, bool MOTION, bool CURVES, bool ROUND>
TRAV_HD void run_warp(const Params& p, const WARP& w, int32_t* next_ray,
                      int32_t* out_overflow, unsigned long long* counts,
                      const float* wt) {
  static_assert(!CURVES || (KINDS && !WANT_ATTRS),
                "curve scenes carry kind tags and no kernel attrs");
  static_assert(!ROUND || CURVES, "round slots are 16-field curve slots");
  constexpr int L = WARP::kLanes;
  constexpr bool STATIC = !MOTION && !CURVES;
  constexpr int refill_lanes = CURVES   ? kCurveRefillLanes
                               : STATIC ? kStaticRefillLanes
                                        : kRefillLanes;
  constexpr int leaf_lanes = CURVES   ? kCurveLeafLanes
                             : STATIC ? kStaticLeafLanes
                                      : kLeafLanes;
  RayState st[L];
  bool busy[L];
  uint32_t finished[L];
  w.each([&](int l, int) {
    busy[l] = false;
    finished[l] = 0;
  });
  auto done = [&](int l) {
    if (finish_ray<WANT_ATTRS>(p, st[l])) w.overflow(out_overflow);
    ++finished[l];
    busy[l] = false;
  };
  bool more = true;  // rays left to take (uniform across the warp)
  uint32_t passes = 0, steps = 0, leaf_passes = 0, leaf_steps = 0,
           rounds = 0;
  auto flush = [&] {
    w.add_counts(counts, passes, steps, finished);
    if (CURVES || STATIC) {
      w.add_leaf_counts(counts, leaf_passes, leaf_steps, rounds);
    }
    passes = steps = leaf_passes = leaf_steps = rounds = 0;
    w.each([&](int l, int) { finished[l] = 0; });
  };
  for (;;) {
    if (more) {
      const uint32_t idle = w.ballot([&](int l) { return !busy[l]; });
      const int n_idle = popc(idle);
      if (n_idle >= refill_lanes) {
        const int base = w.take(next_ray, idle);
        more = base + n_idle < p.n_rays;
        w.each([&](int l, int lane) {
          const int i = base + rank(idle, lane);
          if (!busy[l] && i < p.n_rays) {
            start_ray<HAS_MASK, MOTION>(p, i, st[l]);
            busy[l] = true;
            if (!ray_running(st[l])) done(l);
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
    const bool leaves = popc(at_leaf) >= leaf_lanes || at_node == 0;
    const uint32_t go = leaves ? at_leaf : at_node;
    if (passes == kFlushPasses) flush();
    ++passes;
    steps += popc(go);
    if constexpr (CURVES || STATIC) {
      if (leaves) {
        ++leaf_passes;
        leaf_steps += popc(go);
        int32_t key[L], tb[L];
        if constexpr (CURVES) {
          curve_pass<WARP, HAS_MASK, ROBUST, MOTION, ROUND>(p, w, st, go, wt,
                                                            key, tb, rounds);
        } else {
          static_pass<WARP, HAS_MASK, ROBUST, KINDS>(p, w, st, go, key, tb,
                                                     rounds);
        }
        w.each([&](int l, int lane) {
          if (!((go >> lane) & 1u)) return;
          ++st[l].n_leaf;
          if (!take_leaf_hit<OCCLUSION, WANT_ATTRS, ROBUST>(p, st[l], key[l],
                                                            tb[l])) {
            pop(st[l], w.stack(l));
          }
          if (!ray_running(st[l])) done(l);
        });
        continue;
      }
    }
    w.each([&](int l, int lane) {
      if (!((go >> lane) & 1u)) return;
      const auto stk = w.stack(l);
      bool kept;
      if constexpr (CURVES || STATIC) {
        kept = node_step<ROBUST>(p, st[l], stk);
      } else {
        kept = leaves ? leaf_step<OCCLUSION, WANT_ATTRS, HAS_MASK, ROBUST,
                                  KINDS>(p, st[l])
                      : node_step<ROBUST>(p, st[l], stk);
      }
      if (!kept) pop(st[l], stk);
      if (!ray_running(st[l])) done(l);
    });
  }
  flush();
}

}  // namespace trav
