"""Smoke run of embree_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Drives the port's main path through its public entry points and holds the
Hopper traversal kernel against its plain PyTorch version:

1. the card: name and power limit from nvidia-smi;
2. build the kernel (nvcc, sm_90a: its three sources compile in parallel
   and link into one library), the ablation kernels (two more nvcc
   processes, one library), the loop-probe kernels (three more, one
   library) and the native BVH builder (g++) from the sources in this
   checkout, one compiler process each, in parallel; print each
   instantiation's registers, spills and stack;
3. kernel vs plain version on the 16K-triangle sphere with 1M incoherent
   rays (and on a masked copy of it): every variant, 65,536 of the rays,
   everything bit-equal, no stack overflow;
4. the main path at full size: the 2,097,152-triangle sphere committed by the
   port, 16,777,216 incoherent rays through both intersect modes and
   occluded; a brute-force check on a few rays; kernel vs plain version
   on 262,144 of the rays; kernel and wrapper times (CUDA events, median
   of 5 after a warm-up) and the plain version's time;
   then the same sphere with geometry mask 0x2 and random ray masks, to time
   the masked variants at full size;
5. the viewer: cube and sphere x eyelight/primID/uv at 96x96 through the
   default differentiable path, each within 10 wrong pixels of
   tests/golden/*.pfm;
6. kernel vs plain version for kind tags, points and lines (B3-B5): the
   scene of tests/test_pallas_kernel.py:69-93 with 65,536 rays, as is, with
   half its geometries masked, in robust mode, and both; closest and
   occluded bit-equal with their step counts, no stack overflow;
7. robust mode (B2) at full size: the 2,097,152-triangle sphere committed
   with robust=True, 16,777,216 rays through both intersect modes and
   occluded; 1,048,576 rays from the center must all hit (watertight);
8. kind tags, points and lines at full size: 1,574,400 prims made by
   Embree's tutorial generators (a quad sphere, three point spheres) plus
   655,360 round and flat hair segments, 16,777,216 rays through both
   intersect modes and occluded; every kind class must get hits;
9. motion blur (B6), every instantiation against the plain version at
   65,536 rays with times U[0,1): the kind check scene with every kind
   moving (as is, masked, robust, robust + masked, and over 3 steps, which
   gives windows), a moving 16K-tri sphere (masked, robust, robust +
   masked) and the static robust + masked triangle variants;
10. 2-step motion at full size: the 2,097,152-triangle sphere moving a
   quarter of its radius along x (Embree's motion_blur_geometry tutorial
   at bench.py:56's size), 16,777,216 rays with times through both
   intersect modes and occluded, held against the exact moving sphere and
   brute force; kernel vs plain version on 262,144 of the rays;
11. time-sliced motion at full size: sphere_mesh(512, 1024) over 4 time
   steps, accelerating along x by 0.25 in all, 3,145,728 windowed prims,
   the same rays and checks;
12. kernel vs plain version for flat curves (B7): the scene of
   tests/test_pallas_kernel.py:175-193 scaled up to 4,096 flat Bezier and
   B-spline curves, its backdrop triangle and 32 tessellated round strands
   (512 round segments, B5) at 65,536 rays: as is, masked, robust, robust +
   masked, moving over 2 steps (the same four) and over 3 steps (windows);
   every curve instantiation bit-equal, class-8 hits;
13. the hair cell at full size: 131,072 B-spline strands of 11 control
   points on a unit sphere (1,048,576 flat native curves, rate 4), 16,777,216
   rays through both intersect modes and occluded; brute force on a few
   rays, kernel vs plain version on 262,144 of the rays, commit (with the
   hair tier's leaf OBBs), table, steps and times;
14. kernel vs plain version for round curves (B8), with round curves among
   the packed kinds (the JAX package's EMBREE_TPU_KERNEL_ROUND opt-in): 2,048
   round Bezier curves, 512 round B-spline strands of 4 spans, 32
   tessellated round strands and the backdrop triangle at 65,536 rays, every
   curve instantiation (static and 2-step x {as is, masked, robust, both},
   3 steps), bit-equal, class-9 hits;
15. the round hair cell: phase 13's strands as 1,048,576 native round
   curves. The generic engine (the default route) on 1,048,576 of the rays
   through both intersect modes and occluded, with its lockstep steps, time
   and peak memory; brute force on a few rays; then the kernel route (B8)
   on all 16,777,216 rays, kernel vs plain version on 65,536 of them, and
   B8 against the engine on the engine's rays within the JAX package's own
   bounds (test_pallas_kernel.py:229-233);
16. the generic engine against the kernel on phase 6's kind check scene at
   65,536 rays: equal hit masks, prim ids equal but at near-ties;
17. the viewer's mixed scene (a round curve: the generic engine) at 96x96
   against tests/golden/mixed_*.pfm;
18. the traversal ablations (perf/ablate_v7.py, perf/kernel_ablate.py) at
   the harnesses' size, the 16,384-triangle sphere and 1,048,576 sorted
   rays: each harness's variants (12 v7, pinned at 24 steps; 9 v5) timed
   through its entry point, every kernel held against its plain version
   on 65,536 of the rays (t bits, ids, step row, each ray's steps), the
   full variants against B1 on the same rays (hit masks, t within 1e-4,
   prim ids but at near-ties), then the v7 variants again on the main
   cell's 2,097,152-triangle sphere and 16,777,216 rays beside B1;
19. the loop probes (perf/micro_ops.py, perf/micro_expand.py,
   perf/micro_v8.py) at the harnesses' size: 14, 12 and 19 probes, each
   one CUDA block carrying an (8,128), (8,128) or (128,128) int32 tile over
   x of (512,128), (128,128) and (512,128); every kernel bit-equal to its
   plain version on the harnesses' x and on x with distinct rows at 64 and
   67 iterations (and the (8,128) probes at 1,000), then each timed through
   its entry point at the harness's ITERS (20,000, 3,000, 20,000) on the
   harness's x: ms, ns/iter and ns/iter over the harness's base probe,
   launches, the per-SM bound, the least work over implementations (a
   probe timed below it fails the run: its loop was folded; a fold too
   small to take it below is not caught), registers and stack frame, and
   the plain version's time at 64 iterations;
20. the kernels line, then the result line.

Launch counts are zeroed just before each driven path (4-19) and read just
after; a variant the path uses that was never launched fails the run, and
the kernels line gives each variant the count of the path that timed it. Any
failed check raises, and the script then exits non-zero without a result
line. It refuses to run without a CUDA device. To stay near its earlier
length, phases 10 and 11 hold the kernel against the plain version on
65,536 of their rays (262,144 before).

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 rate outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# operations of one visit, counted from csrc/traverse.cuh: per child slab
# 6 sub + 6 mul + 6 min/max + 6 min/max into tent/tex + compare + clamp (26),
# plus 19 compare-exchanges of the sort; per triangle slot pvec 9, det 5,
# |det| test 2, rcp 1, tvec 3, u 6, qvec 9, v 6, t 6, range tests 6, key
# clamp 1, min 1 (55)
NODE_OPS = 8 * 26 + 19
LEAF_OPS = 8 * 55
ROBUST_NODE_OPS = NODE_OPS + 8 * 6   # the six slab scalings
# operations of one slot test by kind tag, counted the same way (key and
# min included): Moeller 55 (Pluecker 92 in robust mode), sphere 37, disc
# 28, oriented disc 33, round line 192, flat line 88; tag 1 never occurs
SLOT_OPS = {0: 55, 2: 37, 3: 28, 4: 33, 5: 192, 6: 88}
PLUECKER_OPS = 92


def curve_slot_ops(rate):
    """B7, one ribbon slot at ``rate`` segments, counted from
    csrc/traverse.cuh (leaf_ribbon): CPs into the ray frame 72 (per CP 3
    sub + 3 dot products of 5), the magnitude scan 33 (16 abs, 16 max, one
    mul), per knot 61 (4 positions of 7, 3 derivatives of 9, small test 6)
    over rate + 1 knots, per segment 118 (differences 2, selects 4, culling
    11, two normal lengths 12, normals 6, quad corners 16, winding 6,
    corner selects 9, edges 6, U/V 8, normal 9, reciprocal 4, t 6, range
    tests 6, u 3, radius 4, self-intersection 3, take 3), key and min 2."""
    return 72 + 33 + 61 * (rate + 1) + 118 * rate + 2


def round_slot_ops(rate):
    """B8, one round slot before its polishes, counted from
    csrc/traverse.cuh (leaf_round_curve): rcp of |d|^2 2, centroid 12,
    dtc 9, relative CPs 36, box scan 32, error scales 3, first knot 28, per
    cone segment 151 (knot 28, recentring 21, cone coefficients 53, roots
    and their tests 49), key and min 2."""
    n = max(rate, 8)
    return 2 + 12 + 9 + 36 + 32 + 3 + 28 + 151 * n + 2


# B8, per candidate a segment yields: its seed (t, y, u: 9) and 5 Newton
# steps of 258 (the curve and its two derivatives at u 79, the residual
# and its error bounds 36, the tangent and its derivative 23, f, g and
# their Jacobian 79, the update and the acceptance tests 41), the min 2
ROUND_CANDIDATE_OPS = 9 + 5 * 258 + 2


# the curve frame, once per curve leaf visit (curve_frame: 3 square
# roots, 3 divisions, 44 multiply/add/select)
CURVE_FRAME_OPS = 50
# B6, per leaf visit: the lerp a + w * (b - a) of 72 fields (3 each), and
# with windows each slot's weight and window test (2 sub, max, div, max,
# min, 2 compares, and: 9)
MOTION_LEAF_OPS = 72 * 3
WINDOW_LEAF_OPS = 8 * 9
RAY_IN_BYTES = 36            # org, dir (24), tnear, tfar, mask (12)
TIME_BYTES = 4               # the ray time, read by moving scenes
VARIANTS = (("closest_attrs", False, True), ("closest", False, False),
            ("occluded", True, False))
KIND_VARIANTS = (("closest", False, False), ("occluded", True, False))
SOURCE = "embree_tpu_torch/csrc/traverse.cu"
CURVE_SOURCE = "embree_tpu_torch/csrc/traverse_curves.cu"
ROUND_SOURCE = "embree_tpu_torch/csrc/traverse_round.cu"
DEV = "cuda"
CHECK_MESH = (64, 128)       # the 16K-tri sphere (bench.py default)
CHECK_RAYS = 1 << 20
CHECK_COMPARE = 1 << 16
MAIN_MESH = (1024, 1024)     # the 2.1M-tri sphere (bench.py:56)
MAIN_RAYS = 1 << 24
MAIN_COMPARE = 1 << 18
VIEW = 96
KINDS_RAYS = 1 << 16
MIXED_RAYS = 1 << 24
MIXED_PRIMS = 1_574_400
WATERTIGHT_RAYS = 1 << 20
PALLAS = "embree_tpu/accel/traverse_pallas.py"
# the Pallas source each variant family replaces
REPLACES = {"": f"{PALLAS}:108", "robust": f"{PALLAS}:469",
            "kinds": f"{PALLAS}:1048", "masked": f"{PALLAS}:1061",
            "motion": f"{PALLAS}:502", "motion_win": f"{PALLAS}:1059",
            "curves": f"{PALLAS}:739", "curves_round": f"{PALLAS}:858"}
MOTION_RAYS = 1 << 24
MOTION_COMPARE = 1 << 16     # rays of the plain version's sample
MOTION_SHIFT = 0.25          # a quarter of the unit sphere's radius, along x
MSTEP_MESH = (512, 1024)     # 1,048,576 tris
MSTEP_STEPS = 4              # Embree's msmblur scenes carry 3-4 steps
MSTEP_PRIMS = 3 * 2 * MSTEP_MESH[0] * MSTEP_MESH[1]
CURVE_CHECK = (2048, 512, 32)   # Bezier curves, B-spline and round strands
HAIR_STRANDS = 1 << 17          # x 8 B-spline spans = 1,048,576 curves
HAIR_CPS = 11
HAIR_RAYS = 1 << 24
HAIR_COMPARE = 1 << 18
ROUND_CHECK = (2048, 512, 32)   # round Bezier, round B-spline, tessellated
ENGINE_RAYS = 1 << 20           # the generic engine's share of the hair rays
ROUND_COMPARE = 1 << 16
# phase 18, the traversal ablations (perf/ablate_v7.py, perf/kernel_ablate.py)
ABLATE_SOURCES = {"v7": "embree_tpu_torch/csrc/ablate_v7.cu",
                  "v5": "embree_tpu_torch/csrc/ablate_v5.cu"}
ABLATE_REPLACES = {"v7": "perf/ablate_v7.py:336",
                   "v5": "perf/kernel_ablate.py:310"}
ABLATE_COMPARE = 1 << 16
# bytes of one record each variant reads per visit
ABLATE_LEAF_BYTES = {"v7": 288, "v5": 192}
# operations of one visit by phase, counted from csrc/ablate.cuh as NODE_OPS
# and LEAF_OPS are from traverse.cuh: the slab test 8 x 26, keys without it
# 8 x 2; the sort 19 compare-exchanges; per Moeller slot 55, and v5's
# count, mask and first-minimum tests 4 per slot
ABLATE_SLAB_OPS = 8 * 26
ABLATE_REFS_OPS = 8 * 2
ABLATE_SORT_OPS = 19
ABLATE_SLOT_OPS = {"v7": 55, "v5": 55 + 4}
ABLATE_SLOTS = {"v7": 8, "v5": 4}
# phase 19, the loop probes (perf/micro_ops.py, perf/micro_expand.py,
# perf/micro_v8.py)
# the harness function each kernel replaces (its def line: run, bench, run)
MICRO_REPLACES = {"micro_ops": "perf/micro_ops.py:41",
                  "micro_expand": "perf/micro_expand.py:23",
                  "micro_v8": "perf/micro_v8.py:21"}
# kernel vs plain version at 64 iterations (the tests' count), at 67 (not a
# multiple of 8: a roll of 8 rows taken 8k times is the identity, so at 64
# and 1,000 the roll probe cannot tell its direction) and, for the (8,128)
# probes, at 1,000, where `it` passes the values the comparisons test
MICRO_CHECK_ITERS = (64, 67)
MICRO_LONG_ITERS = 1000
MICRO_PLAIN_ITERS = 64


def say(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def incoherent_rays(n, seed):
    """bench.py:116-119: origins U(-2,2)^3, directions N(0,1)^3."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3), dtype=np.float32)
    return org, d


def sorted_inputs(tr, rays):
    """The kernel's inputs as the wrapper hands them over (sorted): org,
    dir, tnear, tfar, mask and time."""
    _, s = tr.sort_rays_by_coherence(
        rays.org, rays.dir, rays.tnear, rays.tfar, rays.mask.to(torch.int32),
        rays.time)
    return s


def run_kernel(tr, packed, x, **kw):
    return tr.traverse_kernel(packed, *x[:5], time=x[5], **kw)


def run_plain(tr, packed, x, **kw):
    return tr.traverse_packed_reference(packed, *x[:5], time=x[5], **kw)


def events_ms(fn, reps=5):
    """Median of reps timed calls after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(tr, packed, inputs, n, occ, attrs, label, robust=False,
            plain=None):
    """Kernel vs plain version on n of the (sorted) rays, every k-th of
    them, so that the sample spans the whole batch and its mix of paths:
    every output bit-equal. Returns the max |difference| over t and
    attributes (0.0 when equal). ``plain``: a dict that gets, under the
    variant's name, the plain run's time (CUDA events, ``ms``), its slot
    tests by kind tag, its leaf visits and its ray count ``n``, for
    ``time_variants``."""
    k = max(inputs[0].shape[0] // n, 1)
    x = [t[::k][:n].contiguous() for t in inputs]
    k = run_kernel(tr, packed, x, occlusion=occ, want_attrs=attrs,
                   robust=robust)
    a0 = torch.cuda.Event(enable_timing=True)
    a1 = torch.cuda.Event(enable_timing=True)
    a0.record()
    p = run_plain(tr, packed, x, occlusion=occ, want_attrs=attrs,
                  robust=robust)
    a1.record()
    torch.cuda.synchronize()
    if plain is not None:
        plain[tr.packed_variant(packed, occ, attrs, robust)] = dict(
            ms=a0.elapsed_time(a1), slots=p.class_slots.double(),
            cands=float(p.round_candidates),
            leaf_visits=int(p.visits[1].sum(dtype=torch.int64)), n=n)
    check(int(k.overflow) == 0 and int(p.overflow) == 0,
          f"{label}: stack overflow")
    check(torch.equal(k.best, p.best), f"{label}: prim ids differ")
    check(torch.equal(k.visits, p.visits), f"{label}: step counts differ")
    check(torch.equal(k.t.view(torch.int32), p.t.view(torch.int32)),
          f"{label}: t bits differ")
    err = (k.t - p.t).abs().nan_to_num(0.0, posinf=0.0).max().item()
    if attrs:
        check(torch.equal(k.attrs.view(torch.int32),
                          p.attrs.view(torch.int32)),
              f"{label}: u/v/Ng bits differ")
        err = max(err, (k.attrs - p.attrs).abs().max().item())
    hits = int((k.best >= 0).sum())
    say(f"  {label}: {n} rays, {hits} hits, kernel == plain (bits, steps)")
    return err


def analytic_sphere_check(rays, hit, n, mesh, center=None):
    """The tessellated unit sphere against the exact one on the first n
    rays (float64): hit masks agree except at grazing rays, and hit
    distances agree to the order of the tessellation's sagitta,
    (pi / n_theta)^2 / 8 of the radius. ``center``: (n, 3) the sphere's
    center at each ray's time (moving spheres), else the origin."""
    o = rays.org[:n].double()
    if center is not None:
        o = o - center.double()
    d = rays.dir[:n].double()
    a = (d * d).sum(1)
    b = (o * d).sum(1)
    c = (o * o).sum(1) - 1.0
    disc = b * b - a * c
    sq = disc.clamp(min=0).sqrt()
    t0, t1 = (-b - sq) / a, (-b + sq) / a
    exact = (disc >= 0) & (t1 >= 0)
    t_exact = torch.where(t0 >= 0, t0, t1)
    got = hit.valid[:n]
    agree = (exact == got).double().mean().item()
    both = exact & got
    rel = ((hit.t[:n][both].double() - t_exact[both]).abs()
           / t_exact[both].clamp(min=1e-3))
    med = rel.median().item()
    say(f"  exact sphere on {n} rays: {agree:.6f} hit masks agree, "
        f"median |dt|/t {med:.3e}, hit rate {got.double().mean().item():.4f}")
    check(agree > 0.998, "hit masks disagree with the exact sphere")
    check(med < 4 * (math.pi / min(mesh)) ** 2,
          "hit distances disagree with the exact sphere")


def phase_kernel_check(pt, tr, sphere_mesh, errs):
    say("phase 3: kernel vs plain version, 16K-tri sphere, 1M rays")
    verts, idx = sphere_mesh(*CHECK_MESH)
    org, d = incoherent_rays(CHECK_RAYS, 0)
    for mask in (0xFFFFFFFF, 0x2):
        s = pt.Scene()
        s.attach(pt.TriangleGeometry(verts, idx, mask=mask))
        cs = s.commit(device=DEV)
        rmask = (0xFFFFFFFF if mask == 0xFFFFFFFF else
                 np.random.default_rng(1).choice(
                     np.array([1, 2, 3], np.uint32), org.shape[0]))
        rays = pt.make_rays(org, d, mask=rmask, device=DEV)
        inputs = sorted_inputs(tr, rays)
        for name, occ, attrs in VARIANTS:
            full = run_kernel(tr, cs.packed, inputs, occlusion=occ,
                              want_attrs=attrs)
            torch.cuda.synchronize()
            check(int(full.overflow) == 0, "stack overflow on 1M rays")
            label = f"{name}{' masked' if cs.packed.has_mask else ''}"
            errs[name] = max(errs[name], compare(
                tr, cs.packed, inputs, CHECK_COMPARE, occ, attrs, label))


def plain_run(tr, packed, inputs, occ, attrs, robust):
    """The plain version over all rays; returns (ms, slot tests by tag,
    round-curve candidates)."""
    a0 = torch.cuda.Event(enable_timing=True)
    a1 = torch.cuda.Event(enable_timing=True)
    a0.record()
    p = run_plain(tr, packed, inputs, occlusion=occ, want_attrs=attrs,
                  robust=robust)
    a1.record()
    torch.cuda.synchronize()
    slots, cands = p.class_slots, float(p.round_candidates)
    del p
    torch.cuda.empty_cache()
    return a0.elapsed_time(a1), slots, cands


def time_variants(tr, packed, inputs, variants, record, table_bytes, card,
                  launches, robust=False, total_ms=None, plain=None):
    """Kernel time (CUDA events, median of 5 after a warm-up), step counts,
    bound and plain-version time of each variant at the inputs' shape; the
    records go into ``record`` under the variant's launch-count name, each
    with its count in ``launches``, those of the path driven on this cell.
    ``plain``: the plain runs ``compare`` already made, by variant name;
    where they saw a sample of the rays (scenes whose plain run is too long
    for all rays), their slot tests by kind tag are scaled to this run by
    its leaf visits."""
    n_rays = inputs[0].shape[0]
    total_ms = total_ms or {}
    for base, o, a in variants:
        name = tr.packed_variant(packed, o, a, robust)
        check(launches.get(name, 0) > 0, f"{name}: no launch on its path")
        res = {}

        def run():
            res["r"] = run_kernel(tr, packed, inputs, occlusion=o,
                                  want_attrs=a, robust=robust)
        ms = events_ms(run)
        r = res["r"]
        node_v = int(r.visits[0].sum(dtype=torch.int64))
        leaf_v = int(r.visits[1].sum(dtype=torch.int64))
        max_steps = int((r.visits[0] + r.visits[1]).max())
        torch.cuda.synchronize()
        check(int(r.overflow) == 0, f"{name}: stack overflow")
        del res, r
        torch.cuda.empty_cache()
        if plain is None:
            plain_rays = n_rays
            plain_ms, slots, cands = plain_run(tr, packed, inputs, o, a,
                                               robust)
        else:
            pl = plain[name]
            plain_rays, plain_ms, slots, cands = (pl["n"], pl["ms"],
                                                  pl["slots"], pl["cands"])
            if plain_rays != n_rays:
                scale = leaf_v / max(pl["leaf_visits"], 1)
                slots = slots * scale
                cands = cands * scale
        out_bytes = 4 + 4 + 8 + (20 if a else 0)
        in_bytes = RAY_IN_BYTES + (TIME_BYTES if packed.has_motion else 0)
        nbytes = table_bytes + n_rays * (in_bytes + out_bytes)
        slot_ops = dict(SLOT_OPS)
        if robust:
            slot_ops[0] = PLUECKER_OPS
        curves = tr.has_curves(packed)
        if curves:
            slot_ops[tr.KIND_CURVE_FLAT] = curve_slot_ops(packed.curve_rate)
            slot_ops[tr.KIND_CURVE_ROUND] = round_slot_ops(packed.curve_rate)
        if packed.has_kinds:
            leaf_ops = sum(float(slots[k]) * slot_ops[k] for k in slot_ops)
        else:
            leaf_ops = leaf_v * 8 * slot_ops[0]
        if curves:
            # the frame at each curve leaf visit; each round candidate's
            # polish (counted from this run's data)
            leaf_ops += leaf_v * CURVE_FRAME_OPS + cands * ROUND_CANDIDATE_OPS
        if packed.has_motion and curves:
            # each slot lerps the fields its test reads (3 operations
            # each) and, with windows, computes its weight
            leaf_ops += sum(float(slots[k]) * (
                3 * (16 if k in tr.CURVE_CLASSES else 9)
                + (WINDOW_LEAF_OPS // 8 if packed.has_win else 0))
                for k in slot_ops)
        elif packed.has_motion:
            leaf_ops += leaf_v * (MOTION_LEAF_OPS + (WINDOW_LEAF_OPS
                                                     if packed.has_win else 0))
        ops = node_v * (ROBUST_NODE_OPS if robust else NODE_OPS) + leaf_ops
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FP32_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        # every ray reads at least its root record
        check(ms >= n_rays * 128 / PEAK_BYTES_PER_S * 1e3,
              f"{name}: {ms} ms is below the sanity bound")
        rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   node_visits=node_v, leaf_visits=leaf_v,
                   slot_tests={k: int(float(slots[k])) for k in slot_ops},
                   round_candidates=int(cands),
                   n_rays=n_rays, plain_rays=plain_rays,
                   steps_per_ray=(node_v + leaf_v) / n_rays,
                   max_steps=max_steps,
                   mrays_per_s=n_rays / ms / 1e3, card=card,
                   launches=launches[name])
        if base in total_ms:
            rec["entry_point_ms"] = total_ms[base]
            rec["wrapper_ms"] = total_ms[base] - ms
        record[name] = rec
        say(f"  {name}: kernel {ms:.3f} ms ({rec['mrays_per_s']:.1f} "
            f"Mrays/s), {rec['steps_per_ray']:.2f} steps/ray "
            f"({node_v / n_rays:.2f} nodes, {leaf_v / n_rays:.2f} leaves; "
            f"max {max_steps}), "
            f"bound {bound_ms:.3f} ms ({rec['bound_by']}), plain "
            f"{plain_ms:.1f} ms"
            + (f" on {plain_rays} rays" if plain_rays != n_rays else "")
            + (f", entry point {total_ms[base]:.3f} ms, wrapper "
               f"{rec['wrapper_ms']:.3f} ms" if base in total_ms else "")
            + f" [{card}]")


def table_mb(packed):
    return (packed.nodes.numel() + packed.leaves.numel()) * 4


def commit_timed(scene, label):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cs = scene.commit(device=DEV)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    p = cs.packed
    table = ("no packed table (the generic engine)" if p is None else
             f"table {table_mb(p) / 1e6:.3f} MB ({p.nodes.shape[0]} nodes, "
             f"{p.leaves.shape[0]} leaves)")
    obbs = int((cs.leaf_obb_up[:, 0] < 3e38).sum())
    say(f"  commit: {cs.num_prims} prims ({label}) in {secs:.3f} s; {table};"
        f" {obbs} leaf OBBs; device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return cs, secs


def phase_main(pt, tr, sphere_mesh, errs, record):
    say("phase 4: main path, sphere_mesh(1024, 1024), 16,777,216 rays")
    verts, idx = sphere_mesh(*MAIN_MESH)
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(verts, idx))
    cs, _ = commit_timed(s, "triangles")
    packed = cs.packed
    table_bytes = table_mb(packed)
    check(cs.num_prims == 2 * MAIN_MESH[0] * MAIN_MESH[1],
          "wrong triangle count")
    n_rays = MAIN_RAYS
    org, d = incoherent_rays(n_rays, 0)
    rays = pt.make_rays(org, d, device=DEV)
    del org, d

    # ---- the main path, launch counts zeroed just before, read after ----
    tr.reset_launch_counts()
    hit = pt.intersect(cs, rays, differentiable=False)
    hd = pt.intersect(cs, rays)
    occ = pt.occluded(cs, rays)
    torch.cuda.synchronize()
    launches = dict(tr.LAUNCHES)
    say(f"  launches on the main path: {launches}")
    check(all(launches.get(n, 0) > 0 for n, _, _ in VARIANTS),
          "the main path did not launch every variant")
    check(torch.equal(hd.valid, hit.valid) and torch.equal(hd.t, hit.t),
          "the two intersect modes disagree")
    del hd
    valid = hit.valid
    n_hit = int(valid.sum())
    say(f"  intersect: {n_hit} of {n_rays} rays hit; occluded: "
        f"{int(occ.sum())}")
    check(hit.t.shape == (n_rays,) and hit.ng.shape == (n_rays, 3),
          "wrong hit shapes")
    check(bool(torch.isfinite(hit.t[valid]).all()), "non-finite hit t")
    check(bool(torch.isfinite(hit.ng[valid]).all()), "non-finite Ng")
    check(bool((hit.t[~valid] == math.inf).all()), "miss t is not inf")
    check(torch.equal(occ, valid), "occluded disagrees with intersect")
    analytic_sphere_check(rays, hit, min(n_rays, CHECK_RAYS), MAIN_MESH)
    # a few rays against brute force over all 2M triangles
    sub = pt.RayBatch(*(getattr(rays, f)[:256] for f in
                        ("org", "dir", "tnear", "tfar", "time", "mask")))
    hb = pt.intersect_brute(cs, sub, chunk=1 << 16)
    hk = pt.intersect(cs, sub, differentiable=False)
    check(torch.equal(hb.valid, hk.valid), "brute force: hit masks differ")
    m = hb.valid
    check(torch.allclose(hb.t[m], hk.t[m], rtol=1e-5),
          "brute force: t differs")
    same = (hb.prim_id[m] == hk.prim_id[m]).float().mean().item()
    check(same > 0.95, "brute force: prim ids differ")
    say(f"  brute force on 256 rays: masks equal, t within 1e-5, "
        f"{same:.4f} equal prim ids")
    del hb, hk, hit, occ, valid

    inputs = sorted_inputs(tr, rays)
    for name, o, a in VARIANTS:
        errs[name] = max(errs.get(name, 0.0), compare(
            tr, packed, inputs, MAIN_COMPARE, o, a, name))

    # ---- timing at the main-path shape ----
    card = card_line()
    total_ms = {
        "closest_attrs": events_ms(
            lambda: pt.intersect(cs, rays, differentiable=False)),
        "occluded": events_ms(lambda: pt.occluded(cs, rays)),
    }
    time_variants(tr, packed, inputs, VARIANTS, record, table_bytes, card,
                  launches, total_ms=total_ms)
    say(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        " GB")
    del cs, rays, inputs, packed
    torch.cuda.empty_cache()

    # ---- the masked variants at full size (geometry mask 0x2, random ray
    # masks), driven through the entry points ----
    say("phase 4b: main cell with geometry mask 0x2 and random ray masks")
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(verts, idx, mask=0x2))
    cs, _ = commit_timed(s, "triangles, masked")
    org, d = incoherent_rays(n_rays, 0)
    rmask = np.random.default_rng(1).choice(np.array([1, 2, 3], np.uint32),
                                            n_rays)
    rays = pt.make_rays(org, d, mask=rmask, device=DEV)
    del org, d, rmask
    tr.reset_launch_counts()
    hit = pt.intersect(cs, rays, differentiable=False)
    hd = pt.intersect(cs, rays)
    occ = pt.occluded(cs, rays)
    torch.cuda.synchronize()
    masked = dict(tr.LAUNCHES)
    say(f"  launches on the masked path: {masked}")
    check(all(masked.get(f"{n}_masked", 0) > 0 for n, _, _ in VARIANTS),
          "the masked path did not launch every masked variant")
    check(torch.equal(occ, hit.valid) and torch.equal(hd.valid, hit.valid),
          "masked: the three entry points disagree")
    ok_mask = (rays.mask & 0x2) != 0
    check(not bool(hit.valid[~ok_mask].any()), "masked: a ray mask leaked")
    say(f"  masked intersect: {int(hit.valid.sum())} hits, none where "
        "ray mask & 0x2 == 0")
    del hit, hd, occ
    inputs = sorted_inputs(tr, rays)
    for name, o, a in VARIANTS:
        errs[f"{name}_masked"] = compare(tr, cs.packed, inputs, MAIN_COMPARE,
                                         o, a, f"{name}_masked")
    total_ms = {
        "closest_attrs": events_ms(
            lambda: pt.intersect(cs, rays, differentiable=False)),
        "occluded": events_ms(lambda: pt.occluded(cs, rays)),
    }
    time_variants(tr, cs.packed, inputs, VARIANTS, record,
                  table_mb(cs.packed), card, masked, total_ms=total_ms)


def phase_viewer(pt, tr):
    from embree_tpu_torch.models.camera import Camera
    from embree_tpu_torch.models.viewer import render
    from embree_tpu_torch.tools.viewer import build_scene
    from embree_tpu_torch.utils.image import compare_images, load_pfm
    say("phase 5: viewer, cube and sphere at 96x96 vs tests/golden")
    tr.reset_launch_counts()
    for sc in ("cube", "sphere"):
        scene, eye = build_scene(sc, pt)
        cs = scene.commit(device=DEV)
        cam = Camera(from_point=np.asarray(eye, np.float32),
                     to_point=np.zeros(3, np.float32),
                     up=np.array([0, 1, 0], np.float32))
        for sh in ("eyelight", "primID", "uv"):
            img = render(cs, cam, VIEW, VIEW, shader=sh).cpu().numpy()
            check(img.shape == (VIEW, VIEW, 3) and np.isfinite(img).all(),
                  f"{sc}/{sh}: bad image")
            ref = load_pfm(os.path.join(ROOT, "tests", "golden",
                                        f"{sc}_{sh}.pfm"))
            wrong = compare_images(img, ref)
            say(f"  {sc}/{sh}: {wrong} wrong px")
            check(wrong <= 10, f"{sc}/{sh}: {wrong} wrong pixels")
    launches = dict(tr.LAUNCHES)
    say(f"  launches on the viewer path: {launches}")
    check(launches.get("closest", 0) > 0,
          "the viewer did not launch the kernel")


def moving(a, shift, steps):
    """``steps`` time steps of buffer ``a`` (as is for 1): its xyz moved by
    shift * (k / (steps - 1))^2 at step k, so 3 or more steps bend the path
    and the merger splits it into windows."""
    a = np.asarray(a, np.float32)
    if steps == 1:
        return a
    out = np.stack([a] * steps)
    for k in range(steps):
        out[k, :, :3] += (np.asarray(shift, np.float32)
                          * np.float32((k / (steps - 1)) ** 2))
    return out


def mixed_check_scene(pt, masked=False, robust=False, steps=1):
    """The scene of tests/test_pallas_kernel.py:69-93 (numpy seed 7):
    triangles, a quad, two of each point kind, two round and two flat
    segments; ``masked``: every second geometry has mask 0x2; ``steps`` > 1:
    every kind moves (oriented-disc normals turn), over that many steps."""
    from embree_tpu_torch.tools.viewer import sphere_mesh
    rng = np.random.default_rng(7)
    verts, idx = sphere_mesh(6, 8)
    qv = np.array([[-2, -2, -1], [2, -2, -1], [2, 2, -1], [-2, 2, -1]],
                  np.float32)
    pts = np.concatenate([rng.uniform(-1.5, 1.5, (6, 3)),
                          rng.uniform(0.2, 0.4, (6, 1))], 1).astype(np.float32)
    lv = np.concatenate([rng.uniform(-1.5, 1.5, (4, 3)),
                         rng.uniform(0.1, 0.3, (4, 1))], 1).astype(np.float32)
    two = np.array([0, 2], np.int32)
    nrm = np.eye(3, dtype=np.float32)[:2]
    if steps > 1:
        nrm = np.stack([nrm if k % 2 == 0 else nrm[::-1]
                        for k in range(steps)])
    geoms = [
        pt.TriangleGeometry(moving(verts, (0.1, 0, 0), steps), idx),
        pt.QuadGeometry(moving(qv, (0, 0, 0.5), steps),
                        np.array([[0, 1, 2, 3]], np.int32)),
        pt.PointGeometry(moving(pts[:2], (0, 0.3, 0), steps), kind="sphere"),
        pt.PointGeometry(moving(pts[2:4], (-0.2, 0, 0.1), steps),
                         kind="disc"),
        pt.PointGeometry(moving(pts[4:6], (0, 0, 0.3), steps),
                         kind="oriented_disc", normals=nrm),
        pt.LineSegmentsGeometry(moving(lv, (0, 0.2, 0), steps), two,
                                kind="round"),
        pt.LineSegmentsGeometry(moving(lv + 0.5, (0.2, 0, -0.2), steps), two,
                                kind="flat"),
    ]
    s = pt.Scene(robust=robust)
    for k, g in enumerate(geoms):
        if masked and k % 2:
            g.mask = 0x2
        s.attach(g)
    return s


def phase_kinds_check(pt, tr, errs, record):
    say("phase 6: kernel vs plain version, kind tags, points, lines "
        "(test_pallas_kernel.py:69-93 scene), 65,536 rays")
    org, d = incoherent_rays(KINDS_RAYS, 0)
    card = card_line()
    launches = {}
    for masked, robust in ((False, False), (True, False), (False, True),
                           (True, True)):
        cs = mixed_check_scene(pt, masked, robust).commit(device=DEV)
        check(cs.packed.has_kinds and cs.packed.has_mask == masked,
              "the check scene is not a kind-tagged scene")
        rmask = (np.random.default_rng(1).choice(
            np.array([1, 2, 3], np.uint32), KINDS_RAYS) if masked
            else 0xFFFFFFFF)
        rays = pt.make_rays(org, d, mask=rmask, device=DEV)
        tr.reset_launch_counts()
        hit = pt.intersect(cs, rays)
        occ = pt.occluded(cs, rays)
        torch.cuda.synchronize()
        got = dict(tr.LAUNCHES)
        launches.update(got)
        check(torch.equal(occ, hit.valid), "occluded disagrees with intersect")
        inputs = sorted_inputs(tr, rays)
        for base, o, a in KIND_VARIANTS:
            name = tr.variant_name(o, a, robust, True, masked)
            check(got.get(name, 0) > 0, f"{name} was not launched")
            errs[name] = max(errs.get(name, 0.0), compare(
                tr, cs.packed, inputs, KINDS_RAYS, o, a, name, robust))
        if masked or robust:
            time_variants(tr, cs.packed, inputs, KIND_VARIANTS, record,
                          table_mb(cs.packed), card, got, robust=robust)
    say(f"  launches on the check paths: {launches}")


def phase_robust(pt, tr, sphere_mesh, errs, record):
    say("phase 7: robust mode, sphere_mesh(1024, 1024), 16,777,216 rays")
    verts, idx = sphere_mesh(*MAIN_MESH)
    s = pt.Scene(robust=True)
    s.attach(pt.TriangleGeometry(verts, idx))
    cs, _ = commit_timed(s, "triangles, robust")
    check(cs.robust and cs.packed.tri_attrs, "not a robust triangle scene")
    org, d = incoherent_rays(MAIN_RAYS, 0)
    rays = pt.make_rays(org, d, device=DEV)
    del org, d
    tr.reset_launch_counts()
    hit = pt.intersect(cs, rays, differentiable=False)
    hd = pt.intersect(cs, rays)
    occ = pt.occluded(cs, rays)
    # watertightness at card scale (tests/test_robustness.py:111-137)
    rng = np.random.default_rng(3)
    wd = rng.standard_normal((WATERTIGHT_RAYS, 3)).astype(np.float32)
    wd /= np.linalg.norm(wd, axis=1, keepdims=True)
    center = pt.make_rays(np.zeros((WATERTIGHT_RAYS, 3), np.float32), wd,
                          device=DEV)
    frac = pt.intersect(cs, center, differentiable=False).valid.double() \
        .mean().item()
    torch.cuda.synchronize()
    launches = dict(tr.LAUNCHES)
    say(f"  launches on the robust path: {launches}")
    for name, _, _ in VARIANTS:
        check(launches.get(f"{name}_robust", 0) > 0,
              f"the robust path did not launch {name}_robust")
    say(f"  watertight: {frac:.7f} of {WATERTIGHT_RAYS} rays from the "
        "center hit")
    check(frac == 1.0, "robust sphere leaked rays from its center")
    valid = hit.valid
    check(torch.equal(occ, valid) and torch.equal(hd.valid, valid),
          "robust: the entry points disagree")
    check(bool(torch.isfinite(hit.t[valid]).all())
          and bool(torch.isfinite(hit.u[valid]).all()), "robust: non-finite")
    analytic_sphere_check(rays, hit, CHECK_RAYS, MAIN_MESH)
    say(f"  intersect: {int(valid.sum())} of {MAIN_RAYS} rays hit")
    del hit, hd, occ, valid, center
    inputs = sorted_inputs(tr, rays)
    for name, o, a in VARIANTS:
        errs[f"{name}_robust"] = compare(tr, cs.packed, inputs, MAIN_COMPARE,
                                         o, a, f"{name}_robust", robust=True)
    card = card_line()
    total_ms = {
        "closest_attrs": events_ms(
            lambda: pt.intersect(cs, rays, differentiable=False)),
        "closest": events_ms(lambda: pt.intersect(cs, rays)),
        "occluded": events_ms(lambda: pt.occluded(cs, rays)),
    }
    time_variants(tr, cs.packed, inputs, VARIANTS, record,
                  table_mb(cs.packed), card, launches, robust=True,
                  total_ms=total_ms)


def prim_sphere_quads(center, radius, num_phi):
    """createQuadSphere (Embree tutorials, geometry_creation.cpp), the vertex
    layout and pole-row [a, b, d, d] quads of
    embree_tpu/tools/parity_models.py:107-162, in numpy."""
    c = np.asarray(center, np.float64)
    n_phi, n_theta = num_phi, 2 * num_phi
    phi = np.arange(n_phi + 1)[:, None] * np.pi / n_phi
    theta = np.arange(n_theta)[None, :] * 2.0 * np.pi / n_theta
    x = c[0] + radius * np.sin(phi) * np.sin(theta)
    y = (c[1] + radius * np.cos(phi)) * np.ones_like(theta)
    z = c[2] + radius * np.sin(phi) * np.cos(theta)
    pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    p, th = np.meshgrid(np.arange(1, n_phi + 1), np.arange(1, n_theta + 1),
                        indexing="ij")
    p00 = (p - 1) * n_theta + th - 1
    p01 = (p - 1) * n_theta + th % n_theta
    p10 = p * n_theta + th - 1
    p11 = p * n_theta + th % n_theta
    q = np.stack([p10, p00, p01, p11], -1)
    q[0] = np.stack([p10[0], np.full_like(p10[0], n_theta - 1), p11[0],
                     p11[0]], -1)
    q[-1] = np.stack([np.full_like(p00[-1], n_phi * n_theta), p00[-1],
                      p01[-1], p01[-1]], -1)
    return pos, q.reshape(-1, 4).astype(np.int32)


def point_sphere(center, radius, point_r, num_phi, oriented=False):
    """createPointSphere (geometry_creation.cpp), as
    embree_tpu/tools/parity_models.py:81-103 lays it out: a
    (num_phi+1) x 2*num_phi grid of points, radial normals when
    ``oriented``."""
    c = np.asarray(center, np.float64)
    n_phi, n_theta = num_phi, 2 * num_phi
    phi = np.arange(n_phi + 1)[:, None] * np.pi / n_phi
    theta = np.arange(n_theta)[None, :] * 2.0 * np.pi / n_theta
    x = c[0] + radius * np.sin(phi) * np.sin(theta)
    y = (c[1] + radius * np.cos(phi)) * np.ones_like(theta)
    z = c[2] + radius * np.sin(phi) * np.cos(theta)
    pos = np.stack([x, y, z, np.full_like(x, point_r)], -1).reshape(-1, 4)
    pos = pos.astype(np.float32)
    if not oriented:
        return pos, None
    nrm = pos[:, :3] - c.astype(np.float32)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    return pos, nrm.astype(np.float32)


def hair(rng, center, n_strands, n_seg=8, step=0.04, r0=0.004, r1=0.002):
    """Strands rooted uniformly on a unit sphere about ``center``, growing
    along the outward normal in ``step``s, radius tapering r0 -> r1: the
    vertices (n_strands * (n_seg+1), 4) and segment start indices."""
    nrm = rng.standard_normal((n_strands, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    k = np.arange(n_seg + 1)
    pts = (np.asarray(center)[None, None] + nrm[:, None]
           * (1.0 + step * k)[None, :, None])
    rad = np.broadcast_to(r0 + (r1 - r0) * k / n_seg, (n_strands, n_seg + 1))
    verts = np.concatenate([pts, rad[..., None]], -1).reshape(-1, 4)
    idx = ((n_seg + 1) * np.arange(n_strands)[:, None]
           + np.arange(n_seg)[None]).reshape(-1)
    return verts.astype(np.float32), idx.astype(np.int32)


def mixed_full_scene(pt):
    """1,574,400 prims: Embree's --quad-sphere (524,288 quads), and its
    --point-sphere, --disc-sphere and --oriented-disc-sphere (131,584 points
    each), plus 524,288 round and 131,072 flat hair segments."""
    s = pt.Scene()
    s.attach(pt.QuadGeometry(*prim_sphere_quads((0, 0, 0), 1.0, 512)))
    pos, _ = point_sphere((2.5, 0, 0), 1.0, 0.01, 256)
    s.attach(pt.PointGeometry(pos, kind="sphere"))
    pos, _ = point_sphere((-2.5, 0, 0), 1.0, 0.01, 256)
    s.attach(pt.PointGeometry(pos, kind="disc"))
    pos, nrm = point_sphere((0, 2.5, 0), 1.0, 0.01, 256, oriented=True)
    s.attach(pt.PointGeometry(pos, kind="oriented_disc", normals=nrm))
    rng = np.random.default_rng(1)
    s.attach(pt.LineSegmentsGeometry(*hair(rng, (0, -2.5, 0), 65536),
                                     kind="round"))
    s.attach(pt.LineSegmentsGeometry(*hair(rng, (0, 0, 2.5), 16384),
                                     kind="flat"))
    return s


def phase_mixed(pt, tr, errs, record):
    say("phase 8: kind tags, points, lines at full size: 1,574,400 prims, "
        "16,777,216 rays")
    from embree_tpu_torch.accel.traverse import traverse_packed
    from embree_tpu_torch.scene import _reconstruct_hits
    cs, commit_s = commit_timed(mixed_full_scene(pt), "mixed")
    check(cs.num_prims == MIXED_PRIMS, "wrong prim count")
    check(cs.packed.has_kinds
          and cs.packed.kind_classes == (0, 2, 3, 4, 5, 6),
          "the mixed scene does not carry every kind class")
    rng = np.random.default_rng(0)
    org = rng.uniform(-4, 4, (MIXED_RAYS, 3)).astype(np.float32)
    d = rng.standard_normal((MIXED_RAYS, 3), dtype=np.float32)
    rays = pt.make_rays(org, d, device=DEV)
    del org, d
    tr.reset_launch_counts()
    hit = pt.intersect(cs, rays, differentiable=False)
    hd = pt.intersect(cs, rays)
    occ = pt.occluded(cs, rays)
    torch.cuda.synchronize()
    launches = dict(tr.LAUNCHES)
    say(f"  launches on the mixed path: {launches}")
    for name, _, _ in KIND_VARIANTS:
        check(launches.get(f"{name}_kinds", 0) > 0,
              f"the mixed path did not launch {name}_kinds")
    valid = hit.valid
    check(torch.equal(occ, valid) and torch.equal(hd.valid, valid),
          "mixed: the entry points disagree")
    flat = rays.reshape(MIXED_RAYS)
    _, prim = traverse_packed(cs.packed, flat.org, flat.dir, flat.tnear,
                              flat.tfar, flat.mask)
    names = ["triangle", "quad", "sphere", "disc", "oriented_disc",
             "round_line", "flat_line"]
    bad = valid & ~(torch.isfinite(hit.t) & torch.isfinite(hit.ng).all(1))
    if bool(bad.any()):
        kb = torch.bincount(cs.prim_kind[prim[bad]].long(), minlength=7)
        say(f"  non-finite hits by kind: {dict(zip(names, kb.tolist()))}")
    check(not bool(bad.any()), "mixed: non-finite t or Ng on a hit")
    check(bool((hit.t[~valid] == math.inf).all()), "miss t is not inf")
    kinds = torch.bincount(cs.prim_kind[prim[prim >= 0]].long(),
                           minlength=7).tolist()
    per_kind = {names[k]: kinds[k] for k in range(1, 7)}
    say(f"  intersect: {int(valid.sum())} of {MIXED_RAYS} rays hit; hits by "
        f"kind {per_kind}")
    check(all(v > 0 for v in per_kind.values()), "a kind class got no hits")
    # brute force over all prims on a few rays
    sub = pt.RayBatch(*(getattr(rays, f)[:64] for f in
                        ("org", "dir", "tnear", "tfar", "time", "mask")))
    hb = pt.intersect_brute(cs, sub, chunk=1 << 15)
    check(torch.equal(hb.valid, hit.valid[:64]), "brute force: masks differ")
    m = hb.valid
    check(torch.allclose(hb.t[m], hit.t[:64][m], rtol=1e-4),
          "brute force: t differs")
    say(f"  brute force on 64 rays: masks equal ({int(m.sum())} hits), t "
        "within 1e-4")
    del hit, hd, occ, valid, hb, prim
    inputs = sorted_inputs(tr, rays)
    plain = {}
    for name, o, a in KIND_VARIANTS:
        errs[f"{name}_kinds"] = max(errs.get(f"{name}_kinds", 0.0), compare(
            tr, cs.packed, inputs, MAIN_COMPARE, o, a, f"{name}_kinds",
            plain=plain))
    card = card_line()
    # entry point = select (wrapper + kernel) + _reconstruct_hits
    select = {}

    def sel():
        select["b"] = traverse_packed(cs.packed, flat.org, flat.dir,
                                      flat.tnear, flat.tfar, flat.mask)[1]
    select_ms = events_ms(sel)
    best = select["b"]
    recon_ms = events_ms(lambda: _reconstruct_hits(cs, flat, best))
    total_ms = {
        "closest": events_ms(
            lambda: pt.intersect(cs, rays, differentiable=False)),
        "occluded": events_ms(lambda: pt.occluded(cs, rays)),
    }
    diff_ms = events_ms(lambda: pt.intersect(cs, rays))
    del best, select
    # the plain version timed on the compare sample (on all 16M rays it
    # took over two minutes of the run)
    time_variants(tr, cs.packed, inputs, KIND_VARIANTS, record,
                  table_mb(cs.packed), card, launches, total_ms=total_ms,
                  plain=plain)
    rec = record["closest_kinds"]
    rec.update(select_ms=select_ms, reconstruct_ms=recon_ms,
               differentiable_entry_ms=diff_ms, commit_s=commit_s,
               hits_by_kind=per_kind,
               wrapper_ms=select_ms - rec["ms"])
    say(f"  intersect(differentiable=False) {total_ms['closest']:.3f} ms, "
        f"intersect() {diff_ms:.3f} ms: select {select_ms:.3f} ms (kernel "
        f"{rec['ms']:.3f} + wrapper {rec['wrapper_ms']:.3f}), "
        f"_reconstruct_hits {recon_ms:.3f} ms [{card}]")
    say(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        " GB")


def ray_times(n, seed=2):
    """Ray times U[0, 1) from numpy seed ``seed``."""
    return np.random.default_rng(seed).uniform(0, 1, n).astype(np.float32)


def motion_cell(pt, tr, label, scene, n_prims, mesh, center, errs, record):
    """A full-size moving sphere: commit, the three entry points at
    16,777,216 rays with times U[0, 1), checks (entry points agree, the
    exact moving sphere, brute force), kernel vs plain version on a
    262,144-ray sample, times. ``center(time)``: the sphere's exact
    center at each time."""
    cs, commit_s = commit_timed(scene, label)
    check(cs.num_prims == n_prims, "wrong prim count")
    check(cs.has_motion and cs.packed.tri_attrs, "not a moving tri scene")
    org, d = incoherent_rays(MOTION_RAYS, 0)
    time = ray_times(MOTION_RAYS)
    rays = pt.make_rays(org, d, time=time, device=DEV)
    del org, d
    tr.reset_launch_counts()
    hit = pt.intersect(cs, rays, differentiable=False)
    hd = pt.intersect(cs, rays)
    occ = pt.occluded(cs, rays)
    torch.cuda.synchronize()
    launches = dict(tr.LAUNCHES)
    say(f"  launches on the {label} path: {launches}")
    for base, o, a in VARIANTS:
        name = tr.packed_variant(cs.packed, o, a, False)
        check(launches.get(name, 0) > 0, f"{label}: {name} was not launched")
    valid = hit.valid
    frac = valid.double().mean().item()
    check(torch.equal(occ, valid) and torch.equal(hd.valid, valid),
          f"{label}: the entry points disagree")
    check(bool(torch.isfinite(hit.t[valid]).all())
          and bool(torch.isfinite(hit.ng[valid]).all()),
          f"{label}: non-finite")
    check(bool((hit.t[~valid] == math.inf).all()), "miss t is not inf")
    # the re-intersection lerps vertices, the kernel v0/e1/e2 (ROADMAP C):
    # t agrees to 1e-5 of the larger of t and the sphere's radius
    rel = ((hd.t[valid] - hit.t[valid]).abs()
           / hit.t[valid].clamp(min=1.0))
    close = (rel <= 1e-5).double().mean().item()
    check(close >= 0.9999, f"{label}: re-intersected t differs")
    say(f"  intersect: {int(valid.sum())} of {MOTION_RAYS} rays hit "
        f"({frac:.4f}); both intersect modes and occluded agree on the hit "
        f"set; re-intersected t within 1e-5 of the kernel's on {close:.6f} "
        f"of hits (max {rel.max().item():.3e})")
    analytic_sphere_check(rays, hit, CHECK_RAYS, mesh,
                          center(rays.time[:CHECK_RAYS]))
    sub = pt.RayBatch(*(getattr(rays, f)[:256] for f in
                        ("org", "dir", "tnear", "tfar", "time", "mask")))
    hb = pt.intersect_brute(cs, sub, chunk=1 << 16)
    check(torch.equal(hb.valid, hit.valid[:256]), "brute force: masks differ")
    m = hb.valid
    check(torch.allclose(hb.t[m], hit.t[:256][m], rtol=1e-5),
          "brute force: t differs")
    say(f"  brute force on 256 rays: masks equal ({int(m.sum())} hits), t "
        "within 1e-5")
    del hit, hd, occ, valid, hb
    inputs = sorted_inputs(tr, rays)
    plain = {}
    for base, o, a in VARIANTS:
        name = tr.packed_variant(cs.packed, o, a, False)
        errs[name] = max(errs.get(name, 0.0), compare(
            tr, cs.packed, inputs, MOTION_COMPARE, o, a, name, plain=plain))
    card = card_line()
    total_ms = {
        "closest_attrs": events_ms(
            lambda: pt.intersect(cs, rays, differentiable=False)),
        "closest": events_ms(lambda: pt.intersect(cs, rays)),
        "occluded": events_ms(lambda: pt.occluded(cs, rays)),
    }
    # the plain version runs until its slowest ray is done, and a few rays
    # walk thousands of overlapping boxes: it is timed on the compare
    # sample only
    time_variants(tr, cs.packed, inputs, VARIANTS, record,
                  table_mb(cs.packed), card, launches, total_ms=total_ms,
                  plain=plain)
    for base, o, a in VARIANTS:
        record[tr.packed_variant(cs.packed, o, a, False)].update(
            commit_s=commit_s, table_mb=table_mb(cs.packed) / 1e6,
            hit_fraction=frac)
    say(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        " GB")


def phase_motion(pt, tr, sphere_mesh, errs, record):
    say("phase 10: 2-step motion, sphere_mesh(1024, 1024) moving "
        f"{MOTION_SHIFT} along x, 16,777,216 rays with times")
    verts, idx = sphere_mesh(*MAIN_MESH)
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(moving(verts, (MOTION_SHIFT, 0, 0), 2), idx))
    del verts

    def center(t):
        c = torch.zeros(t.shape + (3,), dtype=torch.float64, device=t.device)
        c[:, 0] = MOTION_SHIFT * t.double()
        return c
    motion_cell(pt, tr, "2-step motion", s, 2 * MAIN_MESH[0]
                * MAIN_MESH[1], MAIN_MESH, center, errs, record)


def phase_multistep(pt, tr, sphere_mesh, errs, record):
    say(f"phase 11: {MSTEP_STEPS}-step motion, sphere_mesh(512, 1024) "
        f"accelerating {MOTION_SHIFT} along x, split into {MSTEP_PRIMS} "
        "windowed prims, 16,777,216 rays with times")
    verts, idx = sphere_mesh(*MSTEP_MESH)
    # accelerating along x, 0.25 in all: a speed two steps cannot hold
    steps = moving(verts, (MOTION_SHIFT, 0, 0), MSTEP_STEPS)
    off = torch.as_tensor(steps[:, 0] - verts[0], dtype=torch.float64,
                          device=DEV)
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(steps, idx))
    del verts, steps

    def center(t):
        x = t.double() * (MSTEP_STEPS - 1)
        k = x.floor().clamp(0, MSTEP_STEPS - 2)
        w = (x - k)[:, None]
        return (1 - w) * off[k.long()] + w * off[k.long() + 1]
    motion_cell(pt, tr, "multi-step motion", s, MSTEP_PRIMS, MSTEP_MESH,
                center, errs, record)


def phase_motion_check(pt, tr, sphere_mesh, errs, record):
    """Every motion instantiation, and the static robust + masked triangle
    variants, against the plain version at 65,536 rays."""
    say("phase 9: kernel vs plain version, motion variants: the kind check "
        "scene with every kind moving (as is, masked, robust, robust + "
        "masked, 3 steps windowed) and a moving 16K-tri sphere (masked, "
        "robust, robust + masked; static robust + masked), 65,536 rays")
    org, d = incoherent_rays(KINDS_RAYS, 0)
    time = ray_times(KINDS_RAYS)
    rmask = np.random.default_rng(1).choice(np.array([1, 2, 3], np.uint32),
                                            KINDS_RAYS)
    card = card_line()
    verts, idx = sphere_mesh(*CHECK_MESH)
    configs = [("kinds", m, r, st) for m, r, st in
               ((False, False, 2), (True, False, 2), (False, True, 2),
                (True, True, 2), (False, False, 3))]
    configs += [("tris", m, r, st) for m, r, st in
                ((True, False, 2), (False, True, 2), (True, True, 2),
                 (True, True, 1))]
    launches = {}
    for what, masked, robust, steps in configs:
        if what == "kinds":
            s = mixed_check_scene(pt, masked, robust, steps)
            variants = KIND_VARIANTS
        else:
            s = pt.Scene(robust=robust)
            s.attach(pt.TriangleGeometry(
                moving(verts, (MOTION_SHIFT, 0, 0), steps), idx,
                mask=0x2 if masked else 0xFFFFFFFF))
            variants = VARIANTS
        cs = s.commit(device=DEV)
        check(cs.has_motion == (steps > 1)
              and cs.packed.has_win == (steps > 2)
              and cs.packed.has_mask == masked, "wrong check scene flags")
        rays = pt.make_rays(org, d, time=time,
                            mask=rmask if masked else 0xFFFFFFFF, device=DEV)
        tr.reset_launch_counts()
        hit = pt.intersect(cs, rays)
        occ = pt.occluded(cs, rays)
        if what == "tris":
            hk = pt.intersect(cs, rays, differentiable=False)
            check(torch.equal(hk.valid, hit.valid), "intersect modes differ")
        torch.cuda.synchronize()
        got = dict(tr.LAUNCHES)
        launches.update(got)
        check(torch.equal(occ, hit.valid), "occluded disagrees with intersect")
        inputs = sorted_inputs(tr, rays)
        for base, o, a in variants:
            name = tr.packed_variant(cs.packed, o, a, robust)
            check(got.get(name, 0) > 0, f"{name} was not launched")
            errs[name] = max(errs.get(name, 0.0), compare(
                tr, cs.packed, inputs, KINDS_RAYS, o, a, name, robust))
        time_variants(tr, cs.packed, inputs, variants, record,
                      table_mb(cs.packed), card, got, robust=robust)
    say(f"  launches on the motion check paths: {launches}")


def fat_curves(rng, n, step=0.15, r0=0.02, dr=0.002, wiggle=0.05):
    """The curves of tests/test_pallas_kernel.py:175-193 at a smaller
    scale: 4 Bezier CPs along a random direction from a point of [-1, 1]^3
    with a sideways wiggle, radius r0 tapering by dr per CP. Returns the
    vertices (4n, 4) and each curve's first-CP index."""
    base = rng.uniform(-1, 1, (n, 1, 3))
    d = rng.standard_normal((n, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    side = rng.standard_normal((n, 1, 3)) * wiggle
    j = np.arange(4)[None, :, None]
    xyz = base + d * step * j + side * (j % 2)
    r = np.broadcast_to(r0 - dr * j, (n, 4, 1))
    verts = np.concatenate([xyz, r], -1).reshape(-1, 4).astype(np.float32)
    return verts, (4 * np.arange(n)).astype(np.int32)


def strands(rng, n, n_cp, step, r0, r1, wiggle):
    """n random-walk strands of n_cp control points from points of
    [-1, 1]^3, radius r0 -> r1: the vertices and the first-CP index of each
    of a strand's n_cp - 3 cubic spans."""
    base = rng.uniform(-1, 1, (n, 1, 3))
    d = rng.standard_normal((n, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    k = np.arange(n_cp)[None, :, None]
    xyz = base + d * step * k + wiggle * rng.standard_normal((n, n_cp, 3))
    r = np.broadcast_to(np.linspace(r0, r1, n_cp)[None, :, None],
                        (n, n_cp, 1))
    verts = np.concatenate([xyz, r], -1).reshape(-1, 4).astype(np.float32)
    idx = (n_cp * np.arange(n))[:, None] + np.arange(n_cp - 3)[None]
    return verts, idx.reshape(-1).astype(np.int32)


def curve_check_scene(pt, masked=False, robust=False, steps=1):
    """The scene of tests/test_pallas_kernel.py:175-193 scaled up (numpy
    seed 4): 2,048 flat Bezier curves, 512 B-spline strands of 4 flat spans,
    its backdrop triangle and 32 thin B-spline strands tessellated into
    round segments; ``masked``: every second geometry has mask 0x2;
    ``steps`` > 1: every geometry moves, over that many steps."""
    rng = np.random.default_rng(4)
    n_bez, n_bsp, n_round = CURVE_CHECK
    cp, idx = fat_curves(rng, n_bez)
    sv, si = strands(rng, n_bsp, 7, 0.1, 0.02, 0.01, 0.03)
    rv, ri = strands(rng, n_round, 7, 0.1, 0.005, 0.003, 0.01)
    tv = np.array([[-3, -3, -3], [3, -3, -3], [0, 3, -3]], np.float32)
    geoms = [
        pt.CurveGeometry(moving(cp, (0, 0, 0.1), steps), idx, basis="bezier",
                         kind="flat"),
        pt.CurveGeometry(moving(sv, (0.1, 0, 0), steps), si, basis="bspline",
                         kind="flat"),
        pt.CurveGeometry(moving(rv, (0, 0.1, 0), steps), ri, basis="bspline",
                         kind="round", algorithm="tessellate"),
        pt.TriangleGeometry(moving(tv, (0, 0, 0.2), steps),
                            np.array([[0, 1, 2]], np.int32)),
    ]
    s = pt.Scene(robust=robust)
    for k, g in enumerate(geoms):
        if masked and k % 2:
            g.mask = 0x2
        s.attach(g)
    return s


def phase_curves_check(pt, tr, errs, record):
    """Every curve instantiation (B7) against the plain version at 65,536
    rays: static and 2-step x {as is, masked, robust, both}, and 3 steps
    (windows)."""
    say("phase 12: kernel vs plain version, flat curves (B7): 4,096 curves "
        "+ a triangle + 512 tessellated round segments, static, 2-step "
        "and 3-step, 65,536 rays")
    org, d = incoherent_rays(KINDS_RAYS, 0)
    time = ray_times(KINDS_RAYS)
    rmask = np.random.default_rng(1).choice(np.array([1, 2, 3], np.uint32),
                                            KINDS_RAYS)
    card = card_line()
    configs = [(m, r, st) for st in (1, 2)
               for m, r in ((False, False), (True, False), (False, True),
                            (True, True))] + [(False, False, 3)]
    launches = {}
    for masked, robust, steps in configs:
        cs = curve_check_scene(pt, masked, robust, steps).commit(device=DEV)
        p = cs.packed
        check(tr.has_curves(p) and p.nf == 16 and p.kind_classes == (0, 5, 8)
              and cs.has_motion == (steps > 1) and p.has_win == (steps > 2)
              and p.has_mask == masked, "wrong curve check scene flags")
        rays = pt.make_rays(org, d, time=time if steps > 1 else 0.0,
                            mask=rmask if masked else 0xFFFFFFFF, device=DEV)
        tr.reset_launch_counts()
        hit = pt.intersect(cs, rays)
        hk = pt.intersect(cs, rays, differentiable=False)
        occ = pt.occluded(cs, rays)
        torch.cuda.synchronize()
        got = dict(tr.LAUNCHES)
        launches.update(got)
        check(torch.equal(occ, hit.valid) and torch.equal(hk.valid, hit.valid),
              "curves: the entry points disagree")
        by_geom = torch.bincount(hit.geom_id[hit.valid], minlength=4).tolist()
        check(by_geom[0] > 0 and by_geom[1] > 0, "curves: no class-8 hits")
        inputs = sorted_inputs(tr, rays)
        plain = {}
        for base, o, a in KIND_VARIANTS:
            name = tr.packed_variant(p, o, a, robust)
            check(got.get(name, 0) > 0, f"{name} was not launched")
            errs[name] = max(errs.get(name, 0.0), compare(
                tr, p, inputs, KINDS_RAYS, o, a, name, robust, plain=plain))
        say(f"  hits by geometry (Bezier, B-spline, round strands, "
            f"triangle): {by_geom}")
        # the static as-is variants are timed in the hair cell
        if masked or robust or steps > 1:
            time_variants(tr, p, inputs, KIND_VARIANTS, record, table_mb(p),
                          card, got, robust=robust, plain=plain)
    say(f"  launches on the curve check paths: {launches}")


def hair_scene(pt, kind="flat"):
    """Embree's hair_geometry tutorial at full size: 131,072 strands of 11
    B-spline CPs (8 spans each: 1,048,576 native curves, rate 4) rooted on
    the unit sphere with hair()'s layout (numpy seed 1), radius 0.004 ->
    0.002; ``kind``: flat or round."""
    verts, _ = hair(np.random.default_rng(1), (0, 0, 0), HAIR_STRANDS,
                    n_seg=HAIR_CPS - 1)
    idx = ((HAIR_CPS * np.arange(HAIR_STRANDS))[:, None]
           + np.arange(HAIR_CPS - 3)[None]).reshape(-1).astype(np.int32)
    s = pt.Scene()
    s.attach(pt.CurveGeometry(verts, idx, basis="bspline", kind=kind))
    return s


def phase_hair(pt, tr, errs, record):
    say("phase 13: hair cell, 1,048,576 flat B-spline curves, 16,777,216 "
        "rays")
    from embree_tpu_torch.accel.traverse import traverse_packed
    from embree_tpu_torch.scene import _reconstruct_hits
    n_curves = HAIR_STRANDS * (HAIR_CPS - 3)
    cs, commit_s = commit_timed(hair_scene(pt), "hair")
    p = cs.packed
    check(cs.num_prims == n_curves and p.kind_classes == (8,)
          and p.nf == 16 and p.curve_rate == 4, "not the hair cell")
    org, d = incoherent_rays(HAIR_RAYS, 0)
    rays = pt.make_rays(org, d, device=DEV)
    del org, d
    tr.reset_launch_counts()
    hit = pt.intersect(cs, rays, differentiable=False)
    hd = pt.intersect(cs, rays)
    occ = pt.occluded(cs, rays)
    torch.cuda.synchronize()
    launches = dict(tr.LAUNCHES)
    say(f"  launches on the hair path: {launches}")
    for base, o, a in KIND_VARIANTS:
        name = tr.packed_variant(p, o, a, False)
        check(launches.get(name, 0) > 0, f"the hair path did not launch "
              f"{name}")
    valid = hit.valid
    frac = valid.double().mean().item()
    check(torch.equal(occ, valid) and torch.equal(hd.valid, valid),
          "hair: the entry points disagree")
    check(frac > 0.01, "hair: too few hits")
    check(bool(torch.isfinite(hit.t[valid]).all())
          and bool(torch.isfinite(hit.ng[valid]).all()), "hair: non-finite")
    # u along the curve, v across the ribbon: the ribbon's quad test leaves
    # its barycentrics unclamped, as the JAX package's does, so they may pass
    # their range by rounding (v = 2 V / den - 1: up to 8.8e-6 in this cell)
    u, v = hit.u[valid], hit.v[valid]
    say(f"  u in [{u.min().item():.7f}, {u.max().item():.7f}], v in "
        f"[{v.min().item():.7f}, {v.max().item():.7f}]")
    check(bool((u >= -1e-5).all()) and bool((u <= 1 + 1e-5).all())
          and bool((v.abs() <= 1 + 1e-5).all()), "hair: u/v out of range")
    del u, v
    check(bool((hit.t[~valid] == math.inf).all()), "miss t is not inf")
    say(f"  intersect: {int(valid.sum())} of {HAIR_RAYS} rays hit "
        f"({frac:.4f}); both intersect modes and occluded agree")
    sub = pt.RayBatch(*(getattr(rays, f)[:64] for f in
                        ("org", "dir", "tnear", "tfar", "time", "mask")))
    hb = pt.intersect_brute(cs, sub, chunk=1 << 13)
    check(torch.equal(hb.valid, valid[:64]), "brute force: masks differ")
    m = hb.valid
    check(torch.allclose(hb.t[m], hit.t[:64][m], rtol=1e-4),
          "brute force: t differs")
    say(f"  brute force on 64 rays: masks equal ({int(m.sum())} hits), t "
        "within 1e-4")
    del hit, hd, occ, valid, hb
    torch.cuda.empty_cache()
    inputs = sorted_inputs(tr, rays)
    plain = {}
    for base, o, a in KIND_VARIANTS:
        name = tr.packed_variant(p, o, a, False)
        errs[name] = max(errs.get(name, 0.0), compare(
            tr, p, inputs, HAIR_COMPARE, o, a, name, plain=plain))
    card = card_line()
    flat = rays.reshape(HAIR_RAYS)
    select = {}

    def sel():
        select["b"] = traverse_packed(p, flat.org, flat.dir, flat.tnear,
                                      flat.tfar, flat.mask)[1]
    select_ms = events_ms(sel)
    best = select["b"]
    recon_ms = events_ms(lambda: _reconstruct_hits(cs, flat, best))
    total_ms = {
        "closest": events_ms(
            lambda: pt.intersect(cs, rays, differentiable=False)),
        "occluded": events_ms(lambda: pt.occluded(cs, rays)),
    }
    diff_ms = events_ms(lambda: pt.intersect(cs, rays))
    del best, select
    torch.cuda.empty_cache()
    time_variants(tr, p, inputs, KIND_VARIANTS, record, table_mb(p), card,
                  launches, total_ms=total_ms, plain=plain)
    rec = record[tr.packed_variant(p, False, False, False)]
    rec.update(select_ms=select_ms, reconstruct_ms=recon_ms,
               differentiable_entry_ms=diff_ms, commit_s=commit_s,
               table_mb=table_mb(p) / 1e6, hit_fraction=frac,
               n_leaves=p.leaves.shape[0], n_nodes=p.nodes.shape[0],
               wrapper_ms=select_ms - rec["ms"])
    say(f"  intersect(differentiable=False) {total_ms['closest']:.3f} ms, "
        f"intersect() {diff_ms:.3f} ms: select {select_ms:.3f} ms (kernel "
        f"{rec['ms']:.3f} + wrapper {rec['wrapper_ms']:.3f}), "
        f"_reconstruct_hits {recon_ms:.3f} ms [{card}]")
    say(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        " GB")


@contextlib.contextmanager
def round_packed(pscene):
    """Round curves among the packed kinds while the block runs (the JAX
    package's EMBREE_TPU_KERNEL_ROUND opt-in, as its tests take it)."""
    pscene.PACKED_KINDS.add(9)
    try:
        yield
    finally:
        pscene.PACKED_KINDS.discard(9)


def round_check_scene(pt, masked=False, robust=False, steps=1):
    """phase 12's curve check scene with round curves (numpy seed 4): 2,048
    round Bezier curves, 512 round B-spline strands of 4 spans, 32 thin
    B-spline strands tessellated into round segments and the backdrop
    triangle; ``masked``: every second geometry has mask 0x2; ``steps`` > 1:
    every geometry moves, over that many steps."""
    rng = np.random.default_rng(4)
    n_bez, n_bsp, n_round = ROUND_CHECK
    cp, idx = fat_curves(rng, n_bez)
    sv, si = strands(rng, n_bsp, 7, 0.1, 0.02, 0.01, 0.03)
    rv, ri = strands(rng, n_round, 7, 0.1, 0.005, 0.003, 0.01)
    tv = np.array([[-3, -3, -3], [3, -3, -3], [0, 3, -3]], np.float32)
    geoms = [
        pt.CurveGeometry(moving(cp, (0, 0, 0.1), steps), idx, basis="bezier",
                         kind="round"),
        pt.CurveGeometry(moving(sv, (0.1, 0, 0), steps), si, basis="bspline",
                         kind="round"),
        pt.CurveGeometry(moving(rv, (0, 0.1, 0), steps), ri, basis="bspline",
                         kind="round", algorithm="tessellate"),
        pt.TriangleGeometry(moving(tv, (0, 0, 0.2), steps),
                            np.array([[0, 1, 2]], np.int32)),
    ]
    s = pt.Scene(robust=robust)
    for k, g in enumerate(geoms):
        if masked and k % 2:
            g.mask = 0x2
        s.attach(g)
    return s


def phase_round_check(pt, tr, errs, record):
    """Every curve instantiation on round slots (B8) against the plain
    version at 65,536 rays: static and 2-step x {as is, masked, robust,
    both}, and 3 steps (windows)."""
    from embree_tpu_torch import scene as pscene
    say("phase 14: kernel vs plain version, round curves (B8): 2,560 round "
        "curves + 512 tessellated round segments + a triangle, static, "
        "2-step and 3-step, 65,536 rays")
    org, d = incoherent_rays(KINDS_RAYS, 0)
    time = ray_times(KINDS_RAYS)
    rmask = np.random.default_rng(1).choice(np.array([1, 2, 3], np.uint32),
                                            KINDS_RAYS)
    card = card_line()
    configs = [(m, r, st) for st in (1, 2)
               for m, r in ((False, False), (True, False), (False, True),
                            (True, True))] + [(False, False, 3)]
    launches = {}
    for masked, robust, steps in configs:
        with round_packed(pscene):
            cs = round_check_scene(pt, masked, robust, steps).commit(
                device=DEV)
        p = cs.packed
        check(p is not None and p.nf == 16 and p.kind_classes == (0, 5, 9)
              and cs.has_motion == (steps > 1) and p.has_win == (steps > 2)
              and p.has_mask == masked, "wrong round check scene flags")
        rays = pt.make_rays(org, d, time=time if steps > 1 else 0.0,
                            mask=rmask if masked else 0xFFFFFFFF, device=DEV)
        tr.reset_launch_counts()
        hit = pt.intersect(cs, rays)
        hk = pt.intersect(cs, rays, differentiable=False)
        occ = pt.occluded(cs, rays)
        torch.cuda.synchronize()
        got = dict(tr.LAUNCHES)
        launches.update(got)
        check(torch.equal(occ, hit.valid) and torch.equal(hk.valid, hit.valid),
              "round: the entry points disagree")
        by_geom = torch.bincount(hit.geom_id[hit.valid], minlength=4).tolist()
        check(by_geom[0] > 0 and by_geom[1] > 0, "round: no class-9 hits")
        inputs = sorted_inputs(tr, rays)
        plain = {}
        for base, o, a in KIND_VARIANTS:
            name = tr.packed_variant(p, o, a, robust)
            check(got.get(name, 0) > 0, f"{name} was not launched")
            errs[name] = max(errs.get(name, 0.0), compare(
                tr, p, inputs, KINDS_RAYS, o, a, name, robust, plain=plain))
        say(f"  hits by geometry (Bezier, B-spline, round strands, "
            f"triangle): {by_geom}")
        # the static as-is variants are timed in the round hair cell
        if masked or robust or steps > 1:
            time_variants(tr, p, inputs, KIND_VARIANTS, record, table_mb(p),
                          card, got, robust=robust, plain=plain)
    say(f"  launches on the round check paths: {launches}")


def host_ms(fn):
    """Host clock around fn() and a device synchronize, in ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_round_hair(pt, tr, errs, record):
    """The round hair cell: the generic engine on 1,048,576 rays, the
    kernel route (B8) on 16,777,216, and the two against each other."""
    from embree_tpu_torch import scene as pscene
    from embree_tpu_torch.accel import traverse_generic as tg
    say("phase 15: round hair cell, 1,048,576 native round B-spline curves: "
        "the generic engine on 1,048,576 rays, the kernel (B8) on "
        "16,777,216")
    n_curves = HAIR_STRANDS * (HAIR_CPS - 3)
    scene = hair_scene(pt, kind="round")
    cs, commit_s = commit_timed(scene, "round hair, generic route")
    check(cs.num_prims == n_curves and cs.packed is None
          and cs.kinds_present == (9,) and cs.leaf_obb_rot.shape[0] > 0,
          "not the round hair cell on the generic route")
    org, d = incoherent_rays(HAIR_RAYS, 0)
    rays = pt.make_rays(org, d, device=DEV)
    del org, d
    sub = pt.RayBatch(*(getattr(rays, f)[:ENGINE_RAYS] for f in
                        ("org", "dir", "tnear", "tfar", "time", "mask")))
    card = card_line()
    # ---- the generic engine: the scene's default route ----
    tr.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    sel_ms, res = host_ms(lambda: tg.traverse(
        cs.bvh, pscene._make_prim_test(cs, sub), sub.org, sub.dir, sub.tnear,
        sub.tfar, max_leaf_size=pscene.LEAF_SIZE,
        leaf_obb=pscene._scene_leaf_obb(cs)))
    check(res.overflow == 0, "engine: stack overflow")
    diff_ms, he = host_ms(lambda: pt.intersect(cs, sub))
    fast_ms, hf = host_ms(lambda: pt.intersect(cs, sub,
                                               differentiable=False))
    occ_ms, oe = host_ms(lambda: pt.occluded(cs, sub))
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(not tr.LAUNCHES, "the generic route launched the kernel")
    valid = he.valid
    check(torch.equal(valid, hf.valid) and torch.equal(oe, valid)
          and torch.equal(res.best_prim.long() >= 0, valid),
          "engine: the entry points disagree")
    check(bool(torch.isfinite(he.t[valid]).all())
          and bool(torch.isfinite(he.ng[valid]).all()), "engine: non-finite")
    check(bool((he.t[~valid] == math.inf).all()), "miss t is not inf")
    frac = valid.double().mean().item()
    say(f"  engine: {int(valid.sum())} of {ENGINE_RAYS} rays hit ({frac:.4f});"
        f" {res.steps} lockstep steps, select {sel_ms:.1f} ms, intersect() "
        f"{diff_ms:.1f} ms, intersect(differentiable=False) {fast_ms:.1f} ms, "
        f"occluded {occ_ms:.1f} ms, peak device memory {peak:.3f} GB [{card}]")
    hb_rays = pt.RayBatch(*(getattr(sub, f)[:32] for f in
                            ("org", "dir", "tnear", "tfar", "time", "mask")))
    hb = pt.intersect_brute(cs, hb_rays, chunk=1 << 13)
    check(torch.equal(hb.valid, valid[:32]), "brute force: masks differ")
    m = hb.valid
    check(torch.allclose(hb.t[m], he.t[:32][m], rtol=1e-4),
          "brute force: t differs")
    say(f"  brute force on 32 rays: masks equal ({int(m.sum())} hits), t "
        "within 1e-4")
    engine = dict(n_rays=ENGINE_RAYS, steps=res.steps, select_ms=sel_ms,
                  intersect_ms=diff_ms, intersect_fast_ms=fast_ms,
                  occluded_ms=occ_ms, peak_gb=peak, commit_s=commit_s,
                  hit_fraction=frac, card=card)
    e_valid, e_t = valid.clone(), he.t.clone()
    del res, he, hf, oe, hb, valid
    del cs
    torch.cuda.empty_cache()

    # ---- the kernel route: round curves packed (B8) ----
    with round_packed(pscene):
        cs, commit_k = commit_timed(scene, "round hair, kernel route")
    p = cs.packed
    check(p is not None and p.kind_classes == (9,) and p.nf == 16,
          "not the round hair cell on the kernel route")
    tr.reset_launch_counts()
    hit = pt.intersect(cs, rays, differentiable=False)
    hd = pt.intersect(cs, rays)
    occ = pt.occluded(cs, rays)
    torch.cuda.synchronize()
    launches = dict(tr.LAUNCHES)
    say(f"  launches on the round hair path: {launches}")
    for base, o, a in KIND_VARIANTS:
        name = tr.packed_variant(p, o, a, False)
        check(launches.get(name, 0) > 0, f"the round hair path did not "
              f"launch {name}")
    valid = hit.valid
    check(torch.equal(occ, valid) and torch.equal(hd.valid, valid),
          "round hair: the entry points disagree")
    check(bool(torch.isfinite(hit.t[valid]).all())
          and bool(torch.isfinite(hit.ng[valid]).all()), "round hair: "
          "non-finite")
    k_valid = valid[:ENGINE_RAYS]
    agree = (k_valid == e_valid).double().mean().item()
    both = k_valid & e_valid
    rel = ((hit.t[:ENGINE_RAYS][both] - e_t[both]).abs()
           / e_t[both].clamp(min=1e-3))
    close = (rel < 0.01).double().mean().item()
    say(f"  kernel: {int(valid.sum())} of {HAIR_RAYS} rays hit; on the "
        f"engine's {ENGINE_RAYS} rays hit masks agree on {agree:.6f}, t "
        f"within 1% on {close:.6f} of {int(both.sum())} rays both hit")
    check(agree >= 0.97 and close >= 0.95,
          "B8 and the engine disagree beyond the reference's bounds")
    engine.update(kernel_agree=agree, kernel_t_close=close)
    del hit, hd, occ, valid
    torch.cuda.empty_cache()
    inputs = sorted_inputs(tr, rays)
    plain = {}
    for base, o, a in KIND_VARIANTS:
        name = tr.packed_variant(p, o, a, False)
        errs[name] = max(errs.get(name, 0.0), compare(
            tr, p, inputs, ROUND_COMPARE, o, a, name, plain=plain))
    flat = rays.reshape(HAIR_RAYS)
    total_ms = {
        "closest": events_ms(
            lambda: pt.intersect(cs, rays, differentiable=False), reps=3),
        "occluded": events_ms(lambda: pt.occluded(cs, rays), reps=3),
    }
    torch.cuda.empty_cache()
    time_variants(tr, p, inputs, KIND_VARIANTS, record, table_mb(p), card,
                  launches, total_ms=total_ms, plain=plain)
    rec = record[tr.packed_variant(p, False, False, False)]
    rec.update(commit_s=commit_k, table_mb=table_mb(p) / 1e6, engine=engine,
               n_leaves=p.leaves.shape[0], n_nodes=p.nodes.shape[0])
    del flat
    say(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        " GB")


def phase_engine_vs_kernel(pt, tr):
    """The engine against the kernel on the kind check scene. Its launches
    are checked here and not reported: the kernels line counts each variant
    on the path that timed it."""
    say("phase 16: the generic engine vs the kernel, the kind check scene "
        "(test_pallas_kernel.py:69-93), 65,536 rays")
    org, d = incoherent_rays(KINDS_RAYS, 0)
    cs = mixed_check_scene(pt).commit(device=DEV)
    rays = pt.make_rays(org, d, device=DEV)
    tr.reset_launch_counts()
    hk = pt.intersect(cs, rays)
    torch.cuda.synchronize()
    check(tr.LAUNCHES.get("closest_kinds", 0) > 0,
          "the kernel was not launched")
    tr.reset_launch_counts()
    hj = pt.intersect(cs, rays, backend="jnp")
    oj = pt.occluded(cs, rays, backend="jnp")
    torch.cuda.synchronize()
    check(not tr.LAUNCHES, "backend='jnp' launched the kernel")
    check(torch.equal(hk.valid, hj.valid) and torch.equal(oj, hj.valid),
          "engine and kernel: hit masks differ")
    m = hk.valid
    differ = m & ((hk.prim_id != hj.prim_id) | (hk.geom_id != hj.geom_id))
    ties = ((hk.t[differ] - hj.t[differ]).abs()
            <= 1e-4 * hj.t[differ].abs().clamp(min=1.0))
    check(bool(ties.all()), "engine and kernel: prims differ off near-ties")
    rel = ((hk.t[m] - hj.t[m]).abs() / hj.t[m].abs().clamp(min=1.0)).max()
    say(f"  {int(m.sum())} hits: masks equal, prim ids equal but "
        f"{int(differ.sum())} near-ties, max |dt|/t {rel.item():.3e}")


def phase_mixed_goldens(pt):
    from embree_tpu_torch.models.camera import Camera
    from embree_tpu_torch.models.viewer import render
    from embree_tpu_torch.tools.viewer import build_scene
    from embree_tpu_torch.utils.image import compare_images, load_pfm
    say("phase 17: viewer, the mixed scene (generic engine) at 96x96 vs "
        "tests/golden")
    scene, eye = build_scene("mixed", pt)
    cs = scene.commit(device=DEV)
    check(cs.packed is None, "the mixed scene has a packed table")
    cam = Camera(from_point=np.asarray(eye, np.float32),
                 to_point=np.zeros(3, np.float32),
                 up=np.array([0, 1, 0], np.float32))
    for sh in ("eyelight", "primID", "uv"):
        img = render(cs, cam, VIEW, VIEW, shader=sh).cpu().numpy()
        check(img.shape == (VIEW, VIEW, 3) and np.isfinite(img).all(),
              f"mixed/{sh}: bad image")
        ref = load_pfm(os.path.join(ROOT, "tests", "golden",
                                    f"mixed_{sh}.pfm"))
        wrong = compare_images(img, ref)
        say(f"  mixed/{sh}: {wrong} wrong px")
        check(wrong <= 10, f"mixed/{sh}: {wrong} wrong pixels")


def ablate_bound(unit, flags, node_v, leaf_v, n_rays, tabs):
    """Least time of one ablation variant on this run's data: the larger of
    the bytes it must move (each record table it reads once, each ray's
    inputs once, its outputs once) over the memory rate and its operations
    (this run's node and leaf visits times each enabled phase's count) over
    the fp32 rate. Also the time of the bytes its record reads come to,
    visit by visit (node visits x 128 B + leaf visits x 288 or 192 B)."""
    f_node, f_leaf, m_node, m_leaf, sort = flags
    nbytes = (4 * (tabs.nodes.numel() * f_node + tabs.leaves.numel() * f_leaf)
              + n_rays * (RAY_IN_BYTES + 16))
    node_ops = ((ABLATE_SLAB_OPS if m_node == "slab" else
                 ABLATE_REFS_OPS if m_node == "refs" else 0)
                + (ABLATE_SORT_OPS if sort and m_node != "none" else 0))
    leaf_ops = ABLATE_SLOTS[unit] * ABLATE_SLOT_OPS[unit] if m_leaf else 0
    ops = node_v * node_ops + leaf_v * leaf_ops
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    visit_bytes = (node_v * 128 * f_node
                   + leaf_v * ABLATE_LEAF_BYTES[unit] * f_leaf)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", visit_bytes / PEAK_BYTES_PER_S * 1e3)


def ptxas_info(ptxas, entry):
    """Registers, stack frame (its local memory) and spill bytes of each
    kernel instantiation in a build's ptxas lines whose entry name matches
    ``entry``, a pattern with two groups (a name, the template's int
    argument), keyed (name, int)."""
    out, cur = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            m = re.search(entry, m.group(1))
            cur = (m.group(1), int(m.group(2))) if m else None
            if cur is not None:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                            spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            cur = None
    return out


def b1_on(tr, packed, rays, card):
    """B1 closest on the ablation's rays: (ms, its record: ms, ray steps
    at nodes and leaves, the most steps of a ray)."""
    ms = events_ms(lambda: tr.traverse_kernel(packed, *rays))
    v = tr.traverse_kernel(packed, *rays).visits
    rec = dict(ms=ms, node_visits=int(v[0].sum(dtype=torch.int64)),
               leaf_visits=int(v[1].sum(dtype=torch.int64)),
               max_steps=int((v[0] + v[1]).max()), card=card)
    say(f"  B1 closest on the same rays: {ms:.3f} ms, "
        f"{rec['node_visits']} node + {rec['leaf_visits']} leaf steps, "
        f"max {rec['max_steps']} [{card}]")
    return ms, rec


def phase_ablations(pt, tr, record, regs):
    """The two traversal ablations (perf/) at the harnesses' size, the v7
    variants again on the main cell; ``regs``: ptxas_info of the
    ablation kernels."""
    from embree_tpu_torch.perf import ablate_v7 as v7
    from embree_tpu_torch.perf import device, harness, scenes, tables
    from embree_tpu_torch.perf import kernel_ablate as v5
    say("phase 18: traversal ablations (perf/ablate_v7.py, "
        "perf/kernel_ablate.py): 16K-tri sphere, 1,048,576 sorted rays")
    card = card_line()
    cs = scenes.sphere_scene(device=DEV)
    tabs = {"v7": tables.v7_tables(cs.packed).to(DEV),
            "v5": tables.pack_v5(cs).to(DEV)}
    for unit, t in tabs.items():
        say(f"  {unit} tables: {t.n_node_tiles} node tiles, "
            f"{t.n_leaf_tiles} leaf tiles, {t.table_bytes / 1e6:.3f} MB")
    rays = scenes.harness_rays(device=DEV)
    n = rays[0].shape[0]
    b1_check_ms, b1_check = b1_on(tr, cs.packed, rays, card)
    record["ablate_b1"] = dict(check_cell=b1_check)

    # ---- the harnesses' main loops (each variant: a warm-up and 5 timed
    # calls), launch counts zeroed just before, read just after ----
    device.reset_launch_counts()
    runs = {"v7": v7.run_variants(tabs["v7"], rays),
            "v5": v5.run_variants(tabs["v5"], rays)}
    torch.cuda.synchronize()
    launches = dict(device.LAUNCHES)
    say(f"  launches on the ablation path: {launches}")
    for unit, recs in runs.items():
        for rec in recs:
            check(launches.get(rec["kernel"], 0) > 0,
                  f"{rec['kernel']}: no launch on its path")

    # ---- kernel vs plain version on every 16th ray ----
    k = n // ABLATE_COMPARE
    sample = [x[::k][:ABLATE_COMPARE].contiguous() for x in rays]
    mods = {"v7": v7, "v5": v5}
    plain = {}
    for unit, mod in mods.items():
        for name, kw in mod.VARIANTS:
            kw = dict(kw)
            args = (kw.pop("UGRP"),) if unit == "v5" else ()
            a = mod.traverse_kernel(tabs[unit], *sample, *args, **kw)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            b = mod.traverse_plain(tabs[unit], *sample, *args, **kw)
            e1.record()
            torch.cuda.synchronize()
            plain[(unit, name)] = e0.elapsed_time(e1)
            label = f"{unit} {name}"
            check(torch.equal(a.t.view(torch.int32), b.t.view(torch.int32)),
                  f"{label}: t bits differ")
            check(torch.equal(a.best, b.best), f"{label}: ids differ")
            check(torch.equal(a.steps[:, 0], b.steps[:, 0]),
                  f"{label}: step row differs")
            check(torch.equal(a.visits, b.visits),
                  f"{label}: ray steps differ")
            say(f"  {label}: {ABLATE_COMPARE} rays, "
                f"{int((a.best >= 0).sum())} hits, kernel == plain (t bits, "
                f"ids, steps); plain {plain[(unit, name)]:.1f} ms")

    # ---- the full variants against B1 on the same rays ----
    b1 = tr.traverse_kernel(cs.packed, *sample)
    pid = cs.packed.pid_map
    b1_prim = torch.where(b1.best >= 0, pid[b1.best.clamp(min=0).long()], -1)
    a7 = v7.traverse_kernel(tabs["v7"], *sample, max_steps=harness.MAX_STEPS)
    check(int(a7.visits.sum(0).max()) < harness.MAX_STEPS,
          "v7 did not finish")
    slot = a7.best.reshape(-1)[:ABLATE_COMPARE].long()
    p7 = torch.where(slot >= 0, tabs["v7"].pid_map[slot.clamp(min=0)], -1)
    a5 = v5.traverse_kernel(tabs["v5"], *sample, 16)
    for unit, t, prim in (("v7", a7.t, p7),
                          ("v5", a5.t, a5.best.reshape(-1)[:ABLATE_COMPARE])):
        t = t.reshape(-1)[:ABLATE_COMPARE]
        hit = b1_prim >= 0
        check(torch.equal(prim >= 0, hit), f"{unit} full vs B1: hit masks")
        rel = ((t[hit] - b1.t[hit]).abs() / b1.t[hit].abs().clamp(min=1e-30))
        same = (prim[hit] == b1_prim[hit]).double().mean().item()
        exact = int((t.view(torch.int32) == b1.t.view(torch.int32)).sum())
        say(f"  {unit} full vs B1: masks equal ({int(hit.sum())} hits), max "
            f"|dt|/t {rel.max().item():.3e}, prim ids equal on {same:.6f}, "
            f"t bit-equal on {exact} of {ABLATE_COMPARE}")
        check(rel.max().item() <= 1e-4, f"{unit} full vs B1: t differs")
        check(same > 0.99, f"{unit} full vs B1: prim ids differ")
        record.setdefault("ablate_vs_b1", {})[unit] = dict(
            rays=ABLATE_COMPARE, hits=int(hit.sum()),
            max_rel_dt=rel.max().item(), prim_equal=same, t_bit_equal=exact)

    # ---- records: time, launches, bound, plain time ----
    for unit, recs in runs.items():
        for rec in recs:
            fl = rec["flags"]
            if unit == "v7":
                flags = (fl["f_node"], fl["f_leaf"],
                         "slab" if fl["m_node"] else "refs", fl["m_leaf"],
                         fl["sort"])
            else:
                flags = (fl["do_fetch"], fl["do_fetch"],
                         "slab" if fl["do_node"] else "none", fl["do_leaf"],
                         fl["do_sort"])
            bound, by, visit_ms = ablate_bound(unit, flags, rec["node_visits"],
                                               rec["leaf_visits"], n,
                                               tabs[unit])
            rec.update(unit=unit, plain_ms=plain[(unit, rec["name"])],
                       registers=regs.get((unit, rec["flag_bits"]),
                                              {}).get("registers"),
                       b1_ms=b1_check_ms,
                       plain_rays=ABLATE_COMPARE, n_rays=n, bound_ms=bound,
                       bound_by=by, visit_bytes_ms=visit_ms, card=card,
                       launches=launches[rec["kernel"]])
            key = f"ablate_{unit}_{rec['name'].replace(' ', '_')}"
            record[key] = rec
            say(f"  {key}: {rec['ms']:.3f} ms, {rec['registers']} "
                f"registers, bound {bound:.4f} ms ({by}), "
                f"record reads {visit_ms:.4f} ms, plain {rec['plain_ms']:.1f}"
                f" ms on {ABLATE_COMPARE} rays, {rec['launches']} launches "
                f"[{card}]")
    del cs, tabs, rays, sample
    torch.cuda.empty_cache()

    # ---- the v7 variants on the main cell, beside B1 ----
    say("  v7 on the main cell: sphere_mesh(1024, 1024), 16,777,216 sorted "
        "rays")
    cs = scenes.sphere_scene(*MAIN_MESH, device=DEV)
    t7 = tables.v7_tables(cs.packed).to(DEV)
    rays = scenes.harness_rays(MAIN_RAYS, device=DEV)
    b1_ms, record["ablate_b1"]["main_cell"] = b1_on(tr, cs.packed, rays,
                                                    card)
    main_cell = v7.run_variants(t7, rays)
    for rec in main_cell:
        rec.update(card=card, b1_ms=b1_ms, n_rays=MAIN_RAYS)
    record["ablate_v7_main_cell"] = dict(b1_ms=b1_ms, card=card,
                                         table_mb=t7.table_bytes / 1e6,
                                         variants=main_cell)
    del cs, t7, rays
    torch.cuda.empty_cache()


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def phase_micro(record, ptx):
    """The three loop probes at their harnesses' size: every kernel held
    bit for bit against its plain version, then each timed through its
    entry point at the harness's ITERS on the harness's x; ``ptx``:
    ptxas_info of the probe kernels, keyed (unit, probe id)."""
    from embree_tpu_torch.perf import device, micro, micro_expand, micro_ops
    from embree_tpu_torch.perf import micro_v8
    mods = (micro_ops, micro_expand, micro_v8)
    say("phase 19: loop probes (perf/micro_ops.py, perf/micro_expand.py, "
        "perf/micro_v8.py): 14 + 12 + 19 probes")
    card = card_line()
    clock = sm_clock_hz()
    say(f"  SM clock (max) {clock / 1e6:.0f} MHz [{card}]")

    # ---- kernel vs plain version, both inputs ----
    plain_ms = {}
    for mod in mods:
        h = mod.HARNESS
        xs = {"harness": micro.harness_x(h, DEV),
              "distinct": micro.distinct_x(h, DEV)}
        counts = MICRO_CHECK_ITERS + (
            (MICRO_LONG_ITERS,) if h.rows_acc == 8 else ())
        for p in mod.PROBES:
            for tag, x in xs.items():
                for iters in counts:
                    k = micro.launch(h, p, x, iters)
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    q = micro.run_plain(p.body, x, iters, h.rows_acc)
                    e1.record()
                    torch.cuda.synchronize()
                    if (tag, iters) == ("harness", MICRO_PLAIN_ITERS):
                        plain_ms[(h.unit, p.name)] = e0.elapsed_time(e1)
                    check(torch.equal(k, q), f"{h.unit}:{p.name}: kernel "
                          f"!= plain on the {tag} x at {iters} iterations")
        say(f"  {h.unit}: {len(mod.PROBES)} kernels == plain (int32 bits) "
            f"on both inputs at {', '.join(map(str, counts))} iterations")

    # ---- the harnesses' loops (each probe: a warm-up, then 5 timed
    # windows of 5 launches), launch counts zeroed just before, read just
    # after ----
    device.reset_launch_counts()
    timed = {}
    for mod in mods:
        h = mod.HARNESS
        x = micro.harness_x(h, DEV)
        for p in mod.PROBES:
            timed[(h.unit, p.name)], _ = device.time_call(
                lambda: mod.run(p.name, x, h.iters))
    torch.cuda.synchronize()
    launches = dict(device.LAUNCHES)

    # ---- records ----
    for mod in mods:
        h = mod.HARNESS
        x = micro.harness_x(h, DEV)
        base_ns = timed[(h.unit, mod.PROBES[0].name)] * 1e6 / h.iters
        for p in mod.PROBES:
            key = f"{h.unit}:{p.name}"
            ms = timed[(h.unit, p.name)]
            ns = ms * 1e6 / h.iters
            cost = micro.cost_of(p, x, h.iters)
            bound, by = micro.bound_ms(cost, h.iters, clock)
            ptxas = ptx.get((h.unit, p.kid), {})
            rec = dict(unit=h.unit, probe=p.name, kid=p.kid, ms=ms,
                       iters=h.iters, ns_per_iter=ns,
                       ns_over_base=ns - base_ns,
                       launches=launches.get(key, 0), bound_ms=bound,
                       bound_by=by, cost=cost._asdict(),
                       sm_clock_mhz=clock / 1e6,
                       plain_ms=plain_ms[(h.unit, p.name)],
                       plain_iters=MICRO_PLAIN_ITERS, card=card, **ptxas)
            record.setdefault("micro", {})[key] = rec
            say(f"  {key}: {ms:.4f} ms, {ns:.2f} ns/iter (+{ns - base_ns:.2f}"
                f" over base), bound {bound:.4f} ms ({by}), "
                f"{rec['launches']} launches, {ptxas.get('registers')} "
                f"registers, {ptxas.get('stack')} B stack (local memory); "
                f"plain {rec['plain_ms']:.1f} ms "
                f"at {MICRO_PLAIN_ITERS} iterations [{card}]")
            check(rec["launches"] > 0, f"{key}: no launch on its path")
            check("registers" in ptxas, f"{key}: no ptxas line")
            check(ms >= bound, f"{key}: {ms:.4f} ms is below its bound "
                  f"{bound:.4f} ms: the loop was folded away")


def kernel_entries(record, errs):
    """One entry of the kernels line per timed variant, with the launches
    of the path that timed it."""
    kernels = []
    for name, rec in record.items():
        if name in ("ablate_v7_main_cell", "ablate_vs_b1", "ablate_b1"):
            continue
        if name == "micro":
            for key, r in rec.items():
                kernels.append({
                    "name": key, "route": "cuda",
                    "source": f"embree_tpu_torch/csrc/{r['unit']}.cu",
                    "replaces": MICRO_REPLACES[r["unit"]],
                    "launches": r["launches"], "max_abs_err": 0.0,
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": None})
            continue
        if name.startswith("ablate_"):
            unit = rec["unit"]
            kernels.append({
                "name": name, "route": "cuda",
                "source": ABLATE_SOURCES[unit],
                "replaces": ABLATE_REPLACES[unit],
                "launches": rec["launches"], "max_abs_err": 0.0,
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": None, "kernel": rec["kernel"]})
            continue
        family = ("curves_round" if "curves_round" in name else
                  "curves" if "curves" in name else
                  "motion_win" if "motion_win" in name else
                  "motion" if "motion" in name else
                  "kinds" if "kinds" in name else
                  "robust" if "robust" in name else
                  "masked" if "masked" in name else "")
        kernels.append({
            "name": f"traverse_{name}", "route": "cuda",
            "source": (ROUND_SOURCE if family == "curves_round" else
                       CURVE_SOURCE if family == "curves" else SOURCE),
            "replaces": REPLACES[family], "launches": rec["launches"],
            "max_abs_err": errs[name], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    return kernels


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import embree_tpu_torch as pt
    from embree_tpu_torch import _build
    from embree_tpu_torch.accel import traverse as tr
    from embree_tpu_torch.tools.viewer import sphere_mesh

    t_start = time.perf_counter()
    card = card_line()
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    say("phase 2: build")
    secs = _build.build_all(["traverse_cuda", "ablate_cuda", "micro_cuda",
                             "bvh_builder"])
    say(f"  built in {secs:.2f} s")
    ptxas = _build.BUILD_LOGS.get("traverse_cuda", "")
    for line in ptxas.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            say("  ptxas: " + line.strip())
    ptxas_ablate = _build.BUILD_LOGS.get("ablate_cuda", "")
    for line in ptxas_ablate.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            say("  ptxas (ablate): " + line.strip())
    ptxas_micro = _build.BUILD_LOGS.get("micro_cuda", "")
    units = {"Ops": "micro_ops", "Expand": "micro_expand", "V8": "micro_v8"}
    micro_ptx = {(units[u], k): v for (u, k), v in ptxas_info(
        ptxas_micro, r"(Ops|Expand|V8)ELi(\d+)E").items()}
    for (unit, kid), info in sorted(micro_ptx.items()):
        say(f"  ptxas (micro): {unit} probe {kid}: {info.get('registers')} "
            f"registers, {info.get('stack')} B stack frame (local memory), "
            f"spill {info.get('spill_st')} / {info.get('spill_ld')} B")

    errs = {name: 0.0 for name, _, _ in VARIANTS}
    phase_kernel_check(pt, tr, sphere_mesh, errs)
    record = {}
    phase_main(pt, tr, sphere_mesh, errs, record)
    phase_viewer(pt, tr)
    phase_kinds_check(pt, tr, errs, record)
    phase_robust(pt, tr, sphere_mesh, errs, record)
    phase_mixed(pt, tr, errs, record)
    phase_motion_check(pt, tr, sphere_mesh, errs, record)
    phase_motion(pt, tr, sphere_mesh, errs, record)
    phase_multistep(pt, tr, sphere_mesh, errs, record)
    phase_curves_check(pt, tr, errs, record)
    phase_hair(pt, tr, errs, record)
    phase_round_check(pt, tr, errs, record)
    phase_round_hair(pt, tr, errs, record)
    phase_engine_vs_kernel(pt, tr)
    phase_mixed_goldens(pt)
    phase_ablations(pt, tr, record,
                    ptxas_info(ptxas_ablate, r"(v[57])_kernelILi(\d+)E"))
    phase_micro(record, micro_ptx)

    kernels = kernel_entries(record, errs)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "detail": record,
                   "ptxas": ptxas, "ptxas_ablate": ptxas_ablate,
                   "ptxas_micro": ptxas_micro}, f,
                  indent=1)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    # the run drives one card
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
