"""Smoke run of embree_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Drives the port's main path through its public entry points and holds the
Hopper traversal kernel against its plain PyTorch version:

1. the card: name and power limit from nvidia-smi;
2. build the kernel (nvcc, sm_90a: its three sources compile in parallel
   and link into one library), the ablation kernels (two more nvcc
   processes, one library), the loop-probe kernels (three more, one
   library) and the native BVH builder (g++) from the sources in this
   checkout, one compiler process each, in parallel; print each
   instantiation's registers, spills and stack; the library holds 72
   instantiations, every one persistent_kernel and none of the retired
   one-ray-per-thread traverse_kernel (the 20 moving variants of B6, the
   32 curve variants of B7 and B8, static and moving, and the 20 static
   triangle, robust-triangle and mixed-class variants of B1-B5), and they
   must use no local memory (0 B stack frame, no spill) and all but B6's
   mixed-class ones at most 128 registers; and no function of its SASS
   reads or overwrites a register before the wait on the load that
   writes it (perf/sass_hazards.py: fault C.2, a pop that read the next
   record before its shared-memory load landed); the ablation library
   holds v7's 11 and v5's 7 instantiations, and the loop-probe library
   micro_ops' 14, micro_expand's 12 and its row-min form of the masked
   min, and micro_v8's 19, every one a probe_kernel (micro.cuh's block; no function of the first design's
   loop_kernel is left), each with no local memory and no such hazard
   either;
3. kernel vs plain version on the 16K-triangle sphere with 1M incoherent
   rays (and on a masked copy of it): every variant, 65,536 of the rays,
   everything bit-equal, no stack overflow, and the 1M-ray launch's
   outputs on those rays (its warps refill) held against the same plain
   run, bit for bit; each launch finishes every ray once;
4. the main path at full size: the 2,097,152-triangle sphere committed by the
   port, 16,777,216 incoherent rays through both intersect modes and
   occluded; a brute-force check on a few rays; kernel vs plain version
   on 262,144 of the rays, and the full-size launches' outputs on those
   rays (their warps refill) held against the same plain run, bit for
   bit; kernel and wrapper times (CUDA events, median of 5 after a
   warm-up), the plain version's time on the compared rays, and the
   counts of phase 6 (useful lane-steps, node/leaf split, item rounds);
   then the same sphere with geometry mask 0x2 and random ray masks, to time
   the masked variants at full size, with the same checks;
5. the viewer: cube and sphere x eyelight/primID/uv at 96x96 through the
   default differentiable path, each within 10 wrong pixels of
   tests/golden/*.pfm;
6. kernel vs plain version for kind tags, points and lines (B3-B5): the
   scene of tests/test_pallas_kernel.py:69-93 with 65,536 rays, as is, with
   half its geometries masked, in robust mode, and both; closest and
   occluded bit-equal with their step counts, no stack overflow; each
   launch of the persistent warps finishes every ray once; each variant's
   time, useful lane-steps beside one ray per thread's, registers, rays
   finished, warps per SM and the split into node and leaf passes (and
   the leaf passes' item rounds);
7. robust mode (B2) at full size: the 2,097,152-triangle sphere committed
   with robust=True, 16,777,216 rays through both intersect modes and
   occluded; 1,048,576 rays from the center must all hit (watertight);
   kernel vs plain version on 262,144 of the rays, and the full-size
   launches' outputs on those rays (their warps refill) held against the
   same plain run, bit for bit, with the counts of phase 6;
8. kind tags, points and lines at full size: 1,574,400 prims made by
   Embree's tutorial generators (a quad sphere, three point spheres) plus
   655,360 round and flat hair segments, 16,777,216 rays through both
   intersect modes and occluded; every kind class must get hits; the
   full-size launches held bit-equal on the compared rays, with the counts
   of phase 6;
9. motion blur (B6), every instantiation against the plain version at
   65,536 rays with times U[0,1): the kind check scene with every kind
   moving (as is, masked, robust, robust + masked, and over 3 steps, which
   gives windows), a moving 16K-tri sphere (masked, robust, robust +
   masked) and the static robust + masked triangle variants; every
   launch of a moving variant finishes each ray once (its rays-finished
   count);
10. 2-step motion at full size: the 2,097,152-triangle sphere moving a
   quarter of its radius along x (Embree's motion_blur_geometry tutorial
   at bench.py:56's size), 16,777,216 rays with times through both
   intersect modes and occluded, held against the exact moving sphere and
   brute force; kernel vs plain version on 65,536 of the rays, and the
   full-size launch's outputs on those rays (its warps refill) held
   against the same plain run, bit for bit; with each
   variant's time, the share of lane slots that did work in the
   persistent warps beside one ray per thread's (from the rays' steps in
   launch order, in warps of 32 and blocks of 128), rays finished, the
   longest ray's steps, registers and resident warps per SM;
11. time-sliced motion at full size: sphere_mesh(512, 1024) over 4 time
   steps, accelerating along x by 0.25 in all, 3,145,728 windowed prims,
   the same rays and checks;
12. kernel vs plain version for flat curves (B7): the scene of
   tests/test_pallas_kernel.py:175-193 scaled up to 4,096 flat Bezier and
   B-spline curves, its backdrop triangle and 32 tessellated round strands
   (512 round segments, B5) at 65,536 rays: as is, masked, robust, robust +
   masked, moving over 2 steps (the same four) and over 3 steps (windows);
   every curve instantiation bit-equal, class-8 hits; each launch of the
   persistent warps finishes every ray once, with its useful lane-steps
   split into node passes and leaf passes (and the leaf passes' item
   rounds, each dealing 32 (ray, slot) items across the warp);
13. the hair cell at full size: 131,072 B-spline strands of 11 control
   points on a unit sphere (1,048,576 flat native curves, rate 4), 16,777,216
   rays through both intersect modes and occluded; brute force on a few
   rays, kernel vs plain version on 262,144 of the rays, and the full-size
   launches' outputs (their warps refill) on those rays held bit-equal to
   the same plain run; commit (with the hair tier's leaf OBBs), table,
   steps, useful lane-steps and times;
14. kernel vs plain version for round curves (B8), with round curves among
   the packed kinds (the JAX package's EMBREE_TPU_KERNEL_ROUND opt-in): 2,048
   round Bezier curves, 512 round B-spline strands of 4 spans, 32
   tessellated round strands and the backdrop triangle at 65,536 rays, every
   curve instantiation (static and 2-step x {as is, masked, robust, both},
   3 steps), bit-equal, class-9 hits, and their work counts as in 12;
15. the round hair cell: phase 13's strands as 1,048,576 native round
   curves. The generic engine (the default route) on 1,048,576 of the rays
   through both intersect modes and occluded, with its lockstep steps, time
   and peak memory; brute force on a few rays; then the kernel route (B8)
   on all 16,777,216 rays, kernel vs plain version on 65,536 of them (and
   the full-size launches on the same rays), and B8 against the engine on
   the engine's rays within the JAX package's own bounds
   (test_pallas_kernel.py:229-233);
16. the generic engine against the kernel on phase 6's kind check scene at
   65,536 rays: equal hit masks, prim ids equal but at near-ties;
17. the viewer's mixed scene (a round curve: the generic engine) at 96x96
   against tests/golden/mixed_*.pfm;
18. the traversal ablations (perf/ablate_v7.py, perf/kernel_ablate.py) at
   the harnesses' size, the 16,384-triangle sphere and 1,048,576 sorted
   rays: each harness's variants (12 v7, pinned at 24 steps; 9 v5) timed
   through its entry point beside B1, every kernel held against its plain
   version on 65,536 of the rays in whole 128-ray sub-groups (t bits,
   ids, step row, each ray's steps), and each variant's full-size launch
   (its persistent warps refill) on those rays, with its counts: every ray
   finished once, useful lane-steps overall and of node and leaf passes,
   warps per SM; the full variants against B1 on the same rays (hit
   masks, t within 1e-4, prim ids but at near-ties); then both ablations
   again on the main cell's 2,097,152-triangle sphere and 16,777,216 rays
   beside B1, with the same full-size checks and counts;
19. the loop probes (perf/micro_ops.py, perf/micro_expand.py,
   perf/micro_v8.py) at the harnesses' size: 14, 12 and 19 probes, each
   one CUDA block carrying an (8,128), (8,128) or (128,128) int32 tile over
   x of (512,128), (128,128) and (512,128), all three units written
   against csrc/micro.cuh's block, each probe in the layout its least-work
   Cost names; every kernel bit-equal to its plain version on the
   harnesses' x and on x with distinct rows at 64 and 67 iterations (and
   the (8,128) probes at 1,000), micro_expand's masked mins and selects
   also on x whose words cross the probe's threshold within 64 iterations
   (perf/micro_expand.py::edge_x) at 64 and 67, then each timed through
   its entry point at the harness's ITERS (20,000, 3,000, 20,000) on the
   harness's x: ms, ns/iter and ns/iter over the harness's base probe,
   launches, the per-SM bound, the least work over implementations (a
   probe timed below it fails the run: its loop was folded; a fold too
   small to take it below is not caught), the share of the bound,
   registers and stack frame (any local memory in a probe instantiation
   fails the run, as does a dependency-barrier hazard in the library's
   SASS, phase 2), the plain version's time at 64 iterations, and for
   micro_v8's five lane gathers and micro_expand's two 72-row gathers the
   shared-memory wavefronts the harness's x gives against a conflict-free
   count; micro_expand's row-min form of the masked min (a lane reduction
   every iteration) is checked and timed with them, outside the sum of
   launches x (ms - bound);
20. the builders on the card (the default route sends every scene under
   50,000 prims through the SAH builder, as the JAX package does):
   sphere_mesh(128, 192), 49,152 triangles, committed at MEDIUM and LOW
   on the card, each tree and packed table equal to the CPU build's node
   for node; B1's three variants driven through the entry points at
   16,777,216 rays and held against the plain version on 65,536 of them;
   hit masks equal to the native-route commit's and t bit-equal wherever
   both give the same prim; commit seconds, sah_cost and kernel ms on both
   trees. Then the 2,097,152-triangle main sphere on the SAH route
   (EMBREE_TPU_NATIVE_BUILD=0 for that commit) against its native tree:
   commit seconds, sah_cost, B1's ms at 16,777,216 rays, equal hit masks.
   REFIT: the main sphere shifted 0.25 along x and re-committed, the tree
   refit on the card with its topology kept, its hits against a fresh
   commit's; HIGH: 32,768 diagonal slivers, pre-split, at a lower SAH cost
   than MEDIUM with the same hit masks;
21. the rest of Scene on the card: the main sphere committed compact, whose
   differentiable intersect takes B1's attribute path and equals the
   non-compact fast path bit for bit (both scenes' sizes in MB); a filter
   rejecting odd prim ids in both contexts and 65,536 user spheres, each
   through the generic engine at 1,048,576 rays and held against brute
   force on a sample; the progress monitor's milestones, a cancel raising
   CommitCancelled and a commit after it;
22. flattened instances (the default route below 16 instances): 8
   instances of sphere_mesh(512, 512) under random similarities (scale
   0.5-1.5, on a ring; numpy seed 5), 4,194,304 flattened triangles on the
   native route, 16,777,216 incoherent rays through both intersect modes
   and occluded; each hit point in the world box of the instance it
   reports; B1's three variants held against the plain version on a
   strided sample and timed (commit seconds, table MB); then at check size
   (the 16K-tri sphere, 65,536 rays) a 2-step translated instance (B6), a
   quaternion-rotated one (90 degrees about z, resampled: B6 with windows)
   and a nested two-level one (B1), each variant held bit for bit;
23. the two-level cell: an instance array of 4,096 transforms of
   sphere_mesh(128, 192) (its BLAS on the SAH route) on a 64 x 64 grid
   (random turn about y, scale U(0.5, 1.2), numpy seed 5) and the main
   sphere raised above it (native route): 4,097 instances, 203,423,744
   instanced triangles in two BLASes; BLAS and TLAS commit seconds, REFIT
   after moving every transform (update_transforms: no BLAS rebuilt, the
   tensors kept), 4,194,304 rays from the grid's box: waves, rays and
   overflows per wave, collect and BLAS-pass ms per wave, each BLAS
   launch of the first wave held against the plain version on a strided
   sample of its object-space rays and timed, the entry points' ms; then
   an 8 x 8 sub-grid two-level against its own flattening (t within 2e-4
   of max(t, 1) wherever both hit the same prim; ids may differ only at
   near-ties, masks only at a ray's origin or a silhouette:
   same_up_to_ties);
24. grids and subdivision surfaces, whose quads ride B1 as two triangle
   slots (B6 moving, B3-B5 beside other kinds): Embree's createGridSphere
   at 592 (six 593 x 593-vertex grids, 2,102,784 quads) and a torus cage
   of 48 x 32 quads with a crease loop and two holes refined at levels 4
   (392,704 quads; the refinement's host seconds apart from the commit),
   each at 16,777,216 rays through both intersect modes and occluded:
   prim ids are grid indices (base faces), grid u/v within [0, 1], B1
   held against the plain version on a strided sample and the full-size
   launches on those rays, the entry point split into wrapper, kernel and
   re-intersection; then at 65,536 rays a 2-step moving grid sphere (B6),
   the subdivided cube at levels 3 over 3 steps with a time range (B6
   with windows) and a grid beside points and round lines (B3-B5), every
   variant held bit for bit;
25. the rest of the API surface on the card: point queries on the main
   sphere (1,048,576 points from U(-1.2, 1.2)^3 at radius 0.05; at an
   infinite radius 65,536 of them at least 0.5 from the center: on an
   H100 80GB HBM3, points from anywhere took 33,432 lockstep steps and
   500.7 s, the walk of a point near the center visiting most of the
   tree) and collision
   of two 524,288-tri spheres offset by 0.5, with their lockstep steps and
   ms, each held against the port's CPU run on a strided sample; the
   two-level point query of 16 instances against their flattening;
   interpolation of the grid positions at the grid cell's hits;
   scene_stats; a checkpoint round trip of the main sphere (hits
   bit-equal after the load); Device() on CUDA;
26. the path tracer (``models/pathtracer.py``): the Cornell box of
   examples/render_pathtracer_demo.py (walls and panel triangles, two
   sphere points: B3-B5) at 1024 x 1024, 4 spp, depth 4, and the main
   sphere (matte) on a rough-metal floor under a quad light and an ambient
   term (all triangles: B1) at 1024 x 1024, 1 spp, depth 4: the launches
   (once a bounce for the closest hit and for occlusion), the render's ms,
   peak memory, Mrays/s (the primary and shadow rays traced, over every
   bounce) beside Mlanes/s, per bounce the entry point split into wrapper,
   kernel and re-intersection, occlusion, and shading with sampling; the
   first bounce's launches held against the plain version on 65,536 of
   its rays (and the full-size launches on those rays); a 128 x 128
   render of each scene held against the port's CPU render with the CPU
   run's draws replayed;
27. gradients: the Cornell box at 256 x 256, 1 spp, depth 2, with respect
   to the albedo table and the back wall's depth, against central
   differences over the pixels whose path choices stay put within the
   step; the viewer-style vertex gradient of a 16,384-tri sphere through
   the kernel against the port's CPU gradient; backward ms and peak
   memory;
28. multi-device at world size 1 (``parallel/``): an NCCL process group
   of one rank joined through a file store in a temporary directory;
   render_image_sharded of the main sphere at 1024 x 1024 with eyelight
   and occlusion, each bit-equal to intersect + the shader unsharded; one
   make_train_step on sphere_mesh(64, 128) at 65,536 camera rays, its new
   vertex tables and loss bit-equal to the unsharded step's (deterministic
   algorithms on); measure_scaling and measure_scaling_weak at [1] on
   16,777,216 rays, printed as rays/s; then the group is destroyed. NCCL
   puts one rank on each card, so one card runs no larger group;
29. robustness on the kernels (tests/test_robustness.py): its NaN and Inf
   origins and directions and its extreme intervals on an 8 x 12 sphere,
   and its garbage vertices (NaN and 1e30) beside a valid triangle,
   through B1, B2, B6 (2 steps) and B7 (with flat strands): the entry
   points' hits (no hit at a non-finite t, the extreme intervals [True,
   False, False], the valid triangle at t = 1) and every variant's launch
   bit-equal to the plain version, steps included, every ray finished,
   with each launch's longest walk; its watertight sphere and plane grid
   at 50,000 rays through B1 (miss rate at most 2e-5); its deep scene
   with overflow 0 in every variant;
30. the parity tools (tools/parity.py, tools/parity_models.py) on the
   scenes of write_parity_scenes (XML scenes, .ecs files with every
   generator flag, a moving scene, min-width, texcoords) at 512 x 512 on
   the card, each image within 55 wrong pixels (8-bit metric) of the
   port's CPU render of the same file;
31. the tools, examples and perf scripts, each through its own main() on
   the card at the JAX package's defaults: the viewer's command line
   (cube, eyelight, 96 x 96 against tests/golden/cube_eyelight.pfm, 5
   timed frames); the triangle demo (within 1 grey level of its CPU run on
   every pixel, equal hit and shadow fractions); the path-tracer demo
   (128 x 128, 8 spp, depth 4, held against a CPU render with the card's
   draws replayed); the 13 feature demos; perf/sort_tax.py (variants a-g
   at 1,048,576 rows, each variant's rows equal to its CPU rows from the
   same inputs); perf/compaction.py (the 16,384-tri sphere, 1,048,576
   rays, 0/50/75/90% dead lanes; live lanes' t bit-equal to the all-live
   run's); perf/profile_steps.py (visits per 2,048-ray block of the sorted
   rays, the kernel's visits equal to the plain version's on a strided
   sample); perf/bigscene.py (a 1024 x 1024 sphere, 4,194,304 rays: hit
   rate above 0, no overflow); tools/buildbench.py (10,000 and 100,000
   tris x LOW/MEDIUM/HIGH x create/update/refit: 18 figures, recorded
   into a score file under chiprun_out/); perf/obb_hair.py on a round
   Bezier hair scene written here (the tier active with the OBBs on, hits
   equal); tools/info.py and the score file's listing;
32. the kernels line (each traversal variant with its launches on the
   instance paths, on the grid and subdivision paths, in phase 26's
   renders, on phases 28-30's paths and on phase 31's), then the result
   line.

Launch counts are zeroed just before each driven path (4-31) and read just
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
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from embree_tpu_torch.examples.render_pathtracer_demo import cornell_box
from embree_tpu_torch.perf.device import OUT_DIR, card_line, default_out
from embree_tpu_torch.tools.parity_models import point_sphere, prim_sphere

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
MICRO_CLOCK_CYCLES = 5_000_000       # ~2.5 ms a clock measurement
# phases 20-21, the builders and the rest of Scene
BUILD_MESH = (128, 192)      # 49,152 tris: the SAH route's largest sphere
BUILD_COMPARE = 1 << 16
REFIT_SHIFT = 0.25           # the main sphere moved along x
SLIVERS = 32768              # tests/test_sah.py:104-127's slivers, scaled
SLIVER_RAYS = 1 << 16
ENGINE_SCENE_RAYS = 1 << 20  # the filter and user-geometry scenes' rays
USER_SPHERES = 1 << 16
INST_MESH = (512, 512)       # 524,288 tris per instance
INST_COUNT = 8               # under TWO_LEVEL_AUTO: flattened
INST_RING = 2.5              # the instances' ring radius
INST_RAYS = 1 << 24
GRID = 64                    # phase 23's grid of instances, GRID x GRID
GRID_SPACING = 2.5
GRID_MESH = (128, 192)       # 49,152 tris: its BLAS takes the SAH route
BIG_SCALE = 20.0             # the main sphere raised above the grid
BIG_HEIGHT = 30.0
TWO_LEVEL_RAYS = 1 << 22
TWO_LEVEL_COMPARE = 1 << 16  # plain-version sample of each BLAS launch
SUB_GRID = 8                 # the sub-grid held against its flattening
SUB_RAYS = 1 << 20
# phase 24, grids and subdivision surfaces
GRID_N = 592                 # createGridSphere: 6 x 592^2 = 2,102,784 quads
GRID_RAYS = 1 << 24
TORUS = (48, 32)             # the subdivision cage's quad faces
TORUS_HOLES = (100, 900)     # base faces removed before refinement
SUBDIV_LEVELS = 4            # 1,534 faces x 4^4 = 392,704 quads
SUBDIV_RAYS = 1 << 24
CHECK_GRID_N = 64            # the check-size grid spheres: 24,576 quads
# phase 25, the API surface
PQ_POINTS = 1 << 20          # point queries at PQ_RADIUS on the main sphere
PQ_RADIUS = 0.05
PQ_INF_POINTS = 1 << 16      # and at an infinite radius, those points
PQ_INF_MIN_R = 0.5           # at least this far from the center (a cut)
PQ_COMPARE = 1 << 12         # points held against the CPU
COLLIDE_MESH = (512, 512)    # two 524,288-tri spheres, offset along x
COLLIDE_SHIFT = 0.5
COLLIDE_COMPARE = 1 << 12    # prims of A held against the CPU
TL_INSTANCES = 16            # TWO_LEVEL_AUTO: the two-level point query
TL_POINTS = 1 << 16
CK_RAYS = 1 << 20            # rays held after the checkpoint round trip
BRUTE_SAMPLE = 64


def say(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def add_counts(into, counts):
    for k, n in counts.items():
        into[k] = into.get(k, 0) + n


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
    ``time_variants``, and its outputs with the sample's stride, against
    which ``time_variants`` holds the same rays of its full-size launch."""
    stride = max(inputs[0].shape[0] // n, 1)
    x = [t[::stride][:n].contiguous() for t in inputs]
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
            leaf_visits=int(p.visits[1].sum(dtype=torch.int64)), n=n,
            stride=stride, out=p)
    check(int(k.overflow) == 0 and int(p.overflow) == 0,
          f"{label}: stack overflow")
    if k.sched is not None:
        check_sched(k, n, label)
    err = check_bits(k, p, attrs, label)
    hits = int((k.best >= 0).sum())
    say(f"  {label}: {n} rays, {hits} hits, kernel == plain (bits, steps)")
    return err


def check_sample(r, pl, attrs, label):
    """The outputs ``r`` of a launch on all rays, on the rays of the
    compare sample ``pl`` (``compare``'s record: every k-th ray), equal
    the plain run's there, bit for bit."""
    k, m = pl["stride"], pl["n"]
    sample = types.SimpleNamespace(
        t=r.t[::k][:m], best=r.best[::k][:m], visits=r.visits[:, ::k][:, :m],
        attrs=None if r.attrs is None else r.attrs[:, ::k][:, :m])
    check_bits(sample, pl["out"], attrs, label)
    say(f"  {label}: the launch's outputs on the {m} compared rays == "
        "plain (bits, steps)")


def check_bits(k, p, attrs, label):
    """Kernel outputs ``k`` equal the plain version's ``p`` bit for bit:
    prim ids, step counts, t and (``attrs``) u/v/Ng. Returns the max
    |difference| over t and attributes (0.0 when equal)."""
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
            check_sched(full, CHECK_RAYS, f"{label}, 1M rays")
            plain = {}
            errs[name] = max(errs[name], compare(
                tr, cs.packed, inputs, CHECK_COMPARE, occ, attrs, label,
                plain=plain))
            check_sample(full, plain[tr.packed_variant(cs.packed, occ, attrs,
                                                       False)],
                         attrs, f"{label} (1M rays)")


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
        res, scheds = {}, []

        def run():
            res["r"] = run_kernel(tr, packed, inputs, occlusion=o,
                                  want_attrs=a, robust=robust)
            scheds.append(res["r"].sched)
        ms = events_ms(run)
        r = res["r"]
        node_v = int(r.visits[0].sum(dtype=torch.int64))
        leaf_v = int(r.visits[1].sum(dtype=torch.int64))
        max_steps = int((r.visits[0] + r.visits[1]).max())
        torch.cuda.synchronize()
        check(int(r.overflow) == 0, f"{name}: stack overflow")
        inst = tr.kernel_instantiation(packed, o, a, robust)
        check(inst in TRAVERSE_PTXAS, f"{name}: no ptxas line for {inst}")
        ptx = TRAVERSE_PTXAS[inst]
        lanes = {}
        if r.sched is not None:
            # every launch of the timing finished every ray once
            check(all(int(c[2]) == n_rays for c in scheds),
                  f"{name}: a launch did not finish every ray")
            check_sched(r, n_rays, name)
            if plain is not None and plain[name]["n"] < n_rays:
                # the full-size launch refills its lanes (more rays than
                # resident lanes): its outputs on the compare sample's rays
                # equal the plain version's there, bit for bit
                check_sample(r, plain[name], a, f"{name} (full size)")
            one32, one128 = lane_shares(r.visits)
            steps = (r.visits[0] + r.visits[1]).to(torch.int64)
            top = steps.sort(descending=True).values[:max(n_rays // 100, 1)]
            lanes = dict(useful_lane_steps=int(r.sched[1]) / int(r.sched[0]),
                         one_ray_per_thread_warps=one32,
                         one_ray_per_thread_blocks=one128,
                         top_percent_steps=int(top.sum()) / max(
                             int(steps.sum()), 1),
                         longest_at=int(steps.argmax()) / n_rays,
                         rays_finished=int(r.sched[2]),
                         warps_per_sm=int(r.sched[3]), **sched_split(r))
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
                   launches=launches[name],
                   registers=ptx.get("registers"), stack=ptx.get("stack"),
                   **lanes)
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
            + f", {rec['registers']} registers"
            + (f"; useful lane-steps {lanes['useful_lane_steps']:.4f} "
               f"(one ray per thread: {one32:.4f} in warps of 32, "
               f"{one128:.4f} in blocks of 128; the top 1% of rays hold "
               f"{lanes['top_percent_steps']:.4f} of the steps, the "
               f"longest at {lanes['longest_at']:.4f} of the order), "
               f"{lanes['rays_finished']} rays finished, "
               f"{lanes['warps_per_sm']} warps per SM" if lanes else "")
            + (f"; node passes {lanes['node_lane_steps']:.4f}, leaf passes "
               f"{lanes['leaf_lane_steps']:.4f} of their lane-steps "
               f"({lanes['leaf_pass_share']:.4f} of the lane slots), item "
               f"rounds {lanes['item_lane_share']:.4f} of their lanes"
               if "item_lane_share" in lanes else "")
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
    plain = {}
    for name, o, a in VARIANTS:
        errs[name] = max(errs.get(name, 0.0), compare(
            tr, packed, inputs, MAIN_COMPARE, o, a, name, plain=plain))

    # ---- timing at the main-path shape; the plain version timed on the
    # compare sample, against which the full-size launches (their warps
    # refill) are held on the same rays ----
    card = card_line()
    total_ms = {
        "closest_attrs": events_ms(
            lambda: pt.intersect(cs, rays, differentiable=False)),
        "occluded": events_ms(lambda: pt.occluded(cs, rays)),
    }
    time_variants(tr, packed, inputs, VARIANTS, record, table_bytes, card,
                  launches, total_ms=total_ms, plain=plain)
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
    plain = {}
    for name, o, a in VARIANTS:
        errs[f"{name}_masked"] = compare(tr, cs.packed, inputs, MAIN_COMPARE,
                                         o, a, f"{name}_masked", plain=plain)
    total_ms = {
        "closest_attrs": events_ms(
            lambda: pt.intersect(cs, rays, differentiable=False)),
        "occluded": events_ms(lambda: pt.occluded(cs, rays)),
    }
    time_variants(tr, cs.packed, inputs, VARIANTS, record,
                  table_mb(cs.packed), card, masked, total_ms=total_ms,
                  plain=plain)


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
    plain = {}
    for name, o, a in VARIANTS:
        errs[f"{name}_robust"] = compare(tr, cs.packed, inputs, MAIN_COMPARE,
                                         o, a, f"{name}_robust", robust=True,
                                         plain=plain)
    card = card_line()
    total_ms = {
        "closest_attrs": events_ms(
            lambda: pt.intersect(cs, rays, differentiable=False)),
        "closest": events_ms(lambda: pt.intersect(cs, rays)),
        "occluded": events_ms(lambda: pt.occluded(cs, rays)),
    }
    # the plain version timed on the compare sample, against which the
    # full-size launches (their warps refill) are held on the same rays
    time_variants(tr, cs.packed, inputs, VARIANTS, record,
                  table_mb(cs.packed), card, launches, robust=True,
                  total_ms=total_ms, plain=plain)


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
    s.attach(pt.QuadGeometry(*prim_sphere("quad", (0, 0, 0), 1.0, 512)))
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
    65,536-ray sample (launched at that size and at full size), times.
    ``center(time)``: the sphere's exact center at each time."""
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


def ptxas_info(ptxas, entry, key=None):
    """Registers, stack frame (its local memory) and spill bytes of each
    kernel instantiation in a build's ptxas lines whose entry name matches
    ``entry``, a pattern with two groups (a name, the template's int
    argument), keyed (name, int); or keyed ``key(match)``."""
    out, cur = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            m = re.search(entry, m.group(1))
            cur = None if m is None else key(m) if key else (
                m.group(1), int(m.group(2)))
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


# the traversal library's ptxas lines by instantiation, filled after the
# build: {(entry, template flags): registers, stack, spills}
TRAVERSE_PTXAS = {}
# traverse_kernel, the retired one-ray-per-thread kernel, is matched too,
# so that check_traverse_ptxas sees one left in the library
TRAVERSE_ENTRY = r"(traverse_kernel|persistent_kernel)I((?:Lb[01]E)+)E"


def traverse_ptxas(ptxas):
    return ptxas_info(ptxas, TRAVERSE_ENTRY, key=lambda m: (
        m.group(1), tuple(int(b) for b in re.findall(r"Lb([01])E",
                                                     m.group(2)))))


def check_traverse_ptxas(ptxas):
    """Fill TRAVERSE_PTXAS; the library holds the 72 persistent
    instantiations (B6's 20 moving ones, B7's and B8's 32 curve ones,
    B1-B5's 20 static ones) and no traverse_kernel; they keep their stacks
    in shared memory and spill nothing, and all but B6's 8 mixed-class ones
    fit 16 resident warps per SM (128 registers)."""
    TRAVERSE_PTXAS.update(traverse_ptxas(ptxas))
    check(all(e == "persistent_kernel" for e, _ in TRAVERSE_PTXAS),
          "the library holds a traverse_kernel")
    persistent = {f: v for (e, f), v in TRAVERSE_PTXAS.items()
                  if e == "persistent_kernel"}
    check(len(persistent) == 72,
          f"{len(persistent)} persistent instantiations")
    check(sum(f[6] for f in persistent) == 32, "not 32 curve instantiations")
    check(sum(not f[5] and not f[6] for f in persistent) == 20,
          "not 20 static instantiations without curves")
    check(sum(not any(f[3:]) for f in persistent) == 6,
          "not 6 static triangle instantiations (B1)")
    bad = []
    for flags, info in sorted(persistent.items()):
        say(f"  persistent kernel (occlusion, attrs, mask, robust, kinds, "
            f"motion, curves, round) {flags}: {info.get('registers')} "
            f"registers, {info.get('stack')} B stack frame, spill "
            f"{info.get('spill_st')} / {info.get('spill_ld')} B")
        if (info.get("stack") != 0 or info.get("spill_st") != 0
                or info.get("spill_ld") != 0):
            bad.append(f"{flags}: local memory in use")
        if (not (flags[4] and flags[5]) or flags[6]) and info.get(
                "registers", 999) > 128:
            bad.append(f"{flags}: over 128 registers")
    check(not bad, "persistent kernels: " + "; ".join(bad))


def check_sass(library, label, expect):
    """Fault C.2's check: no function of a library reads or overwrites a
    register before the wait on the load that writes it
    (perf/sass_hazards.py over cuobjdump's SASS). The faulty build read the
    pop's next record before its shared-memory load landed. ``expect``:
    {name: the functions whose name holds it}."""
    from embree_tpu_torch.perf import sass_hazards
    t0 = time.perf_counter()
    funcs = sass_hazards.parse(sass_hazards.disassemble(library))
    found = {f: sass_hazards.hazards(code) for f, code in funcs.items()}
    n = sum(map(len, found.values()))
    say(f"  SASS dependency barriers ({label}): {n} hazards in {len(funcs)} "
        f"functions ({sum(map(len, funcs.values()))} instructions, "
        f"{time.perf_counter() - t0:.1f} s)")
    for f, hz in found.items():
        for h in hz[:4]:
            say(f"    {f}: {h.kind} on barrier {h.barrier} for {h.reg}: "
                f"{h.source.addr:#x} {h.source.text} -> {h.at.addr:#x} "
                f"{h.at.text}")
    for name, count in expect.items():
        check(sum(name in f for f in funcs) == count,
              f"the {label} SASS does not hold {count} {name}s")
    check(n == 0, f"{n} dependency-barrier hazards in the {label} SASS")


def check_ablate_ptxas(ptx):
    """The ablation library holds v7's 11 and v5's 7 instantiations; none
    uses local memory (no stack frame: the stacks are in shared memory) or
    spills."""
    check(sum(u == "v7" for u, _ in ptx) == 11, "not 11 v7 instantiations")
    check(sum(u == "v5" for u, _ in ptx) == 7, "not 7 v5 instantiations")
    for (unit, flags), info in sorted(ptx.items()):
        say(f"  ablation kernel {unit} {flags:#04x}: "
            f"{info.get('registers')} registers, {info.get('stack')} B stack "
            f"frame (local memory), spill {info.get('spill_st')} / "
            f"{info.get('spill_ld')} B")
        check(info.get("stack") == 0 and info.get("spill_st") == 0
              and info.get("spill_ld") == 0,
              f"ablation kernel {unit} {flags:#04x}: local memory in use")


def check_micro_ptxas(ptx):
    """The loop-probe library holds micro_ops' 14, micro_expand's 13 (its
    12 probes and the masked min's row-min form) and micro_v8's 19
    instantiations; none uses local memory (a stack frame or spills)."""
    for unit, n in (("micro_ops", 14), ("micro_expand", 13),
                    ("micro_v8", 19)):
        check(sum(u == unit for u, _ in ptx) == n,
              f"not {n} {unit} instantiations")
    for (unit, kid), info in sorted(ptx.items()):
        say(f"  ptxas (micro): {unit} probe {kid}: {info.get('registers')} "
            f"registers, {info.get('stack')} B stack frame (local memory), "
            f"spill {info.get('spill_st')} / {info.get('spill_ld')} B")
        check(info.get("stack") == 0 and info.get("spill_st") == 0
              and info.get("spill_ld") == 0,
              f"{unit} probe {kid}: local memory in use")


def lane_shares(visits):
    """Useful lane-steps of one ray per thread over the rays in launch
    order: the share of lane slots that did work when each warp of 32 runs
    as long as its longest ray, and when each block of 128 holds its slot
    until its longest ray is done."""
    steps = (visits[0] + visits[1]).to(torch.int64)
    total = steps.sum().item()
    out = []
    for width in (32, 128):
        pad = torch.nn.functional.pad(steps, (0, -steps.numel() % width))
        out.append(total / max(width * pad.view(-1, width).amax(1).sum()
                               .item(), 1))
    return out


def check_sched(res, n, label):
    """The persistent warps' counts of one launch: every ray finished once,
    and the lane steps are the rays' steps; where leaf passes deal items
    (curve scenes, static B1-B5) their steps are the rays' leaf visits, and
    each leaf step's 8 items had a lane of an item round."""
    slots, steps, finished, _ = (int(v) for v in res.sched)
    check(finished == n, f"{label}: {finished} rays finished of {n}")
    check(steps == int(res.visits.sum(dtype=torch.int64)),
          f"{label}: lane steps differ from the rays' steps")
    check(slots >= steps, f"{label}: more lane steps than slots")
    leaf_slots, leaf_steps, item_slots = (int(v) for v in res.leaf_sched)
    if item_slots:
        check(leaf_steps == int(res.visits[1].sum(dtype=torch.int64)),
              f"{label}: leaf-pass steps differ from the leaf visits")
        check(leaf_slots >= leaf_steps and item_slots >= 8 * leaf_steps,
              f"{label}: leaf-pass counts out of range")


def sched_split(res):
    """Useful lane-steps of the node passes and leaf passes of a launch
    whose leaf passes deal items (curve scenes, static B1-B5), the leaf
    passes' share of lane slots, and the item rounds' share of lanes that
    tested a slot; {} for a launch without them."""
    slots, steps = int(res.sched[0]), int(res.sched[1])
    leaf_slots, leaf_steps, item_slots = (int(v) for v in res.leaf_sched)
    if not item_slots:
        return {}
    return dict(node_lane_steps=(steps - leaf_steps)
                / max(slots - leaf_slots, 1),
                leaf_lane_steps=leaf_steps / max(leaf_slots, 1),
                leaf_pass_share=leaf_slots / max(slots, 1),
                item_lane_share=8 * leaf_steps / item_slots)


def b1_on(tr, packed, rays, card):
    """B1 closest on the ablation's rays, timed as the ablations are
    (``device.time_call``): (ms, its record: ms, ray steps at nodes and
    leaves, the most steps of a ray, useful lane-steps, warps per SM)."""
    from embree_tpu_torch.perf.device import time_call
    ms, res = time_call(lambda: tr.traverse_kernel(packed, *rays),
                        cuda=rays[0].is_cuda)
    v = res.visits
    rec = dict(ms=ms, node_visits=int(v[0].sum(dtype=torch.int64)),
               leaf_visits=int(v[1].sum(dtype=torch.int64)),
               max_steps=int((v[0] + v[1]).max()),
               useful_lane_steps=int(res.sched[1]) / max(int(res.sched[0]),
                                                         1),
               warps_per_sm=int(res.sched[3]), card=card)
    say(f"  B1 closest on the same rays: {ms:.3f} ms, "
        f"{rec['node_visits']} node + {rec['leaf_visits']} leaf steps, "
        f"max {rec['max_steps']}, useful lane-steps "
        f"{rec['useful_lane_steps']:.4f}, {rec['warps_per_sm']} warps/SM "
        f"[{card}]")
    return ms, rec


def ablate_sample(n, m):
    """Indices of m of n rays in whole 128-ray sub-groups, every k-th
    sub-group, so that the sample spans the batch and a one_trip sub-group
    of the sample is one of the full launch's."""
    groups = n // 128
    g = torch.arange(0, groups, max(groups * 128 // m, 1),
                     device=DEV)[:m // 128]
    return (g[:, None] * 128 + torch.arange(128, device=DEV)).reshape(-1)


def ablate_full_check(full, plain, idx, label):
    """A full-size launch's outputs on the sampled rays ``idx`` equal the
    plain run's on the sample, bit for bit (t, ids, each ray's steps)."""
    m = idx.numel()
    check(torch.equal(full.t.reshape(-1)[idx].view(torch.int32),
                      plain.t.reshape(-1)[:m].view(torch.int32)),
          f"{label}: full-size t bits differ on the sample")
    check(torch.equal(full.best.reshape(-1)[idx], plain.best.reshape(-1)[:m]),
          f"{label}: full-size ids differ on the sample")
    check(torch.equal(full.visits[:, idx], plain.visits[:, :m]),
          f"{label}: full-size ray steps differ on the sample")


def ablate_counts(res, n, unit, label):
    """The work counts of a full-size ablation launch: every ray finished
    once and the lane steps the rays' steps (where leaf passes dealt items,
    their lane steps the rays' leaf steps). Returns useful lane-steps, of
    node passes and of leaf passes, the leaf passes' share of lane slots,
    the share of item-round lanes that held an item, and warps per SM."""
    slots, steps, finished, warps, leaf_slots, leaf_steps, items = (
        int(x) for x in res.sched)
    check(finished == n, f"{label}: {finished} rays finished of {n}")
    check(steps == int(res.visits.sum(dtype=torch.int64)),
          f"{label}: lane steps differ from the rays' steps")
    check(slots >= steps, f"{label}: more lane steps than slots")
    out = dict(rays_finished=finished, useful_lane_steps=steps / max(slots, 1),
               warps_per_sm=warps)
    if items:
        check(leaf_steps == int(res.visits[1].sum(dtype=torch.int64)),
              f"{label}: leaf-pass steps differ from the leaf visits")
        out.update(node_lane_steps=(steps - leaf_steps)
                   / max(slots - leaf_slots, 1),
                   leaf_lane_steps=leaf_steps / max(leaf_slots, 1),
                   leaf_pass_share=leaf_slots / max(slots, 1),
                   item_lane_share=ABLATE_SLOTS[unit] * leaf_steps / items)
    return out


def ablate_line(key, rec):
    say(f"  {key}: {rec['ms']:.3f} ms, rays finished {rec['rays_finished']}"
        f", useful lane-steps {rec['useful_lane_steps']:.4f} (node passes "
        f"{rec.get('node_lane_steps', float('nan')):.4f}, leaf passes "
        f"{rec.get('leaf_lane_steps', float('nan')):.4f}, leaf passes' share "
        f"{rec.get('leaf_pass_share', float('nan')):.4f}), "
        f"{rec['warps_per_sm']} warps/SM, B1 {rec['b1_ms']:.3f} ms "
        f"[{rec['card']}]")


def ablate_cell(mods, tabs, rays, sample_idx, card, b1_ms,
                share_ugrp=False):
    """Each harness's variants on one cell through its entry point (timed;
    the launch counts zeroed just before, read just after), then each
    variant's full-size launch held on the sampled rays against the plain
    version there, with its work counts. ``share_ugrp``: v5 variants that
    differ only in UGRP share one plain run (a ray's outputs do not depend
    on its program). Returns ({unit: records}, {(unit, name): (plain ms,
    the plain result)}, the launch counts)."""
    from embree_tpu_torch.perf import device
    n = rays[0].shape[0]
    device.reset_launch_counts()
    runs = {unit: mod.run_variants(tabs[unit], rays)
            for unit, mod in mods.items()}
    torch.cuda.synchronize()
    launches = dict(device.LAUNCHES)
    sample = [x[sample_idx].contiguous() for x in rays]
    plain, shared = {}, {}
    for unit, mod in mods.items():
        for rec, (name, kw) in zip(runs[unit], mod.VARIANTS):
            kw = dict(kw)
            args = (kw.pop("UGRP"),) if unit == "v5" else ()
            label = f"{unit} {name}"
            key = (unit, rec["flag_bits"], rec["max_steps"])
            if share_ugrp and key in shared:
                plain[(unit, name)] = shared[key]
            else:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                b = mod.traverse_plain(tabs[unit], *sample, *args, **kw)
                e1.record()
                torch.cuda.synchronize()
                plain[(unit, name)] = shared[key] = (e0.elapsed_time(e1), b)
            full = mod.traverse_kernel(tabs[unit], *rays, *args, **kw)
            torch.cuda.synchronize()
            b = plain[(unit, name)][1]
            ablate_full_check(full, b, sample_idx, label)
            rec.update(card=card, b1_ms=b1_ms, n_rays=n,
                       **ablate_counts(full, n, unit, label))
            del full
    return runs, plain, launches


def phase_ablations(pt, tr, record, regs):
    """The two traversal ablations (perf/) at the harnesses' size and on
    the main cell, beside B1; ``regs``: ptxas_info of the ablation
    kernels."""
    from embree_tpu_torch.perf import ablate_v7 as v7
    from embree_tpu_torch.perf import harness, scenes, tables
    from embree_tpu_torch.perf import kernel_ablate as v5
    say("phase 18: traversal ablations (perf/ablate_v7.py, "
        "perf/kernel_ablate.py): 16K-tri sphere, 1,048,576 sorted rays")
    t_phase = time.perf_counter()
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
    mods = {"v7": v7, "v5": v5}

    # ---- the harnesses' main loops (each variant: a warm-up and 5 timed
    # calls), launch counts zeroed just before, read just after; then each
    # kernel against its plain version on 65,536 rays in whole sub-groups,
    # at the sample's size and in a full-size launch ----
    idx = ablate_sample(n, ABLATE_COMPARE)
    runs, plain, launches = ablate_cell(mods, tabs, rays, idx, card,
                                        b1_check_ms)
    say(f"  launches on the ablation path: {launches}")
    sample = [x[idx].contiguous() for x in rays]
    for unit, mod in mods.items():
        for name, kw in mod.VARIANTS:
            kw = dict(kw)
            args = (kw.pop("UGRP"),) if unit == "v5" else ()
            a = mod.traverse_kernel(tabs[unit], *sample, *args, **kw)
            plain_ms, b = plain[(unit, name)]
            torch.cuda.synchronize()
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
                f"ids, steps), and the full-size launch on them; plain "
                f"{plain_ms:.1f} ms")

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

    # ---- records: time, launches, bound, plain time, counts, registers ----
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
            check(launches.get(rec["kernel"], 0) > 0,
                  f"{rec['kernel']}: no launch on its path")
            ptx = regs.get((unit, rec["flag_bits"]), {})
            rec.update(unit=unit, plain_ms=plain[(unit, rec["name"])][0],
                       registers=ptx.get("registers"),
                       local_bytes=ptx.get("stack"),
                       plain_rays=ABLATE_COMPARE, bound_ms=bound,
                       bound_by=by, visit_bytes_ms=visit_ms,
                       launches=launches[rec["kernel"]])
            key = f"ablate_{unit}_{rec['name'].replace(' ', '_')}"
            record[key] = rec
            ablate_line(key, rec)
            say(f"    {rec['registers']} registers, {rec['local_bytes']} B "
                f"local, bound {bound:.4f} ms ({by}), record reads "
                f"{visit_ms:.4f} ms, plain {rec['plain_ms']:.1f} ms on "
                f"{ABLATE_COMPARE} rays, {rec['launches']} launches")
    del cs, tabs, rays, sample, b1, a7, a5, plain
    torch.cuda.empty_cache()

    # ---- both ablations on the main cell, beside B1 ----
    say("  v7 and v5 on the main cell: sphere_mesh(1024, 1024), "
        "16,777,216 sorted rays")
    cs = scenes.sphere_scene(*MAIN_MESH, device=DEV)
    t0 = time.perf_counter()
    tabs = {"v7": tables.v7_tables(cs.packed).to(DEV),
            "v5": tables.pack_v5(cs).to(DEV)}
    say(f"  tables in {time.perf_counter() - t0:.2f} s: v7 "
        f"{tabs['v7'].table_bytes / 1e6:.1f} MB, v5 "
        f"{tabs['v5'].table_bytes / 1e6:.1f} MB")
    rays = scenes.harness_rays(MAIN_RAYS, device=DEV)
    b1_ms, record["ablate_b1"]["main_cell"] = b1_on(tr, cs.packed, rays,
                                                    card)
    runs, _, _ = ablate_cell(mods, tabs, rays,
                             ablate_sample(MAIN_RAYS, ABLATE_COMPARE), card,
                             b1_ms, share_ugrp=True)
    for unit, recs in runs.items():
        for rec in recs:
            ablate_line(f"main cell {unit} {rec['name']}", rec)
        record[f"ablate_{unit}_main_cell"] = dict(
            b1_ms=b1_ms, card=card, table_mb=tabs[unit].table_bytes / 1e6,
            variants=recs)
    del cs, tabs, rays
    torch.cuda.empty_cache()
    say(f"  phase 18 took {time.perf_counter() - t_phase:.1f} s")


def phase_micro(record, ptx):
    """The three loop probes at their harnesses' size: every kernel held
    bit for bit against its plain version, then each timed through its
    entry point at the harness's ITERS on the harness's x; ``ptx``:
    ptxas_info of the probe kernels, keyed (unit, probe id)."""
    from embree_tpu_torch.perf import device, micro, micro_expand, micro_ops
    from embree_tpu_torch.perf import micro_batches, micro_v8
    mods = (micro_ops, micro_expand, micro_v8)
    say("phase 19: loop probes (perf/micro_ops.py, perf/micro_expand.py, "
        "perf/micro_v8.py): 14 + 12 + 19 probes")
    t_phase = time.perf_counter()
    card = card_line()
    smi_clock = micro_batches.sm_clock_hz()
    say(f"  SM clock: nvidia-smi max {smi_clock / 1e6:.0f} MHz, measured "
        f"against the global timer {micro.measured_sm_clock_hz() / 1e6:.1f}"
        f" MHz [{card}]")

    # ---- kernel vs plain version, both inputs ----
    plain_ms = {}
    for mod in mods:
        h = mod.HARNESS
        xs = {"harness": micro.harness_x(h, DEV),
              "distinct": micro.distinct_x(h, DEV)}
        counts = MICRO_CHECK_ITERS + (
            (MICRO_LONG_ITERS,) if h.rows_acc == 8 else ())
        crossings = getattr(mod, "CROSSINGS", {})
        for p in mod.PROBES + getattr(mod, "FORMS", ()):
            inputs = {tag: (x, counts) for tag, x in xs.items()}
            if p.name in crossings:
                # words crossing the threshold within the first count
                inputs["edge"] = (mod.edge_x(crossings[p.name],
                                             MICRO_CHECK_ITERS[0], 3, DEV),
                                  MICRO_CHECK_ITERS)
            for tag, (x, n) in inputs.items():
                # one plain loop to the longest count, its tile kept at
                # each count (the shorter runs are its prefixes), timed to
                # MICRO_PLAIN_ITERS
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                want = {}
                acc = x[0:h.rows_acc].clone()
                e0.record()
                for it in range(1, max(n) + 1):
                    acc = p.body(acc, it - 1, x)
                    if it == MICRO_PLAIN_ITERS:
                        e1.record()
                    if it in n:
                        want[it] = acc
                torch.cuda.synchronize()
                if tag == "harness":
                    plain_ms[(h.unit, p.name)] = e0.elapsed_time(e1)
                for iters in n:
                    k = micro.launch(h, p, x, iters)
                    check(torch.equal(k, want[iters]), f"{h.unit}:{p.name}: "
                          f"kernel != plain on the {tag} x at {iters} "
                          f"iterations")
        forms = len(getattr(mod, "FORMS", ()))
        say(f"  {h.unit}: {len(mod.PROBES)} kernels"
            f"{f' and {forms} other forms' if forms else ''} == plain (int32 "
            f"bits) on both inputs at {', '.join(map(str, counts))} "
            f"iterations{', and on edge_x at ' if crossings else ''}"
            f"{', '.join(map(str, MICRO_CHECK_ITERS)) if crossings else ''}")

    t_checks = time.perf_counter() - t_phase

    # ---- the harnesses' loops (each probe: a warm-up, then 5 timed
    # windows of 5 launches), launch counts zeroed just before, read just
    # after ----
    # the SM clock measured just before and after each probe's timing: the
    # bound takes the fastest of those and nvidia-smi's max, since the card
    # ran up to 0.8% above the max against the timer the events read
    device.reset_launch_counts()
    timed, clocks = {}, {}
    for mod in mods:
        h = mod.HARNESS
        x = micro.harness_x(h, DEV)
        for p in mod.PROBES + getattr(mod, "FORMS", ()):
            before = micro.measured_sm_clock_hz(MICRO_CLOCK_CYCLES)
            timed[(h.unit, p.name)], _ = device.time_call(
                lambda: mod.run(p.name, x, h.iters))
            clocks[(h.unit, p.name)] = max(
                smi_clock, before,
                micro.measured_sm_clock_hz(MICRO_CLOCK_CYCLES))
    torch.cuda.synchronize()
    launches = dict(device.LAUNCHES)
    t_timed = time.perf_counter() - t_phase - t_checks

    # ---- records ----
    for mod in mods:
        h = mod.HARNESS
        x = micro.harness_x(h, DEV)
        base_ns = timed[(h.unit, mod.PROBES[0].name)] * 1e6 / h.iters
        gaps = 0.0
        for p in mod.PROBES + getattr(mod, "FORMS", ()):
            key = f"{h.unit}:{p.name}"
            ms = timed[(h.unit, p.name)]
            ns = ms * 1e6 / h.iters
            cost = micro.cost_of(p, x, h.iters)
            clock = clocks[(h.unit, p.name)]
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
            if p.name in getattr(mod, "GATHERS", ()):
                rec["wavefronts"], rec["wavefronts_free"] = (
                    mod.gather_wavefronts(p.name, x, h.iters))
            record.setdefault("micro", {})[key] = rec
            if p in mod.PROBES:
                gaps += rec["launches"] * (ms - bound)
            say(f"  {key}: {ms:.4f} ms, {ns:.2f} ns/iter (+{ns - base_ns:.2f}"
                f" over base), bound {bound:.4f} ms ({by}), "
                f"{100 * bound / ms:.1f}% of it, "
                f"{rec['launches']} launches, {ptxas.get('registers')} "
                f"registers, {ptxas.get('stack')} B stack (local memory); "
                f"plain {rec['plain_ms']:.1f} ms "
                f"at {MICRO_PLAIN_ITERS} iterations [{card}]")
            if "wavefronts" in rec:
                say(f"    shared-memory wavefronts an iteration on the "
                    f"harness's x: {rec['wavefronts']:.2f} (conflict-free "
                    f"{rec['wavefronts_free']:.2f})")
            check(rec["launches"] > 0, f"{key}: no launch on its path")
            check("registers" in ptxas, f"{key}: no ptxas line")
            check(ms >= bound, f"{key}: {ms:.4f} ms is below its bound "
                  f"{bound:.4f} ms: the loop was folded away")
        say(f"  {h.unit}: sum of launches x (ms - bound) over its probes "
            f"{gaps:.1f}")
    t_all = time.perf_counter() - t_phase
    say(f"  phase 19 took {t_all:.1f} s (checks {t_checks:.1f}, timing "
        f"{t_timed:.1f}, records {t_all - t_checks - t_timed:.1f})")


# ---------------------------------------------------------------------------
# phases 20-21: the builders and the rest of Scene
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def build_route(flag):
    """EMBREE_TPU_NATIVE_BUILD set to ``flag`` for the commits inside."""
    old = os.environ.get("EMBREE_TPU_NATIVE_BUILD")
    os.environ["EMBREE_TPU_NATIVE_BUILD"] = flag
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("EMBREE_TPU_NATIVE_BUILD")
        else:
            os.environ["EMBREE_TPU_NATIVE_BUILD"] = old


def tri_scene(pt, verts, idx, **kw):
    s = pt.Scene(**kw)
    s.attach(pt.TriangleGeometry(verts, idx))
    return s


def slivers(n, seed=9):
    """Long diagonal slivers (tests/test_sah.py:104-127)."""
    rng = np.random.default_rng(seed)
    starts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v1 = starts + np.float32(4.0)
    v2 = v1 + rng.uniform(0.01, 0.02, (n, 3)).astype(np.float32)
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n],
                   axis=1).astype(np.int32)
    return np.concatenate([starts, v1, v2]), idx


def b1_ms(tr, packed, inputs):
    """Each B1 variant's kernel time on the sorted rays (CUDA events)."""
    return {name: events_ms(lambda o=o, a=a: run_kernel(
        tr, packed, inputs, occlusion=o, want_attrs=a))
        for name, o, a in VARIANTS}


def drive_b1(pt, tr, cs, rays, label):
    """The three entry points on cs, launch counts zeroed just before and
    read just after; every B1 variant must run. Returns the fast path's
    hits."""
    tr.reset_launch_counts()
    hit = pt.intersect(cs, rays, differentiable=False)
    hd = pt.intersect(cs, rays)
    occ = pt.occluded(cs, rays)
    torch.cuda.synchronize()
    launches = dict(tr.LAUNCHES)
    check(all(launches.get(n, 0) > 0 for n, _, _ in VARIANTS),
          f"{label}: the path did not launch every B1 variant")
    check(torch.equal(hd.valid, hit.valid) and torch.equal(hd.t, hit.t),
          f"{label}: the two intersect modes disagree")
    check(torch.equal(occ, hit.valid), f"{label}: occluded disagrees")
    say(f"  {label}: launches {launches}; {int(hit.valid.sum())} hits")
    return hit


def same_hits(a, b, label):
    """Equal hit masks, and t bit-equal wherever both hit the same prim."""
    check(torch.equal(a.valid, b.valid), f"{label}: hit masks differ")
    same = a.valid & (a.prim_id == b.prim_id)
    check(torch.equal(a.t[same].view(torch.int32),
                      b.t[same].view(torch.int32)),
          f"{label}: t differs on the same prim")
    share = int(same.sum()) / max(int(a.valid.sum()), 1)
    say(f"  {label}: hit masks equal; {share:.6f} of the hits on the same "
        "prim, t bit-equal there")
    return share


def trees_equal(a, b):
    """Two BVHs (or packed tables) equal node for node, floats by bits."""
    for k in ("node_lower", "node_upper", "node_child", "prim_order"):
        x, y = getattr(a.bvh, k).cpu(), getattr(b.bvh, k).cpu()
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return all(torch.equal(getattr(a.packed, k).cpu(),
                           getattr(b.packed, k).cpu())
               for k in ("nodes", "leaves", "pid_map"))


def tri_bounds(verts, idx):
    """The triangles' bounds on the card, as commit computes them."""
    tri = torch.as_tensor(verts[idx], device=DEV)
    return tri.amin(1), tri.amax(1)


def build_s(lo, up, top_levels):
    """Seconds of build_sah + collapse alone on the card (host clock after
    a synchronize): the builder's share of a commit."""
    from embree_tpu_torch.accel.collapse import collapse
    from embree_tpu_torch.accel.sah import build_sah
    ms, _ = host_ms(lambda: collapse(build_sah(
        lo, up, leaf_size=8, max_top_levels=top_levels), 8))
    return ms / 1e3


def phase_builders(pt, tr, sphere_mesh, out):
    from embree_tpu_torch.accel.bvh import sah_cost
    from embree_tpu_torch.accel.refit import refit_bvh
    say("phase 20: the builders on the card")
    t_phase = time.perf_counter()
    card = card_line()
    out["card"] = card

    # ---- the default route's largest sphere, MEDIUM and LOW ----
    verts, idx = sphere_mesh(*BUILD_MESH)
    org, d = incoherent_rays(MAIN_RAYS, 3)
    rays = pt.make_rays(org, d, device=DEV)
    del org, d
    inputs = sorted_inputs(tr, rays)
    with build_route("1"):
        native, native_s = commit_timed(tri_scene(pt, verts, idx),
                                        "native route")
    native_hit = pt.intersect(native, rays, differentiable=False)
    native_ms = b1_ms(tr, native.packed, inputs)
    native_cost = float(sah_cost(native.bvh))
    for quality in ("MEDIUM", "LOW"):
        q = getattr(pt.BuildQuality, quality)
        with build_route("auto"):
            cs, secs = commit_timed(tri_scene(pt, verts, idx, quality=q),
                                    f"default route, {quality}")
            check(cs.bvh.n_nodes > cs.packed.nodes.shape[0],
                  f"{quality}: not built by the SAH builder")
            t0 = time.perf_counter()
            cpu = tri_scene(pt, verts, idx, quality=q).commit(device="cpu")
            cpu_s = time.perf_counter() - t0
        check(trees_equal(cs, cpu), f"{quality}: the card's tree differs "
              "from the CPU's")
        say(f"  {quality}: the card's tree and packed table == the CPU "
            f"build's ({cs.bvh.n_nodes} binary rows, "
            f"{cs.packed.nodes.shape[0]} wide nodes; CPU commit "
            f"{cpu_s:.3f} s)")
        hit = drive_b1(pt, tr, cs, rays, f"{quality} SAH tree")
        share = same_hits(hit, native_hit, f"{quality} SAH vs native")
        for name, o, a in VARIANTS:
            compare(tr, cs.packed, inputs, BUILD_COMPARE, o, a,
                    f"{name} ({quality} SAH tree)")
        ms = b1_ms(tr, cs.packed, inputs)
        cost = float(sah_cost(cs.bvh))
        alone = build_s(*tri_bounds(verts, idx), 16 if quality == "MEDIUM"
                        else 0)
        say(f"  {quality}: build_sah + collapse alone {alone:.3f} s; "
            f"commit {secs:.3f} s (native {native_s:.3f} s); "
            f"sah_cost {cost:.4f} (native {native_cost:.4f}); B1 ms "
            + ", ".join(f"{n} {ms[n]:.3f} (native {native_ms[n]:.3f})"
                        for n in ms) + f"; {card}")
        out[f"sphere49k_{quality}"] = dict(
            commit_s=secs, native_commit_s=native_s, cpu_commit_s=cpu_s,
            build_s=alone,
            sah_cost=cost, native_sah_cost=native_cost, ms=ms,
            native_ms=native_ms, same_prim_share=share)
        del cs, cpu, hit
    del native, native_hit, rays, inputs
    torch.cuda.empty_cache()

    # ---- the SAH builder at scale: the main sphere ----
    verts, idx = sphere_mesh(*MAIN_MESH)
    org, d = incoherent_rays(MAIN_RAYS, 0)
    rays = pt.make_rays(org, d, device=DEV)
    del org, d
    inputs = sorted_inputs(tr, rays)
    with build_route("1"):
        native, native_s = commit_timed(tri_scene(pt, verts, idx),
                                        "main sphere, native route")
    with build_route("0"):
        sah, sah_s = commit_timed(tri_scene(pt, verts, idx),
                                  "main sphere, SAH route")
    hit_s = drive_b1(pt, tr, sah, rays, "main sphere SAH tree")
    hit_n = pt.intersect(native, rays, differentiable=False)
    share = same_hits(hit_s, hit_n, "main sphere SAH vs native")
    ms_s, ms_n = b1_ms(tr, sah.packed, inputs), b1_ms(tr, native.packed,
                                                         inputs)
    c_s, c_n = float(sah_cost(sah.bvh)), float(sah_cost(native.bvh))
    lo, up = tri_bounds(verts, idx)
    alone = build_s(lo, up, 16)
    say(f"  main sphere: build_sah + collapse alone {alone:.3f} s; "
        f"SAH commit {sah_s:.3f} s, native {native_s:.3f} s;"
        f" sah_cost SAH {c_s:.4f}, native {c_n:.4f}; B1 ms "
        + ", ".join(f"{n} SAH {ms_s[n]:.3f} native {ms_n[n]:.3f}"
                    for n in ms_s) + f"; {card}")
    out["main_sah"] = dict(commit_s=sah_s, native_commit_s=native_s,
                           build_s=alone,
                           sah_cost=c_s, native_sah_cost=c_n, ms=ms_s,
                           native_ms=ms_n, same_prim_share=share)
    del sah, hit_s, hit_n, inputs
    torch.cuda.empty_cache()

    # ---- REFIT: the main sphere moved, its tree refit on the card ----
    s = tri_scene(pt, verts, idx, quality=pt.BuildQuality.REFIT)
    cs0, full_s = commit_timed(s, "REFIT scene, first commit (a build)")
    moved = verts + np.array([REFIT_SHIFT, 0, 0], np.float32)
    s.get(0).vertices = moved
    cs1, refit_s = commit_timed(s, "REFIT re-commit (the refit)")
    check(torch.equal(cs0.bvh.node_child, cs1.bvh.node_child),
          "REFIT changed the topology")
    lo, up = tri_bounds(moved, idx)
    refit_ms, _ = host_ms(lambda: refit_bvh(cs0.bvh, lo, up))
    del cs0, native
    fresh, _ = commit_timed(tri_scene(pt, moved, idx), "moved, fresh")
    tr.reset_launch_counts()
    hit_r = pt.intersect(cs1, rays, differentiable=False)
    torch.cuda.synchronize()
    check(tr.LAUNCHES.get("closest_attrs", 0) > 0, "REFIT: no B1 launch")
    hit_f = pt.intersect(fresh, rays, differentiable=False)
    share = same_hits(hit_r, hit_f, "REFIT vs a fresh commit")
    say(f"  REFIT: re-commit {refit_s:.3f} s (refit_bvh alone "
        f"{refit_ms / 1e3:.3f} s) against the full build's {full_s:.3f} s; "
        f"{card}")
    out["refit"] = dict(refit_s=refit_s, build_s=full_s,
                        refit_alone_s=refit_ms / 1e3,
                        same_prim_share=share)
    del cs1, fresh, hit_r, hit_f, rays
    torch.cuda.empty_cache()

    # ---- HIGH: pre-split slivers ----
    verts, idx = slivers(SLIVERS)
    org, d = incoherent_rays(SLIVER_RAYS, 12)
    rays = pt.make_rays(org * np.float32(1.5), d, device=DEV)
    trees = {}
    for quality in ("MEDIUM", "HIGH"):
        with build_route("auto"):
            cs, secs = commit_timed(tri_scene(
                pt, verts, idx, quality=getattr(pt.BuildQuality, quality)),
                f"slivers, {quality}")
        tr.reset_launch_counts()
        hit = pt.intersect(cs, rays, differentiable=False)
        torch.cuda.synchronize()
        check(tr.LAUNCHES.get("closest_attrs", 0) > 0,
              f"slivers {quality}: no B1 launch")
        trees[quality] = (cs, secs, float(sah_cost(cs.bvh)), hit)
    (med, med_s, c_med, h_med), (high, high_s, c_high, h_high) = (
        trees["MEDIUM"], trees["HIGH"])
    check(c_high < c_med, f"HIGH sah_cost {c_high} !< MEDIUM {c_med}")
    check(torch.equal(h_high.valid, h_med.valid),
          "slivers: HIGH and MEDIUM hit masks differ")
    check(torch.allclose(h_high.t[h_med.valid], h_med.t[h_med.valid],
                         rtol=1e-5), "slivers: HIGH and MEDIUM hit t differ")
    say(f"  slivers: {high.bvh.n_prims} refs for {med.num_prims} prims; "
        f"sah_cost HIGH {c_high:.4f} < MEDIUM {c_med:.4f}; commits "
        f"{high_s:.3f} / {med_s:.3f} s; {int(h_med.valid.sum())} hits, "
        "masks equal, t within 1e-5")
    out["high"] = dict(sah_cost=c_high, medium_sah_cost=c_med,
                       commit_s=high_s, medium_commit_s=med_s,
                       refs=int(high.bvh.n_prims))
    del trees, med, high, h_med, h_high
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 20 took {out['phase_s']:.1f} s")


def scene_mb(cs):
    """Bytes of every tensor of a committed scene, in MB."""
    n = 0
    for f in dataclasses.fields(cs):
        x = getattr(cs, f.name)
        for y in ((x.nodes, x.leaves, x.pid_map) if f.name == "packed"
                  and x is not None else
                  (x.node_lower, x.node_upper, x.node_child, x.prim_order)
                  if f.name == "bvh" else (x,)):
            if isinstance(y, torch.Tensor):
                n += y.numel() * y.element_size()
    return n / 1e6


def user_spheres(n, seed=5):
    """n small spheres in the ray box: (centers, radii, intersect_fn) on
    the card; the function is the UserGeometry callback."""
    rng = np.random.default_rng(seed)
    c = torch.tensor(rng.uniform(-2, 2, (n, 3)), dtype=torch.float32,
                     device=DEV)
    r = torch.tensor(rng.uniform(0.01, 0.03, n), dtype=torch.float32,
                     device=DEV)

    def fn(didx, org, dir, tnear, tfar):
        oc = org - c[didx]
        rr = r[didx]
        a = (dir * dir).sum(-1)
        b = (oc * dir).sum(-1)
        disc = b * b - a * ((oc * oc).sum(-1) - rr * rr)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0, t1 = (-b - sq) / a, (-b + sq) / a
        t = torch.where(t0 >= tnear, t0, t1)
        hit = (disc >= 0) & (t >= tnear) & (t <= tfar)
        ng = oc + dir * t[..., None]
        return hit, t, torch.zeros_like(t), torch.zeros_like(t), ng
    return c, r, fn


def engine_vs_brute(pt, cs, rays, label):
    """The generic engine's intersect and occluded on the rays (host ms),
    held against brute force on the first BRUTE_SAMPLE of them."""
    ms_i, h = host_ms(lambda: pt.intersect(cs, rays))
    ms_o, occ = host_ms(lambda: pt.occluded(cs, rays))
    check(torch.equal(occ, h.valid), f"{label}: occluded != intersect")
    sub = pt.RayBatch(*(getattr(rays, f)[:BRUTE_SAMPLE] for f in
                        ("org", "dir", "tnear", "tfar", "time", "mask")))
    hb = pt.intersect_brute(cs, sub, chunk=1 << 12)
    hk = pt.intersect(cs, sub)
    check(torch.equal(hb.valid, hk.valid), f"{label}: brute masks differ")
    m = hb.valid
    check(torch.allclose(hb.t[m], hk.t[m], rtol=1e-6),
          f"{label}: brute t differs")
    check(bool((hb.prim_id[m] == hk.prim_id[m]).float().mean() > 0.95),
          f"{label}: brute prims differ")
    say(f"  {label}: {int(h.valid.sum())} of {rays.shape[0]} rays hit; "
        f"intersect {ms_i:.1f} ms, occluded {ms_o:.1f} ms (host clock); "
        f"brute force on {BRUTE_SAMPLE} rays: {int(m.sum())} hits, equal")
    return h, ms_i, ms_o


def phase_scene_api(pt, tr, sphere_mesh, out):
    say("phase 21: the rest of Scene on the card")
    t_phase = time.perf_counter()
    card = out.get("card") or card_line()
    verts, idx = sphere_mesh(*MAIN_MESH)
    org, d = incoherent_rays(MAIN_RAYS, 0)
    rays = pt.make_rays(org, d, device=DEV)
    del org, d

    # ---- compact: B1's attributes serve the differentiable intersect ----
    base, _ = commit_timed(tri_scene(pt, verts, idx), "main sphere")
    comp, _ = commit_timed(tri_scene(pt, verts, idx, compact=True),
                           "main sphere, compact")
    check(comp.compact and comp.tri_v0.shape[0] == 0,
          "compact: triangle tables kept")
    tr.reset_launch_counts()
    hc = pt.intersect(comp, rays)
    torch.cuda.synchronize()
    launches = dict(tr.LAUNCHES)
    check(launches.get("closest_attrs", 0) > 0 and
          launches.get("closest", 0) == 0,
          f"compact: not B1's attribute path ({launches})")
    hb = pt.intersect(base, rays, differentiable=False)
    for f in ("t", "u", "v", "ng", "prim_id", "geom_id", "inst_id"):
        x, y = getattr(hc, f), getattr(hb, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        check(torch.equal(x, y), f"compact: {f} differs")
    mb_c, mb_b = scene_mb(comp), scene_mb(base)
    say(f"  compact: launches {launches}; intersect == the fast path of the "
        f"full scene bit for bit; {mb_c:.1f} MB against {mb_b:.1f} MB")
    out["compact"] = dict(mb=mb_c, full_mb=mb_b)
    del base, comp, hc, hb
    torch.cuda.empty_cache()

    # ---- a filter rejecting odd prim ids, both contexts ----
    sub = pt.RayBatch(*(getattr(rays, f)[:ENGINE_SCENE_RAYS] for f in
                        ("org", "dir", "tnear", "tfar", "time", "mask")))
    del rays
    s = tri_scene(pt, verts, idx)
    s.get(0).filter = (lambda org, dir, t, u, v, ng, prim_id, geom_id:
                       prim_id % 2 == 0)
    cs, secs = commit_timed(s, "main sphere, odd prims filtered")
    check(cs.packed is None, "a filter scene has a packed table")
    h, ms_i, ms_o = engine_vs_brute(pt, cs, sub, "filter")
    check(bool((h.prim_id[h.valid] % 2 == 0).all()),
          "filter: an odd prim was hit")
    out["filter"] = dict(intersect_ms=ms_i, occluded_ms=ms_o, rays=
                         ENGINE_SCENE_RAYS, commit_s=secs)
    del cs, h
    torch.cuda.empty_cache()

    # ---- user geometry: spheres with a torch intersect function ----
    c, r, fn = user_spheres(USER_SPHERES)
    s = pt.Scene()
    s.attach(pt.UserGeometry(
        bounds_lower=(c - r[:, None]).cpu().numpy(),
        bounds_upper=(c + r[:, None]).cpu().numpy(), intersect_fn=fn))
    cs, secs = commit_timed(s, "user spheres")
    h, ms_i, ms_o = engine_vs_brute(pt, cs, sub, "user spheres")
    check(int(h.valid.sum()) > ENGINE_SCENE_RAYS // 100,
          "user spheres: too few hits")
    out["user"] = dict(intersect_ms=ms_i, occluded_ms=ms_o,
                       rays=ENGINE_SCENE_RAYS, commit_s=secs)
    del cs, h, sub

    # ---- the progress monitor ----
    s = tri_scene(pt, *sphere_mesh(*BUILD_MESH))
    seen = []
    s.set_progress_monitor(lambda f: (seen.append(f), True)[1])
    s.commit(device=DEV)
    check(seen == [0.0, 0.25, 0.5, 0.8, 1.0], f"milestones {seen}")
    s.set_progress_monitor(lambda f: f < 0.4)
    try:
        s.commit(device=DEV)
        check(False, "a vetoed commit went through")
    except pt.CommitCancelled:
        pass
    s.set_progress_monitor(None)
    check(s.commit(device=DEV).num_prims == 2 * BUILD_MESH[0] * BUILD_MESH[1],
          "no commit after a cancel")
    say(f"  progress: {seen}; a veto at 0.5 raised CommitCancelled; the "
        "scene committed afterwards")
    out["phase21_s"] = time.perf_counter() - t_phase
    say(f"  phase 21 took {out['phase21_s']:.1f} s; {card}")


def similarity(rng, scale, t):
    """A (3, 4) similarity: a random rotation (a unit axis, an angle in
    [0, 2 pi)), a uniform scale and a translation."""
    from embree_tpu_torch.core.math import quat_from_axis_angle, \
        quat_to_matrix
    axis = rng.standard_normal(3).astype(np.float32)
    q = quat_from_axis_angle(axis, np.float32(rng.uniform(0, 2 * np.pi)))
    r = quat_to_matrix(q) * np.float32(scale)
    return np.concatenate([r, np.asarray(t, np.float32)[:, None]],
                          1).astype(np.float32)


def instance_ring(n, seed=5, radius=INST_RING):
    """Phase 22's transforms: similarities with scale U(0.5, 1.5) on a ring
    of ``radius`` in the xy plane (numpy seed 5)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        a = 2 * np.pi * k / n
        out.append(similarity(rng, rng.uniform(0.5, 1.5),
                              (radius * np.cos(a), radius * np.sin(a), 0.0)))
    return np.stack(out)


def check_instance_boxes(rays, hit, xfs, gids, n, label):
    """On the first n rays: each hit point lies in the world box of the
    instance its hit reports (the unit sphere under that instance's
    transform: center t, radius |scale|)."""
    valid = hit.valid[:n]
    p = (rays.org[:n] + hit.t[:n, None] * rays.dir[:n])[valid].double()
    inst = hit.inst_id[:n, 0][valid]
    xf = torch.as_tensor(xfs, device=p.device).double()
    slot = torch.searchsorted(torch.as_tensor(gids, device=p.device), inst)
    center = xf[slot, :, 3]
    radius = xf[slot, :, :3].norm(dim=1).amax(1)
    inside = ((p - center).abs() <= radius[:, None] * (1 + 1e-4)
              + 1e-4).all(1)
    check(bool(inside.all()), f"{label}: a hit lies outside its instance's "
          "box")
    say(f"  {label}: {int(valid.sum())} hits of {n} rays, each in the world "
        "box of the instance it reports")


def instance_check_cells(pt, tr, sphere_mesh, errs):
    """Phase 22's check-size scenes: the 16K-tri check sphere under a
    2-step translated instance, a quaternion-rotated instance (90 degrees
    about z, tests/test_motion_blur.py:104) and a nested two-level
    instance; 65,536 rays each, through the entry points, every variant
    held against the plain version on all rays."""
    from embree_tpu_torch.core.math import (QuaternionDecomposition,
                                            affine_identity,
                                            quat_from_axis_angle,
                                            quat_identity)
    verts, idx = sphere_mesh(*CHECK_MESH)
    child = tri_scene(pt, verts, idx)
    org, d = incoherent_rays(KINDS_RAYS, 0)
    time = ray_times(KINDS_RAYS)
    moving_xf = np.stack([affine_identity()] * 2)
    moving_xf[1, 0, 3] = MOTION_SHIFT
    shift = affine_identity()
    shift[0, 3] = 1.0
    qd0 = QuaternionDecomposition(shift, quat_identity(),
                                  np.zeros(3, np.float32))
    qd1 = QuaternionDecomposition(
        shift, quat_from_axis_angle(np.array([0, 0, 1], np.float32),
                                    np.pi / 2), np.zeros(3, np.float32))
    mid = pt.Scene()
    inner = mid.attach(pt.InstanceGeometry(child, shift))
    cells = {"moving": pt.InstanceGeometry(child, moving_xf),
             "quaternion": pt.InstanceGeometry(child, (qd0, qd1)),
             "nested": pt.InstanceGeometry(mid, similarity(
                 np.random.default_rng(6), 0.8, (0.0, -0.5, 0.2)))}
    launches = {}
    for label, g in cells.items():
        s = pt.Scene()
        gid = s.attach(g)
        cs = s.commit(device=DEV)
        check(isinstance(cs, pt.CommittedScene), f"{label}: not flattened")
        check(cs.has_motion == (label != "nested")
              and cs.packed.has_win == (label == "quaternion"),
              f"{label}: wrong motion flags")
        rays = pt.make_rays(org, d, time=time, device=DEV)
        tr.reset_launch_counts()
        hit = pt.intersect(cs, rays, differentiable=False)
        hd = pt.intersect(cs, rays)
        occ = pt.occluded(cs, rays)
        torch.cuda.synchronize()
        got = dict(tr.LAUNCHES)
        add_counts(launches, got)
        check(torch.equal(occ, hit.valid) and torch.equal(hd.valid,
                                                          hit.valid),
              f"{label}: the entry points disagree")
        v = hit.valid
        check(int(v.sum()) > KINDS_RAYS // 64, f"{label}: too few hits")
        check(bool((hit.inst_id[v, 0] == gid).all()),
              f"{label}: wrong instance id")
        check(bool((hit.inst_id[v, 1] == (inner if label == "nested"
                                          else pt.INVALID_ID)).all()),
              f"{label}: wrong nested instance id")
        inputs = sorted_inputs(tr, rays)
        for _, o, a in VARIANTS:
            name = tr.packed_variant(cs.packed, o, a, False)
            check(got.get(name, 0) > 0, f"{label}: {name} not launched")
            errs[name] = max(errs.get(name, 0.0), compare(
                tr, cs.packed, inputs, KINDS_RAYS, o, a,
                f"{label} instance: {name}"))
        say(f"  {label} instance: {cs.num_prims} prims, {int(v.sum())} "
            f"hits; launches {got}")
    return launches


def phase_instances(pt, tr, sphere_mesh, errs, out):
    """Phase 22: flattened instances at full size, and the check-size
    motion and nesting cells."""
    say(f"phase 22: flattened instances: {INST_COUNT} instances of "
        f"sphere_mesh{INST_MESH} under similarities, {INST_RAYS} rays")
    t_phase = time.perf_counter()
    verts, idx = sphere_mesh(*INST_MESH)
    child = tri_scene(pt, verts, idx)
    xfs = instance_ring(INST_COUNT)
    s = pt.Scene()
    gids = [s.attach(pt.InstanceGeometry(child, x)) for x in xfs]
    cs, commit_s = commit_timed(s, f"{INST_COUNT} instances, flattened")
    check(isinstance(cs, pt.CommittedScene)
          and cs.num_prims == INST_COUNT * 2 * INST_MESH[0] * INST_MESH[1],
          "the instances were not flattened")
    org, d = incoherent_rays(INST_RAYS, 0)
    rays = pt.make_rays(org, d, device=DEV)
    del org, d
    tr.reset_launch_counts()
    hit = pt.intersect(cs, rays, differentiable=False)
    hd = pt.intersect(cs, rays)
    occ = pt.occluded(cs, rays)
    torch.cuda.synchronize()
    launches = dict(tr.LAUNCHES)
    say(f"  launches on the flattened-instance path: {launches}")
    check(all(launches.get(n, 0) > 0 for n, _, _ in VARIANTS),
          "the instance path did not launch every B1 variant")
    v = hit.valid
    check(torch.equal(occ, v) and torch.equal(hd.valid, v),
          "instances: the entry points disagree")
    check(bool(torch.isfinite(hit.t[v]).all())
          and bool(torch.isfinite(hit.ng[v]).all()), "non-finite hits")
    check_instance_boxes(rays, hit, xfs, gids, CHECK_RAYS, "instances")
    del hit, hd, occ, v
    inputs = sorted_inputs(tr, rays)
    plain = {}
    for name, o, a in VARIANTS:
        errs[name] = max(errs.get(name, 0.0), compare(
            tr, cs.packed, inputs, MAIN_COMPARE, o, a,
            f"instances: {name}", plain=plain))
    card = card_line()
    total_ms = {
        "closest_attrs": events_ms(
            lambda: pt.intersect(cs, rays, differentiable=False)),
        "occluded": events_ms(lambda: pt.occluded(cs, rays)),
    }
    rec = {}
    time_variants(tr, cs.packed, inputs, VARIANTS, rec, table_mb(cs.packed),
                  card, launches, total_ms=total_ms, plain=plain)
    out["flattened"] = dict(commit_s=commit_s,
                            table_mb=table_mb(cs.packed) / 1e6,
                            prims=cs.num_prims, kernels=rec, card=card)
    del cs, rays, inputs
    torch.cuda.empty_cache()
    out["check_launches"] = instance_check_cells(pt, tr, sphere_mesh, errs)
    add_counts(launches, out["check_launches"])
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 22: {out['phase_s']:.1f} s")
    return launches


def same_up_to_ties(a, b, rays, label):
    """Hits ``a`` of a two-level scene against ``b`` of its flattening.
    Object space and world space round differently, by about the
    coordinates' ulp (about 8e-6 at this grid's 100), an absolute error:
    where both hit the same prim of the same instance, t agrees within
    2e-4 of max(t, 1) over the cosine of the incidence, clamped at 0.05 (a
    grazing ray's hit moves along the surface), on every ray. A near-tie is
    a ray that passes within rounding of a triangle's edge (the shared edge
    of two prims, a crack of the non-watertight Moeller test, or the
    silhouette of a grazing ray: the least barycentric times the cosine
    under 1e-3) or that starts within rounding of a surface (its hit under
    1e-5 of its origin's distance from 0 away). Only there may the prim or
    instance ids differ (then t is that of another triangle); a hit mask
    may differ only where the ray starts on a surface (one side puts the
    hit behind tnear) or at a silhouette (a near-tie at a cosine under
    0.05). PERF.md section 4 gives the counts on the card behind each
    part: a bound relative to t alone, or equal masks everywhere, fails
    there. Returns the number of rays that differ and the hits in both."""
    def cosine(h):
        return (h.ng * rays.dir).sum(1).abs() / (
            h.ng.norm(dim=1) * rays.dir.norm(dim=1)).clamp(min=1e-30)

    def start(h):
        return h.valid & (h.t * rays.dir.norm(dim=1) < 1e-5 * rays.org.norm(
            dim=1).clamp(min=1.0))

    def edge(h):
        bary = torch.minimum(torch.minimum(h.u, h.v), 1.0 - h.u - h.v)
        return h.valid & (bary.abs() * cosine(h) < 1e-3)
    starts = start(a) | start(b)
    near_tie = edge(a) | edge(b) | starts
    silhouette = (edge(a) & (cosine(a) < 0.05)) | (
        edge(b) & (cosine(b) < 0.05))
    mask_diff = a.valid != b.valid
    m = a.valid & b.valid
    diff = m & ((a.prim_id != b.prim_id) | (a.inst_id != b.inst_id).any(1))
    same = m & ~diff
    dt = (a.t - b.t).abs() / b.t.abs().clamp(min=1.0)
    scaled = dt * torch.minimum(cosine(a), cosine(b)).clamp(min=0.05)
    far = same & (scaled > 2e-4)
    bad = (mask_diff & ~(starts | silhouette)) | far | (diff & ~near_tie)
    for i in torch.nonzero(bad).squeeze(1)[:4].tolist():
        say(f"  ray {i}: " + "; ".join(
            f"{n} valid {bool(h.valid[i])} t {float(h.t[i])!r} prim "
            f"{int(h.prim_id[i])} u {float(h.u[i]):.3e} v "
            f"{float(h.v[i]):.3e} cos {float(cosine(h)[i]):.3e}"
            for n, h in (("two-level", a), ("flattened", b))))
    check(not bool(bad.any()), f"{label}: {int(bad.sum())} rays differ "
          "beyond the rule")
    ties = int((mask_diff | diff).sum())
    say(f"  {label}: {int(m.sum())} hits in both, {int(same.sum())} on the "
        f"same prim, their t within 2e-4 of max(t, 1) over the cosine "
        f"(max {scaled[same].max().item():.3e}); "
        f"{int(mask_diff.sum())} hit masks differ ({int((mask_diff & starts).sum())} "
        f"at a start, {int((mask_diff & silhouette & ~starts).sum())} at a "
        f"silhouette) and {int(diff.sum())} prim or instance ids, all at "
        f"near-ties ({int(near_tie.sum())} rays near an edge or their "
        f"origin, {int(starts.sum())} of them at their origin)")
    return ties, int(m.sum())


def grid_transforms(seed=5):
    """Phase 23's grid: GRID x GRID instances on the xz plane at spacing
    GRID_SPACING, each turned by a random angle about y and scaled by
    U(0.5, 1.2) (numpy seed 5)."""
    rng = np.random.default_rng(seed)
    n = GRID * GRID
    ang = rng.uniform(0, 2 * np.pi, n)
    sc = rng.uniform(0.5, 1.2, n)
    c, s_ = np.cos(ang) * sc, np.sin(ang) * sc
    xf = np.zeros((n, 3, 4), np.float32)
    xf[:, 0, 0], xf[:, 0, 2] = c, s_
    xf[:, 1, 1] = sc
    xf[:, 2, 0], xf[:, 2, 2] = -s_, c
    half = (GRID - 1) * GRID_SPACING / 2
    ij = np.stack(np.meshgrid(np.arange(GRID), np.arange(GRID),
                              indexing="ij"), -1).reshape(-1, 2)
    xf[:, 0, 3] = ij[:, 0] * GRID_SPACING - half
    xf[:, 2, 3] = ij[:, 1] * GRID_SPACING - half
    return xf


def box_rays(n, lo, up, seed=0):
    """n rays with origins uniform over the box [lo, up] grown by 10% and
    directions N(0, 1)^3 (numpy seed ``seed``)."""
    rng = np.random.default_rng(seed)
    lo, up = np.asarray(lo, np.float64), np.asarray(up, np.float64)
    pad = 0.05 * (up - lo)
    org = rng.uniform(lo - pad, up + pad, (n, 3)).astype(np.float32)
    return org, rng.standard_normal((n, 3), dtype=np.float32)


def phase_two_level(pt, tr, sphere_mesh, errs, out):
    """Phase 23: the two-level cell."""
    from embree_tpu_torch import tlas
    say(f"phase 23: two-level cell: {GRID * GRID} instances of "
        f"sphere_mesh{GRID_MESH} on a {GRID} x {GRID} grid and one of "
        f"sphere_mesh{MAIN_MESH} above it, {TWO_LEVEL_RAYS} rays")
    t_phase = time.perf_counter()
    small = tri_scene(pt, *sphere_mesh(*GRID_MESH))
    big = tri_scene(pt, *sphere_mesh(*MAIN_MESH))
    blas_s = {}
    cs_small, blas_s["small"] = commit_timed(small, "the grid's BLAS")
    cs_big, blas_s["big"] = commit_timed(big, "the raised sphere's BLAS")
    xfs = grid_transforms()
    half = (GRID - 1) * GRID_SPACING / 2
    big_xf = np.array([[BIG_SCALE, 0, 0, 0], [0, BIG_SCALE, 0, BIG_HEIGHT],
                       [0, 0, BIG_SCALE, 0]], np.float32)
    top = pt.Scene()
    arr = top.attach(pt.InstanceArrayGeometry(cs_small, xfs))
    one = top.attach(pt.InstanceGeometry(cs_big, big_xf))
    ms, tl = host_ms(lambda: top.commit(device=DEV))
    check(isinstance(tl, tlas.TwoLevelScene) and tl.n_children == 2
          and tl.num_instances == GRID * GRID + 1,
          "the grid did not commit two-level")
    n_tris = GRID * GRID * cs_small.num_prims + cs_big.num_prims
    say(f"  commit: BLASes {blas_s['small']:.3f} s + {blas_s['big']:.3f} s "
        f"(apart), TLAS over {tl.num_instances} instances {ms / 1e3:.3f} s; "
        f"{n_tris} instanced triangles")
    # ---- REFIT: every transform moved, no BLAS rebuilt ----
    ptrs = [(c.bvh.node_lower.data_ptr(), c.packed.nodes.data_ptr(),
             c.packed.leaves.data_ptr()) for c in tl.children]
    top.get(arr).transforms = xfs + np.float32(0)
    top.get(arr).transforms[:, 1, 3] += np.float32(0.1)
    top.get(one).transform = big_xf + np.float32(0)
    top.get(one).transform[0, 3] += np.float32(0.5)
    top.quality = pt.BuildQuality.REFIT
    upd_ms, tl2 = host_ms(lambda: top.commit(device=DEV))
    check(all(a is b for a, b in zip(tl2.children, tl.children))
          and [(c.bvh.node_lower.data_ptr(), c.packed.nodes.data_ptr(),
                c.packed.leaves.data_ptr()) for c in tl2.children] == ptrs,
          "update_transforms rebuilt a BLAS")
    say(f"  update_transforms after moving all {tl.num_instances} "
        f"transforms: {upd_ms / 1e3:.3f} s, every BLAS tensor kept")
    tl = tl2
    lo = xfs[:, :, 3].min(0) - 1.2
    up = xfs[:, :, 3].max(0) + 1.2
    org, d = box_rays(TWO_LEVEL_RAYS, lo, up)
    rays = pt.make_rays(org, d, device=DEV)
    del org, d
    # ---- the path: launch counts zeroed just before, read just after ----
    tr.reset_launch_counts()
    stats = []
    hit = tlas.intersect_two_level(tl, rays, stats=stats)
    occ = pt.occluded(tl, rays)
    torch.cuda.synchronize()
    launches = dict(tr.LAUNCHES)
    say(f"  launches on the two-level path: {launches}")
    check(launches.get("closest", 0) > 0, "the BLAS pass did not launch B1")
    v = hit.valid
    check(torch.equal(occ, v), "two-level: occluded disagrees")
    check(bool(torch.isfinite(hit.t[v]).all()), "two-level: non-finite t")
    check(bool(((hit.inst_id[v, 0] == arr) | (hit.inst_id[v, 0] == one))
               .all()), "two-level: wrong instance ids")
    say(f"  intersect: {int(v.sum())} of {TWO_LEVEL_RAYS} rays hit, "
        f"{int((hit.inst_id[v, 0] == one).sum())} on the raised sphere")
    for k, w in enumerate(stats):
        say(f"  wave {k}: {w['rays']} rays, {w['collect_steps']} collect "
            f"steps, {w['overflow']} overflowed, lanes per child "
            f"{w.get('child_lanes')}, collect "
            f"{w.get('collect_ms', math.nan):.3f} ms, BLAS pass "
            f"{w.get('blas_ms', math.nan):.3f} ms")
    del hit, occ, v
    # ---- wave 1's BLAS launches against the plain version, and timed ----
    flat = rays
    cand, _, _ = tlas._collect_loop(tl, flat, tlas.MAX_CANDIDATES)
    card = card_line()
    child_ms = {}
    for c, child in enumerate(tl.children):
        lanes, rr = tlas.child_rays(tl, flat, cand, c)
        inputs = sorted_inputs(tr, rr)
        n = int(lanes.shape[0])
        errs["closest"] = max(errs.get("closest", 0.0), compare(
            tr, child.packed, inputs, min(n, TWO_LEVEL_COMPARE), False,
            False, f"BLAS {c} (wave 0's {n} lanes): closest"))
        child_ms[c] = events_ms(lambda: run_kernel(
            tr, child.packed, inputs, occlusion=False), reps=3)
        say(f"  BLAS {c}: kernel {child_ms[c]:.3f} ms on {n} object-space "
            f"rays (wave 0) [{card}]")
        del inputs, rr, lanes
    del cand
    torch.cuda.empty_cache()
    entry = {"intersect": events_ms(lambda: pt.intersect(tl, rays), reps=3),
             "occluded": events_ms(lambda: pt.occluded(tl, rays), reps=3)}
    say(f"  entry points: intersect {entry['intersect']:.3f} ms, occluded "
        f"{entry['occluded']:.3f} ms ({TWO_LEVEL_RAYS} rays) [{card}]")
    del rays
    torch.cuda.empty_cache()
    # ---- two levels against the flattening of an 8 x 8 sub-grid ----
    sub = xfs.reshape(GRID, GRID, 3, 4)[:SUB_GRID, :SUB_GRID].reshape(-1, 3, 4)
    s2 = pt.Scene()
    s2.attach(pt.InstanceArrayGeometry(small, sub))
    tl_sub = s2.commit(device=DEV, two_level=True)
    flat_ms, flat_sub = host_ms(lambda: s2.commit(device=DEV,
                                                  two_level=False))
    say(f"  the {SUB_GRID} x {SUB_GRID} sub-grid flattened: "
        f"{flat_sub.num_prims} prims in {flat_ms / 1e3:.3f} s, table "
        f"{table_mb(flat_sub.packed) / 1e6:.3f} MB")
    org, d = box_rays(SUB_RAYS, sub[:, :, 3].min(0) - 1.2,
                      sub[:, :, 3].max(0) + 1.2, seed=1)
    rays = pt.make_rays(org, d, device=DEV)
    a = pt.intersect(tl_sub, rays)
    b = pt.intersect(flat_sub, rays)
    ties, both = same_up_to_ties(a, b, rays, f"sub-grid ({SUB_GRID} x {SUB_GRID}, "
                           f"{SUB_RAYS} rays): two levels against the "
                           "flattening")
    out["two_level"] = dict(
        blas_commit_s=blas_s, tlas_s=ms / 1e3, update_s=upd_ms / 1e3,
        instances=int(tl.num_instances), instanced_tris=int(n_tris),
        waves=stats, child_kernel_ms=child_ms, entry_ms=entry,
        near_ties=ties, sub_hits=both, card=card,
        launches=launches)
    out["two_level"]["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 23: {out['two_level']['phase_s']:.1f} s")
    return launches


def torus_cage(nu, nv, big=1.0, small=0.35):
    """A torus of nu x nv quad faces (nu around the axis, nv around the
    tube), one crease loop of weight 2 along the outer equator. Returns
    (vertices, face counts, indices, creases)."""
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a, b = 2 * np.pi * i / nu, 2 * np.pi * j / nv
    v = np.stack([(big + small * np.cos(b)) * np.cos(a),
                  (big + small * np.cos(b)) * np.sin(a),
                  small * np.sin(b)], -1).reshape(-1, 3).astype(np.float32)

    def vid(p, q):
        return (p % nu) * nv + (q % nv)
    f = np.stack([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1),
                  vid(i, j + 1)], -1).reshape(-1)
    creases = {tuple(sorted((int(vid(k, 0)), int(vid(k + 1, 0))))): 2.0
               for k in range(nu)}
    return v, np.full(nu * nv, 4, np.int64), f.astype(np.int64), creases


def subdiv_cube(levels, steps, time_range):
    """The unit cube cage (tests/test_subdiv_grid.py:14-21) moving along x
    over ``steps`` steps."""
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32)
    f = np.array([[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1],
                  [2, 3, 7, 6], [0, 2, 6, 4], [1, 5, 7, 3]], np.int64)
    return (moving(v, (MOTION_SHIFT, 0, 0), steps), np.full(6, 4, np.int64),
            f.reshape(-1), levels, time_range)


@contextlib.contextmanager
def timed_refinement(pt, spent):
    """The merger's Catmull-Clark refinement timed on the host clock (the
    seconds go into ``spent``), apart from the rest of the commit."""
    ops = pt.scene.subdiv_ops
    orig = ops.catmull_clark

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        spent.append(time.perf_counter() - t0)
        return out
    ops.catmull_clark = timed
    try:
        yield
    finally:
        ops.catmull_clark = orig


def quad_cell(pt, tr, label, cs, rays, errs, out, card):
    """A full-size cell whose quads ride B1 as two triangle slots: the
    three entry points (launch counts zeroed just before, read after),
    kernel vs plain version on a strided sample, the full-size launches
    held on those rays, and each time: the entry point, the selection
    (sort, kernel, unsort), the kernel, the wrapper (selection - kernel)
    and the re-intersection (entry point - selection). Returns (the fast
    path's hits, the launches)."""
    from embree_tpu_torch import scene as scene_mod
    tr.reset_launch_counts()
    hit = pt.intersect(cs, rays, differentiable=False)
    hd = pt.intersect(cs, rays)
    occ = pt.occluded(cs, rays)
    torch.cuda.synchronize()
    launches = dict(tr.LAUNCHES)
    say(f"  {label}: launches {launches}")
    for _, o, a in KIND_VARIANTS:
        name = tr.packed_variant(cs.packed, o, a, False)
        check(launches.get(name, 0) > 0, f"{label}: {name} not launched")
    v = hit.valid
    check(torch.equal(hd.valid, v) and torch.equal(
        hd.t.detach().view(torch.int32), hit.t.view(torch.int32)),
        f"{label}: the two intersect modes disagree")
    check(torch.equal(occ, v), f"{label}: occluded disagrees")
    check(bool(torch.isfinite(hit.t[v]).all())
          and bool(torch.isfinite(hit.ng[v]).all()), f"{label}: non-finite")
    say(f"  {label}: {int(v.sum())} of {v.shape[0]} rays hit")
    del hd, occ
    inputs = sorted_inputs(tr, rays)
    plain = {}
    for name, o, a in KIND_VARIANTS:
        key = tr.packed_variant(cs.packed, o, a, False)
        errs[key] = max(errs.get(key, 0.0), compare(
            tr, cs.packed, inputs, MAIN_COMPARE, o, a, f"{label}: {key}",
            plain=plain))
    total_ms = {"closest": events_ms(
        lambda: pt.intersect(cs, rays, differentiable=False)),
        "occluded": events_ms(lambda: pt.occluded(cs, rays))}
    select_ms = events_ms(lambda: scene_mod._select(cs, rays, False))
    rec = {}
    time_variants(tr, cs.packed, inputs, KIND_VARIANTS, rec,
                  table_mb(cs.packed), card, launches, total_ms=total_ms,
                  plain=plain)
    kernel_ms = rec[tr.packed_variant(cs.packed, False, False, False)]["ms"]
    split = dict(entry_point_ms=total_ms["closest"], select_ms=select_ms,
                 kernel_ms=kernel_ms, wrapper_ms=select_ms - kernel_ms,
                 reintersect_ms=total_ms["closest"] - select_ms)
    say(f"  {label}: intersect(differentiable=False) "
        f"{split['entry_point_ms']:.3f} ms = wrapper "
        f"{split['wrapper_ms']:.3f} + kernel "
        f"{kernel_ms:.3f} + re-intersection {split['reintersect_ms']:.3f} "
        f"ms; occluded {total_ms['occluded']:.3f} ms [{card}]")
    out[label] = dict(kernels=rec, split=split, card=card)
    del inputs
    return hit, launches


def check_variant_cells(pt, tr, errs, out, card):
    """Phase 24's moving and mixed cells at 65,536 rays: a 2-step moving
    grid sphere (B6), the subdivided cube at levels 3 over 3 steps with a
    time range (B6 with windows), and a grid sphere beside points and
    round lines (B3-B5); every variant held against the plain version on
    all rays."""
    org, d = incoherent_rays(KINDS_RAYS, 0)
    times = ray_times(KINDS_RAYS)
    gv, grows = prim_sphere("grid", (0, 0, 0), 1.0, CHECK_GRID_N)
    cells = {}
    s = pt.Scene()
    s.attach(pt.GridGeometry(moving(gv, (MOTION_SHIFT, 0, 0), 2), grows))
    cells["moving grid"] = (s, True, False)
    v, fc, idx, lv, trange = subdiv_cube(3, 3, (0.1, 0.9))
    s = pt.Scene()
    s.attach(pt.SubdivisionGeometry(v, fc, idx, levels=lv,
                                    time_range=trange))
    cells["moving subdivision"] = (s, True, True)
    s = pt.Scene()
    s.attach(pt.GridGeometry(gv, grows))
    pos, _ = point_sphere((1.6, 0, 0), 0.5, 0.02, 32)
    s.attach(pt.PointGeometry(pos, kind="sphere"))
    s.attach(pt.LineSegmentsGeometry(*hair(np.random.default_rng(3),
                                           (0, -1.6, 0), 1024, r0=0.01,
                                           r1=0.005), kind="round"))
    cells["grid, points, lines"] = (s, False, False)
    launches = {}
    for label, (s, motion, win) in cells.items():
        cs = s.commit(device=DEV)
        check(cs.has_motion == motion and cs.packed.has_win == win
              and cs.packed.has_kinds == (not motion),
              f"{label}: wrong flags")
        rays = pt.make_rays(org, d, time=times, device=DEV)
        tr.reset_launch_counts()
        hit = pt.intersect(cs, rays)
        hk = pt.intersect(cs, rays, differentiable=False)
        occ = pt.occluded(cs, rays)
        torch.cuda.synchronize()
        got = dict(tr.LAUNCHES)
        add_counts(launches, got)
        check(torch.equal(occ, hit.valid) and torch.equal(hk.valid,
                                                          hit.valid),
              f"{label}: the entry points disagree")
        check(int(hit.valid.sum()) > KINDS_RAYS // 64, f"{label}: few hits")
        inputs = sorted_inputs(tr, rays)
        rec = {}
        for _, o, a in KIND_VARIANTS:
            name = tr.packed_variant(cs.packed, o, a, False)
            check(got.get(name, 0) > 0, f"{label}: {name} not launched")
            errs[name] = max(errs.get(name, 0.0), compare(
                tr, cs.packed, inputs, KINDS_RAYS, o, a, f"{label}: {name}"))
        time_variants(tr, cs.packed, inputs, KIND_VARIANTS, rec,
                      table_mb(cs.packed), card, got)
        out[label] = dict(prims=cs.num_prims, kernels=rec, launches=got)
        say(f"  {label}: {cs.num_prims} prims, {int(hit.valid.sum())} hits;"
            f" launches {got}")
    return launches


def phase_grids_subdiv(pt, tr, errs, out):
    """Phase 24: grids and subdivision surfaces at full size, and the
    check-size moving and mixed cells. Returns (the launches, the grid
    cell's geometry and a sample of its hits for phase 25)."""
    t_phase = time.perf_counter()
    card = card_line()
    n_quads = 6 * GRID_N * GRID_N
    say(f"phase 24: grids and subdivision: createGridSphere({GRID_N}), "
        f"{n_quads} quads, {GRID_RAYS} rays [{card}]")
    gv, grows = prim_sphere("grid", (0, 0, 0), 1.0, GRID_N)
    geom = pt.GridGeometry(gv, grows)
    s = pt.Scene()
    s.attach(geom)
    cs, commit_s = commit_timed(s, "grid sphere")
    check(cs.num_prims == n_quads and cs.packed.kind_classes == (0,)
          and not cs.packed.tri_attrs, "grid sphere: not two slots a quad")
    org, d = incoherent_rays(GRID_RAYS, 0)
    rays = pt.make_rays(org, d, device=DEV)
    del org, d
    hit, launches = quad_cell(pt, tr, "grid sphere", cs, rays, errs, out,
                              card)
    v = hit.valid
    pid = hit.prim_id[v]
    check(bool(((pid >= 0) & (pid < 6)).all()),
          "grid sphere: a prim id is not a grid index")
    u, w = hit.u[v], hit.v[v]
    say(f"  grid sphere: prim ids in 0..5; u in [{u.min().item():.9f}, "
        f"{u.max().item():.9f}], v in [{w.min().item():.9f}, "
        f"{w.max().item():.9f}]")
    check(bool((u >= -1e-6).all() & (u <= 1 + 1e-6).all()
               & (w >= -1e-6).all() & (w <= 1 + 1e-6).all()),
          "grid sphere: u/v outside [0, 1]")
    analytic_sphere_check(rays, hit, CHECK_RAYS, (GRID_N, 4 * GRID_N))
    n = min(int(v.sum()), CHECK_RAYS)
    sample = dict(prim=pid[:n], u=u[:n], v=w[:n],
                  point=(rays.org + hit.t[:, None] * rays.dir)[v][:n])
    out["grid sphere"].update(commit_s=commit_s, quads=n_quads,
                              table_mb=table_mb(cs.packed) / 1e6)
    del cs, rays, hit
    torch.cuda.empty_cache()

    nu, nv = TORUS
    tv, fc, idx, creases = torus_cage(nu, nv)
    n_sub = (nu * nv - len(TORUS_HOLES)) * 4 ** SUBDIV_LEVELS
    say(f"  subdivision: a torus cage of {nu} x {nv} quads, one crease "
        f"loop, {len(TORUS_HOLES)} holes, levels {SUBDIV_LEVELS}: {n_sub} "
        "quads")
    s = pt.Scene()
    s.attach(pt.SubdivisionGeometry(tv, fc, idx, levels=SUBDIV_LEVELS,
                                    creases=creases,
                                    holes=np.asarray(TORUS_HOLES)))
    spent = []
    with timed_refinement(pt, spent):
        cs, commit_s = commit_timed(s, "subdivision torus")
    check(cs.num_prims == n_sub, "subdivision: wrong quad count")
    check(not bool(np.isin(cs.prim_local.cpu().numpy(), TORUS_HOLES).any()),
          "subdivision: a hole was rendered")
    say(f"  subdivision: refinement {sum(spent):.3f} s of the "
        f"{commit_s:.3f} s commit (host clock) [{card}]")
    org, d = incoherent_rays(SUBDIV_RAYS, 1)
    rays = pt.make_rays(org * np.float32(0.9), d, device=DEV)
    del org, d
    hit, got = quad_cell(pt, tr, "subdivision torus", cs, rays, errs, out,
                         card)
    add_counts(launches, got)
    check(bool(((hit.prim_id[hit.valid] >= 0)
                & (hit.prim_id[hit.valid] < nu * nv)).all()),
          "subdivision: a prim id is not a base face")
    out["subdivision torus"].update(commit_s=commit_s,
                                    refinement_s=sum(spent), quads=n_sub,
                                    levels=SUBDIV_LEVELS,
                                    table_mb=table_mb(cs.packed) / 1e6)
    del cs, rays, hit
    torch.cuda.empty_cache()
    add_counts(launches, check_variant_cells(pt, tr, errs, out, card))
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 24 took {out['phase_s']:.1f} s; launches {launches}; "
        f"{card}")
    return launches, (geom, sample)


def to_cpu(cs):
    """A committed scene's copy on the CPU (the same tree and tables)."""
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: move(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        return x
    return move(cs)


def held_on_cpu(card_r, cpu_r, stride, label):
    """Point-query results on the card against the CPU's on every
    ``stride``-th point: equal prims, distances within 1e-6 relative;
    prints the bit-equal count."""
    prim = card_r.prim[::stride][:cpu_r.prim.shape[0]].cpu()
    dist = card_r.dist[::stride][:cpu_r.prim.shape[0]].cpu()
    check(torch.equal(prim, cpu_r.prim), f"{label}: prims differ from the "
          "CPU's")
    rel = ((dist - cpu_r.dist).abs() / cpu_r.dist.abs().clamp(min=1e-30))
    rel = rel.nan_to_num(0.0, posinf=0.0).max().item()
    same = int((dist.view(torch.int32) == cpu_r.dist.view(torch.int32))
               .sum())
    check(rel <= 1e-6, f"{label}: distances differ from the CPU's by {rel}")
    say(f"  {label}: card == CPU on {prim.shape[0]} points: prims equal, "
        f"{same} distances bit-equal, largest relative difference {rel:.3e}")


def phase_api(pt, tr, sphere_mesh, grid_state, out):
    """Phase 25: the rest of the API surface on the card."""
    from embree_tpu_torch import query
    from embree_tpu_torch.accel.collide import collide
    from embree_tpu_torch.rtcore import Device
    from embree_tpu_torch.utils.checkpoint import load_scene, save_scene
    t_phase = time.perf_counter()
    card = card_line()
    say(f"phase 25: the API surface: point queries, collision, two-level "
        f"point queries, interpolation, statistics, checkpoints [{card}]")
    verts, idx = sphere_mesh(*MAIN_MESH)
    cs, _ = commit_timed(tri_scene(pt, verts, idx), "main sphere")
    cpu = to_cpu(cs)
    rng = np.random.default_rng(12)
    pts = torch.as_tensor(rng.uniform(-1.2, 1.2, (PQ_POINTS, 3))
                          .astype(np.float32), device=DEV)
    # at an infinite radius, the points at least PQ_INF_MIN_R from the
    # center: a point near it is about equally far from every triangle, so
    # its branch and bound visits most of the tree, one node a lockstep step
    far = pts[pts.norm(dim=1) >= PQ_INF_MIN_R][:PQ_INF_POINTS]
    for label, p, radius in (("radius 0.05", pts, PQ_RADIUS),
                             ("radius inf", far, math.inf)):
        ms, r = host_ms(lambda p=p, radius=radius: query.point_query_scene(
            cs, p, radius))
        found = int((r.prim >= 0).sum())
        say(f"  point query, {label}: {p.shape[0]} points in {ms:.1f} ms, "
            f"{r.steps} lockstep steps, {found} found [{card}]")
        check(found > 0 and bool(torch.isfinite(r.dist[r.prim >= 0]).all()),
              f"point query {label}: nothing found")
        stride = max(p.shape[0] // PQ_COMPARE, 1)
        rc = query.point_query_scene(cpu, p[::stride][:PQ_COMPARE].cpu(),
                                     radius)
        held_on_cpu(r, rc, stride, f"point query {label}")
        out[f"point_query {label}"] = dict(points=p.shape[0], ms=ms,
                                           steps=r.steps, found=found,
                                           card=card)
    del pts

    cv, ci = sphere_mesh(*COLLIDE_MESH)
    ca, _ = commit_timed(tri_scene(pt, cv, ci), "collide A")
    cb, _ = commit_timed(tri_scene(
        pt, cv + np.float32([COLLIDE_SHIFT, 0, 0]), ci), "collide B")
    ms, res = host_ms(lambda: query.collide_scenes(ca, cb))
    count = int(res.count)
    say(f"  collide: {count} pairs of {ca.num_prims} x {cb.num_prims} "
        f"triangles in {ms:.1f} ms, {res.steps} lockstep steps [{card}]")
    check(count > 0, "collide: no pair")
    pairs = res.pairs[:count].cpu()
    check(bool((pairs[1:, 0] >= pairs[:-1, 0]).all()),
          "collide: pairs out of order")
    # the CPU on every stride-th prim of A against the same B
    ca_c, cb_c = to_cpu(ca), to_cpu(cb)
    stride = max(ca.num_prims // COLLIDE_COMPARE, 1)
    sub = torch.arange(0, ca.num_prims, stride)[:COLLIDE_COMPARE]
    a0, a1, a2 = (x[sub] for x in query._tri_rows(ca_c))
    from embree_tpu_torch.core.math import fmax, fmin
    b0, b1, b2 = query._tri_rows(cb_c)
    rc = collide(cb_c.bvh, b0, b1, b2, fmin(fmin(a0, a1), a2),
                 fmax(fmax(a0, a1), a2), a0, a1, a2)
    got = rc.pairs[:int(rc.count)].long()
    got[:, 0] = sub[got[:, 0]]
    keep = pairs[:, 0] % stride == 0
    keep &= pairs[:, 0] < sub[-1] + 1
    check(torch.equal(pairs[keep].long(), got),
          "collide: pairs differ from the CPU's")
    say(f"  collide: card == CPU on {sub.shape[0]} prims of A: "
        f"{got.shape[0]} pairs equal, in order")
    out["collide"] = dict(pairs=count, ms=ms, steps=res.steps, card=card)
    del ca, cb, ca_c, cb_c, res

    child = tri_scene(pt, *sphere_mesh(*CHECK_MESH))
    xfs = instance_ring(TL_INSTANCES, seed=7)
    s = pt.Scene()
    for x in xfs:
        s.attach(pt.InstanceGeometry(child, x))
    tl = s.commit(device=DEV)
    check(isinstance(tl, pt.TwoLevelScene), "16 instances: not two-level")
    flat = s.commit(device=DEV, two_level=False)
    q = torch.as_tensor(np.random.default_rng(13).uniform(
        -INST_RING - 1.5, INST_RING + 1.5, (TL_POINTS, 3))
        .astype(np.float32), device=DEV)
    ms_tl, r_tl = host_ms(lambda: query.point_query_scene(tl, q, math.inf))
    ms_fl, r_fl = host_ms(lambda: query.point_query_scene(flat, q, math.inf))
    # object space and world space round apart by ulps of the coordinates:
    # the difference is taken relative to max(distance, 1)
    rel = ((r_tl.dist - r_fl.dist).abs() / r_fl.dist.clamp(min=1.0)).max()
    say(f"  two-level point query: {TL_POINTS} points, {TL_INSTANCES} "
        f"instances in {ms_tl:.1f} ms ({r_tl.steps} steps over the "
        f"instances), flattened {ms_fl:.1f} ms ({r_fl.steps} steps); "
        f"largest |difference| / max(distance, 1) {rel.item():.3e} "
        f"[{card}]")
    check(bool((r_tl.prim >= 0).all()) and bool((r_fl.prim >= 0).all())
          and rel.item() < 1e-5, "two-level point query disagrees with the "
          "flattened one")
    out["two_level_point_query"] = dict(ms=ms_tl, flat_ms=ms_fl,
                                        max_rel=rel.item(), card=card)
    del tl, flat, q, r_tl, r_fl

    geom, sample = grid_state
    ms, p = host_ms(lambda: pt.interpolate(
        geom, sample["prim"], sample["u"], sample["v"],
        torch.as_tensor(geom.vertices, device=DEV)))
    err = (p - sample["point"]).norm(dim=1).max().item()
    say(f"  interpolate: grid positions at {p.shape[0]} grid-cell hits in "
        f"{ms:.2f} ms, largest distance to the hit point {err:.3e}")
    check(err < 1e-3, "interpolate: grid positions off the hit points")

    st = query.scene_stats(cs)
    say("  scene_stats: " + json.dumps(
        {k: v for k, v in st.items() if k != "memory_by_field"}))
    check(st["prims_in_leaves"] == cs.num_prims, "scene_stats: prims")

    org, d = incoherent_rays(CK_RAYS, 0)
    rays = pt.make_rays(org, d, device=DEV)
    with tempfile.TemporaryDirectory(dir=ROOT) as td:
        path = os.path.join(td, "main.npz")
        save_ms, _ = host_ms(lambda: save_scene(path, cs))
        mb = os.path.getsize(path) / 1e6
        load_ms, back = host_ms(lambda: load_scene(path, device=DEV))
    h0 = pt.intersect(cs, rays, differentiable=False)
    h1 = pt.intersect(back, rays, differentiable=False)
    check(torch.equal(h0.valid, h1.valid)
          and torch.equal(h0.prim_id, h1.prim_id)
          and torch.equal(h0.t.view(torch.int32), h1.t.view(torch.int32)),
          "checkpoint: hits differ after the round trip")
    say(f"  checkpoint: {mb:.1f} MB archive, save {save_ms:.0f} ms, load "
        f"{load_ms:.0f} ms; {CK_RAYS} rays' hits bit-equal after the load")
    dev = Device()
    check(dev.get_property("platform") == "cuda"
          and dev.get_property("device_count") == torch.cuda.device_count(),
          "Device: not on CUDA")
    dc = dev.new_scene()
    dc.attach(pt.TriangleGeometry(*sphere_mesh(8, 12)))
    check(dev.commit_scene(dc).device.type == "cuda", "Device: commit")
    say(f"  Device(): platform {dev.get_property('platform')}, "
        f"{dev.get_property('device_count')} device(s)")
    out.update(checkpoint=dict(mb=mb, save_ms=save_ms, load_ms=load_ms),
               stats={k: v for k, v in st.items() if k != "memory_by_field"})
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 25 took {out['phase_s']:.1f} s; {card}")


# ---------------------------------------------------------------------------
# phases 26-27: the path tracer and its gradients
# ---------------------------------------------------------------------------

PT_SIZE = 1024               # full-size renders, PT_SIZE x PT_SIZE pixels
PT_CORNELL = dict(spp=4, max_depth=4)
PT_SPHERE = dict(spp=1, max_depth=4)
PT_CHECK = 128               # the render held against the port's CPU render
PT_CHECK_SPP = {"cornell": 2, "sphere": 1}
PT_COMPARE = 1 << 16         # first-bounce rays of the plain-version sample
PT_MAX_FLIPS = 8             # check pixels a flipped branch may move (of
                             # 16,384; H100 runs flip 1 a render)
GRAD_SIZE = 256              # phase 27's image, spp 1, depth 2
GRAD_EPS = 1e-3
GRAD_MESH = (64, 128)        # the viewer-style vertex gradient's mesh
GRAD_RAYS = 256              # its camera, GRAD_RAYS x GRAD_RAYS


def sphere_on_floor(pt, tm, tl, sphere_mesh):
    """The main sphere (2,097,152 tris, matte) on a rough-metal floor under
    a quad light and an ambient term: all triangles (B1)."""
    verts, idx = sphere_mesh(*MAIN_MESH)
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(verts, idx))
    s.attach(pt.TriangleGeometry(
        np.array([[-20, -1, -20], [20, -1, -20], [20, -1, 20],
                  [-20, -1, 20]], np.float32),
        np.array([[0, 1, 2], [0, 2, 3]], np.int32)))
    mats = {0: (tm.MATTE, (0.7, 0.7, 0.7), 0.0),
            1: (tm.METAL, (0.8, 0.8, 0.8), 0.3)}
    lights = tl.LightSetBuilder().quad([-1, 4, -1], [2, 0, 0], [0, 0, 2],
                                       (8, 8, 8)).ambient((0.1, 0.1, 0.15))
    cam = dict(from_point=np.array([0, 1.0, 4.0], np.float32),
               to_point=np.array([0, 0, 0], np.float32),
               up=np.array([0, 1, 0], np.float32), fov_deg=45)
    return s, mats, lights, cam


class BounceClock:
    """Wraps the path tracer's ``intersect`` and ``occluded`` (the names it
    calls) in CUDA events, in call order, and keeps the inputs and outputs
    of the first ``keep`` calls; restores them on exit. ``record``: keep
    every call's ids and occlusion flags instead (path signatures).
    ``traced``: the rays of all calls that trace (``tfar >= tnear``), on
    the device until read."""

    def __init__(self, tpt, keep=0, record=False):
        self.tpt, self.keep, self.record = tpt, keep, record
        self.calls, self.kept, self.sig = [], [], []
        self.traced = 0

    def __enter__(self):
        self.orig = (self.tpt.intersect, self.tpt.occluded)

        def wrap(kind, fn):
            def call(scene, rays, **kw):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(scene, rays, **kw)
                b.record()
                self.calls.append((kind, a, b))
                self.traced = self.traced + (rays.tfar >= rays.tnear).sum()
                if len(self.kept) < self.keep:
                    self.kept.append((kind, rays, out))
                if self.record:
                    self.sig += ([out.geom_id, out.prim_id]
                                 if kind == "intersect" else [out.long()])
                return out
            return call
        self.tpt.intersect = wrap("intersect", self.orig[0])
        self.tpt.occluded = wrap("occluded", self.orig[1])
        return self

    def __exit__(self, *exc):
        self.tpt.intersect, self.tpt.occluded = self.orig

    def bounce_ms(self, end, depth):
        """Per bounce index (mean over samples): intersect, occluded and
        the rest (shading and sampling, up to the next intersect or
        ``end``)."""
        out = [dict(intersect=0.0, occluded=0.0, shading=0.0)
               for _ in range(depth)]
        starts = [c[1] for c in self.calls[0::2]] + [end]
        for k, (i, o) in enumerate(zip(self.calls[0::2], self.calls[1::2])):
            check(i[0] == "intersect" and o[0] == "occluded",
                  "the bounce calls are out of order")
            span = i[1].elapsed_time(starts[k + 1])
            ti = i[1].elapsed_time(i[2])
            to = o[1].elapsed_time(o[2])
            rec = out[k % depth]
            rec["intersect"] += ti
            rec["occluded"] += to
            rec["shading"] += span - ti - to
        n = len(self.calls) // (2 * depth)
        return [{k: v / n for k, v in r.items()} for r in out]


def pt_parts(tm, build, label):
    """A path-tracer cell on the card: (committed scene, materials,
    lights, camera, commit seconds)."""
    from embree_tpu_torch.models.camera import Camera
    s, mats, lb, cam = build
    cs, secs = commit_timed(s, label)
    m = tm.make_materials(max(mats) + 1, mats, device=DEV)
    return cs, m, lb.build(device=DEV), Camera(**cam), secs


def pt_cell(tr, tpt, label, parts, cfg, errs, out, card):
    """One full-size render: launch counts zeroed just before and read
    after, the render's ms and peak memory, per-bounce times (the entry
    point split into wrapper, kernel and re-intersection on the first
    sample's rays), the first bounce's launches held against the plain
    version on a strided sample, Mrays/s of the rays traced. Returns the
    launches."""
    from embree_tpu_torch import scene as scene_mod
    cs, mats, lights, cam, commit_s = parts
    depth, spp, n = cfg["max_depth"], cfg["spp"], PT_SIZE

    def render():
        return tpt.render_pathtracer(cs, mats, lights, cam, n, n, spp=spp,
                                     max_depth=depth,
                                     draws=tpt.Draws.seeded(0, DEV))

    t0 = time.perf_counter()
    render()                    # warm-up: first-use costs, the allocator
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    tr.reset_launch_counts()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with BounceClock(tpt, keep=2 * depth) as clock:
        a.record()
        img = render()
        b.record()
    torch.cuda.synchronize()
    launches = dict(tr.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base_mem
    clocked_ms = a.elapsed_time(b)
    say(f"  {label}: launches {launches} ({spp} spp x {depth} bounces)")
    variants = {o: tr.packed_variant(cs.packed, o, False, False)
                for o in (False, True)}
    for o, name in variants.items():
        check(launches.get(name, 0) == spp * depth,
              f"{label}: {name} launched {launches.get(name, 0)} times, "
              f"not once a bounce")
    check(tuple(img.shape) == (n, n, 3) and bool(torch.isfinite(img).all()),
          f"{label}: the image is not finite")
    check(float(img.mean()) > 0.0 and not img.requires_grad,
          f"{label}: a black image, or a graph recorded")
    render_ms = events_ms(render, reps=3)
    bounces = clock.bounce_ms(b, depth)
    lanes = 2 * n * n * spp * depth
    traced = int(clock.traced)      # the seeded renders trace the same rays
    live = []
    for k in range(depth):
        _, rays, _ = clock.kept[2 * k]
        _, srays, _ = clock.kept[2 * k + 1]
        live.append([int((rays.tfar >= rays.tnear).sum()),
                     int((srays.tfar >= srays.tnear).sum())])
        flat = rays.reshape(n * n)
        select_ms = events_ms(lambda: scene_mod._select(cs, flat, False))
        inputs = sorted_inputs(tr, flat)
        kernel_ms = events_ms(lambda: run_kernel(
            tr, cs.packed, inputs, occlusion=False, want_attrs=False))
        bounces[k].update(select=select_ms, kernel=kernel_ms,
                          wrapper=select_ms - kernel_ms,
                          reintersect=bounces[k]["intersect"] - select_ms)
        if k == 0:
            plain = {}
            for o, rs in ((False, flat), (True, srays.reshape(n * n))):
                x = inputs if not o else sorted_inputs(tr, rs)
                key = variants[o]
                errs[key] = max(errs.get(key, 0.0), compare(
                    tr, cs.packed, x, PT_COMPARE, o, False,
                    f"{label}: bounce 0 {key}", plain=plain))
                r = run_kernel(tr, cs.packed, x, occlusion=o,
                               want_attrs=False)
                check_sample(r, plain[key], False, f"{label}: bounce 0 {key}")
        say(f"  {label}: bounce {k}: intersect {bounces[k]['intersect']:.3f}"
            f" ms (wrapper {bounces[k]['wrapper']:.3f} + kernel "
            f"{kernel_ms:.3f} + re-intersection "
            f"{bounces[k]['reintersect']:.3f}), occluded "
            f"{bounces[k]['occluded']:.3f} ms, shading and sampling "
            f"{bounces[k]['shading']:.3f} ms; live rays {live[k][0]} / "
            f"shadow rays {live[k][1]} of {n * n}")
    del clock
    mrays = traced / (render_ms * 1e3)
    mlanes = lanes / (render_ms * 1e3)
    say(f"  {label}: {n} x {n}, {spp} spp, depth {depth}: render "
        f"{render_ms:.3f} ms (with the bounce clock {clocked_ms:.3f}; the "
        f"first render {first_s:.3f} s), {traced} rays traced of {lanes} "
        f"ray lanes: {mrays:.2f} Mrays/s ({mlanes:.2f} Mlanes/s), peak "
        f"memory {peak / 1e9:.3f} GB, image mean {float(img.mean()):.5f} "
        f"[{card}]")
    out[label] = dict(render_ms=render_ms, clocked_ms=clocked_ms,
                      first_s=first_s, lanes=lanes, traced=traced,
                      mrays_per_s=mrays, mlanes_per_s=mlanes,
                      peak_bytes=peak, bounces=bounces,
                      live=live, launches=launches, commit_s=commit_s,
                      size=n, spp=spp, depth=depth, card=card)
    return launches


def pt_check_cpu(tpt, label, parts, cpu_parts, spp, depth):
    """A PT_CHECK x PT_CHECK render on the card against the port's CPU
    render of the same scene (its tables copied), with the CPU run's draws
    replayed: each pixel within rtol 1e-4 / atol 1e-6, but for at most
    PT_MAX_FLIPS pixels (a branch flipped by a last-bit difference
    of the card's math, counted)."""
    n = PT_CHECK
    rec = []
    cs, mats, lights, cam, _ = cpu_parts
    t0 = time.perf_counter()
    ref = tpt.render_pathtracer(cs, mats, lights, cam, n, n, spp=spp,
                                max_depth=depth,
                                draws=tpt.Draws.seeded(1, "cpu", record=rec))
    cpu_s = time.perf_counter() - t0
    cs, mats, lights, cam, _ = parts
    got = tpt.render_pathtracer(cs, mats, lights, cam, n, n, spp=spp,
                                max_depth=depth,
                                draws=tpt.ReplayDraws(rec, DEV)).cpu()
    close = torch.isclose(got, ref, rtol=1e-4, atol=1e-6).all(-1)
    flips = int((~close).sum())
    same = int((got.view(torch.int32) == ref.view(torch.int32)).all(-1)
               .sum())
    diff = float((got - ref).abs().max())
    say(f"  {label}: {n} x {n} card render == CPU render ({spp} spp, depth "
        f"{depth}, {len(rec)} draws replayed): {n * n - flips} pixels "
        f"within rtol 1e-4 / atol 1e-6 ({same} bit-equal), {flips} not "
        f"(bound {PT_MAX_FLIPS}); max |diff| {diff:.3e}; the "
        f"CPU render {cpu_s:.1f} s")
    check(flips <= PT_MAX_FLIPS, f"{label}: {flips} pixels differ "
          "from the CPU render")
    return dict(pixels=n * n, within=n * n - flips, bit_equal=same,
                max_abs_diff=diff, flips=flips)


def phase_pathtracer(pt, tr, sphere_mesh, errs, out):
    """Phase 26: the path tracer on the card."""
    from embree_tpu_torch.models import lights as tl
    from embree_tpu_torch.models import materials as tm
    from embree_tpu_torch.models import pathtracer as tpt
    t_phase = time.perf_counter()
    card = card_line()
    say(f"phase 26: the path tracer: the Cornell box (B3-B5) at "
        f"{PT_SIZE}^2, {PT_CORNELL['spp']} spp, depth "
        f"{PT_CORNELL['max_depth']}; the main sphere on a floor (B1) at "
        f"{PT_SIZE}^2, {PT_SPHERE['spp']} spp, depth "
        f"{PT_SPHERE['max_depth']} [{card}]")
    launches = {}
    for label, build, cfg in (
            ("cornell", cornell_box(pt), PT_CORNELL),
            ("sphere", sphere_on_floor(pt, tm, tl, sphere_mesh), PT_SPHERE)):
        parts = pt_parts(tm, build, label)
        got = pt_cell(tr, tpt, label, parts, cfg, errs, out, card)
        add_counts(launches, got)
        cpu = (to_cpu(parts[0]), to_cpu(parts[1]), to_cpu(parts[2]),
               parts[3], 0.0)
        out[label]["cpu_check"] = pt_check_cpu(
            tpt, label, parts, cpu, PT_CHECK_SPP[label],
            cfg["max_depth"])
        del parts, cpu
        torch.cuda.empty_cache()
    say(f"  phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def translated(cs, gid, direction, d):
    """The committed scene with geometry ``gid``'s triangles moved by
    ``d`` along ``direction`` (a differentiable replacement of the
    tables the re-intersection reads)."""
    from embree_tpu_torch.scene import KIND_TRIANGLE
    rows = cs.prim_data[(cs.prim_kind == KIND_TRIANGLE)
                        & (cs.prim_geom == gid)]
    sel = torch.zeros(cs.tri_v0.shape[0], 1, device=cs.device)
    sel[rows] = 1.0
    shift = sel * torch.as_tensor(direction, dtype=torch.float32,
                                  device=cs.device) * d
    return dataclasses.replace(
        cs, tri_v0=cs.tri_v0 + shift, tri_v1=cs.tri_v1 + shift,
        tri_v2=cs.tri_v2 + shift, tri_v0b=cs.tri_v0b + shift,
        tri_v1b=cs.tri_v1b + shift, tri_v2b=cs.tri_v2b + shift)


def phase_gradients(pt, tr, sphere_mesh, out):
    """Phase 27: image gradients on the card."""
    from embree_tpu_torch.models import materials as tm
    from embree_tpu_torch.models import pathtracer as tpt
    from embree_tpu_torch.models.viewer import ispc_camera_rays
    t_phase = time.perf_counter()
    card = card_line()
    n = GRAD_SIZE
    say(f"phase 27: gradients: the Cornell box at {n}^2, 1 spp, depth 2, "
        f"with respect to the albedo and the back wall's depth; the "
        f"viewer-style vertex gradient through the kernel [{card}]")
    cs, mats, lights, cam, _ = pt_parts(tm, cornell_box(pt), "cornell")
    back_wall = 2
    w = torch.as_tensor(np.random.default_rng(11).uniform(
        0.5, 1.5, (n, n, 3)).astype(np.float32), device=DEV)

    def run(albedo, dz, keep=None, record=False):
        """The weighted image sum (float64) and the path signature (each
        bounce's geometry and prim ids and shadow flags, per pixel)."""
        m = dataclasses.replace(mats, albedo=albedo)
        s2 = translated(cs, back_wall, (0.0, 0.0, 1.0), dz)
        with BounceClock(tpt, record=record) as clock:
            img = tpt.render_pathtracer(s2, m, lights, cam, n, n, spp=1,
                                        max_depth=2,
                                        draws=tpt.Draws.seeded(3, DEV))
        wk = w if keep is None else w * keep[..., None]
        sig = torch.stack(clock.sig, -1) if record else None
        return (wk.double() * img.double()).sum(), sig

    a0 = mats.albedo.clone()
    z0 = torch.tensor(0.0, device=DEV)
    with torch.no_grad():
        _, sig0 = run(a0, z0, record=True)
    rng = np.random.default_rng(1)
    d_alb = torch.as_tensor(rng.normal(size=tuple(a0.shape))
                            .astype(np.float32), device=DEV)
    eps = GRAD_EPS
    keep = torch.ones((n, n), device=DEV)
    plus_minus = {}
    for name, (da, dz) in (("albedo", (d_alb, 0.0)), ("dz", (None, 1.0))):
        sigs = []
        for sgn in (1.0, -1.0):
            alb = a0 + sgn * eps * da if da is not None else a0
            with torch.no_grad():
                _, sg = run(alb, z0 + sgn * eps * dz, record=True)
            sigs.append(sg)
            plus_minus[(name, sgn)] = (alb, z0 + sgn * eps * dz)
        same = (sigs[0] == sig0).all(-1) & (sigs[1] == sig0).all(-1)
        keep = keep * same.to(torch.float32)
    dropped = int((keep == 0).sum())
    say(f"  {dropped} of {n * n} pixels change a path choice (a bounce's "
        f"prim or a shadow test) within +-{eps}: left out of the loss, so "
        "that the central differences see no structure term")
    check(dropped <= 0.05 * n * n, "too many pixels change their paths")

    alb = a0.clone().requires_grad_()
    dz = z0.clone().requires_grad_()
    torch.autograd.grad(run(alb, dz, keep)[0], (alb, dz))   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    e[0].record()
    loss, _ = run(alb, dz, keep)
    e[1].record()
    ga, gz = torch.autograd.grad(loss, (alb, dz))
    e[2].record()
    torch.cuda.synchronize()
    fwd_ms, bwd_ms = e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])
    peak = torch.cuda.max_memory_allocated() - base_mem
    check(bool(torch.isfinite(ga).all()) and bool(torch.isfinite(gz)),
          "non-finite gradients")
    res = {}
    with torch.no_grad():
        for name, ad in (("albedo", float((ga * d_alb).sum())),
                         ("dz", float(gz))):
            lp = float(run(*plus_minus[(name, 1.0)], keep)[0])
            lm = float(run(*plus_minus[(name, -1.0)], keep)[0])
            fd = (lp - lm) / (2 * eps)
            ok = abs(ad - fd) <= 1e-3 + 2e-2 * abs(fd)
            say(f"  d(loss)/d({name}): autograd {ad:.6f}, central "
                f"differences {fd:.6f} ({'within' if ok else 'NOT within'} "
                "rtol 2e-2 / atol 1e-3)")
            check(ok and abs(ad) > 1e-3, f"gradient {name} off its central "
                  "differences")
            res[name] = dict(autograd=ad, fd=fd)
    say(f"  render with graph {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, "
        f"peak memory {peak / 1e9:.3f} GB [{card}]")
    out["cornell_grad"] = dict(size=n, forward_ms=fwd_ms, backward_ms=bwd_ms,
                               peak_bytes=peak, dropped_pixels=dropped,
                               checks=res, card=card)

    # the viewer-style vertex gradient: the kernel selects on the card,
    # the plain version on the CPU; the re-intersection carries both
    verts, idx = sphere_mesh(*GRAD_MESH)
    cs = tri_scene(pt, verts, idx).commit(device=DEV)
    cpu_cs = to_cpu(cs)
    eye = (np.array([0.3, 0.2, 3.0]), np.zeros(3), np.array([0.0, 1, 0]))

    # the rays are made on the CPU, so both devices trace the same bits
    cam_rays = ispc_camera_rays(*eye, 50.0, GRAD_RAYS, GRAD_RAYS,
                                device="cpu").reshape(GRAD_RAYS * GRAD_RAYS)

    def vertex_grad(c, dev):
        flat = pt.make_rays(cam_rays.org.to(dev), cam_rays.dir.to(dev))
        vv = torch.as_tensor(verts, device=dev)
        ii = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        ww = torch.as_tensor(np.random.default_rng(7).uniform(
            0.5, 1.5, GRAD_RAYS * GRAD_RAYS).astype(np.float32), device=dev)
        dv = torch.zeros_like(vv, requires_grad=True)
        t0 = (vv + dv)[ii]
        s2 = dataclasses.replace(
            c, tri_v0=t0[:, 0], tri_v1=t0[:, 1], tri_v2=t0[:, 2],
            tri_v0b=t0[:, 0], tri_v1b=t0[:, 1], tri_v2b=t0[:, 2])
        h = pt.intersect(s2, flat)
        ng = h.ng * torch.rsqrt(torch.clamp(
            (h.ng * h.ng).sum(-1, keepdim=True), min=1e-30))
        px = torch.where(h.valid, (-flat.dir * ng).sum(-1).abs()
                         + 0.05 * h.t, 0.0)
        loss = (ww * px).sum()
        ms = None
        if dev == DEV:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        g, = torch.autograd.grad(loss, dv)
        if dev == DEV:
            b.record()
            torch.cuda.synchronize()
            ms = a.elapsed_time(b)
        return g.cpu(), h.prim_id.cpu(), ms

    tr.reset_launch_counts()
    g_card, p_card, vbwd = vertex_grad(cs, DEV)
    check(tr.LAUNCHES.get(tr.packed_variant(cs.packed, False, False,
                                            False), 0) > 0,
          "the vertex gradient did not launch the kernel")
    g_cpu, p_cpu, _ = vertex_grad(cpu_cs, "cpu")
    check(torch.equal(p_card, p_cpu), "the kernel and the plain version "
          "select other prims")
    scale = float(g_cpu.abs().max())
    err = float(((g_card - g_cpu).abs()
                 - 1e-3 * g_cpu.abs()).max()) / scale
    say(f"  vertex gradient ({cs.num_prims} tris, {GRAD_RAYS}^2 rays): card "
        f"== CPU within rtol 1e-3 + 1e-4 of the largest ({scale:.4f}); "
        f"worst excess {err:.3e}; backward {vbwd:.3f} ms")
    check(err <= 1e-4 and scale > 1e-4, "the card's vertex gradient is off "
          "the CPU's")
    out["vertex_grad"] = dict(tris=cs.num_prims, rays=GRAD_RAYS ** 2,
                              backward_ms=vbwd, worst_excess=err, card=card)
    say(f"  phase 27 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 28: multi-device at world size 1
# ---------------------------------------------------------------------------

MD_SIZE = 1024               # phase 28's sharded renders, MD_SIZE x MD_SIZE
MD_SHADERS = ("eyelight", "occlusion")
MD_TRAIN_MESH = (64, 128)    # the training step's sphere
MD_TRAIN_RAYS = 256          # its camera, 256 x 256 = 65,536 rays
MD_LR = 1e-2


def phase_parallel(pt, tr, sphere_mesh, out):
    """Phase 28: ``parallel/`` on one card, an NCCL group of one rank
    joined through a file store: the sharded render of the main sphere and
    the training step bit-equal to their unsharded counterparts, and the
    scaling measurements at [1]. NCCL puts one rank on each card, so this
    machine runs no larger group."""
    import torch.distributed as dist
    from embree_tpu_torch.models.camera import Camera
    from embree_tpu_torch.models.viewer import SHADERS
    from embree_tpu_torch.parallel import mesh as pmesh
    from embree_tpu_torch.parallel import render as prender
    say("phase 28: multi-device at world size 1 (NCCL, a file store)")
    t_phase = time.perf_counter()
    card = card_line()
    launches = {}
    res = out.setdefault("parallel", {})
    cam = Camera(from_point=np.array([0.3, 0.6, 3.0], np.float32),
                 to_point=np.zeros(3, np.float32),
                 up=np.array([0, 1, 0], np.float32), fov_deg=50.0)
    with tempfile.TemporaryDirectory() as d:
        prender.init_distributed("file://" + os.path.join(d, "store"), 1, 0)
        try:
            mesh = prender.make_mesh()
            check(dist.get_backend() == "nccl" and mesh.size == 1
                  and mesh.rank == 0 and mesh.group is not None
                  and mesh.device.type == "cuda", f"the mesh: {mesh}")
            cs, _ = commit_timed(tri_scene(pt, *sphere_mesh(*MAIN_MESH)),
                                 "main sphere")
            for sh in MD_SHADERS:
                tr.reset_launch_counts()
                img = prender.render_image_sharded(cs, cam, MD_SIZE, MD_SIZE,
                                                   mesh, sh)
                counts = dict(tr.LAUNCHES)
                check(counts, f"the sharded {sh} render launched nothing")
                add_counts(launches, counts)
                rays = cam.rays(MD_SIZE, MD_SIZE, device=DEV)
                ref = SHADERS[sh](cs, rays, pt.intersect(cs, rays))
                check(same_bits(img, ref), f"the sharded {sh} render "
                      "differs from the unsharded one")
                check(float(img.max()) > 0, f"a black {sh} image")
                ms = events_ms(lambda: prender.render_image_sharded(
                    cs, cam, MD_SIZE, MD_SIZE, mesh, sh))
                say(f"  render_image_sharded {sh} {MD_SIZE}^2: {ms:.3f} ms, "
                    f"launches {counts}, == intersect + shader (bits) "
                    f"[{card}]")
                res[f"render_{sh}_ms"] = ms

            verts, idx = sphere_mesh(*MD_TRAIN_MESH)
            cs2 = tri_scene(pt, verts, idx).commit(device=DEV)
            rays = cam.rays(MD_TRAIN_RAYS, MD_TRAIN_RAYS, device=DEV) \
                .reshape(MD_TRAIN_RAYS * MD_TRAIN_RAYS)
            shrunk = dataclasses.replace(cs2, tri_v0=cs2.tri_v0 * 0.95,
                                         tri_v1=cs2.tri_v1 * 0.95,
                                         tri_v2=cs2.tri_v2 * 0.95)
            with torch.no_grad():
                target = pmesh.render_depth(shrunk, rays)
            # autograd's scatter of the vertex gradient adds in atomic
            # order on CUDA unless deterministic algorithms are on
            was = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                step = pmesh.make_train_step(mesh, lr=MD_LR)
                tr.reset_launch_counts()
                new, loss = step(cs2, prender.shard_rays(rays, mesh), target)
                counts = dict(tr.LAUNCHES)
                vs = [v.detach().requires_grad_()
                      for v in (cs2.tri_v0, cs2.tri_v1, cs2.tri_v2)]
                ref_loss = pmesh.depth_loss(*vs, cs2, rays, target)
                grads = torch.autograd.grad(ref_loss, vs)
                step_ms = events_ms(lambda: step(
                    cs2, prender.shard_rays(rays, mesh), target))
            finally:
                torch.use_deterministic_algorithms(was)
            check(counts, "the training step launched nothing")
            add_counts(launches, counts)
            check(same_bits(loss, ref_loss.detach()),
                  f"train loss {float(loss)} != {float(ref_loss.detach())}")
            for k, g in zip(("tri_v0", "tri_v1", "tri_v2"), grads):
                check(same_bits(getattr(new, k), getattr(cs2, k) - MD_LR * g),
                      f"the step's {k} differs from the unsharded step")
            gmax = max(float(g.abs().max()) for g in grads)
            check(float(loss) > 0 and gmax > 0, "a step that moves nothing")
            say(f"  make_train_step on {cs2.num_prims} tris, "
                f"{rays.shape[0]} rays: loss {float(loss):.6e}, largest "
                f"|gradient| {gmax:.4e}, new tables and loss == the "
                f"unsharded step's (bits); {step_ms:.3f} ms, launches "
                f"{counts} [{card}]")
            res.update(train_loss=float(loss), train_ms=step_ms)

            org, dd = incoherent_rays(MAIN_RAYS, 0)
            rays = pt.make_rays(org, dd, device=DEV)
            tr.reset_launch_counts()
            strong = prender.measure_scaling(cs, rays, [1])
            weak = prender.measure_scaling_weak(cs, rays, [1])
            counts = dict(tr.LAUNCHES)
            add_counts(launches, counts)
            check(strong[1]["rays_per_s"] > 0 and weak[1]["rays_per_s"] > 0,
                  "no scaling rate")
            say(f"  measure_scaling [1], {MAIN_RAYS} rays: "
                f"{strong[1]['rays_per_s'] / 1e6:.2f} Mrays/s (efficiency "
                f"{strong[1]['efficiency']:.3f}); measure_scaling_weak [1]: "
                f"{weak[1]['rays_per_s'] / 1e6:.2f} Mrays/s; launches "
                f"{counts} [{card}]")
            res.update(strong=strong[1], weak=weak[1], card=card)
        finally:
            dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived phase 28")
    res["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 28 took {res['phase_s']:.1f} s; {card}")
    return launches


# ---------------------------------------------------------------------------
# phase 29: robustness on the kernels
# ---------------------------------------------------------------------------

ROBUST_TEST_RAYS = 50_000    # tests/test_robustness.py:25, :52
MISS_RATE_BOUND = 2e-5       # verify.cpp:3686


def bad_rays(pt):
    """tests/test_robustness.py:62's NaN and Inf origins and directions
    (rays 0-5), then :95's extreme intervals (rays 6-8: tnear 1e30, tfar
    1e-30; only ray 6 may hit)."""
    bad = np.array([[np.nan, 0, 0], [0, np.inf, 0], [0, 0, -np.inf]],
                   np.float32)
    down = np.tile(np.float32([0, 0, -1]), (3, 1))
    org = np.vstack([bad, np.zeros((6, 3), np.float32)]) \
        + np.float32([0, 0, 5])
    dirs = np.vstack([down, bad, down])
    tnear = np.float32([0] * 7 + [1e30, 0])
    tfar = np.float32([np.inf] * 8 + [1e-30])
    return org, dirs, tnear, tfar


def garbage_geometry(pt, steps=1):
    """tests/test_robustness.py:76: 40 triangles over NaN and 1e30
    vertices (moving over ``steps`` when more than 1) beside one valid
    triangle, which the ray from (0.2, 0.2, 1) down meets at t = 1."""
    rng = np.random.default_rng(2)
    v = rng.normal(size=(64, 3)).astype(np.float32) * 1e30
    v[::7] = np.nan
    idx = rng.integers(0, 64, (40, 3)).astype(np.int32)
    if steps > 1:
        v = np.stack([v * np.float32(1 - 0.5 * k) for k in range(steps)])
    return [pt.TriangleGeometry(v, idx), pt.TriangleGeometry(
        np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
        np.array([[0, 1, 2]], np.int32))]


def flat_strands(pt):
    """64 flat Bezier strands left of the scenes' rays (B7's slots)."""
    rng = np.random.default_rng(6)
    base = rng.uniform(-1, 1, (64, 3)).astype(np.float32) \
        + np.float32([-4, 0, 0])
    k = np.arange(4, dtype=np.float32)[None, :, None] / 3
    cp = base[:, None] + k * np.float32([0.3, 1.0, 0.1])
    v = np.concatenate([cp, np.full((64, 4, 1), 0.01, np.float32)], -1)
    return pt.CurveGeometry(v.reshape(-1, 4), np.arange(64, dtype=np.int32)
                            * 4, basis="bezier", kind="flat")


def robustness_cells(pt, sphere_mesh):
    """(label, scene) pairs: B1, B2, B6 and B7 each on the 8 x 12 sphere
    (the bad rays) and on the garbage geometry (its ray and the bad
    rays)."""
    sv, si = sphere_mesh(8, 12)
    cells = []
    for fam, kw, steps, curves in (("B1", {}, 1, False),
                                   ("B2", {"robust": True}, 1, False),
                                   ("B6", {}, 2, False),
                                   ("B7", {}, 1, True)):
        for what in ("sphere", "garbage"):
            s = pt.Scene(**kw)
            if what == "sphere":
                s.attach(pt.TriangleGeometry(
                    moving(sv, (0.25, 0, 0), steps) if steps > 1 else sv,
                    si))
            else:
                for g in garbage_geometry(pt, steps):
                    s.attach(g)
            if curves:
                s.attach(flat_strands(pt))
            cells.append((f"{fam} {what}", s))
    return cells


def launch_pair(tr, cs, x, occ, attrs, label):
    """One launch of the kernel and of its plain version on the same
    (sorted) rays: bit-equal outputs and steps, no overflow, every ray
    finished once. Returns (the kernel's result, its longest ray's
    steps)."""
    k = run_kernel(tr, cs.packed, x, occlusion=occ, want_attrs=attrs,
                   robust=cs.robust)
    p = run_plain(tr, cs.packed, x, occlusion=occ, want_attrs=attrs,
                  robust=cs.robust)
    check(int(k.overflow) == 0 and int(p.overflow) == 0,
          f"{label}: stack overflow")
    check_bits(k, p, attrs, label)
    check_sched(k, x[0].shape[0], label)
    hit = k.best >= 0
    check(bool(torch.isfinite(k.t[hit]).all()), f"{label}: a hit at a "
          "non-finite t")
    return k, int(k.visits.sum(0).max())


def robust_rates(pt, tr, label, scene, org, dirs, card):
    """A watertightness case of tests/test_robustness.py through B1's
    entry points: the miss rate of both intersect modes and occluded."""
    cs = scene.commit(device=DEV)
    rays = pt.make_rays(org, dirs, device=DEV)
    tr.reset_launch_counts()
    rates = []
    for fn in (lambda: pt.intersect(cs, rays).valid,
               lambda: pt.intersect(cs, rays, differentiable=False).valid,
               lambda: pt.occluded(cs, rays)):
        rates.append(1.0 - float(fn().float().mean()))
    counts = dict(tr.LAUNCHES)
    check(max(rates) <= MISS_RATE_BOUND, f"{label}: miss rates {rates}")
    say(f"  {label}: {rays.shape[0]} rays through B1, miss rates "
        f"{rates} (closest, closest + attrs, occluded; bound "
        f"{MISS_RATE_BOUND}), launches {counts} [{card}]")
    return counts


def phase_robustness(pt, tr, sphere_mesh, out):
    """Phase 29: the NaN and Inf rays, the garbage vertices and the extreme
    intervals through B1, B2, one B6 and one B7 variant, each launch
    bit-equal to the plain version; tests/test_robustness.py's watertight
    sphere and plane grid through B1; its deep scene with no overflow."""
    say("phase 29: robustness on the kernels")
    t_phase = time.perf_counter()
    card = card_line()
    launches = {}
    res = out.setdefault("robustness", {})
    org, dirs, tnear, tfar = bad_rays(pt)
    for label, scene in robustness_cells(pt, sphere_mesh):
        cs = scene.commit(device=DEV)
        check(cs.packed is not None, f"{label}: no packed table")
        o, d, tn, tf = org, dirs, tnear, tfar
        if label.endswith("garbage"):
            o = np.vstack([np.float32([[0.2, 0.2, 1.0]]), org])
            d = np.vstack([np.float32([[0, 0, -1]]), dirs])
            tn, tf = np.append(np.float32(0), tnear), \
                np.append(np.float32(np.inf), tfar)
        rays = pt.make_rays(o, d, tnear=tn, tfar=tf, device=DEV)
        tr.reset_launch_counts()
        hits = [pt.intersect(cs, rays), pt.intersect(cs, rays,
                                                     differentiable=False)]
        occ = pt.occluded(cs, rays)
        counts = dict(tr.LAUNCHES)
        check(counts, f"{label}: nothing launched")
        add_counts(launches, counts)
        for h in hits:
            check(bool(torch.isfinite(h.t[h.valid]).all()),
                  f"{label}: a hit at a non-finite t")
            check(torch.equal(h.valid, occ), f"{label}: occluded and "
                  "intersect disagree")
            if label.endswith("garbage"):
                check(bool(h.valid[0]) and abs(float(h.t[0]) - 1.0) < 1e-4,
                      f"{label}: the valid triangle was not found at t = 1")
            else:
                check(h.valid[6:].tolist() == [True, False, False],
                      f"{label}: extreme intervals {h.valid[6:].tolist()}")
        x = sorted_inputs(tr, rays)
        steps = []
        variants = VARIANTS if cs.packed.tri_attrs else KIND_VARIANTS
        for name, occl, attrs in variants:
            _, n = launch_pair(tr, cs, x, occl, attrs, f"{label} {name}")
            steps.append(n)
        family = tr.packed_variant(cs.packed, False, False, cs.robust)
        say(f"  {label} ({family} family): {rays.shape[0]} rays, "
            f"{int(hits[0].valid.sum())} hits; each variant == plain (bits, "
            f"steps), every ray finished, no overflow; longest ray's steps "
            f"by variant "
            f"{steps}; launches {counts}")
        res[label] = dict(max_steps=steps, launches=counts)

    n = ROBUST_TEST_RAYS
    d = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    add_counts(launches, robust_rates(
        pt, tr, "watertight sphere (:16)",
        tri_scene(pt, *sphere_mesh(32, 64)), np.zeros((n, 3), np.float32),
        d, card))
    k = 64
    xs, ys = np.meshgrid(np.linspace(-1, 1, k + 1, dtype=np.float32),
                         np.linspace(-1, 1, k + 1, dtype=np.float32),
                         indexing="ij")
    v = np.stack([xs.ravel(), ys.ravel(),
                  np.zeros((k + 1) ** 2, np.float32)], -1)
    a = (np.arange(k)[:, None] * (k + 1) + np.arange(k)[None, :]).ravel()
    idx = np.stack([np.stack([a, a + 1, a + k + 2], -1),
                    np.stack([a, a + k + 2, a + k + 1], -1)], 1) \
        .reshape(-1, 3).astype(np.int32)
    rng = np.random.default_rng(1)
    targets = rng.uniform(-0.98, 0.98, (n, 2)).astype(np.float32)
    po = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)),
                         np.full((n, 1), 3.0)], axis=1).astype(np.float32)
    pd = (np.concatenate([targets, np.zeros((n, 1))], axis=1) - po) \
        .astype(np.float32)
    add_counts(launches, robust_rates(pt, tr, "plane grid (:33)",
                                      tri_scene(pt, v, idx), po, pd, card))

    # :140's deep tree: clusters at exponentially shrinking scales
    rng = np.random.default_rng(4)
    vs = [rng.normal(size=(8, 3, 3)).astype(np.float32) * 2.0 ** -(j + 3)
          + np.array([2.0 ** -j, 0, 0], np.float32) for j in range(12)]
    verts = np.concatenate(vs).reshape(-1, 3)
    cs = tri_scene(pt, verts, np.arange(verts.shape[0], dtype=np.int32)
                   .reshape(-1, 3)).commit(device=DEV)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    # the test's random directions, then one ray at each triangle's
    # centroid, which walks the tree to its deepest leaves
    aim = verts.reshape(-1, 3, 3).mean(1) - np.float32(3.0)
    d = np.vstack([d, aim]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = pt.make_rays(np.full((d.shape[0], 3), 3.0, np.float32), d,
                        device=DEV)
    tr.reset_launch_counts()
    hit = pt.intersect(cs, rays, differentiable=False)
    counts = dict(tr.LAUNCHES)
    add_counts(launches, counts)
    x = sorted_inputs(tr, rays)
    steps = [launch_pair(tr, cs, x, occl, attrs, f"deep scene {name}")[1]
             for name, occl, attrs in VARIANTS]
    check(int(hit.valid[512:].sum()) > 0, "no aimed ray hit the deep scene")
    say(f"  deep scene (:140): {cs.num_prims} tris, {int(hit.valid.sum())} "
        f"of {d.shape[0]} rays hit; overflow 0 in every variant, == plain "
        f"(bits, steps); longest ray's steps {steps}; launches {counts}")
    res["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 29 took {res['phase_s']:.1f} s; {card}")
    return launches


# ---------------------------------------------------------------------------
# phase 30: the parity tools
# ---------------------------------------------------------------------------

PARITY_SIZE = 512            # the tools' frame, as the reference renders
PARITY_BUDGET = 55           # wrong pixels (tutorial.cpp:646-658)
PARITY_CAM = dict(from_=np.array([0.3, 0.8, 3.5]), to=np.zeros(3),
                  up=np.array([0.0, 1.0, 0.0]), fov=50.0)
# a Catmull-Clark patch of two quads with texcoords (the texcoords shaders)
SUBDIV_TEX_XML = """<?xml version="1.0"?>
<scene>
  <PerspectiveCamera name="default" from="1 0.5 2.4" to="1 0.5 0"
                     up="0 1 0" fov="60"/>
  <SubdivisionMesh>
    <positions>0 0 0  1 0 0  2 0 0  0 1 0.2  1 1 0.4  2 1 0.2</positions>
    <position_indices>0 1 4 3  1 2 5 4</position_indices>
    <faces>4 4</faces>
    <texcoords>0 0  0.5 0  1 0  0 1  0.5 1  1 1</texcoords>
    <texcoord_indices>0 1 4 3  1 2 5 4</texcoord_indices>
  </SubdivisionMesh>
</scene>
"""
# .ecs command files (tools/parity_models.py): name -> text
PARITY_ECS = {
    "generators.ecs": (
        "# every generator flag of the reference's viewer\n"
        "--point-sphere -2.2 1.2 0 0.6 0.04 12\n"
        "--disc-sphere 0 1.2 0 0.6 0.04 12\n"
        "--oriented-disc-sphere 2.2 1.2 0 0.6 0.04 12\n"
        "--triangle-sphere -2.2 -1.2 0 0.6 12\n"
        "--quad-sphere 0 -1.2 0 0.6 12\n"
        "--grid-sphere 2.2 -1.2 0 0.6 6\n"
        "-vp 0 0 7 -vi 0 0 0 -vu 0 1 0 -fov 60\n"),
    "moving.ecs": "-i ../moving.xml -vp 0.3 0.8 3.5 -vi 0 0 0 -fov 50\n",
    "min_width.ecs": "-i ../curves.xml --min-width 3 4\n",
    "shader_ng.ecs": "-i ../kinds.xml --shader Ng\n",
    "texcoords.ecs": "-i subdiv_tex.xml --shader texcoords\n",
    "texcoords_grid.ecs": "-i subdiv_tex.xml --shader texcoords-grid\n",
}


def write_parity_scenes(pt, d, sphere_mesh):
    """The scenes of phase 30 and tests/test_torch_parity_tools.py, written
    into directory ``d``: XML scenes (``utils/ply.write_xml``) for
    ``tools/parity.py`` and, under ``d/ecs``, the .ecs files of PARITY_ECS
    for ``tools/parity_models.py`` beside the subdivision patch that the
    texcoords shaders read (its XML as text). Returns (XML paths, .ecs
    paths)."""
    from embree_tpu_torch.utils.ply import write_xml
    from embree_tpu_torch.utils.xml_scene import XMLScene

    rng = np.random.default_rng(8)
    sv, si = sphere_mesh(16, 24)
    floor = pt.QuadGeometry(np.float32([[-3, -1.2, -3], [3, -1.2, -3],
                                        [3, -1.2, 3], [-3, -1.2, 3]]),
                            np.int32([[0, 1, 2, 3]]))
    pts = np.concatenate([rng.uniform(-2, 2, (48, 3)),
                          rng.uniform(0.05, 0.15, (48, 1))], -1)
    pts[:, 2] -= 1.5
    strands = np.concatenate([rng.uniform(-1.5, 1.5, (32, 1, 3))
                              + np.arange(4)[None, :, None]
                              * np.float64([0.1, 0.5, 0.05]),
                              np.full((32, 4, 1), 0.02)], -1)
    seg = np.concatenate([rng.uniform(-1.5, 1.5, (24, 3)),
                          np.full((24, 1), 0.03)], -1)
    seg = np.stack([seg, seg + np.float64([0.6, 0.3, 0.0, 0.0])], 1)
    gv, grows = prim_sphere("grid", (0, 0, 0), 0.6, 8)
    scenes = {
        "kinds.xml": [pt.TriangleGeometry(sv, si), floor,
                      pt.PointGeometry(pts[:24].astype(np.float32),
                                       kind="sphere"),
                      pt.PointGeometry(pts[24:].astype(np.float32),
                                       kind="disc"),
                      pt.GridGeometry(gv + np.float32([2.2, 0, -1]), grows)],
        "curves.xml": [pt.CurveGeometry(
            strands.reshape(-1, 4).astype(np.float32),
            np.arange(32, dtype=np.int32) * 4, basis="bezier", kind="flat"),
            pt.LineSegmentsGeometry(seg.reshape(-1, 4).astype(np.float32),
                                    np.arange(24, dtype=np.int32) * 2,
                                    kind="round")],
        "moving.xml": [pt.TriangleGeometry(moving(sv, (0.4, 0, 0), 2), si),
                       floor],
    }
    xmls = []
    for name, geoms in scenes.items():
        xs = XMLScene()
        xs.geometries = geoms
        xs.camera = PARITY_CAM
        xmls.append(os.path.join(d, name))
        write_xml(xmls[-1], xs)
    os.makedirs(os.path.join(d, "ecs"), exist_ok=True)
    with open(os.path.join(d, "ecs", "subdiv_tex.xml"), "w") as f:
        f.write(SUBDIV_TEX_XML)
    ecss = []
    for name, text in PARITY_ECS.items():
        ecss.append(os.path.join(d, "ecs", name))
        with open(ecss[-1], "w") as f:
            f.write(text)
    return sorted(xmls), ecss


def phase_parity(pt, tr, sphere_mesh, out):
    """Phase 30: tools/parity.py (5 shaders a scene) and
    tools/parity_models.py (the viewer's default and named shaders) on the
    card at 512^2, each image scored against the port's CPU render of the
    same file with the reference's 8-bit wrong-pixel metric."""
    from embree_tpu_torch.tools import parity, parity_models
    from embree_tpu_torch.utils.exr import compare_images, quantize8
    say("phase 30: the parity tools")
    t_phase = time.perf_counter()
    card = card_line()
    launches = {}
    res = out.setdefault("parity", {})
    with tempfile.TemporaryDirectory() as d:
        xmls, ecss = write_parity_scenes(pt, d, sphere_mesh)
        jobs = [(os.path.basename(x), lambda dev, x=x: parity.run_scene(
            x, parity.SHADERS, size=PARITY_SIZE, device=dev)) for x in xmls]
        jobs += [(os.path.basename(e), lambda dev, e=e: {
            "default": parity_models.run_ecs(e, size=PARITY_SIZE,
                                             device=dev)}) for e in ecss]
        for name, job in jobs:
            tr.reset_launch_counts()
            ms, card_imgs = host_ms(lambda: job(DEV))
            counts = dict(tr.LAUNCHES)
            add_counts(launches, counts)
            t0 = time.perf_counter()
            cpu_imgs = job("cpu")
            cpu_s = time.perf_counter() - t0
            scores = {}
            for sh, img in card_imgs.items():
                check(img.shape == (PARITY_SIZE, PARITY_SIZE, 3)
                      and np.isfinite(img).all(), f"{name} {sh}: bad image")
                scores[sh] = compare_images(quantize8(img),
                                            quantize8(cpu_imgs[sh]))
            check(max(scores.values()) <= PARITY_BUDGET,
                  f"{name}: wrong pixels {scores} over {PARITY_BUDGET}")
            say(f"  {name}: card vs CPU wrong pixels "
                f"{ {k: round(v, 3) for k, v in scores.items()} }; card "
                f"{ms:.1f} ms (load, commit, trace, shade), CPU {cpu_s:.1f} "
                f"s; launches {counts} [{card}]")
            res[name] = dict(scores=scores, card_ms=ms, launches=counts)
    res["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 30 took {res['phase_s']:.1f} s; {card}")
    return launches


TOOLS_MESH = (64, 128)         # phase 31: the perf scripts' 16K sphere
TOOLS_RAYS = 1 << 20           # and their rays (the scripts' defaults)
SORT_ROWS = 1 << 20
BIG_SCENE = (1024, 1024, 1 << 22)   # perf/bigscene.py's defaults
BUILD_SIZES = "10000,100000"   # tools/buildbench.py's defaults
HAIR_OBB_STRANDS = 1 << 13     # phase 31's round Bezier hair (a cut)
HAIR_OBB_SIZE = 256            # perf/obb_hair.py's default frame
PROFILE_STRIDE = 16            # profile_steps rays held against the plain
DEMO_MAX_FLIPS = 32            # pixels of the 8-spp demo a flipped branch
                               # may move (phase 26's bound at 2 spp, x 4)


def write_hair_scene(pt, d, n_strands, seed=1, kind="round"):
    """A hair scene of Bezier curves (``kind``: round or flat) as XML
    (``utils/ply.write_xml``) and an .ecs file in ``d``: ``n_strands``
    strands of 4 control points rooted on the unit sphere with hair()'s
    layout (numpy ``seed``), radius 0.004 -> 0.002, one curve each, and a
    camera 3.5 away. Returns the .ecs path."""
    from embree_tpu_torch.utils.ply import write_xml
    from embree_tpu_torch.utils.xml_scene import XMLScene
    verts, _ = hair(np.random.default_rng(seed), (0, 0, 0), n_strands,
                    n_seg=3)
    xs = XMLScene()
    xs.geometries = [pt.CurveGeometry(
        verts, (4 * np.arange(n_strands)).astype(np.int32), basis="bezier",
        kind=kind)]
    xs.camera = dict(from_=np.array([0.0, 0.0, 3.5]), to=np.zeros(3),
                     up=np.array([0.0, 1.0, 0.0]), fov=50.0)
    write_xml(os.path.join(d, "hair.xml"), xs)
    ecs = os.path.join(d, "hair.ecs")
    with open(ecs, "w") as f:
        f.write("-i hair.xml -vp 0 0 3.5 -vi 0 0 0 -vu 0 1 0 -fov 50\n")
    return ecs


def phase_tools(pt, tr, out):
    """Phase 31: the tools, examples and perf scripts through their own
    main() on the card, each held against its CPU run or its own checks;
    returns the traversal kernel's launches on these paths."""
    from embree_tpu_torch.examples import (feature_demos,
                                           render_pathtracer_demo,
                                           render_triangle_demo)
    from embree_tpu_torch.models.pathtracer import ReplayDraws
    from embree_tpu_torch.perf import (bigscene, compaction, obb_hair,
                                       profile_steps, sort_tax)
    from embree_tpu_torch.tools import benchdb, buildbench, info, viewer
    say("phase 31: the tools, examples and perf scripts")
    t_phase = time.perf_counter()
    card = card_line()
    os.makedirs(OUT_DIR, exist_ok=True)
    launches = {}
    secs = out.setdefault("seconds", {})

    def drive(name, fn, kernel=True):
        """fn() with the launch counts zeroed just before and read just
        after; its seconds on the host clock. ``kernel``: the path runs
        the traversal kernel, so it must have launched it."""
        tr.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        counts = dict(tr.LAUNCHES)
        add_counts(launches, counts)
        say(f"  {name}: {secs[name]:.1f} s, launches {counts}")
        check(bool(counts) or not kernel,
              f"{name}: the traversal kernel was never launched")
        return res

    golden = os.path.join(ROOT, "tests", "golden", "cube_eyelight.pfm")
    rc = drive("viewer", lambda: viewer.main(
        ["--scene", "cube", "--shader", "eyelight", "--size", str(VIEW),
         "--golden", golden, "--benchmark", "5",
         "--out", os.path.join(OUT_DIR, "viewer_cube.png")]))
    check(rc == 0, f"viewer main returned {rc}")

    tri_out = os.path.join(OUT_DIR, "et_render")
    got = drive("triangle_demo", lambda: render_triangle_demo.main(
        ["--out", tri_out + ".pgm"]))
    ref = render_triangle_demo.main(["--cpu", "--out", tri_out + "_cpu.pgm"])
    grey = int(np.abs(got["image"].astype(np.int32)
                      - ref["image"].astype(np.int32)).max())
    check(grey <= 1, f"triangle demo: {grey} grey levels from the CPU run")
    check((got["hits"], got["shadows"]) == (ref["hits"], ref["shadows"]),
          f"triangle demo: {got['hits']} hits and {got['shadows']} shadowed "
          f"pixels, the CPU run {ref['hits']} and {ref['shadows']}")
    out["triangle_demo"] = dict(max_grey_diff=grey, ms=got["render_ms"],
                                hit=got["hit_fraction"],
                                shadowed=got["shadowed"])

    rec = []
    got = drive("pathtracer_demo", lambda: render_pathtracer_demo.main(
        ["--out", os.path.join(OUT_DIR, "et_pathtracer")], record=rec))
    t0 = time.perf_counter()
    parts = render_pathtracer_demo.setup(pt, "cpu")
    ref = render_pathtracer_demo.render(
        parts, got["size"], got["spp"], ReplayDraws(rec, "cpu")).numpy()
    cpu_s = time.perf_counter() - t0
    img = got["image"]
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-6).all(-1)
    flips = int((~close).sum())
    say(f"  path-tracer demo: {got['size']}^2, {got['spp']} spp card render"
        f" vs the CPU's ({len(rec)}"
        f" draws replayed): {flips} pixels outside rtol 1e-4 / atol 1e-6 "
        f"(bound {DEMO_MAX_FLIPS}), max |diff| "
        f"{float(np.abs(img - ref).max()):.3e}; card {got['render_ms']:.1f}"
        f" ms, CPU {cpu_s:.1f} s")
    check(np.isfinite(img).all() and flips <= DEMO_MAX_FLIPS,
          f"path-tracer demo: {flips} pixels differ from the CPU render")
    out["pathtracer_demo"] = dict(flips=flips, ms=got["render_ms"],
                                  cpu_s=cpu_s)
    del parts, ref, rec

    ran = drive("feature_demos", lambda: feature_demos.main([]))
    check(len(ran) == 13, f"feature demos ran {len(ran)} of 13")

    tax = drive("sort_tax", lambda: sort_tax.main(
        ["--rays", str(SORT_ROWS)]), kernel=False)
    key, ops = sort_tax.inputs(SORT_ROWS, "cpu")
    for name, (ms, rows) in tax.items():
        cpu = sort_tax.VARIANTS[name](key, ops)
        same = (all(torch.equal(a, b) for a, b in zip(rows, cpu))
                if isinstance(cpu, list) else torch.equal(rows, cpu))
        check(same, f"sort_tax {name}: the card's rows differ from the CPU's")
    out["sort_tax"] = {k: v[0] for k, v in tax.items()}
    say(f"  sort_tax rows equal to the CPU's in all 7 variants [{card}]")

    perf_args = ["--rays", str(TOOLS_RAYS), "--mesh",
                 ",".join(map(str, TOOLS_MESH))]
    comp = drive("compaction", lambda: compaction.main(perf_args))
    t0 = comp[0.0]["t"]
    for frac, r in comp.items():
        live = ~r["dead"]
        check(same_bits(r["t"][live], t0[live]),
              f"compaction {frac:.0%}: live lanes' t differs from all-live")
        check(not torch.isfinite(r["t"][r["dead"]]).any(),
              f"compaction {frac:.0%}: a dead lane hit")
    out["compaction"] = {str(k): v["ms"] for k, v in comp.items()}

    prof = drive("profile_steps", lambda: profile_steps.main(perf_args))
    sample = [x[::PROFILE_STRIDE].contiguous() for x in prof["inputs"]]
    plain = tr.traverse_packed_reference(prof["packed"], *sample)
    vis = prof["result"].visits[:, ::PROFILE_STRIDE]
    check(torch.equal(vis, plain.visits) and same_bits(
        prof["result"].t[::PROFILE_STRIDE], plain.t),
        "profile_steps: the kernel's visits differ from the plain version's")
    say(f"  profile_steps: visits of {sample[0].shape[0]} sampled rays "
        f"({int(vis.sum())}) equal the plain version's")
    check(prof["overflow"] == 0, "profile_steps: stack overflow")
    out["profile_steps"] = {k: prof.get(k) for k in (
        "ms", "sorted", "unsorted", "useful_lane_steps", "lane_slots",
        "ns_per_useful_lane_step", "table_mib")}
    del prof, sample, plain, vis

    big = drive("bigscene", lambda: bigscene.main(
        [str(x) for x in BIG_SCENE]))
    check(big["hit_rate"] > 0 and big["overflow"] == 0,
          f"bigscene: hit rate {big['hit_rate']}, overflow "
          f"{big['overflow']}")
    out["bigscene"] = big
    torch.cuda.empty_cache()

    db = os.path.join(OUT_DIR, "benchscores.json")
    old = os.environ.get("EMBREE_TPU_BENCH_DB")
    os.environ["EMBREE_TPU_BENCH_DB"] = db
    try:
        bb = drive("buildbench", lambda: buildbench.main(
            ["--sizes", BUILD_SIZES]), kernel=False)
        check(len(bb) == 6 and all(
            set(r) == {"create", "update", "refit"}
            and all(v > 0 for v in r.values()) for r in bb.values()),
            "buildbench: not 2 sizes x 3 qualities x 3 modes")
        out["buildbench"] = {f"{m}_{q}_{n}": v for (n, q), r in bb.items()
                             for m, v in r.items()}
        benchdb.main([])
    finally:
        if old is None:
            os.environ.pop("EMBREE_TPU_BENCH_DB")
        else:
            os.environ["EMBREE_TPU_BENCH_DB"] = old

    with tempfile.TemporaryDirectory() as d:
        ecs = write_hair_scene(pt, d, HAIR_OBB_STRANDS)
        res = drive("obb_hair", lambda: obb_hair.main(
            ["--scenes", ecs, "--size", str(HAIR_OBB_SIZE),
             "--out", os.path.join(OUT_DIR, "obb_hair.json")]),
            kernel=False)
    r = res["hair"]
    check("error" not in r, f"obb_hair: {r.get('error')}")
    check(r["hits_equal"] and r["tier_active_on"]
          and not r["tier_active_off"],
          f"obb_hair: hits_equal {r['hits_equal']}, tier on "
          f"{r['tier_active_on']}, off {r['tier_active_off']}")
    out["obb_hair"] = dict(r, strands=HAIR_OBB_STRANDS)

    drive("info", lambda: info.main([]), kernel=False)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 31 took {out['phase_s']:.1f} s; {card}")
    return launches


def kernel_entries(record, errs, phase_launches):
    """One entry of the kernels line per timed variant, with the launches
    of the path that timed it; each traversal variant also carries, under
    each key of ``phase_launches``, its launches on a later phase's path:
    the instance paths of phases 22-23 (``instance_launches``), the grid
    and subdivision paths of phase 24 (``grid_subdiv_launches``), phase
    26's renders (``pathtracer_launches``), phases 28-30's paths
    (``parallel_launches``, ``robustness_launches``,
    ``parity_launches``) and phase 31's tools, examples and perf scripts
    (``tools_launches``)."""
    kernels = []
    for name, rec in record.items():
        if name in ("ablate_v7_main_cell", "ablate_v5_main_cell",
                    "ablate_vs_b1", "ablate_b1"):
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
            "bound_by": rec["bound_by"], "library_ms": None,
            **{key: counts.get(name, 0)
               for key, counts in phase_launches.items()}})
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
    check_traverse_ptxas(ptxas)
    check_sass(_build.ensure("traverse_cuda"), "traversal",
               {"persistent_kernel": 72})
    ptxas_ablate = _build.BUILD_LOGS.get("ablate_cuda", "")
    ablate_ptx = ptxas_info(ptxas_ablate, r"(v[57])_kernelILi(\d+)E")
    check_ablate_ptxas(ablate_ptx)
    check_sass(_build.ensure("ablate_cuda"), "ablation",
               {"v7_kernel": 11, "v5_kernel": 7})
    ptxas_micro = _build.BUILD_LOGS.get("micro_cuda", "")
    units = {"Ops": "micro_ops", "Expand": "micro_expand", "V8": "micro_v8"}
    micro_ptx = {(units[u], k): v for (u, k), v in ptxas_info(
        ptxas_micro, r"(Ops|Expand|V8)ELi(\d+)E").items()}
    check_micro_ptxas(micro_ptx)
    check_sass(_build.ensure("micro_cuda"), "loop-probe",
               {"probe_kernel": 46, "loop_kernel": 0})

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
    phase_ablations(pt, tr, record, ablate_ptx)
    phase_micro(record, micro_ptx)
    builders = {}
    phase_builders(pt, tr, sphere_mesh, builders)
    phase_scene_api(pt, tr, sphere_mesh, builders)
    instances = {}
    inst_launches = phase_instances(pt, tr, sphere_mesh, errs, instances)
    add_counts(inst_launches, phase_two_level(pt, tr, sphere_mesh, errs,
                                              instances))
    api = {}
    grid_launches, grid_state = phase_grids_subdiv(pt, tr, errs, api)
    phase_api(pt, tr, sphere_mesh, grid_state, api)
    del grid_state
    pathtracer = {}
    pt_launches = phase_pathtracer(pt, tr, sphere_mesh, errs, pathtracer)
    phase_gradients(pt, tr, sphere_mesh, pathtracer)
    later = {}
    phase_launches = {
        "instance_launches": inst_launches,
        "grid_subdiv_launches": grid_launches,
        "pathtracer_launches": pt_launches,
        "parallel_launches": phase_parallel(pt, tr, sphere_mesh, later),
        "robustness_launches": phase_robustness(pt, tr, sphere_mesh, later),
        "parity_launches": phase_parity(pt, tr, sphere_mesh, later)}
    tools = {}
    phase_launches["tools_launches"] = phase_tools(pt, tr, tools)

    kernels = kernel_entries(record, errs, phase_launches)
    with open(default_out("chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "detail": record,
                   "builders": builders, "instances": instances,
                   "grids_api": api, "pathtracer": pathtracer,
                   "parallel_robustness_parity": later, "tools": tools,
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
