"""Sweep of the constants of the persistent warps, on the card.

``run_warp`` (``csrc/traverse.cuh``) refills a warp once enough of its
lanes are idle, and runs the lanes waiting at leaves once enough of them
wait there (or none is left at a node); ``persistent_kernel``
(``csrc/launch.cuh``) asks ptxas for a number of resident blocks per SM.
All are constants of the source, not knobs, with their own values for the
moving variants of scenes without curves (B6), for the curve variants
(B7, B8) and for the static triangles, robust triangles and mixed classes
(B1-B5).
For each configuration given, this script builds a copy of
``csrc/`` with the constants replaced, every copy at once, and times the
cell's kernel one configuration after another in turns, CUDA events,
median of 5 rounds. Each configuration's outputs must equal the built
library's bit for bit. Cells (``--cell``), all at 16,777,216
coherence-sorted rays, from ``chip_smoke.py`` in the tree's root:

- ``motion`` (B6, phase 10): the 2,097,152-triangle sphere moving 0.25
  along x, rays with times U[0, 1); constants (kRefillLanes, kLeafLanes,
  kSlotGroup, kMinBlocks); the copies compile ``traverse.cu`` with the
  curve launchers as stubs;
- ``hair`` (B7, phase 13): 1,048,576 flat B-spline curves; constants
  (kCurveRefillLanes, kCurveLeafLanes, kMinBlocks);
- ``round_hair`` (B8, phase 15): the same strands as round curves,
  packed for the kernel; the same constants;
- ``mixed`` (B3-B5, phase 8): the 1,574,400-prim mixed cell, rays from
  U(-4, 4)^3; constants (kStaticRefillLanes, kStaticLeafLanes,
  kMinBlocks); the copies compile ``traverse.cu`` with the curve
  launchers as stubs;
- ``robust`` (B2, phase 7): the 2,097,152-triangle sphere in robust mode;
  the same constants;
- ``main`` (B1, phase 4): the 2,097,152-triangle sphere in normal mode;
  the same constants;
- ``main_masked`` (B1 with the mask chunk, phase 4b): the same sphere
  with geometry mask 0x2, ray masks from {1, 2, 3} (numpy seed 1); the
  same constants.

For the curve cells the copies compile the family's own source and
``traverse.cu`` with its launches of scenes without curves skipped, so
that kMinBlocks there moves the curve variants' bound alone.

``--cell`` takes several cells of one family of constants, comma
separated (``main,main_masked``): the copies are built once for all.

Usage: python -m embree_tpu_torch.perf.sched_sweep [--cell motion]
           [--configs 8:4:4:4,...] [--variants closest,occluded]
           [--rays 16777216] [--out file.json]
(``--variants all``: the cell's variants, closest + attrs only where the
cell has triangle attributes.)
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import tempfile

import numpy as np
import torch

from .. import _build
from ..accel import traverse as tr
from .device import card_line

MOTION_CONSTANTS = (("traverse.cuh", "kRefillLanes"),
                    ("traverse.cuh", "kLeafLanes"),
                    ("traverse.cuh", "kSlotGroup"),
                    ("launch.cuh", "kMinBlocks"))
CURVE_CONSTANTS = (("traverse.cuh", "kCurveRefillLanes"),
                   ("traverse.cuh", "kCurveLeafLanes"),
                   ("launch.cuh", "kMinBlocks"))
# (refill lanes, leaf lanes, slot group, min blocks): each constant moved
# alone from the source's (8, 8, 4, 4), and the first design's
MOTION_CONFIGS = ((8, 8, 4, 4), (8, 8, 1, 4), (8, 8, 8, 4), (1, 8, 4, 4),
                  (4, 8, 4, 4), (16, 8, 4, 4), (32, 8, 4, 4), (8, 1, 4, 4),
                  (8, 4, 4, 4), (8, 12, 4, 4), (8, 16, 4, 4), (8, 32, 4, 4),
                  (8, 8, 4, 1), (8, 8, 4, 5), (4, 16, 1, 1))
# (refill lanes, leaf lanes, min blocks): each constant moved alone from
# the source's (1, 8, 4)
CURVE_CONFIGS = ((1, 8, 4), (4, 8, 4), (8, 8, 4), (16, 8, 4), (32, 8, 4),
                 (1, 1, 4), (1, 2, 4), (1, 4, 4), (1, 16, 4), (1, 32, 4),
                 (1, 8, 3))
STATIC_CONSTANTS = (("traverse.cuh", "kStaticRefillLanes"),
                    ("traverse.cuh", "kStaticLeafLanes"),
                    ("launch.cuh", "kMinBlocks"))
# (refill lanes, leaf lanes, min blocks): the first design's (8, 8, 4),
# the source's (4, 4, 4) and their neighbours
STATIC_CONFIGS = ((8, 8, 4), (1, 8, 4), (2, 8, 4), (4, 8, 4), (16, 8, 4),
                  (8, 4, 4), (8, 6, 4), (8, 12, 4), (4, 4, 4), (4, 6, 4),
                  (2, 4, 4), (8, 8, 3))
CELLS = {"motion": (MOTION_CONSTANTS, MOTION_CONFIGS, ()),
         "mixed": (STATIC_CONSTANTS, STATIC_CONFIGS, ()),
         "robust": (STATIC_CONSTANTS, STATIC_CONFIGS, ()),
         "main": (STATIC_CONSTANTS, STATIC_CONFIGS, ()),
         "main_masked": (STATIC_CONSTANTS, STATIC_CONFIGS, ()),
         "hair": (CURVE_CONSTANTS, CURVE_CONFIGS, ("traverse_curves.cu",)),
         "round_hair": (CURVE_CONSTANTS, CURVE_CONFIGS,
                        ("traverse_round.cu",))}
VARIANTS = {"closest_attrs": (False, True), "closest": (False, False),
            "occluded": (True, False)}
MESH = (1024, 1024)
SHIFT = 0.25
REPS = 5

# the curve launchers a copy does not compile
STUBS = {"traverse_curves.cu": """
void launch_curves(const Params&, int, int, int, int, Counters,
                   cudaStream_t) {}""",
         "traverse_round.cu": """
void launch_round(const Params&, int, int, int, int, Counters,
                  cudaStream_t) {}"""}
# traverse.cu's launches of scenes without curves, skipped in the curve
# cells' copies: SKIP after its include of launch.cuh, each of its
# SKIPPED launches renamed
INCLUDE = '#include "launch.cuh"\n'
SKIPPED = ("launch_motion<", 5)
SKIP = """namespace trav {
template <bool... B, class... A>
void skip_launch(A&&...) {}
}  // namespace trav
"""


def _replace(src, old, new, count, what):
    """src with ``old`` replaced by ``new``, which must occur ``count``
    times (a regular expression when ``old`` is a compiled pattern)."""
    if isinstance(old, re.Pattern):
        src, n = old.subn(new, src)
    else:
        n = src.count(old)
        src = src.replace(old, new)
    if n != count:
        raise RuntimeError(f"{what}: {n} matches, not {count}")
    return src


def _copy(root, cell, config):
    """csrc/ with the cell's constants replaced, in ``root``; its Target."""
    constants, _, units = CELLS[cell]
    os.makedirs(root)
    for f in ("traverse.cu", "launch.cuh", "traverse.cuh") + units:
        shutil.copy(os.path.join(_build.CSRC, f), root)
    for (f, name), v in zip(constants, config):
        path = os.path.join(root, f)
        src = _replace(open(path).read(),
                       re.compile(rf"constexpr int {name} = \d+;"),
                       f"constexpr int {name} = {v};", 1, f"{f}: {name}")
        open(path, "w").write(src)
    if units:
        path = os.path.join(root, "traverse.cu")
        src = _replace(open(path).read(), INCLUDE, INCLUDE + SKIP, 1,
                       "traverse.cu: its include of launch.cuh")
        src = _replace(src, SKIPPED[0], "trav::skip_launch<", SKIPPED[1],
                       "traverse.cu: its launches without curves")
        open(path, "w").write(src)
    stubs = "".join(v for k, v in STUBS.items() if k not in units)
    open(os.path.join(root, "stubs.cu"), "w").write(
        '#include "launch.cuh"\nnamespace trav {' + stubs
        + "\n}  // namespace trav\n")
    base = _build.TARGETS["traverse_cuda"]
    return _build.Target(
        os.path.join(root, "libtraverse_sweep.so"),
        tuple(os.path.join(root, f)
              for f in ("traverse.cu",) + units + ("stubs.cu",)),
        (os.path.join(root, "launch.cuh"), os.path.join(root,
                                                        "traverse.cuh")),
        base.flags, base.link)


def build(cell, configs, tmp):
    """Build every configuration's library, and the package's, at once;
    returns {configuration: launch fn}."""
    names = ["sweep_" + "_".join(map(str, c)) for c in configs]
    copies = {n: _copy(os.path.join(tmp, n), cell, c)
              for n, c in zip(names, configs)}
    secs = _build.build_all(names + ["traverse_cuda"],
                            dict(_build.TARGETS, **copies))
    print(f"built {len(names)} copies and the library in {secs:.1f} s",
          flush=True)
    fns = {}
    for c, name in zip(configs, names):
        regs, spill = ptxas_summary(_build.BUILD_LOGS.get(name, ""), cell)
        print(f"  {c}: persistent kernels at {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers, {spill} B of local "
              "memory", flush=True)
        fn = ctypes.CDLL(copies[name].path).traverse_launch
        fn.restype = ctypes.c_int
        fn.argtypes = tr._ARGS + [ctypes.c_void_p] * 3
        fns[c] = fn
    return fns


# the persistent kernels of each cell's family, by template flags
# (occlusion, attrs, mask, robust, kinds, motion, curves, round)
FAMILY = {"motion": lambda f: f[5] and not f[6],
          "hair": lambda f: f[6], "round_hair": lambda f: f[6],
          "mixed": lambda f: f[4] and not f[5] and not f[6],
          "robust": lambda f: f[3] and not f[4] and not f[5],
          "main": lambda f: not any(f[3:]),
          "main_masked": lambda f: not any(f[3:])}


def ptxas_summary(log, cell):
    """Registers of each persistent kernel of the cell's family in a
    build's ptxas lines, and the bytes of stack frame and spills they add
    up to."""
    regs, spill, on = [], 0, False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            flags = [int(b) for b in re.findall(r"Lb([01])E", m.group(1))]
            on = ("persistent_kernel" in m.group(1) and len(flags) == 8
                  and bool(FAMILY[cell](flags)))
        elif on and "stack frame" in line:
            spill += sum(int(v) for v in re.findall(r"(\d+) bytes", line))
        elif on and "Used" in line:
            regs.append(int(re.search(r"Used (\d+) registers",
                                      line).group(1)))
            on = False
    return regs, spill


def launch(fn, packed, x, occ, attrs, robust):
    """One launch of a configuration's library, as ``traverse_kernel``
    makes it."""
    outs = tr._outputs(x[0].shape[0], x[0].device, attrs)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*tr._call_args(packed, *x[:5], tr._time(packed, x[0], x[5]),
                            outs, occ, attrs, robust),
             tr._ptr(outs[5]), tr._ptr(outs[6]), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return tr._result(outs)


def cell(name, n_rays):
    """The cell's packed scene, whether it is robust, and its sorted rays
    (time U[0, 1) in the motion cell, ray masks in the masked main
    cell)."""
    import chip_smoke as cs
    import embree_tpu_torch as pt
    from embree_tpu_torch import scene as pscene
    rng = np.random.default_rng(0)
    spread = 4 if name == "mixed" else 2
    org = rng.uniform(-spread, spread, (n_rays, 3)).astype(np.float32)
    d = rng.standard_normal((n_rays, 3), dtype=np.float32)
    if name in ("mixed", "robust", "main", "main_masked"):
        if name == "mixed":
            s = cs.mixed_full_scene(pt)
        else:
            from embree_tpu_torch.tools.viewer import sphere_mesh
            s = pt.Scene(robust=name == "robust")
            s.attach(pt.TriangleGeometry(
                *sphere_mesh(*MESH),
                mask=0x2 if name == "main_masked" else 0xFFFFFFFF))
        committed = s.commit(device="cuda")
        rmask = (np.random.default_rng(1).choice(
            np.array([1, 2, 3], np.uint32), n_rays)
            if name == "main_masked" else 0xFFFFFFFF)
        rays = pt.make_rays(org, d, mask=rmask, device="cuda")
    elif name == "motion":
        from embree_tpu_torch.tools.viewer import sphere_mesh
        v, idx = sphere_mesh(*MESH)
        s = pt.Scene()
        s.attach(pt.TriangleGeometry(
            np.stack([v, v + np.float32([SHIFT, 0, 0])]), idx))
        committed = s.commit(device="cuda")
        t = np.random.default_rng(2).uniform(0, 1, n_rays).astype(np.float32)
        rays = pt.make_rays(org, d, time=t, device="cuda")
    else:
        with cs.round_packed(pscene):
            committed = cs.hair_scene(
                pt, "round" if name == "round_hair" else "flat").commit(
                    device="cuda")
        rays = pt.make_rays(org, d, device="cuda")
    _, x = tr.sort_rays_by_coherence(rays.org, rays.dir, rays.tnear,
                                     rays.tfar, rays.mask.to(torch.int32),
                                     rays.time)
    return committed.packed, committed.robust, x


def same(a, b):
    return (torch.equal(a.t.view(torch.int32), b.t.view(torch.int32))
            and torch.equal(a.best, b.best)
            and torch.equal(a.visits, b.visits)
            and (a.attrs is None or torch.equal(a.attrs.view(torch.int32),
                                                b.attrs.view(torch.int32))))


def sweep(name, fns, configs, names, args, card):
    """Time the cell ``name`` in every configuration; its rows."""
    packed, robust, x = cell(name, args.rays)
    n = args.rays
    rows = []
    variants = ([v for v in VARIANTS if packed.tri_attrs
                 or not VARIANTS[v][1]] if args.variants == "all"
                else args.variants.split(","))
    for var in variants:
        occ, attrs = VARIANTS[var]
        ref = tr.traverse_kernel(packed, *x[:5], occ, attrs, robust,
                                 time=x[5])
        times = {c: [] for c in configs}
        stats = {}
        for rep in range(REPS + 1):          # round 0 warms up
            for c in configs:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                res = launch(fns[c], packed, x, occ, attrs, robust)
                b.record()
                torch.cuda.synchronize()
                if int(res.sched[2]) != n or not same(res, ref):
                    raise AssertionError(f"{c} {var}: outputs differ")
                if rep:
                    times[c].append(a.elapsed_time(b))
                stats[c] = (int(res.sched[1]) / int(res.sched[0]),
                            int(res.sched[3]),
                            [int(v) for v in res.leaf_sched])
                del res
        for c in configs:
            ms = statistics.median(times[c])
            share, warps, leaf = stats[c]
            rows.append(dict(cell=name, variant=var,
                             **dict(zip(names, c)), ms=ms,
                             warps_per_sm=warps,
                             useful_lane_steps=share, leaf_sched=leaf,
                             card=card))
            print(f"{name} {var} "
                  + " ".join(f"{k} {v}" for k, v in zip(names, c))
                  + f": {ms:.3f} ms, useful lane-steps {share:.4f}, "
                  f"{warps} warps per SM [{card}]", flush=True)
    del packed, x
    torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="motion")
    ap.add_argument("--configs", default=None)
    ap.add_argument("--variants", default="closest")
    ap.add_argument("--rays", type=int, default=1 << 24)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cells = args.cell.split(",")
    if not set(cells) <= set(CELLS) or len(
            {CELLS[c][0] + (CELLS[c][2],) for c in cells}) != 1:
        ap.error(f"--cell: cells of one family of constants from "
                 f"{sorted(CELLS)}")
    if not torch.cuda.is_available():
        raise SystemExit("sched_sweep times the card; no CUDA device")
    configs = ([tuple(int(v) for v in c.split(":"))
                for c in args.configs.split(",")] if args.configs
               else list(CELLS[cells[0]][1]))
    names = [n for _, n in CELLS[cells[0]][0]]
    card = card_line()
    print(card, flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(cells[0], configs, tmp)
        for name in cells:
            rows += sweep(name, fns, configs, names, args, card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
