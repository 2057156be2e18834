"""Sweep of the four constants of B6's persistent warps, on the card.

``run_warp`` (``csrc/traverse.cuh``) refills a warp once ``kRefillLanes``
of its lanes are idle, and runs the lanes waiting at leaves once
``kLeafLanes`` of them wait there (or none is left at a node);
``motion_leaf`` reads, lerps and tests ``kSlotGroup`` slots of a leaf at
a time; ``persistent_kernel`` (``csrc/launch.cuh``) asks ptxas for
``kMinBlocks`` resident blocks per SM. All four are constants of the
source, not knobs. For each (refill, leaf, group, blocks) configuration
given, this script builds a copy of ``csrc/`` with the four replaced
(``traverse.cu``, with the curve launchers, which no triangle scene
reaches, as stubs), every copy at once, and times B6 on the 2-step motion
cell of ``chip_smoke.py`` (phase 10: the 2,097,152-triangle sphere moving
0.25 along x, 16,777,216 coherence-sorted rays with times U[0, 1)), one
configuration after another in turns, CUDA events, median of 5 rounds.
Each configuration's outputs must equal the built library's bit for bit.

Usage: python -m embree_tpu_torch.perf.sched_sweep
           [--configs 8:4:4:4,4:16:4:1,...] [--variants closest,occluded]
           [--rays 16777216] [--out file.json]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import tempfile

import numpy as np
import torch

from .. import _build
from ..accel import traverse as tr

# (refill lanes, leaf lanes, slot group, min blocks): each constant moved
# alone from the source's (8, 8, 4, 4), and the first design's
CONSTANTS = (("traverse.cuh", "kRefillLanes"), ("traverse.cuh", "kLeafLanes"),
             ("traverse.cuh", "kSlotGroup"), ("launch.cuh", "kMinBlocks"))
CONFIGS = ((8, 8, 4, 4), (8, 8, 1, 4), (8, 8, 8, 4), (1, 8, 4, 4),
           (4, 8, 4, 4), (16, 8, 4, 4), (32, 8, 4, 4), (8, 1, 4, 4),
           (8, 4, 4, 4), (8, 12, 4, 4), (8, 16, 4, 4), (8, 32, 4, 4),
           (8, 8, 4, 1), (8, 8, 4, 5), (4, 16, 1, 1))
VARIANTS = {"closest_attrs": (False, True), "closest": (False, False),
            "occluded": (True, False)}
MESH = (1024, 1024)
SHIFT = 0.25
REPS = 5

STUBS = """#include "launch.cuh"
namespace trav {
void launch_curves(const Params&, int, int, int, int, Counters,
                   cudaStream_t) {}
void launch_round(const Params&, int, int, int, int, Counters,
                  cudaStream_t) {}
}  // namespace trav
"""


def _copy(root, config):
    """csrc/ with the four constants replaced, in ``root``; its Target."""
    os.makedirs(root)
    for f in ("traverse.cu", "launch.cuh", "traverse.cuh"):
        shutil.copy(os.path.join(_build.CSRC, f), root)
    for (f, name), v in zip(CONSTANTS, config):
        path = os.path.join(root, f)
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {v};", open(path).read())
        if n != 1:
            raise RuntimeError(f"{name} not found in {f}")
        open(path, "w").write(src)
    open(os.path.join(root, "stubs.cu"), "w").write(STUBS)
    base = _build.TARGETS["traverse_cuda"]
    return _build.Target(
        os.path.join(root, "libtraverse_sweep.so"),
        (os.path.join(root, "traverse.cu"), os.path.join(root, "stubs.cu")),
        (os.path.join(root, "launch.cuh"), os.path.join(root,
                                                        "traverse.cuh")),
        base.flags, base.link)


def build(configs, tmp):
    """Build every configuration's library, and the package's, at once;
    returns {configuration: launch fn}."""
    names = ["sweep_" + "_".join(map(str, c)) for c in configs]
    copies = {n: _copy(os.path.join(tmp, n), c)
              for n, c in zip(names, configs)}
    secs = _build.build_all(names + ["traverse_cuda"],
                            dict(_build.TARGETS, **copies))
    print(f"built {len(names)} copies and the library in {secs:.1f} s",
          flush=True)
    fns = {}
    for c, name in zip(configs, names):
        regs, spill = ptxas_summary(_build.BUILD_LOGS.get(name, ""))
        print(f"  {c}: persistent kernels at {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers, {spill} B of local "
              "memory", flush=True)
        fn = ctypes.CDLL(copies[name].path).traverse_launch
        fn.restype = ctypes.c_int
        fn.argtypes = tr._ARGS + [ctypes.c_void_p] * 3
        fns[c] = fn
    return fns


def ptxas_summary(log):
    """Registers of each persistent kernel in a build's ptxas lines, and
    the bytes of stack frame and spills they add up to."""
    regs, spill, on = [], 0, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = "persistent_kernel" in line
        elif on and "stack frame" in line:
            spill += sum(int(v) for v in re.findall(r"(\d+) bytes", line))
        elif on and "Used" in line:
            regs.append(int(re.search(r"Used (\d+) registers",
                                      line).group(1)))
            on = False
    return regs, spill


def launch(fn, packed, x, occ, attrs):
    """One launch of a configuration's library, as ``traverse_kernel``
    makes it."""
    outs = tr._outputs(x[0].shape[0], x[0].device, attrs, True)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*tr._call_args(packed, *x[:5], x[5], outs, occ, attrs, False),
             tr._ptr(outs[5]), tr._ptr(outs[6]), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return tr.TraceResult(*outs[:5], sched=outs[6])


def cell(n_rays):
    """Phase 10's cell: the moving sphere and its sorted rays."""
    import embree_tpu_torch as pt
    from embree_tpu_torch.tools.viewer import sphere_mesh
    v, idx = sphere_mesh(*MESH)
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(
        np.stack([v, v + np.float32([SHIFT, 0, 0])]), idx))
    cs = s.commit(device="cuda")
    rng = np.random.default_rng(0)
    org = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = rng.standard_normal((n_rays, 3), dtype=np.float32)
    t = np.random.default_rng(2).uniform(0, 1, n_rays).astype(np.float32)
    rays = pt.make_rays(org, d, time=t, device="cuda")
    _, x = tr.sort_rays_by_coherence(rays.org, rays.dir, rays.tnear,
                                     rays.tfar, rays.mask.to(torch.int32),
                                     rays.time)
    return cs.packed, x


def same(a, b):
    return (torch.equal(a.t.view(torch.int32), b.t.view(torch.int32))
            and torch.equal(a.best, b.best)
            and torch.equal(a.visits, b.visits)
            and (a.attrs is None or torch.equal(a.attrs.view(torch.int32),
                                                b.attrs.view(torch.int32))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default=",".join(
        ":".join(map(str, c)) for c in CONFIGS))
    ap.add_argument("--variants", default="closest")
    ap.add_argument("--rays", type=int, default=1 << 24)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sched_sweep times the card; no CUDA device")
    configs = [tuple(int(v) for v in c.split(":"))
               for c in args.configs.split(",")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(configs, tmp)
        packed, x = cell(args.rays)
        n = args.rays
        rows = []
        for var in args.variants.split(","):
            occ, attrs = VARIANTS[var]
            ref = tr.traverse_kernel(packed, *x[:5], occ, attrs, time=x[5])
            times = {c: [] for c in configs}
            share, warps = {}, {}
            for rep in range(REPS + 1):          # round 0 warms up
                for c in configs:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    res = launch(fns[c], packed, x, occ, attrs)
                    b.record()
                    torch.cuda.synchronize()
                    if int(res.sched[2]) != n or not same(res, ref):
                        raise AssertionError(f"{c} {var}: outputs differ")
                    if rep:
                        times[c].append(a.elapsed_time(b))
                    share[c] = int(res.sched[1]) / int(res.sched[0])
                    warps[c] = int(res.sched[3])
                    del res
            for c in configs:
                ms = statistics.median(times[c])
                rows.append(dict(variant=var, refill=c[0], leaf=c[1],
                                 group=c[2], min_blocks=c[3], ms=ms,
                                 warps_per_sm=warps[c],
                                 useful_lane_steps=share[c], card=card))
                print(f"{var} refill {c[0]:2d} leaf {c[1]:2d} group "
                      f"{c[2]} min blocks {c[3]}: {ms:.3f} ms, useful "
                      f"lane-steps "
                      f"{share[c]:.4f}, {warps[c]} warps per SM [{card}]",
                      flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
