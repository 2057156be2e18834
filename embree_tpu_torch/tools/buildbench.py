"""buildbench analog: BVH build-performance benchmark.

Port of embree_tpu/tools/buildbench.py (the reference's buildbench,
tutorials/buildbench/buildbench.cpp:27-39 build modes): static create,
dynamic update (re-commit with deformed vertices), refit, and the
LOW/MEDIUM/HIGH quality tiers, over procedural scenes of several sizes.
Each figure is Mprims/s from the best of ``iters`` commits on the host
clock; on the card every clock starts and stops after a
``torch.cuda.synchronize()``, so a commit's device work counts. Results
go to the per-machine score database (``tools/benchdb.py``) as
``build_{mode}_{quality}_{n}``.

Usage: python -m embree_tpu_torch.tools.buildbench [--sizes 10000,100000]
       [--iters 3] [--cpu] [--no-db]
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def make_mesh(n_tris: int, seed: int = 0):
    """Procedural triangle soup with locality (grid of perturbed quads)."""
    rng = np.random.default_rng(seed)
    side = max(int(np.sqrt(n_tris / 2)), 1)
    xs, ys = np.meshgrid(np.arange(side + 1), np.arange(side + 1),
                         indexing="ij")
    verts = np.stack([xs, ys, np.zeros_like(xs)], -1).reshape(-1, 3)
    verts = (verts + rng.normal(0, 0.2, verts.shape)).astype(np.float32)
    i, j = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    a = (i * (side + 1) + j).reshape(-1)
    b, c = a + 1, a + side + 1
    d = c + 1
    idx = np.stack([np.stack([a, b, d], -1), np.stack([a, d, c], -1)],
                   axis=1).reshape(-1, 3)
    return verts, np.asarray(idx[:n_tris], np.int32)


def bench_scene(n_tris: int, quality, iters: int, device="cuda"):
    """{"create", "update", "refit"}: Mprims/s of the best commit."""
    import embree_tpu_torch as pt
    from embree_tpu_torch.scene import BuildQuality
    from ..perf.device import sync

    def clock():
        """Host seconds, after the card's queued work."""
        sync(device)
        return time.perf_counter()

    verts, idx = make_mesh(n_tris)
    results = {}

    # static create (build from scratch each time)
    ts = []
    for _ in range(iters):
        s = pt.Scene(quality=quality)
        s.attach(pt.TriangleGeometry(verts, idx))
        t0 = clock()
        s.commit(device=device)
        ts.append(clock() - t0)
    results["create"] = n_tris / min(ts) / 1e6

    # dynamic update: deform the vertices, a full re-commit of the Scene;
    # refit: keep the topology, refresh the bounds
    for mode, q in (("update", quality), ("refit", BuildQuality.REFIT)):
        s = pt.Scene(quality=q)
        gid = s.attach(pt.TriangleGeometry(verts, idx))
        s.commit(device=device)
        ts = []
        for k in range(iters):
            s.get(gid).vertices = verts + np.float32(0.01 * (k + 1))
            t0 = clock()
            s.commit(device=device)
            ts.append(clock() - t0)
        results[mode] = n_tris / min(ts) / 1e6
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="10000,100000")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-db", action="store_true")
    args = ap.parse_args(argv)

    from embree_tpu_torch.scene import BuildQuality
    from ..perf.device import sync

    def clock():
        """Host seconds, after the card's queued work."""
        sync(device)
        return time.perf_counter()
    from .benchdb import record

    device = "cpu" if args.cpu else "cuda"
    sizes = [int(x) for x in args.sizes.split(",")]
    qualities = [("low", BuildQuality.LOW), ("medium", BuildQuality.MEDIUM),
                 ("high", BuildQuality.HIGH)]
    print(f"{'scene':>12s} {'quality':>8s} {'create':>10s} {'update':>10s} "
          f"{'refit':>10s}   (Mprims/s)")
    out = {}
    for n in sizes:
        for qname, q in qualities:
            r = bench_scene(n, q, args.iters, device)
            out[(n, qname)] = r
            print(f"{n:>10d}tri {qname:>8s} {r['create']:>10.3f} "
                  f"{r['update']:>10.3f} {r['refit']:>10.3f}", flush=True)
            if not args.no_db:
                for mode, v in r.items():
                    record(f"build_{mode}_{qname}_{n}", v, unit="Mprims/s")
    return out


if __name__ == "__main__":
    main()
