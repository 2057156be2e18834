"""The static triangles (B1), robust triangles (B2) and mixed classes
(B3-B5) timed over many launches, small batches and full size, to hold two
trees of the port against each other on one card.

Run it from the root of a tree (it takes the scenes from that tree's
``chip_smoke.py``), one tree after another in one call, in the order
A, B, B, A:

    python -m embree_tpu_torch.perf.static_batches [--reps 41]
        [--full-reps 5] [--cases tri,kinds] [--out file.json]

(``--cases``: only the cases whose label holds one of these words.) A
tree older than a case's kernel may lack the case: copy this script into
that tree and run it from there.

Cases, each on the rays sorted as the wrapper hands them to the kernel:
- the kind check scene of phase 6 of ``chip_smoke.py`` at 65,536 rays, as
  is, masked (every second geometry 0x2, ray masks from {1, 2, 3}), robust
  and both: the eight mixed-class instantiations, closest and occluded;
- the mixed cell of phase 8 (1,574,400 prims) at 16,777,216 rays from
  U(-4, 4)^3, as is, masked, robust and both;
- the robust sphere of phase 7 (2,097,152 triangles) at 16,777,216 rays:
  closest + attrs, closest and occluded;
- B1: the 16,384-triangle sphere of phase 3 at 65,536 rays, and the main
  sphere of phase 4 (2,097,152 triangles) at 16,777,216 rays, as is and
  masked as in phase 4b (geometry mask 0x2, ray masks from {1, 2, 3}):
  closest + attrs, closest and occluded.

Each variant: the median, least and most of ``reps`` launches after one
warm-up, timed as ``b6_batches`` times them (CUDA events around one
``traverse_kernel`` call each), with the card's name and power limit, and
where the tree's wrapper reports the persistent warps' counts, their
useful share of lane slots (a tree whose B1 runs one ray per thread
reports none for it).
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from .b6_batches import FULL_RAYS, SMALL_RAYS, _sorted, _time


def _mixed(pt, cs, masked, robust):
    """chip_smoke.mixed_full_scene, ``masked``: every second geometry has
    mask 0x2; ``robust``: in robust mode."""
    rng = np.random.default_rng(1)
    geoms = [pt.QuadGeometry(*cs.prim_sphere("quad", (0, 0, 0), 1.0, 512))]
    for center, kind in (((2.5, 0, 0), "sphere"), ((-2.5, 0, 0), "disc")):
        pos, _ = cs.point_sphere(center, 1.0, 0.01, 256)
        geoms.append(pt.PointGeometry(pos, kind=kind))
    pos, nrm = cs.point_sphere((0, 2.5, 0), 1.0, 0.01, 256, oriented=True)
    geoms.append(pt.PointGeometry(pos, kind="oriented_disc", normals=nrm))
    geoms.append(pt.LineSegmentsGeometry(*cs.hair(rng, (0, -2.5, 0), 65536),
                                         kind="round"))
    geoms.append(pt.LineSegmentsGeometry(*cs.hair(rng, (0, 0, 2.5), 16384),
                                         kind="flat"))
    s = pt.Scene(robust=robust)
    for k, g in enumerate(geoms):
        if masked and k % 2:
            g.mask = 0x2
        s.attach(g)
    return s


def _robust_sphere(pt, cs):
    from embree_tpu_torch.tools.viewer import sphere_mesh
    s = pt.Scene(robust=True)
    s.attach(pt.TriangleGeometry(*sphere_mesh(*cs.MAIN_MESH)))
    return s


def _sphere(pt, cs, mesh, masked=False):
    """The sphere of ``mesh`` in normal mode, with geometry mask 0x2 when
    ``masked``."""
    from embree_tpu_torch.tools.viewer import sphere_mesh
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(*sphere_mesh(*mesh),
                                 mask=0x2 if masked else 0xFFFFFFFF))
    return s


def _cases(pt, cs):
    """(label, a function that builds the scene, masked, robust, the
    variants, ray origins' half-width or None for 65,536 incoherent
    rays)."""
    flags = ((False, False), (True, False), (False, True), (True, True))
    for masked, robust in flags:
        yield (f"kinds check masked={masked} robust={robust}",
               lambda m=masked, r=robust: cs.mixed_check_scene(pt, m, r),
               masked, robust, cs.KIND_VARIANTS, None)
    for masked, robust in flags:
        yield (f"mixed full masked={masked} robust={robust}",
               lambda m=masked, r=robust: _mixed(pt, cs, m, r), masked,
               robust, cs.KIND_VARIANTS, 4.0)
    yield ("robust sphere", lambda: _robust_sphere(pt, cs), False, True,
           cs.VARIANTS, 2.0)
    yield ("tri check sphere", lambda: _sphere(pt, cs, cs.CHECK_MESH), False,
           False, cs.VARIANTS, None)
    for masked in (False, True):
        yield (f"tri main masked={masked}",
               lambda m=masked: _sphere(pt, cs, cs.MAIN_MESH, m), masked,
               False, cs.VARIANTS, 2.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=41)
    ap.add_argument("--full-reps", type=int, default=5)
    ap.add_argument("--cases", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("static_batches times the card; no CUDA device")
    import chip_smoke as cs
    import embree_tpu_torch as pt
    from embree_tpu_torch.accel import traverse as tr
    card = cs.card_line()
    print(card, flush=True)
    rows = []
    words = args.cases.split(",") if args.cases else None
    for label, scene, masked, robust, variants, spread in _cases(pt, cs):
        if words and not any(w in label for w in words):
            continue
        c = scene().commit(device="cuda")
        assert not c.has_motion and not tr.has_curves(c.packed)
        full = spread is not None
        n = FULL_RAYS if full else SMALL_RAYS
        if full:
            rng = np.random.default_rng(0)
            org = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
            d = rng.standard_normal((n, 3), dtype=np.float32)
        else:
            org, d = cs.incoherent_rays(n, 0)
        rmask = (np.random.default_rng(1).choice(
            np.array([1, 2, 3], np.uint32), n) if masked else 0xFFFFFFFF)
        rays = pt.make_rays(org, d, mask=rmask, device="cuda")
        x = _sorted(tr, rays)
        del rays, org, d
        for base, occ, attrs in variants:
            ms, res = _time(tr, c.packed, x, occ, attrs, robust,
                            args.full_reps if full else args.reps)
            sched = getattr(res, "sched", None)
            share = (None if sched is None
                     else int(sched[1]) / max(int(sched[0]), 1))
            steps = int(res.visits.sum(dtype=torch.int64)) / n
            row = dict(case=label, variant=base, n_rays=n,
                       name=tr.packed_variant(c.packed, occ, attrs, robust),
                       median_ms=statistics.median(ms), min_ms=min(ms),
                       max_ms=max(ms), reps=len(ms), steps_per_ray=steps,
                       useful_lane_steps=share, card=card)
            rows.append(row)
            print(f"{label} {base}: median {row['median_ms']:.4f} ms "
                  f"(min {row['min_ms']:.4f}, max {row['max_ms']:.4f}, "
                  f"{len(ms)} launches, {n} rays, {steps:.2f} steps/ray"
                  + (f", useful lane-steps {share:.4f}" if share is not None
                     else "") + f") [{card}]", flush=True)
            del res
        del c, x
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
