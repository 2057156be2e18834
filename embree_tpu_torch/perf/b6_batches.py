"""B6's moving variants timed over many launches, small batches and full
size, to hold two trees of the port against each other on one card.

Run it from the root of a tree (it takes the scenes from that tree's
``chip_smoke.py``), one tree after another in one call, in the order
A, B, B, A:

    python -m embree_tpu_torch.perf.b6_batches [--reps 41] [--full-reps 5]
        [--out file.json]

Cases, each on the rays sorted as the wrapper hands them to the kernel:
- phase 9 of ``chip_smoke.py`` at 65,536 rays with times U[0, 1): the kind
  check scene with every kind moving (as is, masked, robust, robust +
  masked, 3 steps with windows) and the 16K-triangle sphere moving
  (masked, robust, robust + masked); at this size every ray gets a lane
  of its own;
- the mixed cell of phase 8 (1,574,400 prims) with every geometry moving
  over 2 steps, as is, masked (every second geometry 0x2, ray masks from
  {1, 2, 3}), robust and both, at 16,777,216 rays from U(-4, 4)^3: the
  eight mixed-class moving instantiations at full size.

Each variant: the median, least and most of ``reps`` launches after one
warm-up (CUDA events around one ``traverse_kernel`` call each), with the
card's name and power limit. Where the tree's wrapper reports the
persistent warps' counts (``TraceResult.sched``), their useful share of
lane slots is printed beside.
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

SMALL_RAYS = 1 << 16
FULL_RAYS = 1 << 24


def _moving_mixed(pt, cs, masked, robust):
    """chip_smoke.mixed_full_scene with every geometry moving over 2
    steps (each along its own axis, a tenth of its size or less), oriented
    disc normals turning; ``masked``: every second geometry has mask 0x2."""
    rng = np.random.default_rng(1)
    pos_s, _ = cs.point_sphere((2.5, 0, 0), 1.0, 0.01, 256)
    pos_d, _ = cs.point_sphere((-2.5, 0, 0), 1.0, 0.01, 256)
    pos_o, nrm = cs.point_sphere((0, 2.5, 0), 1.0, 0.01, 256, oriented=True)
    qv, qi = cs.prim_sphere("quad", (0, 0, 0), 1.0, 512)
    rv, ri = cs.hair(rng, (0, -2.5, 0), 65536)
    fv, fi = cs.hair(rng, (0, 0, 2.5), 16384)
    geoms = [
        pt.QuadGeometry(cs.moving(qv, (0.1, 0, 0), 2), qi),
        pt.PointGeometry(cs.moving(pos_s, (0, 0.1, 0), 2), kind="sphere"),
        pt.PointGeometry(cs.moving(pos_d, (0, 0, 0.1), 2), kind="disc"),
        pt.PointGeometry(cs.moving(pos_o, (0.1, 0, 0), 2),
                         kind="oriented_disc",
                         normals=np.stack([nrm, nrm[:, [1, 2, 0]]])),
        pt.LineSegmentsGeometry(cs.moving(rv, (0, 0, 0.05), 2), ri,
                                kind="round"),
        pt.LineSegmentsGeometry(cs.moving(fv, (0.05, 0, 0), 2), fi,
                                kind="flat"),
    ]
    s = pt.Scene(robust=robust)
    for k, g in enumerate(geoms):
        if masked and k % 2:
            g.mask = 0x2
        s.attach(g)
    return s


def _sorted(tr, rays):
    _, x = tr.sort_rays_by_coherence(rays.org, rays.dir, rays.tnear,
                                     rays.tfar, rays.mask.to(torch.int32),
                                     rays.time)
    return x


def _time(tr, packed, x, occ, attrs, robust, reps):
    """[ms of each of ``reps`` launches], the last launch's result."""
    def launch():
        return tr.traverse_kernel(packed, *x[:5], occ, attrs, robust,
                                  time=x[5])
    launch()
    torch.cuda.synchronize()
    out, res = [], None
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = launch()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out, res


def _cases(pt, cs):
    """(label, a function that builds the scene, masked, robust, the
    variants, full size) of each case."""
    from embree_tpu_torch.tools.viewer import sphere_mesh
    verts, idx = sphere_mesh(*cs.CHECK_MESH)
    for masked, robust, steps in ((False, False, 2), (True, False, 2),
                                  (False, True, 2), (True, True, 2),
                                  (False, False, 3)):
        yield (f"kinds masked={masked} robust={robust} steps={steps}",
               lambda m=masked, r=robust, st=steps:
               cs.mixed_check_scene(pt, m, r, st), masked, robust,
               cs.KIND_VARIANTS, False)
    for masked, robust in ((True, False), (False, True), (True, True)):
        def tris(m=masked, r=robust):
            s = pt.Scene(robust=r)
            s.attach(pt.TriangleGeometry(
                cs.moving(verts, (cs.MOTION_SHIFT, 0, 0), 2), idx,
                mask=0x2 if m else 0xFFFFFFFF))
            return s
        yield (f"tris masked={masked} robust={robust} steps=2", tris,
               masked, robust, cs.VARIANTS, False)
    for masked, robust in ((False, False), (True, False), (False, True),
                           (True, True)):
        yield (f"mixed full masked={masked} robust={robust} steps=2",
               lambda m=masked, r=robust: _moving_mixed(pt, cs, m, r),
               masked, robust, cs.KIND_VARIANTS, True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=41)
    ap.add_argument("--full-reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("b6_batches times the card; no CUDA device")
    import chip_smoke as cs
    import embree_tpu_torch as pt
    from embree_tpu_torch.accel import traverse as tr
    card = cs.card_line()
    print(card, flush=True)
    rows = []
    for label, scene, masked, robust, variants, full in _cases(pt, cs):
        c = scene().commit(device="cuda")
        assert c.has_motion and tr.has_curves(c.packed) is False
        n = FULL_RAYS if full else SMALL_RAYS
        if full:
            rng = np.random.default_rng(0)
            org = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
            d = rng.standard_normal((n, 3), dtype=np.float32)
        else:
            org, d = cs.incoherent_rays(n, 0)
        rmask = (np.random.default_rng(1).choice(
            np.array([1, 2, 3], np.uint32), n) if masked else 0xFFFFFFFF)
        rays = pt.make_rays(org, d, time=cs.ray_times(n), mask=rmask,
                            device="cuda")
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
