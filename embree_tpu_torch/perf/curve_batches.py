"""The curve variants (B7, B8) timed over many launches, small batches and
full size, to hold two trees of the port against each other on one card.

Run it from the root of a tree (it takes the scenes from that tree's
``chip_smoke.py``), one tree after another in one call, in the order
A, B, B, A:

    python -m embree_tpu_torch.perf.curve_batches [--reps 41]
        [--full-reps 5] [--out file.json]

Cases, each on the rays sorted as the wrapper hands them to the kernel,
closest and occluded:
- the curve check scenes of phases 12 (flat, B7) and 14 (round, B8) of
  ``chip_smoke.py`` at 65,536 rays: static and 2-step x {as is, masked,
  robust, robust + masked}, the 32 curve instantiations, and over 3 steps
  (windows); moving scenes with times U[0, 1), masked ones with ray masks
  from {1, 2, 3};
- the hair cell (phase 13, 1,048,576 flat curves) and the round hair cell
  (phase 15, the same strands as round curves packed for the kernel) at
  16,777,216 rays.

Each variant: the median, least and most of ``reps`` launches after one
warm-up, timed as ``b6_batches`` times them (CUDA events around one
``traverse_kernel`` call each), with the card's name and power limit, and
where the tree's wrapper reports the persistent warps' counts, their
useful share of lane slots.
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from .b6_batches import FULL_RAYS, SMALL_RAYS, _sorted, _time


def _cases(pt, cs):
    """(label, a function that commits the scene, masked, robust, full
    size) of each case."""
    from embree_tpu_torch import scene as pscene

    def commit(scene, family):
        if family == "round":
            with cs.round_packed(pscene):
                return scene.commit(device="cuda")
        return scene.commit(device="cuda")

    for family, build in (("flat", cs.curve_check_scene),
                          ("round", cs.round_check_scene)):
        for steps in (1, 2):
            for masked, robust in ((False, False), (True, False),
                                   (False, True), (True, True)):
                yield (f"{family} check masked={masked} robust={robust} "
                       f"steps={steps}",
                       lambda b=build, f=family, m=masked, r=robust, s=steps:
                       commit(b(pt, m, r, s), f), masked, robust, False)
        yield (f"{family} check masked=False robust=False steps=3",
               lambda b=build, f=family: commit(b(pt, False, False, 3), f),
               False, False, False)
    for family in ("flat", "round"):
        yield (f"{family} hair", lambda f=family: commit(
            cs.hair_scene(pt, kind=f), f), False, False, True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=41)
    ap.add_argument("--full-reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("curve_batches times the card; no CUDA device")
    import chip_smoke as cs
    import embree_tpu_torch as pt
    from embree_tpu_torch.accel import traverse as tr
    card = cs.card_line()
    print(card, flush=True)
    rows = []
    for label, commit, masked, robust, full in _cases(pt, cs):
        c = commit()
        assert tr.has_curves(c.packed)
        n = FULL_RAYS if full else SMALL_RAYS
        org, d = cs.incoherent_rays(n, 0)
        rmask = (np.random.default_rng(1).choice(
            np.array([1, 2, 3], np.uint32), n) if masked else 0xFFFFFFFF)
        rays = pt.make_rays(org, d, time=cs.ray_times(n) if c.has_motion
                            else 0.0, mask=rmask, device="cuda")
        x = _sorted(tr, rays)
        del rays, org, d
        for base, occ, attrs in cs.KIND_VARIANTS:
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
