"""Phase 9's motion configurations launched many times, each launch held
against the plain version bit for bit: a search for launches whose output
depends on the persistent warps' scheduling.

Run it on a GPU from the root of a tree (it takes the scenes from that
tree's ``chip_smoke.py``):

    python -m embree_tpu_torch.perf.repeat_launches [--reps 20]
        [--routes 1,auto] [--match text]

For each build route (the value of EMBREE_TPU_NATIVE_BUILD: ``1`` the
native builder, ``auto`` the default route, the SAH builder at these
sizes), each configuration of phase 9 (the kind check scene moving: as is,
masked, robust, both, 3 steps with windows; the 16K-triangle sphere
moving: masked, robust, both, and static robust + masked) and closest and
occluded, it runs the plain version once and the kernel ``reps`` times on
the 65,536 sorted rays, and prints how many launches differ from the plain
version in prim ids, t bits or step counts, with the first differing rays
(index, the kernel's and the plain version's node and leaf steps, and
whether their prim ids and t bits agree). ``--match`` keeps the
configurations whose label contains the text.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def configurations(cs, pt, sphere_mesh):
    """(label, scene, masked, robust) of phase 9."""
    verts, idx = sphere_mesh(*cs.CHECK_MESH)
    for m, r, st in ((False, False, 2), (True, False, 2), (False, True, 2),
                     (True, True, 2), (False, False, 3)):
        yield f"kinds masked={m} robust={r} steps={st}", \
            cs.mixed_check_scene(pt, m, r, st), m, r
    for m, r, st in ((True, False, 2), (False, True, 2), (True, True, 2),
                     (True, True, 1)):
        s = pt.Scene(robust=r)
        s.attach(pt.TriangleGeometry(
            cs.moving(verts, (cs.MOTION_SHIFT, 0, 0), st), idx,
            mask=0x2 if m else 0xFFFFFFFF))
        yield f"tris masked={m} robust={r} steps={st}", s, m, r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--routes", default="1,auto")
    ap.add_argument("--match", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("repeat_launches: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import embree_tpu_torch as pt
    from embree_tpu_torch.accel import traverse as tr
    from embree_tpu_torch.tools.viewer import sphere_mesh

    print(cs.card_line())
    org, d = cs.incoherent_rays(cs.KINDS_RAYS, 0)
    time = cs.ray_times(cs.KINDS_RAYS)
    rmask = np.random.default_rng(1).choice(np.array([1, 2, 3], np.uint32),
                                            cs.KINDS_RAYS)
    total = bad_total = 0
    for route in args.routes.split(","):
        os.environ["EMBREE_TPU_NATIVE_BUILD"] = route
        for label, s, masked, robust in configurations(cs, pt, sphere_mesh):
            if args.match not in label:
                continue
            c = s.commit(device="cuda")
            rays = pt.make_rays(org, d, time=time,
                                mask=rmask if masked else 0xFFFFFFFF,
                                device="cuda")
            x = cs.sorted_inputs(tr, rays)
            for occ in (False, True):
                p = cs.run_plain(tr, c.packed, x, occlusion=occ,
                                 robust=robust)
                bad, first = 0, None
                for _ in range(args.reps):
                    k = cs.run_kernel(tr, c.packed, x, occlusion=occ,
                                      robust=robust)
                    torch.cuda.synchronize()
                    diff = ((k.visits != p.visits).any(0) | (k.best != p.best)
                            | (k.t.view(torch.int32)
                               != p.t.view(torch.int32)))
                    if bool(diff.any()):
                        bad += 1
                        if first is None:
                            i = torch.nonzero(diff).squeeze(1)[:4]
                            first = [(int(j), k.visits[:, j].tolist(),
                                      p.visits[:, j].tolist(),
                                      bool(k.best[j] == p.best[j]),
                                      bool(k.t[j].view(torch.int32)
                                           == p.t[j].view(torch.int32)))
                                     for j in i]
                total += args.reps
                bad_total += bad
                print(f"route={route} {label} occluded={occ}: {bad} of "
                      f"{args.reps} launches differ"
                      + (f"; first rays (index, kernel steps, plain steps, "
                         f"same prim, same t): "
                         f"{first}" if first else ""), flush=True)
    print(f"{bad_total} of {total} launches differ")
    return 1 if bad_total else 0


if __name__ == "__main__":
    sys.exit(main())
