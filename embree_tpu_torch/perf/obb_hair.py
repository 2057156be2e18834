"""Hair-tier OBB payoff: the generic engine's steps and time with the
leaf OBBs on and off.

Port of perf/obb_hair.py. For each hair scene (an Embree ``.ecs`` command
file with its XML) it commits twice (``EMBREE_TPU_HAIR_OBB`` on, then off)
and traces the scene's camera rays through the generic engine
(``accel/traverse_generic.traverse`` with ``leaf_obb`` from
``scene._scene_leaf_obb``), measuring:
  - lockstep traversal steps (``TraversalResult.steps``),
  - seconds of one warm trace (after a ``torch.cuda.synchronize()`` on
    the card; the host clock),
  - hit-image equality (the tier must be conservative).
A scene that fails is recorded as an ``error`` and the run goes on. The
default scenes are the JAX tool's: Embree's four hair models, under the
Embree checkout given by --reference (not in the repository); pass others
with --scenes.

Usage: python -m embree_tpu_torch.perf.obb_hair [--size 256]
       [--out chiprun_out/obb_hair.json] [--reference EMBREE_DIR]
       [--scenes A.ecs ...] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

# perf/obb_hair.py:23-29's scenes, relative to an Embree checkout
SCENES = [
    "tests/models/curves/hair0.ecs",
    "tests/models/curves/hair1.ecs",
    "tests/models/furball/furball_bezier_normaloriented.ecs",
    "tests/models/furball/furball_bezier_round.ecs",
]
ENV = "EMBREE_TPU_HAIR_OBB"


def measure(ecs, size, device="cuda"):
    """The figures of one scene: steps_on/off, sec_on/off,
    tier_active_on/off, hits_equal, step_reduction, speedup."""
    from .. import scene as scene_mod
    from .device import sync
    from ..accel import traverse_generic
    from ..models.viewer import ispc_camera_rays
    from ..tools.parity_models import parse_ecs
    from ..utils.xml_scene import load_xml, to_scene

    cfg = parse_ecs(ecs)
    xs = load_xml(cfg["xml"])
    cam = (xs.cameras.get(cfg["camera"]) if cfg["camera"] else None) \
        or xs.camera or {}
    vp = cfg["vp"] or tuple(cam.get("from_", (0.0001, 0.0001, -3.0)))
    vi = cfg["vi"] or tuple(cam.get("to", (0.0, 0.0, 0.0)))
    rays = ispc_camera_rays(np.asarray(vp), np.asarray(vi),
                            np.asarray(cfg["vu"]), cfg["fov"], size, size,
                            device=device).reshape(size * size)

    out = {}
    before = os.environ.get(ENV)
    try:
        for enabled in (True, False):
            os.environ[ENV] = "1" if enabled else "0"
            cs = to_scene(xs).commit(device=device)
            obb = scene_mod._scene_leaf_obb(cs)

            def run():
                return traverse_generic.traverse(
                    cs.bvh, scene_mod._make_prim_test(cs, rays), rays.org,
                    rays.dir, rays.tnear, rays.tfar, occlusion=False,
                    max_leaf_size=scene_mod.LEAF_SIZE, robust=cs.robust,
                    leaf_obb=obb)

            run()                                          # warm-up
            sync(device)
            t0 = time.perf_counter()
            r = run()
            sync(device)
            dt = time.perf_counter() - t0
            key = "on" if enabled else "off"
            out[f"steps_{key}"] = int(r.steps)
            out[f"sec_{key}"] = round(dt, 4)
            out[f"tier_active_{key}"] = bool(obb is not None)
            out[f"best_{key}"] = r.best_prim.cpu().numpy()
            out[f"tfar_{key}"] = r.tfar.cpu().numpy()
    finally:
        if before is None:
            os.environ.pop(ENV, None)
        else:
            os.environ[ENV] = before

    out["hits_equal"] = bool(
        np.array_equal(out.pop("best_on"), out.pop("best_off"))
        and np.array_equal(out.pop("tfar_on"), out.pop("tfar_off")))
    out["step_reduction"] = round(
        1.0 - out["steps_on"] / max(out["steps_off"], 1), 4)
    out["speedup"] = round(out["sec_off"] / max(out["sec_on"], 1e-9), 3)
    return out


def main(argv=None):
    """Returns {scene name: figures or {"error": ...}, "_meta": ...}."""
    from .device import OUT_DIR, ROOT
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "obb_hair.json"))
    ap.add_argument("--reference", default=os.path.join(ROOT, "reference"),
                    help="the Embree checkout the default scenes are in")
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    scenes = args.scenes if args.scenes is not None else [
        os.path.join(args.reference, s) for s in SCENES]

    results = {}
    for ecs in scenes:
        name = os.path.basename(ecs).replace(".ecs", "")
        try:
            results[name] = measure(ecs, args.size, device)
        except Exception as e:  # noqa: BLE001 — record and continue
            results[name] = {"error": f"{type(e).__name__}: {e}"}
        print(name, json.dumps(results[name]), flush=True)

    results["_meta"] = dict(size=args.size, platform=device,
                            device=(torch.cuda.get_device_name(0)
                                    if device == "cuda" else "cpu"))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", args.out)
    return results


if __name__ == "__main__":
    main()
