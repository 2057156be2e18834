"""Image parity against the reference's golden EXRs.

Port of embree_tpu/tools/parity.py. The reference's CTest image-regression
tier (tests/CMakeLists.txt:4-41) renders every tests/primitives/*.xml with
5 shaders through embree_viewer and compares against golden EXRs with a
wrong-pixel budget of 55 (tutorial.cpp:646-658, compareImages in
image.cpp:13). This tool does the same through the port: it loads each XML
scene, renders the 5 shaders with the reference camera model at 512x512
through the port's ``intersect`` (on the card unless asked for the CPU),
quantizes to the same 8-bit framebuffer and scores with the same metric.

Usage:
  python -m embree_tpu_torch.tools.parity SCENE_DIR [--glob '*.xml']
      [--out parity.json] [--threshold 55] [--shaders a,b,...] [--cpu]
"""
from __future__ import annotations

import argparse
import glob as globmod
import json
import os
import sys
import time

import numpy as np

SHADERS = ("eyelight", "uv", "Ng", "primID", "occlusion")


def run_scene(xml_path, shaders, size=512, time_=0.5, device=None):
    """Render the shaders of one scene from one trace of its camera rays.
    Returns {shader: (H, W, 3) np.ndarray} or raises."""
    from ..models.viewer import SHADERS as SHADER_FNS, ispc_camera_rays
    from ..scene import intersect
    from ..utils.xml_scene import load_xml, to_scene

    xs = load_xml(xml_path)
    if not xs.geometries:
        raise ValueError("no geometries parsed")
    cam = xs.camera or dict(from_=np.array([0.0001, 0.0001, -3.0]),
                            to=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
                            fov=90.0)
    cs = to_scene(xs).commit(device=device)
    rays = ispc_camera_rays(cam["from_"], cam["to"], cam["up"], cam["fov"],
                            size, size, time=time_, device=cs.device)
    hits = intersect(cs, rays)
    return {sh: SHADER_FNS[sh](cs, rays, hits).cpu().numpy()
            for sh in shaders}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Render XML scenes with the viewer's shaders and score "
                    "them against their <scene>.xml.embree_viewer_<shader>"
                    ".exr goldens")
    ap.add_argument("scene_dir", help="directory holding the XML scenes")
    ap.add_argument("--glob", default="*.xml", help="pattern under "
                    "SCENE_DIR")
    ap.add_argument("--out", default="parity.json")
    ap.add_argument("--threshold", type=float, default=55.0)
    ap.add_argument("--shaders", default=",".join(SHADERS))
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (the plain versions)")
    args = ap.parse_args(argv)
    from ..utils.exr import compare_images, quantize8, read_exr
    device = "cpu" if args.cpu else None

    shaders = tuple(args.shaders.split(","))
    results = {}
    xmls = sorted(globmod.glob(os.path.join(args.scene_dir, args.glob)))
    if args.limit:
        xmls = xmls[:args.limit]
    n_pass = n_fail = 0
    for xml in xmls:
        name = os.path.basename(xml)
        golds = {sh: xml + f".embree_viewer_{sh}.exr" for sh in shaders}
        golds = {sh: p for sh, p in golds.items() if os.path.exists(p)}
        if not golds:
            continue
        t0 = time.time()
        try:
            imgs = run_scene(xml, tuple(golds), size=args.size,
                             device=device)
        except Exception as e:  # noqa: BLE001 — record, count, go on
            results[name] = {"error": f"{type(e).__name__}: {e}"}
            n_fail += len(golds)
            print(f"{name}: LOAD/RENDER ERROR {e}")
            continue
        row = {}
        for sh, gold_path in golds.items():
            gold = read_exr(gold_path)
            err = compare_images(quantize8(imgs[sh]), gold)
            row[sh] = round(err, 3)
            ok = err <= args.threshold
            n_pass += ok
            n_fail += not ok
        results[name] = row
        worst = max(row.values())
        print(f"{name}: {row}  [{time.time()-t0:.1f}s]"
              f" {'PASS' if worst <= args.threshold else 'FAIL'}")

    summary = {"pass": n_pass, "fail": n_fail,
               "threshold": args.threshold, "results": results}
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"\n{n_pass}/{n_pass + n_fail} shader-images within threshold "
          f"{args.threshold}; detail -> {args.out}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
