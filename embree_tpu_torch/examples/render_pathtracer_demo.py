"""Cornell-box-style path tracer demo (reference: tutorials/pathtracer/).

Port of examples/render_pathtracer_demo.py: NEE + BRDF sampling at 128^2,
8 spp, depth 4, written as PNG and PFM (``--out`` without the extension;
default ``chiprun_out/et_pathtracer``). Runs on the card unless --cpu is
given. ``cornell_box`` is the one copy of the scene builder: the smoke
run's path-tracer phases take their Cornell box from it.

Usage: python -m embree_tpu_torch.examples.render_pathtracer_demo [--cpu]
       [--size 128] [--spp 8] [--out PREFIX]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..perf.device import default_out, timed

MAX_DEPTH = 4


def quad(p0, p1, p2, p3):
    return (np.array([p0, p1, p2, p3], np.float32),
            np.array([[0, 1, 2], [0, 2, 3]], np.int32))


def cornell_box(pt):
    """examples/render_pathtracer_demo.py:40-74: five walls, a mirror and a
    matte ball (sphere points), an emissive ceiling panel and a quad light.
    Returns (Scene, {geom id: material}, LightSetBuilder, Camera keywords)."""
    from ..models.lights import LightSetBuilder
    from ..models.materials import EMISSIVE, MATTE, MIRROR
    s = pt.Scene()
    mats = {}

    def wall(p0, p1, p2, p3, mat):
        gid = s.attach(pt.TriangleGeometry(*quad(p0, p1, p2, p3)))
        mats[gid] = mat
        return gid

    white = (MATTE, (0.73, 0.73, 0.73), 0.0)
    # box: floor/ceiling/back/left(red)/right(green)
    wall([-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1], white)
    wall([-1, 2, 1], [1, 2, 1], [1, 2, -1], [-1, 2, -1], white)
    wall([-1, 0, -1], [-1, 2, -1], [1, 2, -1], [1, 0, -1], white)
    wall([-1, 0, 1], [-1, 2, 1], [-1, 2, -1], [-1, 0, -1],
         (MATTE, (0.65, 0.05, 0.05), 0.0))
    wall([1, 0, -1], [1, 2, -1], [1, 2, 1], [1, 0, 1],
         (MATTE, (0.12, 0.45, 0.15), 0.0))
    # mirror sphere + matte tall box stand-in (sphere point)
    gid = s.attach(pt.PointGeometry(
        np.array([[-0.35, 0.4, -0.3, 0.4]], np.float32), kind="sphere"))
    mats[gid] = (MIRROR, (0.9, 0.9, 0.9), 0.0)
    gid = s.attach(pt.PointGeometry(
        np.array([[0.45, 0.3, 0.35, 0.3]], np.float32), kind="sphere"))
    mats[gid] = (MATTE, (0.3, 0.3, 0.8), 0.0)
    # emissive ceiling panel
    wall([-0.4, 1.99, -0.4], [0.4, 1.99, -0.4], [0.4, 1.99, 0.4],
         [-0.4, 1.99, 0.4], (EMISSIVE, (6.0, 6.0, 6.0), 0.0))
    lights = LightSetBuilder().quad([-0.4, 1.98, -0.4], [0.8, 0, 0],
                                    [0, 0, 0.8], (6, 6, 6))
    cam = dict(from_point=np.array([0, 1.0, 3.6], np.float32),
               to_point=np.array([0, 0.9, 0], np.float32),
               up=np.array([0, 1, 0], np.float32), fov_deg=40)
    return s, mats, lights, cam


def setup(pt, device):
    """(committed scene, materials, lights, camera) on ``device``."""
    from ..models.camera import Camera
    from ..models.materials import make_materials
    s, mats, lights, cam = cornell_box(pt)
    cs = s.commit(device=device)
    return (cs, make_materials(s._next_id, mats, device=device),
            lights.build(device=device), Camera(**cam))


def render(parts, size, spp, draws=None):
    """(size, size, 3) radiance of the demo's render."""
    from ..models.pathtracer import render_pathtracer
    cs, mats, lights, cam = parts
    return render_pathtracer(cs, mats, lights, cam, size, size, spp=spp,
                             max_depth=MAX_DEPTH, draws=draws)


def main(argv=None, record=None):
    """``record``: a list that receives a CPU copy of every draw of the
    steady render, in order (to replay it on another device)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = args.out or default_out("et_pathtracer")

    import embree_tpu_torch as pt
    from ..models.pathtracer import Draws
    from ..utils.image import save_pfm, save_png
    device = "cpu" if args.cpu else "cuda"
    parts = setup(pt, device)
    H = W = args.size
    t_first, _ = timed(lambda: render(parts, H, args.spp), device)
    t_run, img = timed(lambda: render(
        parts, H, args.spp, Draws.seeded(0, device, record=record)), device)
    n_rays = H * W * args.spp * MAX_DEPTH * 2
    print(f"pathtracer: {H}x{W}x{args.spp}spp first {t_first / 1e3:.1f}s "
          f"steady {t_run:.0f}ms (~{n_rays / t_run / 1e3:.2f} Mrays/s)")

    img = img.cpu()
    img_t = torch.clamp(img / (1 + img), 0, 1).numpy() ** (1 / 2.2)
    save_png(out + ".png", img_t)
    save_pfm(out + ".pfm", img.numpy())
    print("wrote", out + ".png")
    return dict(image=img.numpy(), size=H, spp=args.spp, render_ms=t_run,
                device=device)


if __name__ == "__main__":
    main()
