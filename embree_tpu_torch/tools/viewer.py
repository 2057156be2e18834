"""embree_viewer analog: render a scene (OBJ or built-in procedural) with a
chosen shader, benchmark it, or compare it against a golden image.

Usage:
  python -m embree_tpu_torch.tools.viewer --scene cube --shader eyelight \
      --size 256 --out /tmp/out.png [--golden ref.pfm --compare-threshold 55]
      [--benchmark N] [--cpu]

Port of embree_tpu/tools/viewer.py: ``build_scene`` (:21-71) takes an
``.obj`` path (its meshes as triangle geometries), the cube + ground
plane, the UV sphere (built with vectorized numpy) or the ``mixed`` scene
(a quad floor, two spheres and a native round Bezier curve, which rides
the generic engine); ``main`` (:75) has the same flags. Parity:
tutorials/viewer (shader modes viewer_device.cpp:45-54), the CTest
image-regression flow (tutorial.cpp:646 compare) and the --benchmark
timing mode (tutorial/benchmark.h). On the card ``--benchmark`` times each
frame with CUDA events after a synchronize; the line prints the best frame
(the JAX tool's figure) with the median beside it.
"""
from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np


def sphere_mesh(n_theta: int, n_phi: int, radius: float = 1.0):
    """Triangulated UV sphere with the index order of the JAX package's
    loops (bench.py:18-35, tools/viewer.py:43-55): per (i, j) cell the
    triangles (a, b, d) then (a, d, c)."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([radius * np.sin(t) * np.cos(p),
                      radius * np.sin(t) * np.sin(p),
                      radius * np.cos(t)], axis=-1).reshape(-1, 3) \
        .astype(np.float32)
    i, j = np.meshgrid(np.arange(n_theta), np.arange(n_phi), indexing="ij")
    a = i * n_phi + j
    b = i * n_phi + (j + 1) % n_phi
    c = (i + 1) * n_phi + j
    d = (i + 1) * n_phi + (j + 1) % n_phi
    idx = np.stack([np.stack([a, b, d], -1), np.stack([a, d, c], -1)],
                   axis=2).reshape(-1, 3).astype(np.int32)
    return verts, idx


def cube_plane():
    """The unit cube and a ground plane just below it, as two (vertices,
    indices) meshes."""
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32)
    i = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]], np.int32)
    p = np.array([[-6, -1.01, -6], [6, -1.01, -6], [6, -1.01, 6],
                  [-6, -1.01, 6]], np.float32)
    return [(v, i), (p, np.array([[0, 1, 2], [0, 2, 3]], np.int32))]


def build_scene(name: str, et):
    """Returns (Scene, eye point) for an ``.obj`` path or a built-in scene;
    ``et`` is the package whose Scene and geometry classes to use."""
    if name.endswith(".obj"):
        from ..utils.obj import load_obj
        meshes, _ = load_obj(name)
        s = et.Scene()
        for m in meshes:
            s.attach(et.TriangleGeometry(m.vertices, m.indices))
        return s, (3.0, 2.0, 3.0)
    if name == "cube":
        s = et.Scene()
        for v, i in cube_plane():
            s.attach(et.TriangleGeometry(v, i))
        return s, (3.0, 2.5, 3.5)
    if name == "sphere":
        verts, idx = sphere_mesh(32, 64)
        s = et.Scene()
        s.attach(et.TriangleGeometry(verts, idx))
        return s, (0.0, 0.8, 3.0)
    if name == "mixed":
        s = et.Scene()
        s.attach(et.QuadGeometry(
            np.array([[-4, -1, -4], [4, -1, -4], [4, -1, 4], [-4, -1, 4]],
                     np.float32), np.array([[0, 1, 2, 3]], np.int32)))
        s.attach(et.PointGeometry(
            np.array([[-1, 0, 0, 0.5], [1, 0, 0.5, 0.4]], np.float32),
            kind="sphere"))
        s.attach(et.CurveGeometry(
            np.array([[-1, 0.5, 0, 0.06], [-0.4, 1.4, 0, 0.06],
                      [0.4, 1.4, 0, 0.06], [1, 0.5, 0.5, 0.06]], np.float32),
            np.array([0], np.int32), basis="bezier", kind="round",
            tessellation_rate=12))
        return s, (0.0, 1.5, 4.5)
    raise ValueError(f"unknown scene '{name}'")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cube")
    ap.add_argument("--shader", default="eyelight",
                    choices=["eyelight", "uv", "Ng", "primID", "geomID",
                             "occlusion"])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--out", default=None)
    ap.add_argument("--golden", default=None,
                    help="golden .pfm to compare against")
    ap.add_argument("--compare-threshold", type=float, default=55,
                    help="max wrong pixels (reference CTest default)")
    ap.add_argument("--save-golden", default=None)
    ap.add_argument("--benchmark", type=int, default=0, metavar="N",
                    help="time N repetitions")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import embree_tpu_torch as pt
    from ..models.camera import Camera
    from ..models.viewer import render
    from ..utils.image import compare_images, load_pfm, save_pfm, save_png

    try:
        scene, eye = build_scene(args.scene, pt)
    except ValueError as e:
        raise SystemExit(str(e))
    cs = scene.commit(device="cpu" if args.cpu else None)
    cam = Camera(from_point=np.asarray(eye, np.float32),
                 to_point=np.zeros(3, np.float32),
                 up=np.array([0, 1, 0], np.float32))

    H = W = args.size

    def run():
        return render(cs, cam, H, W, shader=args.shader)
    img = run().cpu().numpy()

    if args.benchmark:
        from ..perf.device import timed
        cuda = cs.device.type == "cuda"
        times = [timed(run, cs.device)[0] for _ in range(args.benchmark)]
        best, med = min(times), statistics.median(times)
        print(f"BENCHMARK {args.scene}/{args.shader}: {best:.2f} ms/frame "
              f"({H * W / best / 1e3:.2f} Mrays/s primary); median "
              f"{med:.2f} ms ({'CUDA events' if cuda else 'host clock'})")

    if args.out:
        if args.out.endswith(".pfm"):
            save_pfm(args.out, img)
        else:
            save_png(args.out, img)
        print("wrote", args.out)
    if args.save_golden:
        save_pfm(args.save_golden, img)
        print("wrote golden", args.save_golden)
    if args.golden:
        ref = load_pfm(args.golden)
        wrong = compare_images(img, ref)
        status = "PASS" if wrong <= args.compare_threshold else "FAIL"
        print(f"COMPARE {status}: {wrong} wrong pixels "
              f"(threshold {args.compare_threshold})")
        return 0 if wrong <= args.compare_threshold else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
