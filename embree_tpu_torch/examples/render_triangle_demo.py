"""triangle_geometry tutorial analog (reference: tutorials/triangle_geometry/):
cube + ground plane, primary rays + hard shadows, written to a PGM image.

Port of examples/render_triangle_demo.py. Runs on the card unless --cpu is
given; the image goes to --out (default ``chiprun_out/et_render.pgm``).

Usage: python -m embree_tpu_torch.examples.render_triangle_demo [--cpu]
       [--size 96] [--out PATH]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..perf.device import default_out, timed


def scene(pt):
    """The cube and the ground plane (tools/viewer.py's ``cube``)."""
    from ..tools.viewer import cube_plane
    s = pt.Scene()
    for v, i in cube_plane():
        s.attach(pt.TriangleGeometry(v, i))
    return s


def render(pt, cs, size):
    """(colour (H, W), hit mask, shadow mask) of the demo's camera and
    light, as the JAX demo computes them."""
    from ..core.math import cross, dot, length
    dev = cs.device
    W = H = size

    def vec(*x):
        return torch.tensor(x, dtype=torch.float32, device=dev)
    eye, look, up = vec(3.0, 2.5, 3.5), vec(0.0, 0.0, 0.0), vec(0.0, 1.0, 0.0)
    w = (look - eye) / length(look - eye)
    u = cross(w, up)
    u = u / length(u)
    v = cross(u, w)
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which is not the exact quotient the CPU and XLA give
    px = (torch.arange(W, device=dev) + 0.5) / vec(W) * 2 - 1
    py = (torch.arange(H, device=dev) + 0.5) / vec(H) * 2 - 1
    d = px[None, :, None] * u - py[:, None, None] * v + 1.8 * w
    org = torch.broadcast_to(eye, (H, W, 3)).contiguous()
    lightp = vec(4.0, 6.0, 2.0)

    rays = pt.make_rays(org, d)
    hits = pt.intersect(cs, rays)
    p = org + rays.dir * hits.t[..., None]
    ng = hits.ng / torch.clamp(length(hits.ng)[..., None], min=1e-9)
    tolight = lightp - p
    dist = length(tolight)
    ldir = tolight / dist[..., None]
    offs = ng * 1e-3 * torch.sign(dot(ng, ldir))[..., None]
    srays = pt.make_rays(p + offs, ldir, tnear=1e-3, tfar=dist - 1e-2)
    shadow = pt.occluded(cs, srays)
    ndotl = dot(ng, ldir).abs()
    valid = hits.valid
    col = torch.where(valid, 0.1 + 0.9 * ndotl * (~shadow).float(),
                      torch.zeros_like(ndotl))
    return col, valid, shadow


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = args.out or default_out("et_render.pgm")

    import embree_tpu_torch as pt
    device = "cpu" if args.cpu else "cuda"
    cs = scene(pt).commit(device=device)
    print(f"committed: prims={cs.num_prims} bvh_nodes={cs.bvh.n_nodes}")

    W = H = args.size
    t_first, _ = timed(lambda: render(pt, cs, args.size), device)
    t_run, (col, valid, shadow) = timed(lambda: render(pt, cs, args.size),
                                        device)
    # fractions from integer counts: a device's float mean may multiply by
    # 1/n where another divides
    n_hit, n_shadow = int(valid.sum()), int((shadow & valid).sum())
    hit, shadowed = n_hit / valid.numel(), n_shadow / valid.numel()
    print(f"hit fraction: {hit:.4f}  shadowed: {shadowed:.4f}")
    print(f"first {t_first / 1e3:.1f}s  render {t_run:.1f}ms "
          f"({2 * H * W / t_run / 1e3:.2f} Mrays/s incl shadow)")

    img = (col.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    with open(out, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (W, H))
        f.write(np.ascontiguousarray(img).tobytes())
    print("wrote", out)
    return dict(image=img, hit_fraction=hit, shadowed=shadowed,
                hits=n_hit, shadows=n_shadow, render_ms=t_run, device=device)


if __name__ == "__main__":
    main()
