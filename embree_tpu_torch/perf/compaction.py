"""Wavefront compaction payoff, on the card (SURVEY §2.8 P2).

Port of perf/compaction.py. The path tracer's bounce loop leaves
terminated rays inert (tnear > tfar). The coherence sort's dead bit packs
them at the tail of the sorted order, where the persistent warps retire
them after one step. This times ``intersect(differentiable=False)`` on the
16,384-triangle sphere at 1,048,576 rays with 0/50/75/90% dead lanes
(``tfar = -1``); the cost should track the LIVE fraction, not the total.
Times are the median of 5 windows of 5 calls between CUDA events
(``perf/device.py::time_call``); on the CPU the host clock.

Usage: python -m embree_tpu_torch.perf.compaction [--rays N]
       [--mesh 64,128] [--cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

FRACTIONS = (0.0, 0.5, 0.75, 0.9)


def main(argv=None):
    """Returns {dead fraction: dict(ms, t, dead)}, t and dead on the host."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--mesh", default="64,128", help="n_theta,n_phi")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import embree_tpu_torch as pt
    from ..tools.viewer import sphere_mesh
    from .device import time_call
    device = "cpu" if args.cpu else "cuda"
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(*sphere_mesh(*map(int,
                                                   args.mesh.split(",")))))
    cs = s.commit(device=device)
    n = args.rays
    rng = np.random.default_rng(0)
    org = torch.from_numpy(rng.uniform(-2, 2, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    org, d = org.to(device), d.to(device)

    out = {}
    base = None
    for frac in FRACTIONS:
        dead = torch.from_numpy(rng.uniform(size=n) < frac).to(device)
        tfar = torch.where(dead, -1.0, float("inf"))     # inert lanes
        rays = pt.make_rays(org, d, tfar=tfar)
        ms, t = time_call(
            lambda: pt.intersect(cs, rays, differentiable=False).t,
            cuda=device == "cuda")
        if base is None:
            base = ms
        live = 1.0 - frac
        print(f"dead={frac:.0%}: {ms:8.3f} ms  vs-all-live {ms / base:5.2f} "
              f"(ideal {max(live, 0.02):4.2f})", flush=True)
        out[frac] = dict(ms=ms, t=t.cpu(), dead=dead.cpu())
    return out


if __name__ == "__main__":
    main()
