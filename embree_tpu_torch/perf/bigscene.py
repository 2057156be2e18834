"""Big-scene experiment: a 2,097,152-triangle sphere at 4,194,304
incoherent rays through the main path on the card (the Crown-class
workload, tutorials/models/trace.bench:1-11; verify.cpp:5933's incoherent
rays).

Port of perf/bigscene.py. Its sphere keeps that script's index order:
all (a, b, d) triangles first, then all (a, d, c), which is not the
interleaved order of ``tools/viewer.sphere_mesh``. It prints the commit's
seconds, the node and leaf tables' MiB (the port's ``PackedScene``
tensors), the hit rate, Mrays/s of ``intersect(differentiable=False)``
(best of 3 between CUDA events, the median beside it; the host clock on
the CPU), and the kernel's visits per ray with its stack overflows, from
one traced launch on the sorted rays. The card has no fetch loop and no
DMA counters, so the JAX script's ``ntrips``/``ltrips``/``ndma``/``ldma``
have no counterpart (ROADMAP §C, "fetch trips").

Usage: python -m embree_tpu_torch.perf.bigscene [n_theta n_phi n_rays]
       [--cpu]
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch


def sphere_mesh(n_theta, n_phi, radius=1.0):
    """perf/bigscene.py:18-34's sphere, in its block order."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([
        radius * np.sin(t) * np.cos(p),
        radius * np.sin(t) * np.sin(p),
        radius * np.cos(t)], axis=-1).reshape(-1, 3).astype(np.float32)
    i = np.arange(n_theta)[:, None]
    j = np.arange(n_phi)[None, :]
    a = (i * n_phi + j).ravel()
    b = (i * n_phi + (j + 1) % n_phi).ravel()
    c = ((i + 1) * n_phi + j).ravel()
    d = ((i + 1) * n_phi + (j + 1) % n_phi).ravel()
    idx = np.concatenate([np.stack([a, b, d], -1), np.stack([a, d, c], -1)])
    return verts, idx.astype(np.int32)


def main(argv=None):
    """Returns a dict of the figures."""
    ap = argparse.ArgumentParser()
    ap.add_argument("n_theta", type=int, nargs="?", default=1024)
    ap.add_argument("n_phi", type=int, nargs="?", default=1024)
    ap.add_argument("n_rays", type=int, nargs="?", default=1 << 22)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import embree_tpu_torch as pt
    from ..accel import traverse as tr
    from .device import sync, timed
    device = "cpu" if args.cpu else "cuda"
    print("device:", torch.cuda.get_device_name(0) if device == "cuda"
          else "cpu")
    verts, idx = sphere_mesh(args.n_theta, args.n_phi)
    print(f"tris={len(idx):,} verts={len(verts):,}")

    sync(device)
    t0 = time.perf_counter()
    scene = pt.Scene()
    scene.attach(pt.TriangleGeometry(verts, idx))
    cs = scene.commit(device=device)
    sync(device)
    commit_s = time.perf_counter() - t0
    print(f"commit: {commit_s:.2f}s")
    pk = cs.packed
    node_mib = pk.nodes.numel() * pk.nodes.element_size() / 2**20
    leaf_mib = pk.leaves.numel() * pk.leaves.element_size() / 2**20
    print(f"node table: {node_mib:.1f} MiB ({pk.nodes.shape[0]} records), "
          f"leaf table: {leaf_mib:.1f} MiB ({pk.leaves.shape[0]} records)")

    n = args.n_rays
    rng = np.random.default_rng(0)
    org = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    rays = pt.make_rays(org, d, device=device)

    def run():
        return pt.intersect(cs, rays, differentiable=False).t
    first_ms, t = timed(run, device)
    hit_rate = float(torch.isfinite(t).float().mean())
    print(f"first run: {first_ms / 1e3:.1f}s hit-rate={hit_rate:.3f}")
    times = [timed(run, device)[0] for _ in range(3)]
    best = min(times)
    print(f"times: {[f'{x:.3f}' for x in times]} ms")
    print(f"=> {n / best / 1e3:.2f} Mrays/s (median "
          f"{n / statistics.median(times) / 1e3:.2f})")

    flat = rays.reshape(n)
    _, sorted_in = tr.sort_rays_by_coherence(
        flat.org, flat.dir, flat.tnear, flat.tfar,
        flat.mask.to(torch.int32))
    res = tr.trace(pk, *sorted_in)
    per_ray = res.visits.sum(0, dtype=torch.int64)
    overflow = int(res.overflow)
    print(f"visits/ray mean={float(per_ray.float().mean()):.2f} "
          f"(nodes {float(res.visits[0].float().mean()):.2f} + leaves "
          f"{float(res.visits[1].float().mean()):.2f}) "
          f"max={int(per_ray.max())} overflow={overflow}")
    return dict(tris=len(idx), commit_s=commit_s, node_mib=node_mib,
                leaf_mib=leaf_mib, hit_rate=hit_rate, ms=times,
                mrays_s=n / best / 1e3, visits_mean=float(
                    per_ray.float().mean()), visits_max=int(per_ray.max()),
                overflow=overflow)


if __name__ == "__main__":
    main()
