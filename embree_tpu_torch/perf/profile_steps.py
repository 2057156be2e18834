"""Profile the traversal kernel's work on the bench scene: visits per
block of rays, time per useful lane-step, sorted against unsorted rays.

Port of perf/profile_steps.py. The JAX script reads the Pallas kernel's
per-program step counters for 2,048-ray programs (16 groups x 128 lanes)
of the coherence-sorted rays. The card's kernel counts each ray's visits
(node + leaf records) instead, so this sums them over each 2,048-ray block
of the same sorted order, and over the same blocks of the unsorted rays
(``sort_rays=False``). The persistent warps' own counts
(``TraceResult.sched``) give the useful lane-steps, and the kernel's time
over them the time per useful lane-step. The card has no fetch loop and
no DMA counters, so the JAX script's fetch trips (``ntrips``, ``ltrips``)
have no counterpart (ROADMAP §C, "fetch trips").

The kernel runs through ``accel/traverse.py::trace`` on the sorted rays,
timed as the median of 5 windows of 5 calls between CUDA events
(``perf/device.py::time_call``); on the CPU the plain version on the host
clock.

Usage: python -m embree_tpu_torch.perf.profile_steps [--rays N]
       [--mesh 64,128] [--cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

BLOCK = 16 * 128          # the Pallas program's rays (UGRP x LANE)


def block_sums(visits, block: int = BLOCK):
    """Per-ray visits (2, R) summed over both records and over each block
    of ``block`` rays (the last block may be short): (ceil(R/block),)
    int64."""
    per_ray = visits.sum(0, dtype=torch.int64)
    pad = (-per_ray.shape[0]) % block
    per_ray = torch.cat([per_ray, per_ray.new_zeros(pad)])
    return per_ray.reshape(-1, block).sum(1)


def _stats(x):
    a = x.cpu().numpy()
    return dict(mean=float(a.mean()), min=int(a.min()), max=int(a.max()),
                p90=float(np.percentile(a, 90)), total=int(a.sum()))


def main(argv=None):
    """Returns a dict of the figures, the packed scene, the sorted inputs
    and the sorted run's TraceResult."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--mesh", default="64,128", help="n_theta,n_phi")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import embree_tpu_torch as pt
    from ..accel import traverse as tr
    from ..tools.viewer import sphere_mesh
    from .device import time_call
    device = "cpu" if args.cpu else "cuda"
    cuda = device == "cuda"
    n = args.rays
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(*sphere_mesh(*map(int,
                                                   args.mesh.split(",")))))
    packed = s.commit(device=device).packed
    mib = (packed.nodes.numel() + packed.leaves.numel()) * 4 / 2**20
    print(f"node records: {packed.nodes.shape[0]} leaf records: "
          f"{packed.leaves.shape[0]} ({mib:.3f} MiB)")

    rng = np.random.default_rng(0)
    org = torch.from_numpy(rng.uniform(-2, 2, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    org, d = org.to(device), d.to(device)
    tnear = torch.zeros(n, dtype=torch.float32, device=device)
    tfar = torch.full((n,), float("inf"), dtype=torch.float32, device=device)
    mask = torch.full((n,), -1, dtype=torch.int32, device=device)

    _, sorted_in = tr.sort_rays_by_coherence(org, d, tnear, tfar, mask)
    ms, res = time_call(lambda: tr.trace(packed, *sorted_in),
                        cuda=cuda)
    blocks = block_sums(res.visits)
    st = _stats(blocks)
    visits = st["total"]
    print(f"time {ms:.3f} ms -> {n / ms / 1e3:.2f} Mrays/s")
    print(f"blocks {blocks.shape[0]} of {BLOCK} rays, visits/block: mean "
          f"{st['mean']:.0f} min {st['min']} max {st['max']} p90 "
          f"{st['p90']:.0f}")
    print(f"total visits {visits}, time/visit {ms / visits * 1e6:.3f} ns")
    out = dict(ms=ms, sorted=st, blocks=blocks.cpu(), n_rays=n,
               overflow=int(res.overflow), table_mib=mib, packed=packed,
               inputs=sorted_in, result=res)
    if res.sched is not None:
        slots, useful, finished, warps = (int(x) for x in res.sched.cpu())
        out.update(lane_slots=slots, useful_lane_steps=useful,
                   rays_finished=finished, warps_per_sm=warps,
                   ns_per_useful_lane_step=ms / useful * 1e6)
        print(f"lane slots {slots}, useful lane-steps {useful} "
              f"({useful / slots:.1%}), time/useful lane-step "
              f"{ms / useful * 1e6:.3f} ns, rays finished {finished}, "
              f"warps/SM {warps}")

    # the same blocks of the rays in their given order (sort_rays=False)
    res_u = tr.trace(packed, org, d, tnear, tfar, mask)
    su = _stats(block_sums(res_u.visits))
    print(f"unsorted visits/block: mean {su['mean']:.0f} max {su['max']}")
    out["unsorted"] = su
    return out


if __name__ == "__main__":
    main()
