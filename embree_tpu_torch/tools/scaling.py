"""Record the multi-device scaling table as JSON.

Port of embree_tpu/tools/scaling.py: ``measure_scaling`` (a fixed total of
rays sharded over the first n ranks) and ``measure_scaling_weak`` (the
same batch on every rank) on a 4,096-triangle sphere and incoherent rays
(numpy seed 0), written in the JAX tool's layout.

Run it under ``torchrun --nproc_per_node=N`` (NCCL, one card a rank), or
without torchrun, where it starts max(counts) ranks itself, each joining
the group through a file store: on the card (NCCL puts one rank on each
card) or with ``--device cpu`` as gloo ranks on the host. The ranks of a
CPU run share one host's cores, so its rates measure the sharding
machinery, not a speedup.

Usage: python -m embree_tpu_torch.tools.scaling
           [--out chiprun_out/scaling_torch.json] [--rays N]
           [--counts 1,2,4,8] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def sphere():
    """The JAX tool's 33 x 64 UV sphere: 4,096 triangles."""
    import numpy as np
    th = np.linspace(0, np.pi, 33)
    ph = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),
                      np.cos(t)], -1).reshape(-1, 3).astype(np.float32)
    i = np.arange(32)[:, None]
    j = np.arange(64)[None, :]
    a = (i * 64 + j).ravel()
    b = (i * 64 + (j + 1) % 64).ravel()
    c = ((i + 1) * 64 + j).ravel()
    d = ((i + 1) * 64 + (j + 1) % 64).ravel()
    idx = np.concatenate([np.stack([a, b, d], -1),
                          np.stack([a, d, c], -1)]).astype(np.int32)
    return verts, idx


def measure(args):
    """Every rank of the group: build the scene, trace, and (rank 0) write
    the table."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import embree_tpu_torch as pt
    from embree_tpu_torch.parallel.render import (measure_scaling,
                                                  measure_scaling_weak)
    from embree_tpu_torch.perf.device import card_line

    dev = "cpu" if args.device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(*sphere()))
    cs = s.commit(device=dev)
    rng = np.random.default_rng(0)
    org = rng.uniform(-2, 2, (args.rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(args.rays, 3)).astype(np.float32)
    rays = pt.make_rays(org, dirs, device=dev)
    counts = [int(x) for x in args.counts.split(",")]
    per_dev = args.rays // max(counts)
    rays_w = pt.make_rays(org[:per_dev], dirs[:per_dev], device=dev)
    weak = measure_scaling_weak(cs, rays_w, counts)
    table = measure_scaling(cs, rays, counts)
    if dist.get_rank() != 0:
        return
    t1 = table[min(table)]["rays_per_s"]
    for n in table:
        table[n]["throughput_retention"] = table[n]["rays_per_s"] / t1
    backend = dist.get_backend()
    on = ("the host's CPU cores, shared by every rank" if args.device == "cpu"
          else f"{torch.cuda.device_count()} x {card_line()}")
    out = {"backend": f"torch.distributed {backend} on {on}",
           "n_rays": args.rays,
           "metric_note": ("efficiency = T_n / (n T_1) holds only where each "
                           "rank has a card of its own; ranks that share "
                           "one host's cores read throughput_retention "
                           "(T_n / T_1) as the sharding overhead"),
           "devices": {str(k): v for k, v in table.items()},
           "weak_scaling": {
               "note": ("per-rank batch constant (total = n x base), "
                        "identical batches -> uniform load: "
                        "flat_retention = T_weak(n) / T_weak(1)"),
               "rays_per_device": per_dev,
               "devices": {str(k): v for k, v in weak.items()}}}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    for n, row in table.items():
        print(f"n={n}: {row['rays_per_s']/1e6:.3f} Mrays/s "
              f"retention={row['throughput_retention']:.3f} "
              f"weak_flat={weak[n]['flat_retention']:.3f} [{out['backend']}]")
    print(f"-> {args.out}")


def _rank(rank, world, store, args):
    """One rank started by this tool (not under torchrun)."""
    import torch
    import torch.distributed as dist

    from embree_tpu_torch.parallel.render import init_distributed
    if args.device == "cpu":
        torch.set_num_threads(1)
    init_distributed("file://" + store, world, rank, device=args.device)
    try:
        measure(args)
    finally:
        dist.destroy_process_group()


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "scaling_torch.json"))
    ap.add_argument("--rays", type=int, default=1 << 17)
    ap.add_argument("--counts", default="1,2,4,8")
    ap.add_argument("--device", default=None,
                    help="cpu: gloo ranks on the host (default: the cards, "
                         "NCCL)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    if "WORLD_SIZE" in os.environ:           # under torchrun
        import torch.distributed as dist

        from embree_tpu_torch.parallel.render import init_distributed
        init_distributed(device=args.device)
        try:
            measure(args)
        finally:
            dist.destroy_process_group()
        return 0
    import torch.multiprocessing as mp
    world = max(int(x) for x in args.counts.split(","))
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank, args=(world, os.path.join(d, "store"), args),
                 nprocs=world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
