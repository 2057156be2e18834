"""The ranks of the port's multi-device tests (tests/test_torch_parallel.py).

Each rank joins a gloo process group through a file store, runs the
counterparts of tests/test_parallel.py's sharded computations on its block
of the rays, and writes what it holds to ``<out>/rank<r>.npz``. This module
imports the port and numpy only (no JAX), so that spawned ranks start
quickly. ``python torch_dist_worker.py multihost RANK WORLD STORE INPUTS
OUT`` runs one separately started process of the two-process render.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch


def _join(rank, world, store):
    from embree_tpu_torch.parallel.render import init_distributed
    torch.set_num_threads(1)
    init_distributed("file://" + store, world, rank, device="cpu")


def _scene(inp, prefix="sphere"):
    import embree_tpu_torch as pt
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(inp[f"{prefix}/verts"],
                                 inp[f"{prefix}/idx"]))
    return s.commit(device="cpu")


def _rays(inp, name):
    import embree_tpu_torch as pt
    return pt.make_rays(inp[f"{name}/org"], inp[f"{name}/dir"],
                        device="cpu")


def _camera(inp, prefix):
    from embree_tpu_torch.models.camera import Camera
    return Camera(from_point=inp[f"{prefix}/from"],
                  to_point=inp[f"{prefix}/to"], up=inp[f"{prefix}/up"],
                  fov_deg=float(inp[f"{prefix}/fov"]))


def sum_t_loss(cs, rays):
    """tests/test_parallel.py:70-73: the sum of the hit distances, as a
    function of the triangles' first vertices (both time steps)."""
    import embree_tpu_torch as pt

    def loss(v0):
        s2 = dataclasses.replace(cs, tri_v0=v0, tri_v0b=v0)
        h = pt.intersect(s2, rays, backend="jnp")
        return torch.where(h.valid, h.t, 0.0).sum()
    return loss


def depth_target(cs, rays):
    """A depth target for the training step: the inverse depth of the
    scene with its vertices pulled 5% toward the origin."""
    from embree_tpu_torch.parallel.mesh import render_depth
    s2 = dataclasses.replace(cs, tri_v0=cs.tri_v0 * 0.95,
                             tri_v1=cs.tri_v1 * 0.95,
                             tri_v2=cs.tri_v2 * 0.95)
    with torch.no_grad():
        return render_depth(s2, rays)


def group_rank(rank, world, store, inputs, out):
    """One rank of the 8-rank group (started by torch.multiprocessing)."""
    import torch.distributed as dist

    import embree_tpu_torch as pt
    from embree_tpu_torch.parallel import render as prender

    _join(rank, world, store)
    try:
        inp = dict(np.load(inputs))
        res = {}
        cs = _scene(inp)
        mesh = prender.make_mesh()
        res["mesh"] = np.array([mesh.size, mesh.rank])
        rays = _rays(inp, "rays0")
        local = prender.shard_rays(rays, mesh)
        scene_r = prender.replicate(cs, mesh)
        for backend in ("jnp", "pallas"):
            h = pt.intersect(scene_r, local, backend=backend)
            for f in ("t", "u", "v", "ng", "prim_id", "geom_id"):
                res[f"hits_{backend}/{f}"] = getattr(h, f).numpy()
        res["image"] = prender.render_image_sharded(
            cs, _camera(inp, "cam"), 64, 64, mesh).numpy()
        for name, fn in (("strong", prender.measure_scaling),
                         ("weak", prender.measure_scaling_weak)):
            table = fn(cs, _rays(inp, "rays1"), [1, 8], iters=1)
            res[f"scaling_{name}"] = np.array(
                [[n] + list(table[n].values()) for n in (1, 8)])
        # the gradient of the sum over all ranks' rays: each rank's share,
        # summed (the psum XLA inserts under jit with sharded rays)
        v0 = cs.tri_v0.clone().requires_grad_()
        g, = torch.autograd.grad(sum_t_loss(cs, prender.shard_rays(
            _rays(inp, "rays2"), mesh))(v0), [v0])
        dist.all_reduce(g, group=mesh.group)
        res["grad"] = g.numpy()
        res.update(_train(cs, inp, mesh))
        sub = prender.make_mesh(4)
        res["sub"] = np.array([sub.size, sub.rank])
        try:
            prender.shard_rays(_rays(inp, "rays_odd"), mesh)
            res["odd_error"] = np.array("none")
        except ValueError as e:
            res["odd_error"] = np.array(type(e).__name__)
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _train(cs, inp, mesh):
    from embree_tpu_torch.parallel import mesh as pmesh
    rays = _rays(inp, "rays2")
    # the JAX package's target (the same inputs for both steps)
    target = torch.from_numpy(inp["target/rays2"])
    n = rays.shape[0] // mesh.size
    lo = mesh.rank * n
    step = pmesh.make_train_step(mesh, lr=1e-2)
    new, loss = step(cs, pmesh.shard_rays(rays, mesh), target[lo:lo + n])
    return {"train/loss": loss.numpy(), "train/v0": new.tri_v0.numpy(),
            "train/v1": new.tri_v1.numpy(), "train/v2": new.tri_v2.numpy()}


def multihost(rank, world, store, inputs, out):
    """One of the separately started processes of the multi-host render:
    tests/test_multihost.py:27-66 on the port."""
    import torch.distributed as dist

    from embree_tpu_torch.parallel.render import (make_mesh,
                                                  render_image_sharded)
    _join(rank, world, store)
    try:
        inp = dict(np.load(inputs))
        img = render_image_sharded(_scene(inp, "quad"), _camera(inp, "mh"),
                                   32, 32, make_mesh())
        np.save(os.path.join(out, f"multihost{rank}.npy"), img.numpy())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    rank, world = int(sys.argv[2]), int(sys.argv[3])
    {"multihost": multihost}[sys.argv[1]](rank, world, *sys.argv[4:])
