"""Data-parallel training over the ranks' ray blocks: the depth loss and
its SGD step on vertex positions.

Port of embree_tpu/parallel/mesh.py. The mesh, the ray sharding and the
replicated scene are ``render.py``'s (re-exported here). The JAX step runs
under jit with sharded rays and XLA inserts the psum of the vertex
gradient; here each rank differentiates its own block's share of the
global mean loss and the gradients are summed with ``all_reduce``, so every
rank applies the gradient of the global mean.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.ray import RayBatch
from ..scene import CommittedScene, intersect
from .render import Mesh, make_mesh, replicate, shard_rays

__all__ = ["Mesh", "make_mesh", "shard_rays", "replicate", "render_depth",
           "depth_loss", "make_train_step"]


def render_depth(scene: CommittedScene, rays: RayBatch) -> torch.Tensor:
    """Flagship differentiable forward: per-ray inverse depth (0 for a
    miss)."""
    hits = intersect(scene, rays)
    return torch.where(hits.valid, 1.0 / torch.clamp(hits.t, min=1e-6), 0.0)


def _squared_error(tri_v0, tri_v1, tri_v2, scene, rays, target):
    s = dataclasses.replace(scene, tri_v0=tri_v0, tri_v1=tri_v1,
                            tri_v2=tri_v2)
    return ((render_depth(s, rays) - target) ** 2).sum()


def depth_loss(tri_v0, tri_v1, tri_v2, scene: CommittedScene,
               rays: RayBatch, target: torch.Tensor) -> torch.Tensor:
    """MSE between rendered inverse depth and a target; differentiable
    w.r.t. the vertex tables (the gradient flows through the
    re-intersection of each ray's selected triangle). The mean is the sum
    over the rays divided by their count, as jnp.mean reduces (a tensor
    divisor: CUDA divides by a Python number through its reciprocal)."""
    return _squared_error(tri_v0, tri_v1, tri_v2, scene, rays, target) \
        / _count(target)


def _count(target):
    return torch.tensor(target.numel(), dtype=torch.int64,
                        device=target.device)


def make_train_step(mesh: Mesh, lr: float = 1e-2, axis: str = "rays"):
    """One SGD step on the triangle vertex tables from this rank's rays.

    ``step(scene, rays, target)`` takes this rank's block of the rays and
    of the target, and returns the updated scene and the global mean loss
    (before the step), the same on every rank of the mesh."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")

    def all_sum(x):
        if mesh.group is not None:
            dist.all_reduce(x, group=mesh.group)
        return x

    def step(scene: CommittedScene, rays: RayBatch, target):
        count = all_sum(_count(target))
        vs = [v.detach().requires_grad_()
              for v in (scene.tri_v0, scene.tri_v1, scene.tri_v2)]
        sq = _squared_error(*vs, scene, rays, target)
        grads = torch.autograd.grad(sq / count, vs)
        grads = [all_sum(g.contiguous()) for g in grads]
        loss = all_sum(sq.detach().clone()) / count
        new = dataclasses.replace(
            scene, tri_v0=scene.tri_v0 - lr * grads[0],
            tri_v1=scene.tri_v1 - lr * grads[1],
            tri_v2=scene.tri_v2 - lr * grads[2])
        return new, loss

    return step
