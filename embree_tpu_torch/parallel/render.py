"""Distributed rendering: rays sharded over the ranks of a process group.

Port of embree_tpu/parallel/render.py. The JAX package puts one
``jax.sharding.Mesh`` over its devices, shards the rays along the "rays"
axis, replicates the committed scene and lets XLA insert the collectives.
Here each rank of a ``torch.distributed`` process group is one device of
the mesh: it traces the contiguous block of the flat rays that
``PartitionSpec("rays")`` gives device ``i`` (``shard_rays``), against its
own copy of the committed scene (``replicate``), and the image blocks are
gathered with ``all_gather`` so that every rank holds the full image, as
the JAX package's multi-host test reads it with ``process_allgather``.

NCCL serves CUDA tensors, one card a rank; gloo serves ranks on the CPU and
is used only when the caller asks for the CPU. Every rank builds and
commits the same scene (the per-host deterministic build of the JAX
package's ``_global_put``): nothing of the scene crosses between ranks.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..core.ray import RayBatch, resolve_device
from ..models.camera import Camera
from ..scene import CommittedScene, intersect


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: Optional[str] = None) -> torch.device:
    """Join this process to the process group (jax.distributed.initialize's
    role). NCCL on CUDA, the default; gloo only with ``device="cpu"``.

    With no ``coordinator`` the group comes from the ``torchrun``
    environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE). Otherwise
    ``coordinator`` is an init method (``tcp://host:port`` or
    ``file:///path``; a bare ``host:port`` means tcp) and
    ``num_processes`` and ``process_id`` are required. Returns this rank's
    device."""
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = process_id if process_id is not None else 0
        dev = torch.device("cuda", int(local) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw = dict(backend="nccl", device_id=dev)
    elif dev.type == "cpu":
        kw = dict(backend="gloo")
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        kw.update(init_method=coordinator if "://" in coordinator
                  else "tcp://" + coordinator,
                  world_size=num_processes, rank=process_id)
    dist.init_process_group(**kw)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The first ``size`` ranks of the process group along one axis.

    ``group`` is None for a mesh of one without a process group. ``rank``
    is this process's index in the mesh, -1 when it is not a member."""
    group: Optional[object]
    size: int
    rank: int
    device: torch.device
    axis: str = "rays"

    @property
    def member(self) -> bool:
        return self.rank >= 0


def _rank_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None, axis: str = "rays",
              device: Optional[str] = None) -> Mesh:
    """A mesh over the first ``n_devices`` ranks (all by default).

    Every rank of the group must call it: a mesh smaller than the group is
    a new subgroup (``dist.new_group``), which is a collective of the whole
    group. Without a process group it is a mesh of one on ``device``
    (CUDA unless the caller asks for the CPU)."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} ranks needs a process "
                             "group: call init_distributed first")
        return Mesh(None, 1, 0, resolve_device(device), axis)
    dev = _rank_device()
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"this rank's device is {dev}, not {device}")
    world = dist.get_world_size()
    n = n_devices or world
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    group = dist.group.WORLD if n == world \
        else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    return Mesh(group, n, rank if rank < n else -1, dev, axis)


def _move(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _move(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (list, tuple)):
        return type(x)(_move(v, device) for v in x)
    return x


def replicate(tree, mesh: Mesh):
    """The committed scene (or any dataclass of tensors) on this rank's
    device. No transfer between ranks: every rank commits the same
    scene."""
    return _move(tree, mesh.device)


def shard_rays(rays: RayBatch, mesh: Mesh, axis: str = "rays") -> RayBatch:
    """This rank's contiguous block of a flat RayBatch, in rank order, on
    its device: the layout ``PartitionSpec(axis)`` gives device ``i``. A
    ray count the mesh does not divide raises, as ``jax.device_put`` does
    for that sharding."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    if len(rays.shape) != 1:
        raise ValueError(f"shard_rays takes a flat RayBatch, got shape "
                         f"{rays.shape}")
    if not mesh.member:
        raise ValueError("this rank is not in the mesh")
    n = rays.shape[0]
    if n % mesh.size:
        raise ValueError(f"the sharding over {mesh.size} ranks needs a ray "
                         f"count divisible by {mesh.size}, got {n}")
    b = n // mesh.size
    lo = mesh.rank * b
    return RayBatch(*(getattr(rays, f.name)[lo:lo + b].to(mesh.device)
                      for f in dataclasses.fields(RayBatch)))


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated in rank order, on every
    rank."""
    if mesh.group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def render_image_sharded(scene: CommittedScene, camera: Camera,
                         height: int, width: int, mesh: Mesh,
                         shader: str = "eyelight", backend=None):
    """The image's flat rays sharded over the mesh: each rank traces and
    shades its block, and every rank returns the full (H, W, 3) image."""
    from ..models.viewer import SHADERS

    rays = camera.rays(height, width, device=mesh.device)
    local = shard_rays(rays.reshape(height * width), mesh)
    scene_r = replicate(scene, mesh)
    hits = intersect(scene_r, local, backend=backend)
    col = SHADERS[shader](scene_r, local, hits)
    return _all_gather(col, mesh).reshape(height, width, 3)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _slowest_seconds(fn, mesh: Mesh) -> float:
    """One run of ``fn`` on every rank of the mesh, started after a
    barrier; the slowest rank's seconds (CUDA events on the card, the host
    clock on the CPU)."""
    _synchronize(mesh.device)
    if mesh.group is not None:
        dist.barrier(group=mesh.group)
    if mesh.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        secs = start.elapsed_time(stop) / 1e3
    else:
        t0 = time.perf_counter()
        fn()
        secs = time.perf_counter() - t0
    if mesh.group is None:
        return secs
    t = torch.tensor([secs], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t)


def _from_rank0(value: float, device) -> float:
    """Rank 0's value on every rank of the group (ranks outside a mesh
    return what its members measured)."""
    if not dist.is_initialized():
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.broadcast(t, src=0)
    return float(t)


def _rates(scene, rays_for, device_counts, backend, iters, device):
    """Rays/s at each mesh size: ``rays_for(mesh)`` gives a member's rays
    and the total the mesh traces."""
    results = {}
    for n in device_counts:
        mesh = make_mesh(n, device=device)
        rate = 0.0
        if mesh.member:
            rays, total = rays_for(mesh)
            scene_r = replicate(scene, mesh)

            def run():
                return intersect(scene_r, rays, backend=backend).t

            run()
            rate = total / min(_slowest_seconds(run, mesh)
                               for _ in range(iters))
        results[n] = _from_rank0(rate, mesh.device)
    return results


def measure_scaling(scene: CommittedScene, rays_flat: RayBatch,
                    device_counts, backend=None, iters: int = 3):
    """Rays/s at several mesh sizes (the first n ranks, a fixed total of
    rays sharded over them) and the scaling efficiency against the
    smallest mesh. Every rank of the group calls it and gets the same
    table."""
    n_rays = rays_flat.shape[0]
    results = _rates(scene, lambda m: (shard_rays(rays_flat, m), n_rays),
                     device_counts, backend, iters, scene.device)
    base = results[min(results)] / min(results)
    return {n: dict(rays_per_s=v, efficiency=v / (n * base))
            for n, v in results.items()}


def measure_scaling_weak(scene: CommittedScene, rays_flat: RayBatch,
                         device_counts, backend=None, iters: int = 3):
    """Weak scaling: every rank of a mesh of n traces the whole
    ``rays_flat`` (n copies of the batch sharded over n ranks), so the
    total is n times the batch. ``flat_retention`` is rays/s against the
    smallest mesh's."""
    per = rays_flat.shape[0]

    def rays_for(mesh):
        return (RayBatch(*(getattr(rays_flat, f.name).to(mesh.device)
                           for f in dataclasses.fields(RayBatch))),
                per * mesh.size)

    results = _rates(scene, rays_for, device_counts, backend, iters,
                     scene.device)
    t1 = results[min(results)]
    return {n: dict(rays_per_s=v, flat_retention=v / t1)
            for n, v in results.items()}
