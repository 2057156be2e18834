"""Queries beyond ray casting: point queries, collision, statistics.

Port of embree_tpu/query.py (API parity: rtcPointQuery, rtcCollide
rtcore_scene.h:346, the BVH statistics of kernels/bvh/bvh_statistics.cpp
returned as a dict). Everything runs in torch ops on the scene's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .accel.bvh import INVALID_NODE, decode_leaf, is_leaf, sah_cost
from .accel.collide import CollisionResult, collide
from .accel.point_query import PointQueryResult, point_query
from .core.math import fmax, fmin, sqrt_rn
from .geometry import KIND_TRIANGLE
from .scene import CommittedScene

# the JAX package's CommittedScene array fields, in its order
# (embree_tpu/scene.py:180, dataclass field order): scene_stats reports
# memory by these names, and utils/checkpoint.py writes its leaves in it
ARRAY_FIELDS = (
    "bvh", "prim_kind", "prim_geom", "prim_local", "prim_inst", "prim_data",
    "prim_mask", "prim_filter",
    "tri_v0", "tri_v1", "tri_v2", "tri_v0b", "tri_v1b", "tri_v2b",
    "quad_v", "quad_vb", "quad_uvm",
    "pnt_c", "pnt_r", "pnt_n", "pnt_cb", "pnt_rb", "pnt_nb",
    "line_p0", "line_r0", "line_p1", "line_r1", "line_u0", "line_u1",
    "line_fl", "line_pL", "line_rL", "line_pR", "line_rR",
    "line_p0b", "line_r0b", "line_p1b", "line_r1b",
    "line_pLb", "line_rLb", "line_pRb", "line_rRb",
    "curve_cp", "curve_cpb", "curve_n", "curve_nb",
    "user_lo", "user_up", "packed", "prim_t0", "prim_t1", "curve_prate",
    "leaf_obb_rot", "leaf_obb_lo", "leaf_obb_up")


def _tri_rows(scene: CommittedScene):
    """Each merged prim's triangle vertices (rows of other kinds read the
    first triangle and are masked out by the caller)."""
    didx = scene.prim_data.clamp(0, max(scene.tri_v0.shape[0] - 1, 0))
    return scene.tri_v0[didx], scene.tri_v1[didx], scene.tri_v2[didx]


def _points(points, device):
    return torch.as_tensor(points, dtype=torch.float32, device=device)


def point_query_scene(scene, points, radius) -> PointQueryResult:
    """The closest point on the scene's triangles within ``radius``
    (rtcPointQuery analog), for (Q, 3) points.

    A flattened scene holds instanced triangles in world space, so the
    query covers them directly. A TwoLevelScene is queried per instance in
    object space with the similarity-scaled radius (the reference's
    documented similarity-transform constraint), the results mapped back
    through the instance transform; its ``steps`` add up the instances'."""
    if not isinstance(scene, CommittedScene):      # TwoLevelScene
        return _point_query_two_level(scene, points, radius)
    return _point_query_child(scene, _points(points, scene.device), radius)


def _point_query_child(scene: CommittedScene, points, radius):
    v0, v1, v2 = _tri_rows(scene)
    return point_query(scene.bvh, v0, v1, v2,
                       scene.prim_kind == KIND_TRIANGLE, points, radius)


def _xf(m, p):
    """p (Q, 3) under the (3, 4) affine m, each row a 3-term sum in index
    order."""
    return (p[:, 0:1] * m[:, 0] + p[:, 1:2] * m[:, 1]
            + p[:, 2:3] * m[:, 2]) + m[:, 3]


def _point_query_two_level(tl, points, radius) -> PointQueryResult:
    """The closest point through the TLAS: one object-space query per
    instance (embree_tpu/query.py:44-76)."""
    points = _points(points, tl.device)
    Q = points.shape[0]
    radius = torch.broadcast_to(torch.as_tensor(
        radius, dtype=torch.float32, device=points.device), (Q,))
    dist = torch.full((Q,), float("inf"), device=points.device)
    point = torch.zeros((Q, 3), device=points.device)
    prim = torch.full((Q,), -1, dtype=torch.int32, device=points.device)
    best_d = radius
    steps = 0
    for i in range(tl.num_instances):
        child = tl.children[tl.inst_child[i]]
        w2l = tl.inst_w2l[i]
        l2w = tl.inst_l2w[i, 0]                     # the t = 0 transform
        s = torch.linalg.det(l2w[:, :3]).abs() ** (1.0 / 3.0)
        r = _point_query_child(child, _xf(w2l, points),
                               best_d / torch.clamp(s, min=1e-20))
        steps += r.steps
        wp = _xf(l2w, r.point)
        e = wp - points
        wd = sqrt_rn(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]
                     + e[:, 2] * e[:, 2])
        better = (r.prim >= 0) & (wd < best_d)
        dist = torch.where(better, wd, dist)
        point = torch.where(better[:, None], wp, point)
        prim = torch.where(better, r.prim, prim)
        best_d = torch.where(better, wd, best_d)
    return PointQueryResult(dist=dist, point=point, prim=prim, steps=steps)


def collide_scenes(scene_a: CommittedScene,
                   scene_b: CommittedScene) -> CollisionResult:
    """All overlapping triangle pairs between two committed scenes
    (rtcCollide analog; the collide cloth tutorial's workload). The bounds
    of A's triangles take the ordered min and max (core/math.py), so a
    -0.0 vertex gives XLA's box bits."""
    a0, a1, a2 = _tri_rows(scene_a)
    a_lo = fmin(fmin(a0, a1), a2)
    a_up = fmax(fmax(a0, a1), a2)
    b0, b1, b2 = _tri_rows(scene_b)
    return collide(scene_b.bvh, b0, b1, b2, a_lo, a_up, a0, a1, a2)


def _nbytes(v):
    """Bytes of every tensor of a field (the BVH's four, the packed
    records' three)."""
    if torch.is_tensor(v):
        return v.numel() * v.element_size()
    if dataclasses.is_dataclass(v):
        return sum(_nbytes(getattr(v, f.name)) for f in dataclasses.fields(v))
    return 0


def scene_stats(scene: CommittedScene) -> Dict:
    """BVH and memory statistics (bvh_statistics / Scene::printStatistics
    analogs). ``memory_by_field`` counts each field's tensors in the JAX
    package's field order; the port's dtypes and packed layout are its own,
    so the byte counts are the port's."""
    bvh = scene.bvh
    child = bvh.node_child.cpu().numpy()
    leaf_mask = np.asarray(is_leaf(child))
    valid = child != int(INVALID_NODE)
    _, counts = decode_leaf(child)
    counts = np.asarray(counts)
    n_leaf_refs = int(leaf_mask.sum())
    prims_in_leaves = int(counts[leaf_mask].sum())
    mem = {}
    total = 0
    for f in ARRAY_FIELDS:
        v = getattr(scene, f)
        if v is None:
            continue
        nb = _nbytes(v)
        mem[f] = nb
        total += nb
    kinds, kc = np.unique(scene.prim_kind.cpu().numpy(), return_counts=True)
    packed = scene.packed
    return {
        "num_prims": int(scene.num_prims),
        "prims_by_kind": {int(k): int(c) for k, c in zip(kinds, kc)},
        "bvh_nodes": int(child.shape[0]),
        "bvh_width": int(child.shape[1]),
        "internal_child_refs": int((valid & ~leaf_mask).sum()),
        "leaf_refs": n_leaf_refs,
        "prims_in_leaves": prims_in_leaves,
        "avg_leaf_size": prims_in_leaves / max(n_leaf_refs, 1),
        "sah_cost": float(sah_cost(bvh)),
        "memory_bytes": total,
        "memory_by_field": mem,
        # 128-record tiles of the JAX package's unified table
        "packed_tiles": None if packed is None else int(
            -(-packed.nodes.shape[0] // 128)
            + -(-packed.leaves.shape[0] // 128)),
    }
