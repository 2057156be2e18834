"""Geometry types, the subset the port covers: triangles, quads, points and
line segments.

Port of embree_tpu/geometry.py:24-35 (kind tags) and :109-185
(RTC_GEOMETRY_TYPE_TRIANGLE, QUAD, SPHERE/DISC/ORIENTED_DISC_POINT and
ROUND/FLAT_LINEAR_CURVE; role parity with kernels/common/scene_*.h).
Buffers stay on the host (numpy or tensors); ``Scene.commit`` reads them.
Vertex buffers with a leading time axis (motion blur) and intersection
filters are accepted here, as in the JAX package, and refused by ``commit``
until the port covers them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

# primitive kind tags in the merged prim table (embree_tpu/geometry.py:24-35)
KIND_TRIANGLE = 0
KIND_QUAD = 1
KIND_SPHERE = 2
KIND_DISC = 3
KIND_ORIENTED_DISC = 4
KIND_ROUND_LINE = 5
KIND_FLAT_LINE = 6
KIND_USER = 7
KIND_CURVE_FLAT = 8
KIND_CURVE_ROUND = 9
KIND_CURVE_ORIENTED = 10
KIND_CURVE_DISTANCE = 11

FilterFn = Callable  # (org, dir, t, u, v, ng, prim_id, geom_id) -> bool mask


@dataclasses.dataclass
class GeometryBase:
    mask: int = dataclasses.field(default=0xFFFFFFFF, init=False)
    enabled: bool = dataclasses.field(default=True, init=False)
    filter: Optional[FilterFn] = dataclasses.field(default=None, init=False)


@dataclasses.dataclass
class TriangleGeometry:
    """RTC_GEOMETRY_TYPE_TRIANGLE."""
    vertices: object             # (n_verts, 3) or (2, n_verts, 3) for motion
    indices: object              # (n_tris, 3) int
    mask: int = 0xFFFFFFFF
    enabled: bool = True
    filter: Optional[FilterFn] = None
    time_range: tuple = (0.0, 1.0)

    @property
    def num_prims(self):
        return np.asarray(self.indices).shape[0]


@dataclasses.dataclass
class QuadGeometry:
    """RTC_GEOMETRY_TYPE_QUAD."""
    vertices: object             # (n_verts, 3) or (S, n_verts, 3) for motion
    indices: object              # (n_quads, 4) int
    mask: int = 0xFFFFFFFF
    enabled: bool = True
    filter: Optional[FilterFn] = None
    time_range: tuple = (0.0, 1.0)

    @property
    def num_prims(self):
        return np.asarray(self.indices).shape[0]


@dataclasses.dataclass
class PointGeometry:
    """RTC_GEOMETRY_TYPE_{SPHERE,DISC,ORIENTED_DISC}_POINT."""
    points: object               # (n, 4) xyz+radius, or (S, n, 4)
    kind: str = "sphere"         # sphere | disc | oriented_disc
    normals: Optional[object] = None   # (n, 3) for oriented discs
    mask: int = 0xFFFFFFFF
    enabled: bool = True
    filter: Optional[FilterFn] = None
    time_range: tuple = (0.0, 1.0)

    @property
    def num_prims(self):
        a = np.asarray(self.points)
        return a.shape[1] if a.ndim == 3 else a.shape[0]


@dataclasses.dataclass
class LineSegmentsGeometry:
    """RTC_GEOMETRY_TYPE_{ROUND,FLAT}_LINEAR_CURVE line segments."""
    vertices: object             # (n_verts, 4) xyz+radius, or (S, n_verts, 4)
    indices: object              # (n_segs,) int: segment i joins vertex
    #                              idx[i] and idx[i] + 1
    kind: str = "round"          # round | flat
    mask: int = 0xFFFFFFFF
    enabled: bool = True
    filter: Optional[FilterFn] = None
    time_range: tuple = (0.0, 1.0)

    @property
    def num_prims(self):
        return np.asarray(self.indices).shape[0]
