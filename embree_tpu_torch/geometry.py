"""Geometry types: triangles, quads, points, line
segments, cubic curves, grids, subdivision surfaces, user geometry and
instances, static or moving.

Port of embree_tpu/geometry.py:24-35 (kind tags), :40-106 (time steps) and
:109-387 (RTC_GEOMETRY_TYPE_TRIANGLE, QUAD, SPHERE/DISC/ORIENTED_DISC_POINT,
ROUND/FLAT_LINEAR_CURVE, the *_BEZIER/BSPLINE/HERMITE/CATMULL_ROM_CURVE
types, USER, INSTANCE, INSTANCE_ARRAY, GRID and SUBDIVISION; role parity with
kernels/common/scene_*.h).
Buffers stay on the host (numpy or tensors); ``Scene.commit`` reads them.
A buffer with a leading time axis, (S, n, C) with 2 <= S <= 129, declares
S-step linear motion blur over the geometry's ``time_range``
(rtcSetGeometryTimeStepCount / rtcSetGeometryTimeRange); traversal lerps by
the ray's time. An intersection filter and a user geometry's intersect
function are called with torch tensors on the scene's device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .ops.curve import BASIS_BEZIER, BASIS_LINEAR

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

# (org, dir, t, u, v, ng, prim_id, geom_id) -> bool mask, or with a leading
# context ("intersect" or "occluded") -> (bool mask, updates of u/v/ng)
FilterFn = Callable

MAX_TIME_STEPS = 129   # reference RTC_MAX_TIME_STEP_COUNT (rtcore_common.h:54)


def _sample_steps(arr, t, time_range=(0.0, 1.0)):
    """Evaluate an (S, n, C) piecewise-linear motion buffer at global time
    t (the itime/ftime split of the reference's Geometry::timeSegment,
    kernels/common/default.h:223). The buffer's knots span time_range;
    outside it the boundary segment is linearly extrapolated: itime is
    clamped, ftime is not. 2-D (static) buffers pass through."""
    a = np.asarray(arr, np.float32)
    if a.ndim == 2:
        return a
    S = a.shape[0]
    r0, r1 = float(time_range[0]), float(time_range[1])
    x = (float(t) - r0) / (r1 - r0) * (S - 1)
    k = min(max(int(np.floor(x)), 0), S - 2)
    w = np.float32(x - k)
    if w == 0.0:
        return a[k]
    return ((1.0 - w) * a[k] + w * a[k + 1]).astype(np.float32)


def _split_timesteps(arr, name, window=(0.0, 1.0), time_range=(0.0, 1.0)):
    """Accept (n, C) static or (S, n, C) S-step motion buffers and return
    (buffer at window[0], buffer at window[1], moving). Multi-step buffers
    are exact because the scene merger first splits prims at every interior
    knot time (time-sliced replication, the MSMBlur analog), so each window
    lies within one linear segment; extrapolated endpoints keep that true
    for a sub-[0,1] time_range."""
    a = np.asarray(arr, np.float32)
    if a.ndim == 3:
        S = a.shape[0]
        if not 2 <= S <= MAX_TIME_STEPS:
            raise ValueError(f"{name}: motion buffers need 2..{MAX_TIME_STEPS}"
                             f" time steps, got {S}")
        return (_sample_steps(a, window[0], time_range),
                _sample_steps(a, window[1], time_range), True)
    return a, a, False


def motion_knots(arrays, window, time_range=(0.0, 1.0)):
    """Interior knot times of S-step motion buffers strictly inside the
    window: the prim replication boundaries of time slicing. Knot k of an
    S-step buffer sits at time_range[0] + (time_range[1]-time_range[0]) *
    k/(S-1) (Geometry::timeStep, kernels/common/geometry.h:341)."""
    ks = set()
    r0, r1 = float(time_range[0]), float(time_range[1])
    for a in arrays:
        if a is None:
            continue
        a = np.asarray(a)
        if a.ndim == 3 and a.shape[0] > 2:
            S = a.shape[0]
            for k in range(1, S - 1):
                t = r0 + (r1 - r0) * k / (S - 1)
                if window[0] < t < window[1]:
                    ks.add(t)
    return sorted(ks)


@dataclasses.dataclass
class GeometryBase:
    mask: int = dataclasses.field(default=0xFFFFFFFF, init=False)
    enabled: bool = dataclasses.field(default=True, init=False)
    filter: Optional[FilterFn] = dataclasses.field(default=None, init=False)


@dataclasses.dataclass
class TriangleGeometry:
    """RTC_GEOMETRY_TYPE_TRIANGLE."""
    vertices: object             # (n_verts, 3) or (S, n_verts, 3) for motion
    indices: object              # (n_tris, 3) int
    mask: int = 0xFFFFFFFF
    enabled: bool = True
    filter: Optional[FilterFn] = None
    # rtcSetGeometryTimeRange (rtcore_geometry.h:151): the geometry exists
    # only within it, and motion buffers span it instead of [0,1]
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
    normals: Optional[object] = None   # (n, 3) or (S, n, 3), oriented discs
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


@dataclasses.dataclass
class CurveGeometry:
    """RTC_GEOMETRY_TYPE_*_{BEZIER,BSPLINE,HERMITE,CATMULL_ROM}_CURVE and
    the linear basis.

    algorithm="native" keeps one prim per curve (the reference's per-curve
    intersectors: the ribbon for flat curves); algorithm="tessellate", or
    the linear basis, lowers each curve into ``tessellation_rate`` line
    segments at commit. tessellation_rate mirrors
    rtcSetGeometryTessellationRate (reference default 4): the ribbon's
    segment count and the tessellation's."""
    vertices: object             # (n_cp, 4) xyz+radius, or (S, n_cp, 4)
    indices: object              # (n_curves,) int first-control-point index
    basis: str = BASIS_BEZIER
    kind: str = "round"          # round | flat | oriented
    tangents: Optional[object] = None  # (n_cp, 4) hermite tangents
    normals: Optional[object] = None   # (n_cp, 3) oriented-curve normals
    normal_derivatives: Optional[object] = None  # (n_cp, 3) hermite
    tessellation_rate: int = 4
    algorithm: str = "native"    # native | tessellate (| distance)
    mask: int = 0xFFFFFFFF
    enabled: bool = True
    filter: Optional[FilterFn] = None
    time_range: tuple = (0.0, 1.0)

    @property
    def num_prims(self):
        n = np.asarray(self.indices).shape[0]
        if self.algorithm == "native" and self.basis != BASIS_LINEAR:
            return n
        return n * self.tessellation_rate


@dataclasses.dataclass
class UserGeometry:
    """RTC_GEOMETRY_TYPE_USER: user bounds and an intersect function.

    The reference's RTCIntersectFunctionN callback (object_intersector.h)
    becomes a function of torch tensors, called on candidate prims during
    traversal:
      intersect_fn(prim_data, org, dir, tnear, tfar) -> (hit, t, u, v, ng)
    ``prim_data`` is the prim's row in the scene's table of user prims, as
    in the JAX package."""
    bounds_lower: object         # (n, 3)
    bounds_upper: object         # (n, 3)
    intersect_fn: Callable = None
    mask: int = 0xFFFFFFFF
    enabled: bool = True
    filter: Optional[FilterFn] = None
    time_range: tuple = (0.0, 1.0)

    @property
    def num_prims(self):
        return np.asarray(self.bounds_lower).shape[0]


@dataclasses.dataclass
class InstanceGeometry:
    """RTC_GEOMETRY_TYPE_INSTANCE: a scene instanced under a transform.

    Below ``scene.TWO_LEVEL_AUTO`` instances (or with
    ``commit(two_level=False)``) commit flattens the instanced prims into
    the top scene's one table in world space; hits report the instanced
    scene's geometry id and this instance's id. From that many on (or with
    ``two_level=True``) commit builds a TLAS over instance bounds above one
    shared BLAS per child scene (``tlas.py``).

    transform: a (3, 4) affine; an (S, 3, 4) stack of S motion steps (each
    segment a linear matrix lerp); or a sequence of
    ``core.math.QuaternionDecomposition`` for quaternion motion blur,
    resampled onto a finer knot grid at commit (instance_transform_steps).
    """
    scene: object                # a Scene (or, two-level, a CommittedScene)
    transform: object            # see the class docstring
    mask: int = 0xFFFFFFFF
    enabled: bool = True
    # rtcSetGeometryTimeRange on the instance: its transform knots span
    # [start, end], extrapolated linearly outside
    time_range: tuple = (0.0, 1.0)

    @property
    def num_prims(self):
        return 0  # resolved at commit


QUAT_RESAMPLE = 8   # sub-knots per quaternion motion segment


def instance_transform_steps(g):
    """An instance's transform as a (3, 4) static affine or an (S, 3, 4)
    stack of knot affines (embree_tpu/geometry.py:282-314).

    Quaternion decompositions are slerp-evaluated at QUAT_RESAMPLE
    sub-knots per segment (halved until the knots fit MAX_TIME_STEPS) and
    lerped linearly in between, a piecewise-linear approximation of the
    rotation that rides the time-sliced machinery of multi-step motion."""
    from .core.math import qd_interpolate
    tr = g.transform
    if isinstance(tr, (list, tuple)) and len(tr) and hasattr(tr[0], "quat"):
        L = len(tr)
        if L == 1:
            return np.asarray(tr[0].to_affine(), np.float32)
        q = QUAT_RESAMPLE
        while (L - 1) * q + 1 > MAX_TIME_STEPS and q > 1:
            q //= 2
        mats = [np.asarray(qd_interpolate(tr[seg], tr[seg + 1],
                                          j / q).to_affine(), np.float32)
                for seg in range(L - 1) for j in range(q)]
        mats.append(np.asarray(tr[-1].to_affine(), np.float32))
        return np.stack(mats, axis=0)
    a = np.asarray(tr, np.float32)
    if a.ndim not in (2, 3) or a.shape[-2:] != (3, 4):
        raise ValueError(f"transform must be (3, 4) or (S, 3, 4), got "
                         f"{a.shape}")
    if a.ndim == 3 and not 2 <= a.shape[0] <= MAX_TIME_STEPS:
        raise ValueError(f"transform motion needs 2..{MAX_TIME_STEPS} "
                         f"steps, got {a.shape[0]}")
    return a


@dataclasses.dataclass
class InstanceArrayGeometry:
    """RTC_GEOMETRY_TYPE_INSTANCE_ARRAY: one scene under N static
    transforms; each counts as an instance, all report this geometry's
    id."""
    scene: object
    transforms: object           # (N, 3, 4)
    mask: int = 0xFFFFFFFF
    enabled: bool = True
    time_range: tuple = (0.0, 1.0)

    @property
    def num_prims(self):
        return 0


@dataclasses.dataclass
class GridGeometry:
    """RTC_GEOMETRY_TYPE_GRID (rtcore_geometry.h:390 RTCGrid): regular
    grids of vertices, split into quads at commit. prim id = grid index;
    u/v span the whole grid (embree_tpu/geometry.py:331-349)."""
    vertices: object             # (n_verts, 3) or (S, n_verts, 3)
    grids: object                # (n_grids, 4) int: startVert, stride,
    #                              width, height
    mask: int = 0xFFFFFFFF
    enabled: bool = True
    filter: Optional[FilterFn] = None
    time_range: tuple = (0.0, 1.0)

    @property
    def num_prims(self):
        g = np.asarray(self.grids)
        return int(((g[:, 2] - 1) * (g[:, 3] - 1)).sum())


@dataclasses.dataclass
class SubdivisionGeometry:
    """RTC_GEOMETRY_TYPE_SUBDIVISION: a Catmull-Clark surface, uniformly
    subdivided ``levels`` times at commit (ops/subdiv.py) and pushed onto
    its limit surface; prim id = base face (embree_tpu/geometry.py:352-387).
    Creases: {(v0, v1): weight}; vertex creases: {vertex: weight}, inf
    pins a corner; ``holes`` (base-face ids) are removed before refinement;
    ``position_mode`` is None, "pin_corners", "pin_boundary", "pin_all" or
    "no_boundary" (RTC_SUBDIVISION_MODE)."""
    vertices: object             # (n_verts, 3) or (S, n_verts, 3) motion
    face_counts: object          # (F,) verts per face
    indices: object              # flat indices
    levels: int = 2
    creases: Optional[dict] = None
    vertex_creases: Optional[dict] = None
    boundary_interpolation: bool = True
    holes: Optional[object] = None         # (H,) int base-face indices
    texcoords: Optional[object] = None     # (Nt, 2)
    texcoord_indices: Optional[object] = None  # flat, parallel to indices
    texcoord_mode: Optional[str] = None
    position_mode: Optional[str] = None
    mask: int = 0xFFFFFFFF
    enabled: bool = True
    filter: Optional[FilterFn] = None
    time_range: tuple = (0.0, 1.0)

    @property
    def num_prims(self):
        # 4**(levels-1) per quad face, as the JAX package counts; commit
        # makes 4**levels (ROADMAP.md, logged differences)
        F = np.asarray(self.face_counts)
        per = np.where(F == 4, 4 ** (self.levels - 1) if self.levels else 1,
                       F * 4 ** max(self.levels - 1, 0))
        return int(per.sum())
