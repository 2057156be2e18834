"""embree_tpu_torch — the PyTorch/CUDA port of embree_tpu.

The port runs on an NVIDIA H100: plain tensor code is PyTorch, and every
Pallas TPU kernel of the JAX package becomes a kernel written by hand for
Hopper (``csrc/``, built at first use by ``_build.py``). Module names mirror
``embree_tpu`` so each counterpart is easy to find. Entry points run on CUDA
unless the caller passes ``device="cpu"``; on the CPU every kernel is replaced
by its plain PyTorch version.

The port covers scenes of triangles, quads, points (sphere, disc, oriented
disc), line segments (round, flat), cubic curves of every basis (flat,
round, oriented and distance native curves; tessellated curves as line
segments), grids, Catmull-Clark subdivision surfaces and user geometry,
static or moving, in normal and robust mode,
with min-width, intersection filters and compact scenes, instanced
(InstanceGeometry, InstanceArrayGeometry; transform and quaternion motion)
by flattening or through a TLAS over shared BLASes (tlas.py): Scene -> commit
(a BVH8 build on the JAX package's route: the binned-SAH builder on the
device below 50,000 prims, the native builder above; HIGH pre-splits,
REFIT refits; then record packing) -> intersect / occluded -> HitBatch, and
the viewer. Scenes the traversal kernel serves run it; the others run the
generic engine (accel/traverse_generic.py). Around them: interpolation
(interpolate.py, buffer.py), point queries, collision and statistics
(query.py), user BVH builds (builder_api.py), the device model
(rtcore.py) and checkpoints in the JAX package's archive format
(utils/checkpoint.py).

The package imports torch and numpy, never jax, and nothing of embree_tpu.
"""
__version__ = "0.1.0"

from .core.ray import (INVALID_ID, MAX_INSTANCE_LEVELS, HitBatch, RayBatch,
                       make_miss_hits, make_rays, select_hits)
from .core.math import (QuaternionDecomposition, affine_identity,
                        qd_identity, qd_interpolate, quat_from_axis_angle,
                        quat_identity)
from .geometry import (CurveGeometry, GeometryBase, GridGeometry,
                       InstanceArrayGeometry, InstanceGeometry,
                       LineSegmentsGeometry, PointGeometry, QuadGeometry,
                       SubdivisionGeometry, TriangleGeometry, UserGeometry)
from .scene import (BuildQuality, CommitCancelled, CommittedScene, Scene,
                    from_arrays, intersect, intersect_brute, occluded)
from .tlas import TwoLevelScene, two_level_from_arrays
from .interpolate import interpolate
from .buffer import (BUFFER_TYPE_INDEX, BUFFER_TYPE_VERTEX,
                     BUFFER_TYPE_VERTEX_ATTRIBUTE, Buffer, BufferError,
                     get_geometry_buffer, interpolate_slot,
                     set_geometry_buffer, set_vertex_attribute_count,
                     vertex_attribute_count)
from .builder_api import build_bvh, walk_bvh

__all__ = [
    "BUFFER_TYPE_INDEX", "BUFFER_TYPE_VERTEX", "BUFFER_TYPE_VERTEX_ATTRIBUTE",
    "Buffer", "BufferError", "BuildQuality", "CommitCancelled",
    "CommittedScene", "CurveGeometry", "GeometryBase", "GridGeometry",
    "HitBatch", "INVALID_ID", "InstanceArrayGeometry", "InstanceGeometry",
    "LineSegmentsGeometry", "MAX_INSTANCE_LEVELS", "PointGeometry",
    "QuadGeometry", "QuaternionDecomposition", "RayBatch", "Scene",
    "SubdivisionGeometry", "TriangleGeometry", "TwoLevelScene",
    "UserGeometry", "affine_identity", "build_bvh", "from_arrays",
    "get_geometry_buffer", "interpolate", "interpolate_slot", "intersect",
    "intersect_brute", "make_miss_hits", "make_rays", "occluded",
    "qd_identity", "qd_interpolate", "quat_from_axis_angle",
    "quat_identity", "select_hits", "set_geometry_buffer",
    "set_vertex_attribute_count", "two_level_from_arrays",
    "vertex_attribute_count", "walk_bvh",
]
