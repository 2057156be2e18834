"""Scene: geometry container + commit (BVH build) + intersect/occluded queries.

Port of embree_tpu/scene.py (:194-308 Scene, :323-701 merging, :878-1170
finalize, :1172-1286 packing and the native build route, :1310-1720
queries), without filters, user geometry and instances. Role parity with
the reference runtime core (kernels/common/scene.{h,cpp}, query dispatch
kernels/common/rtcore.cpp:599 rtcIntersect1):

- ``Scene`` is the mutable host-side container of geometries.
- ``Scene.commit(device=...)`` merges triangles, quads, points, line
  segments and curves, builds a BVH8 with the native builder (the JAX
  package's ``EMBREE_TPU_NATIVE_BUILD=1`` route, at every prim count),
  packs the records where the kernel serves the scene (the packable gate,
  ``PACKED_KINDS``), fits strand-aligned leaf OBBs for hair scenes and
  returns a ``CommittedScene``: a dataclass of tensors on one device, CUDA
  unless the caller asks for the CPU.
- Curves: native curves of every cubic basis are one prim per curve, stored
  as world-space Bezier CPs (oriented curves with a Bezier normal spline),
  flat, round, oriented or distance, each at its own tessellation rate;
  packed slots widen to 16 fields (4 CPs x xyz+r). Tessellated curves
  (``algorithm="tessellate"`` or the linear basis) become round or flat
  line segments whose prim id is the curve's and whose u runs over the
  whole curve.
- Motion blur: 2-step geometry carries A and B tables lerped by the ray's
  time; S-step geometry is split at its interior knots into one prim per
  linear segment with its own [t0, t1] window (time-sliced replication,
  the MSMBlur analog); a ``time_range`` clips a geometry's window, so the
  geometry exists only within it.
- ``intersect``/``occluded`` are plain functions over (CommittedScene,
  RayBatch) that route as the JAX package does: the traversal kernel (on
  CUDA; its plain PyTorch version on the CPU) for scenes with a packed
  table, the generic engine (accel/traverse_generic.py) for the others:
  native round, oriented and distance curves, flat curves of several
  rates, fat round-line joints, min-width. ``backend="jnp"`` or
  ``"pallas"`` picks one, as in the JAX package.

What the port does not cover yet, commit refuses with NotImplementedError:
grids, subdivision, user geometry, instances and two-level scenes (so
quaternion and transform motion), filters, compact scenes, HIGH and REFIT
quality.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from .accel import pack as pack_mod
from .accel import traverse_generic
from .accel.bvh import BVH
from .accel.obb import leaf_obbs
from .accel.traverse import traverse_packed
from .core.ray import (INVALID_ID, MAX_INSTANCE_LEVELS, HitBatch, RayBatch,
                       make_miss_hits, resolve_device, select_hits)
from .core.math import sqrt_rn
from .geometry import (KIND_CURVE_DISTANCE, KIND_CURVE_FLAT,
                       KIND_CURVE_ORIENTED, KIND_CURVE_ROUND, KIND_DISC,
                       KIND_FLAT_LINE, KIND_ORIENTED_DISC, KIND_QUAD,
                       KIND_ROUND_LINE, KIND_SPHERE, KIND_TRIANGLE, KIND_USER,
                       CurveGeometry, LineSegmentsGeometry, PointGeometry,
                       QuadGeometry, TriangleGeometry, _split_timesteps,
                       motion_knots)
from .native import build_bvh8_native
from .ops import curve as curve_ops
from .ops import line as line_ops
from .ops import point as point_ops
from .ops.quad import intersect_quad
from .ops.triangle import intersect_moeller, intersect_pluecker

# Static leaf block size for scene BVHs (TriangleM M=4 analog, triangle.h:14).
LEAF_SIZE = 8
# the kinds the packed kernel serves (scene.py:1172-1187). Round curves
# join them only on request: the JAX package keeps them on its generic
# engine by default (its kernel's cone candidates miss roots the 32-seed
# sweep finds), and EMBREE_TPU_KERNEL_ROUND=1 is its opt-in. A module-level
# set, so that a caller (a test) can widen it as the JAX package's tests do.
PACKED_KINDS = {KIND_TRIANGLE, KIND_QUAD, KIND_SPHERE, KIND_DISC,
                KIND_ORIENTED_DISC, KIND_ROUND_LINE, KIND_FLAT_LINE,
                KIND_CURVE_FLAT}
if os.environ.get("EMBREE_TPU_KERNEL_ROUND", "0") == "1":
    PACKED_KINDS.add(KIND_CURVE_ROUND)
# native curve kinds in 16-field slots (4 Bezier CPs x xyz+r)
CURVE_PACKED = {KIND_CURVE_FLAT, KIND_CURVE_ROUND}
CURVE_KINDS = (KIND_CURVE_FLAT, KIND_CURVE_ROUND, KIND_CURVE_ORIENTED,
               KIND_CURVE_DISTANCE)
# kinds eligible for the strand-aligned leaf-OBB hair tier (scene.py:62)
HAIR_KINDS = {KIND_ROUND_LINE, KIND_FLAT_LINE} | set(CURVE_KINDS)
# rays per call of the generic engine, and per re-intersection where the
# scene holds curve kinds whose test carries many seeds or segments per ray
# (the sweep's 32 seeds, the oriented test's 64 segments): they bound the
# batch the device holds at once
GENERIC_CHUNK = 1 << 20
SEEDED_KINDS = (KIND_CURVE_ROUND, KIND_CURVE_ORIENTED, KIND_CURVE_DISTANCE)
# the kernel's ribbon rate starts here and rises to the largest native
# flat-curve rate of the scene (scene.py:349, :650-651)
DEFAULT_CURVE_RATE = 4
_POINT_KINDS = {"sphere": KIND_SPHERE, "disc": KIND_DISC,
                "oriented_disc": KIND_ORIENTED_DISC}
# per-kind tables of the merged scene: name -> trailing shape. A name
# ending in "b" is the second time step of the table without it (equal to
# it for static geometry).
_TABLES = {"tri_v0": (3,), "tri_v1": (3,), "tri_v2": (3,),
           "tri_v0b": (3,), "tri_v1b": (3,), "tri_v2b": (3,),
           "quad_v": (4, 3), "quad_vb": (4, 3), "quad_uvm": (6,),
           "pnt_c": (3,), "pnt_r": (), "pnt_n": (3,),
           "pnt_cb": (3,), "pnt_rb": (), "pnt_nb": (3,),
           "line_p0": (3,), "line_r0": (), "line_p1": (3,), "line_r1": (),
           "line_fl": (), "line_u0": (), "line_u1": (),
           "line_pL": (3,), "line_rL": (), "line_pR": (3,), "line_rR": (),
           "line_p0b": (3,), "line_r0b": (), "line_p1b": (3,),
           "line_r1b": (), "line_pLb": (3,), "line_rLb": (),
           "line_pRb": (3,), "line_rRb": (),
           "curve_cp": (4, 4), "curve_cpb": (4, 4), "curve_n": (4, 3),
           "curve_nb": (4, 3), "curve_prate": ()}


class BuildQuality:
    """RTCBuildQuality analog (rtcore_common.h)."""
    LOW = 0      # the JAX package's Morton/LBVH tier
    MEDIUM = 1   # binned SAH
    HIGH = 2     # SAH + spatial splits (not ported yet)
    REFIT = 3    # refit existing topology (not ported yet)


@dataclasses.dataclass
class CommittedScene:
    """Device-resident traversable: merged prim tables + BVH + records."""
    bvh: BVH
    prim_kind: torch.Tensor    # (T,) int32
    prim_geom: torch.Tensor    # (T,) int64 geometry id
    prim_local: torch.Tensor   # (T,) int64 prim id within its geometry
    prim_inst: torch.Tensor    # (T, 2) int64 instance ids (INVALID_ID)
    prim_data: torch.Tensor    # (T,) int64 index into its kind's table
    prim_mask: torch.Tensor    # (T,) int64 geometry mask (uint32 value)
    prim_t0: torch.Tensor      # (T,) float32 time window ([0, 1] = whole)
    prim_t1: torch.Tensor
    tri_v0: torch.Tensor       # (Tt, 3) float32
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_v0b: torch.Tensor      # the same at the second time step
    tri_v1b: torch.Tensor
    tri_v2b: torch.Tensor
    quad_v: torch.Tensor       # (Tq, 4, 3) float32
    quad_vb: torch.Tensor
    quad_uvm: torch.Tensor     # (Tq, 6) affine uv frame (identity)
    pnt_c: torch.Tensor        # (Tp, 3) point centers
    pnt_r: torch.Tensor        # (Tp,) radii
    pnt_n: torch.Tensor        # (Tp, 3) normals (oriented discs)
    pnt_cb: torch.Tensor
    pnt_rb: torch.Tensor
    pnt_nb: torch.Tensor
    line_p0: torch.Tensor      # (Tl, 3) segment start
    line_r0: torch.Tensor      # (Tl,)
    line_p1: torch.Tensor      # (Tl, 3) segment end
    line_r1: torch.Tensor      # (Tl,)
    line_fl: torch.Tensor      # (Tl,) 1 where a segment ends at our start
    line_u0: torch.Tensor      # (Tl,) curve u at the segment's start (0
    line_u1: torch.Tensor      # for segments) and at its end (1)
    line_pL: torch.Tensor      # (Tl, 3) left neighbor's start point
    line_rL: torch.Tensor      # (Tl,) its radius, < 0 when absent
    line_pR: torch.Tensor      # (Tl, 3) right neighbor's end point
    line_rR: torch.Tensor      # (Tl,) its radius, < 0 when absent
    line_p0b: torch.Tensor     # the line tables at the second time step
    line_r0b: torch.Tensor
    line_p1b: torch.Tensor
    line_r1b: torch.Tensor
    line_pLb: torch.Tensor
    line_rLb: torch.Tensor
    line_pRb: torch.Tensor
    line_rRb: torch.Tensor
    curve_cp: torch.Tensor     # (Tc, 4, 4) world-space Bezier CPs, xyz+r
    curve_cpb: torch.Tensor    # the same at the second time step
    curve_n: torch.Tensor      # (Tc, 4, 3) Bezier normal spline (oriented
    curve_nb: torch.Tensor     # curves; zero for the others), both steps
    curve_prate: torch.Tensor  # (Tc,) int32 each curve's tessellation rate
    leaf_obb_rot: torch.Tensor  # (L, 3, 3) hair-tier leaf frames by leaf
    leaf_obb_lo: torch.Tensor   # start slot, (L, 3) local bounds; L = 0
    leaf_obb_up: torch.Tensor   # when the tier is off
    # the kernel's records, None where it does not serve the scene (the
    # generic engine then answers every query)
    packed: Optional[pack_mod.PackedScene]
    kinds_present: tuple = (KIND_TRIANGLE,)
    robust: bool = False       # RTC_SCENE_FLAG_ROBUST analog (B2)
    has_motion: bool = False   # B tables differ from A, or windows exist
    has_windows: bool = False  # some prim has a window other than [0, 1]
    curve_rate: int = DEFAULT_CURVE_RATE   # the kernel's ribbon rate
    curve_rates_present: tuple = (DEFAULT_CURVE_RATE,)  # rates of the curves
    # min-width (rtcSetGeometryMaxRadiusScale + minWidthDistanceFactor):
    # radii grow with the distance from the ray origin, up to
    # max_radius_scale times (context.h:65-74); 0 = off
    min_width_factor: float = 0.0
    max_radius_scale: float = 1.0

    @property
    def num_prims(self):
        return self.prim_kind.shape[0]

    @property
    def device(self):
        return self.prim_kind.device


def _refuse(what: str):
    raise NotImplementedError(
        f"embree_tpu_torch does not cover {what} yet (see ROADMAP.md)")


class _Merger:
    """The merged prim table (scene.py:323-579 for the packed kinds).

    Every emitted prim carries the current time window. A geometry's
    ``time_range`` clips that window and drops the geometry when the two do
    not overlap; an S-step buffer splits it at the buffer's interior knots,
    one prim copy per linear segment (``_segmented``)."""

    def __init__(self):
        self.rows = []          # (n, 5): kind, gid, local id, data, mask
        self.tab = {k: [] for k in _TABLES}
        self.count = {"tri": 0, "quad": 0, "pnt": 0, "line": 0, "curve": 0}
        self.curve_rate = DEFAULT_CURVE_RATE   # max rate of native curves
        self.windows = []       # (n, 2) per emit: [t0, t1]
        self.has_motion = False
        # a round-line joint fatter than half its segment (the packable
        # gate: the kernel's record has no neighbor fields for the clip)
        self.fat_round_joints = False
        self._window = (0.0, 1.0)
        self._trange = (0.0, 1.0)   # time_range of the geometry being added

    def _emit(self, kind, gid, n, group, mask):
        r = np.empty((n, 5), np.int64)
        r[:, 0] = kind
        r[:, 1] = gid
        r[:, 2] = np.arange(n)
        r[:, 3] = self.count[group] + np.arange(n)
        r[:, 4] = int(mask) & 0xFFFFFFFF
        self.rows.append(r)
        self.windows.append(np.tile(np.asarray(self._window, np.float32),
                                    (n, 1)))
        self.count[group] += n

    def _put(self, **cols):
        for k, v in cols.items():
            self.tab[k].append(np.asarray(v, np.float32))

    def _steps(self, buf, name, flags_motion=True):
        """The buffer at the current window's two ends (scene.py:385-388).
        ``flags_motion``: a moving buffer sets the scene's motion flag; the
        JAX merger drops the flag of normal derivatives (scene.py:628-630),
        so a scene whose only moving buffer they are stays static."""
        a, b, moving = _split_timesteps(buf, name, self._window, self._trange)
        if flags_motion:
            self.has_motion |= moving
        return a, b

    def _segmented(self, knots, fn):
        """Run fn once per sub-window of the current window split at the
        interior knot times (scene.py:390-398)."""
        outer = self._window
        ts = [outer[0]] + list(knots) + [outer[1]]
        for t0, t1 in zip(ts[:-1], ts[1:]):
            self._window = (t0, t1)
            fn()
        self._window = outer

    def add(self, g, gid):
        if not isinstance(g, (TriangleGeometry, QuadGeometry, PointGeometry,
                              LineSegmentsGeometry, CurveGeometry)):
            _refuse(type(g).__name__)
        if g.filter is not None:
            _refuse("intersection filters")
        # the geometry exists only within its time range (scene.py:403-418)
        tr = tuple(float(x) for x in g.time_range)
        cw = (max(self._window[0], tr[0]), min(self._window[1], tr[1]))
        if cw[0] > cw[1]:
            return
        outer = self._window
        self._window = cw
        self._trange = tr
        try:
            knots = motion_knots([getattr(g, a, None) for a in
                                  ("vertices", "points", "normals",
                                   "tangents")],
                                 self._window, self._trange)
            if knots:
                self._segmented(knots, lambda: self._add_window(g, gid))
            else:
                self._add_window(g, gid)
        finally:
            self._window = outer

    def _add_window(self, g, gid):
        """Emit g's prims for the current window, whose buffers are linear
        in time (scene.py:474-579)."""
        if isinstance(g, TriangleGeometry):
            va, vb = self._steps(g.vertices, "vertices")
            idx = np.asarray(g.indices, np.int64)
            ta, tb = va[idx], vb[idx]                         # (n, 3, 3)
            self._emit(KIND_TRIANGLE, gid, ta.shape[0], "tri", g.mask)
            self._put(tri_v0=ta[:, 0], tri_v1=ta[:, 1], tri_v2=ta[:, 2],
                      tri_v0b=tb[:, 0], tri_v1b=tb[:, 1], tri_v2b=tb[:, 2])
        elif isinstance(g, QuadGeometry):
            va, vb = self._steps(g.vertices, "vertices")
            idx = np.asarray(g.indices, np.int64)
            n = idx.shape[0]
            uvm = np.zeros((n, 6), np.float32)                # :1289-1295
            uvm[:, 2] = uvm[:, 5] = 1.0
            self._emit(KIND_QUAD, gid, n, "quad", g.mask)
            self._put(quad_v=va[idx], quad_vb=vb[idx], quad_uvm=uvm)
        elif isinstance(g, PointGeometry):
            pa, pb = self._steps(g.points, "points")
            n = pa.shape[0]
            if g.normals is not None:
                na, nb = self._steps(g.normals, "normals")
            else:
                na = nb = np.tile(np.array([[0, 0, 1]], np.float32), (n, 1))
            self._emit(_POINT_KINDS[g.kind], gid, n, "pnt", g.mask)
            self._put(pnt_c=pa[:, :3], pnt_r=pa[:, 3], pnt_n=na,
                      pnt_cb=pb[:, :3], pnt_rb=pb[:, 3], pnt_nb=nb)
        elif isinstance(g, CurveGeometry):
            self._add_curves(g, gid)
        else:
            va, vb = self._steps(g.vertices, "vertices")
            idx = np.asarray(g.indices, np.int64)
            n = idx.shape[0]
            kind = KIND_ROUND_LINE if g.kind == "round" else KIND_FLAT_LINE
            # a begin sphere exists only where no segment ends at our start
            # (roundline_intersector.h isBeginPoint); neighbor far endpoints
            # with radius < 0 marking absent (scene.py:534-544)
            has_left = np.isin(idx - 1, idx)
            has_right = np.isin(idx + 1, idx)
            il = np.clip(idx - 1, 0, va.shape[0] - 1)
            ir = np.clip(idx + 2, 0, va.shape[0] - 1)
            if kind == KIND_ROUND_LINE and n > 0:
                # fat joints need the generic engine's neighbor-cone
                # clipping, which the packed record lacks; the JAX merger
                # tests the first time step only (scene.py:545-557)
                seg_len = np.linalg.norm(va[idx + 1, :3] - va[idx, :3],
                                         axis=-1)
                rj = np.maximum(va[idx, 3], va[idx + 1, 3])
                self.fat_round_joints |= bool(
                    ((has_left | has_right) & (rj > 0.5 * seg_len)).any())
            self._emit(kind, gid, n, "line", g.mask)
            for sfx, v in (("", va), ("b", vb)):
                self._put(**{"line_p0" + sfx: v[idx, :3],
                             "line_r0" + sfx: v[idx, 3],
                             "line_p1" + sfx: v[idx + 1, :3],
                             "line_r1" + sfx: v[idx + 1, 3],
                             "line_pL" + sfx: v[il, :3],
                             "line_rL" + sfx: np.where(has_left, v[il, 3],
                                                       -1.0),
                             "line_pR" + sfx: v[ir, :3],
                             "line_rR" + sfx: np.where(has_right, v[ir, 3],
                                                       -1.0)})
            self._put(line_fl=has_left, line_u0=np.zeros(n),
                      line_u1=np.ones(n))

    def _add_curves(self, g, gid):
        """Native curves: one prim per curve, its world-space Bezier CPs at
        both steps (hermite as p, tangent, p, tangent), its normal spline
        (oriented curves; zero when the geometry has no normals) and its
        rate. Tessellated curves (or the linear basis):
        ``tessellation_rate`` line segments per curve, prim id = curve
        index, curve-global u, neighbor tables within the curve
        (scene.py:581-701)."""
        cps, cpsb = self._steps(g.vertices, "vertices")
        idx = np.asarray(g.indices, np.int64)
        if g.basis == curve_ops.BASIS_HERMITE:
            tan, tanb = self._steps(g.tangents, "tangents")
            cp = np.stack([cps[idx], tan[idx], cps[idx + 1], tan[idx + 1]], 1)
            cpb = np.stack([cpsb[idx], tanb[idx], cpsb[idx + 1],
                            tanb[idx + 1]], 1)
        else:
            gather = idx[:, None] + np.arange(4)[None, :]
            cp, cpb = cps[gather], cpsb[gather]
        if (g.algorithm in ("native", "distance")
                and g.basis != curve_ops.BASIS_LINEAR):
            kind = (KIND_CURVE_DISTANCE if g.algorithm == "distance" else
                    KIND_CURVE_ORIENTED if g.kind == "oriented" else
                    KIND_CURVE_ROUND if g.kind == "round" else
                    KIND_CURVE_FLAT)
            n = cp.shape[0]
            if g.normals is not None:
                nr, nrb = self._steps(g.normals, "normals")
                if g.basis == curve_ops.BASIS_HERMITE:
                    # (n0, dn0, n1, dn1): the normal-derivative buffer,
                    # zero when absent (scene.py:623-637)
                    if g.normal_derivatives is not None:
                        dn, dnb = self._steps(g.normal_derivatives,
                                              "normal_derivatives",
                                              flags_motion=False)
                    else:
                        dn = dnb = np.zeros_like(nr)
                    ncp = np.stack([nr[idx], dn[idx], nr[idx + 1],
                                    dn[idx + 1]], 1)
                    ncpb = np.stack([nrb[idx], dnb[idx], nrb[idx + 1],
                                     dnb[idx + 1]], 1)
                else:
                    gather = idx[:, None] + np.arange(4)[None, :]
                    ncp, ncpb = nr[gather], nrb[gather]
                nbez = curve_ops.to_bezier(g.basis,
                                           torch.from_numpy(ncp)).numpy()
                nbezb = curve_ops.to_bezier(g.basis,
                                            torch.from_numpy(ncpb)).numpy()
            else:
                nbez = nbezb = np.zeros((n, 4, 3), np.float32)
            self._emit(kind, gid, n, "curve", g.mask)
            rate = int(g.tessellation_rate)
            self.curve_rate = max(self.curve_rate, rate)
            self._put(curve_cp=curve_ops.to_bezier(
                          g.basis, torch.from_numpy(cp)).numpy(),
                      curve_cpb=curve_ops.to_bezier(
                          g.basis, torch.from_numpy(cpb)).numpy(),
                      curve_n=nbez, curve_nb=nbezb,
                      curve_prate=np.full(n, rate))
            return
        rate = int(g.tessellation_rate)
        p0, r0, p1, r1, u0, u1 = (x.numpy() for x in
                                  curve_ops.tessellate_segments(
                                      g.basis, torch.from_numpy(cp), rate))
        p0b, r0b, p1b, r1b, _, _ = (x.numpy() for x in
                                    curve_ops.tessellate_segments(
                                        g.basis, torch.from_numpy(cpb), rate))
        kind = KIND_ROUND_LINE if g.kind == "round" else KIND_FLAT_LINE
        n = p0.shape[0]
        jj = np.arange(n)
        has_left = (jj % rate) != 0
        has_right = (jj % rate) != rate - 1
        if kind == KIND_ROUND_LINE and n > 0:
            # the JAX merger's fat-joint predicate as it stands (first step
            # only, scene.py:668-673): it marks every segment of a curve of
            # rate > 1 as a joint (ROADMAP C), so the port routes exactly
            # the scenes the JAX package sends to its generic engine
            seg_len = np.linalg.norm(p1 - p0, axis=-1)
            rj = np.maximum(r0, r1)
            self.fat_round_joints |= bool(
                ((has_left | has_right) & (rj > 0.5 * seg_len)).any())
        self._emit(kind, gid, n, "line", g.mask)
        self.rows[-1][:, 2] = np.repeat(np.arange(idx.shape[0]), rate)
        for sfx, (a0, b0, a1, b1) in (("", (p0, r0, p1, r1)),
                                      ("b", (p0b, r0b, p1b, r1b))):
            self._put(**{"line_p0" + sfx: a0, "line_r0" + sfx: b0,
                         "line_p1" + sfx: a1, "line_r1" + sfx: b1,
                         "line_pL" + sfx: np.roll(a0, 1, axis=0),
                         "line_rL" + sfx: np.where(has_left, np.roll(b0, 1),
                                                   -1.0),
                         "line_pR" + sfx: np.roll(a1, -1, axis=0),
                         "line_rR" + sfx: np.where(has_right,
                                                   np.roll(b1, -1), -1.0)})
        self._put(line_fl=has_left, line_u0=u0, line_u1=u1)

    def curve_rates(self):
        """The distinct rates of the native curves, every kind
        (scene.py:902-904)."""
        rates = self.tab["curve_prate"]
        return (tuple(int(r) for r in np.unique(np.concatenate(rates)))
                if rates else (DEFAULT_CURVE_RATE,))

    def tables(self):
        return {k: (np.concatenate(v).reshape((-1,) + _TABLES[k]) if v else
                    np.zeros((0,) + _TABLES[k], np.float32))
                for k, v in self.tab.items()}


class Scene:
    """Mutable geometry container; commit() produces a CommittedScene."""

    def __init__(self, quality: int = BuildQuality.MEDIUM,
                 robust: bool = False, threads: int = 0,
                 min_width_factor: float = 0.0,
                 max_radius_scale: float = 1.0,
                 compact: bool = False):
        self.quality = quality
        self.threads = threads     # native-builder OpenMP team size (0 = all)
        self.robust = robust       # RTC_SCENE_FLAG_ROBUST analog
        # min-width (rtcSetGeometryMaxRadiusScale + minWidthDistanceFactor)
        self.min_width_factor = min_width_factor
        self.max_radius_scale = max_radius_scale
        self.compact = compact
        self._geoms: Dict[int, object] = {}
        self._next_id = 0
        self.committed: Optional[CommittedScene] = None

    def attach(self, geom) -> int:
        """rtcAttachGeometry analog; returns the geometry id."""
        gid = self._next_id
        self._geoms[gid] = geom
        self._next_id += 1
        return gid

    def detach(self, geom_id: int):
        del self._geoms[geom_id]

    def commit(self, device=None, two_level: bool = None) -> CommittedScene:
        """Merge geometries, build + pack the BVH (rtcCommitScene analog).
        The build runs on the host; the finished traversable goes to
        ``device`` (CUDA unless the caller passes device='cpu')."""
        dev = resolve_device(device)
        if two_level:
            _refuse("two-level (instanced) scenes")
        if self.compact:
            _refuse("compact scenes")
        if self.quality not in (BuildQuality.LOW, BuildQuality.MEDIUM):
            _refuse(f"build quality {self.quality}")
        m = _Merger()
        for gid, g in sorted(self._geoms.items()):
            if getattr(g, "enabled", True):
                m.add(g, gid)
        if not m.rows:
            raise ValueError("commit() on empty scene")
        self.committed = _finalize(
            np.concatenate(m.rows), m.tables(), np.concatenate(m.windows),
            m.has_motion, self.threads, self.robust, dev,
            (m.curve_rate, m.curve_rates()),
            min_width=(float(self.min_width_factor),
                       float(np.float32(self.max_radius_scale))),
            fat_round_joints=m.fat_round_joints)
        return self.committed


def _bounds(kind, data, tab, mrs):
    """Per-prim bounds by kind, the union over both time steps
    (scene.py:907-955), sanitized: NaN, Inf or huge bounds become
    zero-volume boxes at the origin that never produce hits
    (GarbageGeometryTest parity, :957-965)."""
    T = kind.shape[0]
    lo = np.empty((T, 3), np.float32)
    up = np.empty((T, 3), np.float32)
    for k in np.unique(kind):
        sel = kind == k
        d = data[sel]
        if k == KIND_TRIANGLE:
            pts = [tab[f"tri_v{j}{b}"][d] for b in ("", "b") for j in range(3)]
            a, b = np.minimum.reduce(pts), np.maximum.reduce(pts)
        elif k == KIND_QUAD:
            allv = np.concatenate([tab["quad_v"][d], tab["quad_vb"][d]], 1)
            a, b = allv.min(1), allv.max(1)
        elif k in (KIND_SPHERE, KIND_DISC, KIND_ORIENTED_DISC):
            ca, cb = tab["pnt_c"][d], tab["pnt_cb"][d]
            ra = mrs * tab["pnt_r"][d][:, None]
            rb = mrs * tab["pnt_rb"][d][:, None]
            a = np.minimum(ca - ra, cb - rb)
            b = np.maximum(ca + ra, cb + rb)
        elif k in CURVE_KINDS:
            # the Bezier hull of both steps dilated by the largest radius
            cpx = np.concatenate([tab["curve_cp"][d], tab["curve_cpb"][d]],
                                 axis=1)
            rmax = mrs * cpx[..., 3].max(axis=1)[:, None]
            a = cpx[..., :3].min(axis=1) - rmax
            b = cpx[..., :3].max(axis=1) + rmax
        else:
            ends = [(tab[f"line_p{j}{s}"][d],
                     mrs * tab[f"line_r{j}{s}"][d][:, None])
                    for j in (0, 1) for s in ("", "b")]
            a = np.minimum.reduce([p - e for p, e in ends])
            b = np.maximum.reduce([p + e for p, e in ends])
        lo[sel] = a
        up[sel] = b
    bad = (~np.isfinite(lo).all(axis=1) | ~np.isfinite(up).all(axis=1)
           | (np.abs(lo) > 1e18).any(axis=1) | (np.abs(up) > 1e18).any(axis=1))
    if bad.any():
        lo[bad] = 0.0
        up[bad] = 0.0
    return lo, up


def _slot_encoding(rows, tab, factor):
    """Per-slot generic fields of both time steps, kind tags and prim ids
    (scene.py:1190-1258): prim p owns slots factor*p .. factor*p+factor-1;
    a quad fills two triangle slots, every other prim the first. The line's
    begin flag is the same in both steps. Slots are 9 fields wide, or 16
    when the scene holds flat or round curves (Bezier CP j at fields
    4j..4j+3, tags 8 and 9)."""
    T = rows.shape[0]
    kind = rows[:, 0]
    data = rows[:, 3]
    S = T * factor
    nf = (pack_mod.CURVE_FIELDS if np.isin(kind, list(CURVE_PACKED)).any()
          else pack_mod.N_FIELDS)
    fields = np.zeros((2, S, nf), np.float32)
    skind = np.zeros(S, np.int32)
    spid = np.full(S, -1, np.int32)
    base = np.arange(T, dtype=np.int64) * factor

    for step, b in enumerate(("", "b")):       # table suffix of the step
        def put(sel, off, cols, tag):
            idx = base[sel] + off
            arr = np.concatenate(
                [np.asarray(c, np.float32).reshape(len(idx), -1)
                 for c in cols], axis=1)
            fields[step, idx, :arr.shape[1]] = arr
            skind[idx] = tag
            spid[idx] = np.nonzero(sel)[0]

        for k in np.unique(kind):
            sel = kind == k
            d = data[sel]
            if k == KIND_TRIANGLE:
                v0 = tab["tri_v0" + b][d]
                put(sel, 0, (v0, tab["tri_v1" + b][d] - v0,
                             tab["tri_v2" + b][d] - v0), KIND_TRIANGLE)
            elif k == KIND_QUAD:
                q = tab["quad_v" + b][d]
                put(sel, 0, (q[:, 0], q[:, 1] - q[:, 0], q[:, 3] - q[:, 0]),
                    KIND_TRIANGLE)
                put(sel, 1, (q[:, 2], q[:, 3] - q[:, 2], q[:, 1] - q[:, 2]),
                    KIND_TRIANGLE)
            elif k in (KIND_SPHERE, KIND_DISC):
                put(sel, 0, (tab["pnt_c" + b][d], tab["pnt_r" + b][d]), k)
            elif k == KIND_ORIENTED_DISC:
                put(sel, 0, (tab["pnt_c" + b][d], tab["pnt_r" + b][d],
                             tab["pnt_n" + b][d]), k)
            elif k in CURVE_PACKED:
                put(sel, 0, (tab["curve_cp" + b][d],), k)
            else:
                put(sel, 0, (tab["line_p0" + b][d], tab["line_r0" + b][d],
                             tab["line_p1" + b][d], tab["line_r1" + b][d],
                             tab["line_fl"][d]), k)
    return fields[0], fields[1], skind, spid


def _packable(kinds_present, rates, min_width_factor, fat_round_joints):
    """The packable gate of scene.py:982-992: the kernel serves the scene
    when every kind is in PACKED_KINDS, min-width is off, flat curves run
    one rate (over every native curve's rate) and no round-line joint is
    fat. (Filters and user geometry, the gate's other terms, are refused
    before.)"""
    return (set(kinds_present) <= PACKED_KINDS and min_width_factor == 0.0
            and (KIND_CURVE_FLAT not in kinds_present or len(rates) <= 1)
            and not fat_round_joints)


def _hair_obbs(rows, tab, mrs, node_child, prim_order):
    """The hair tier's leaf OBBs (scene.py:1077-1117): fitted when at least
    half the prims are curves or lines and the scene holds 8 prims or more,
    unless EMBREE_TPU_HAIR_OBB=0. Returns (rot, lo, up); zero-size tables
    when the tier is off."""
    T = rows.shape[0]
    kind = rows[:, 0]
    data = rows[:, 3]
    elig = np.isin(kind, list(HAIR_KINDS))
    if not (T >= 8 and elig.mean() >= 0.5
            and os.environ.get("EMBREE_TPU_HAIR_OBB", "1") != "0"):
        return (np.zeros((0, 3, 3), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.float32))
    pts = np.zeros((T, 8, 3), np.float32)
    paxis = np.zeros((T, 3), np.float32)
    prmax = np.zeros((T,), np.float32)
    for k in np.unique(kind):
        if k not in HAIR_KINDS:
            continue
        sel = kind == k
        d = data[sel]
        if k in (KIND_ROUND_LINE, KIND_FLAT_LINE):
            p = np.stack([tab["line_p0"][d], tab["line_p1"][d],
                          tab["line_p0b"][d], tab["line_p1b"][d]], axis=1)
            pts[sel] = np.concatenate([p, p], axis=1)
            paxis[sel] = tab["line_p1"][d] - tab["line_p0"][d]
            prmax[sel] = mrs * np.maximum.reduce(
                [tab["line_r0"][d], tab["line_r1"][d], tab["line_r0b"][d],
                 tab["line_r1b"][d]])
        else:
            cc = tab["curve_cp"][d]
            cb = tab["curve_cpb"][d]
            pts[sel] = np.concatenate([cc[..., :3], cb[..., :3]], 1)
            paxis[sel] = cc[:, 3, :3] - cc[:, 0, :3]
            prmax[sel] = mrs * np.maximum(cc[..., 3].max(1),
                                          cb[..., 3].max(1))
    return leaf_obbs(node_child, prim_order, pts, paxis, prmax,
                     eligible=elig)


def _finalize(rows, tab, windows, has_motion, threads, robust, device,
              curves, min_width=(0.0, 1.0), fat_round_joints=False):
    """Bounds, native BVH8 build, packing where the kernel serves the scene
    and the hair tier's leaf OBBs (scene.py:878-1117). ``curves``: (the
    kernel's ribbon rate, the distinct rates of the native curves);
    ``min_width``: (min_width_factor, max_radius_scale)."""
    T = rows.shape[0]
    kind = rows[:, 0]
    kinds_present = tuple(sorted(int(k) for k in np.unique(kind)))
    curve_rate, rates = curves
    mwf, mrs = min_width
    packable = _packable(kinds_present, rates, mwf, fat_round_joints)
    # windowed prims ride the motion path even where both steps are equal
    # (scene.py:970-976)
    has_windows = bool((windows[:, 0] != 0.0).any()
                       or (windows[:, 1] != 1.0).any())
    has_motion = bool(has_motion or has_windows)
    lo, up = _bounds(kind, rows[:, 3], tab, np.float32(mrs))
    # quads expand to two triangle slots of the kernel's records: its
    # leaves hold half the prims
    factor = 2 if KIND_QUAD in kinds_present else 1
    nl, nu, nc, order, n_wide = build_bvh8_native(
        lo, up, leaf_size=LEAF_SIZE // (factor if packable else 1),
        threads=threads)
    bvh_np = dict(node_lower=nl, node_upper=nu, node_child=nc,
                  prim_order=order)
    packed = None
    if packable:
        fields_a, fields_b, skind, spid = _slot_encoding(rows, tab, factor)
        classes = tuple(sorted({int(t) for t in np.unique(skind[spid >= 0])}))
        has_kinds = classes != (KIND_TRIANGLE,)
        smask = np.repeat(rows[:, 4], factor).astype(np.uint32)
        has_mask = bool(np.any(rows[:, 4] != 0xFFFFFFFF))
        # every expansion slot inherits its prim's window (:1261-1267)
        nodes, leaves, pid_map = pack_mod.pack_arrays(
            nc, nl, nu, order, n_wide, fields_a, smask, spid, has_mask,
            slot_kind=skind if has_kinds else None, slot_factor=factor,
            slot_fields_b=fields_b if has_motion else None,
            slot_t01=np.repeat(windows, factor, axis=0) if has_windows
            else None)
        packed = pack_mod.PackedScene(
            nodes=nodes, leaves=leaves, pid_map=pid_map, has_mask=has_mask,
            tri_attrs=classes == (KIND_TRIANGLE,) and factor == 1,
            has_kinds=has_kinds, kind_classes=classes,
            has_motion=has_motion, has_win=has_windows,
            nf=fields_a.shape[1], curve_rate=curve_rate)
    obb = _hair_obbs(rows, tab, np.float32(mrs), nc, order)
    prims = dict(kind=kind, geom=rows[:, 1], local=rows[:, 2],
                 inst=np.full((T, MAX_INSTANCE_LEVELS), INVALID_ID, np.int64),
                 data=rows[:, 3], mask=rows[:, 4], t0=windows[:, 0],
                 t1=windows[:, 1])
    return _to_device(bvh_np, prims, tab, packed, kinds_present, robust,
                      has_motion, has_windows, device, curves, obb,
                      min_width)


def _to_device(bvh_np, prims, tab, packed, kinds_present, robust, has_motion,
               has_windows, device, curves, obb, min_width):
    """The CommittedScene on ``device`` from host arrays; ``packed`` holds
    numpy arrays or CPU tensors, or is None; ``curves`` and ``min_width``
    as for ``_finalize``; ``obb``: the leaf OBB tables (rot, lo, up)."""
    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)
    bvh = BVH(node_lower=t(bvh_np["node_lower"], torch.float32),
              node_upper=t(bvh_np["node_upper"], torch.float32),
              node_child=t(bvh_np["node_child"], torch.int32),
              prim_order=t(bvh_np["prim_order"], torch.int32))
    if packed is not None:
        packed = dataclasses.replace(
            packed, nodes=t(packed.nodes, torch.int32),
            leaves=t(packed.leaves, torch.int32),
            pid_map=t(packed.pid_map, torch.int64),
            kind_classes=tuple(int(k) for k in packed.kind_classes))
    tables = {k: t(v, torch.int32 if k == "curve_prate" else torch.float32)
              for k, v in tab.items()}
    return CommittedScene(
        bvh=bvh,
        prim_kind=t(prims["kind"], torch.int32),
        prim_geom=t(prims["geom"], torch.int64),
        prim_local=t(prims["local"], torch.int64),
        prim_inst=t(prims["inst"], torch.int64),
        prim_data=t(prims["data"], torch.int64),
        prim_mask=t(prims["mask"], torch.int64),
        prim_t0=t(prims["t0"], torch.float32),
        prim_t1=t(prims["t1"], torch.float32),
        leaf_obb_rot=t(obb[0], torch.float32),
        leaf_obb_lo=t(obb[1], torch.float32),
        leaf_obb_up=t(obb[2], torch.float32),
        packed=packed, kinds_present=tuple(int(k) for k in kinds_present),
        robust=bool(robust), has_motion=bool(has_motion),
        has_windows=bool(has_windows), curve_rate=int(curves[0]),
        curve_rates_present=tuple(int(r) for r in curves[1]),
        min_width_factor=float(min_width[0]),
        max_radius_scale=float(min_width[1]), **tables)


def from_arrays(arrays: Dict[str, np.ndarray], flags: Dict,
                device) -> CommittedScene:
    """Build the port's CommittedScene from the JAX package's committed
    arrays (converted to numpy by the caller) — the state carried across.

    arrays: ``bvh.node_lower``, ``bvh.node_upper``, ``bvh.node_child``,
    ``bvh.prim_order``, ``prim_kind``, ``prim_geom``, ``prim_local``,
    ``prim_inst``, ``prim_data``, ``prim_mask``, ``prim_t0``, ``prim_t1``
    (missing: [0, 1]), ``packed.table`` (the unified tile table; missing
    for a scene the kernel does not serve, whose ``packed`` is None),
    ``packed.pid_map``, ``leaf_obb_rot``/``_lo``/``_up`` (the hair tier;
    missing: off) and the kind tables the scene has (``tri_v0`` ..
    ``curve_prate``, the names of CommittedScene; missing ones are empty).
    flags: ``gn``, ``has_mask``, ``tri_attrs``, ``has_kinds`` and
    ``kind_classes`` (scenes with a packed table), ``kinds_present``,
    ``robust``, ``has_motion`` and ``has_windows`` (the JAX package's
    packed ``has_motion``/``has_win`` equal them), ``nf``, ``curve_rate``
    and ``curve_rates_present`` (curve scenes), ``min_width_factor`` and
    ``max_radius_scale`` (min-width scenes), and the scene flags the port
    refuses when set (``compact``, ``filters``). ``packed.table`` is
    re-laid into the port's records; the record contents are unchanged, so
    both packages traverse the same records."""
    dev = resolve_device(device)
    if flags.get("compact"):
        _refuse("compact scenes")
    if flags.get("filters"):
        _refuse("intersection filters")
    kinds_present = tuple(flags.get("kinds_present", (KIND_TRIANGLE,)))
    if KIND_USER in kinds_present:
        _refuse("user geometry")
    curve_rate = int(flags.get("curve_rate", DEFAULT_CURVE_RATE))
    rates = tuple(flags.get("curve_rates_present", (curve_rate,)))
    has_windows = bool(flags.get("has_windows", False))
    has_motion = bool(flags.get("has_motion", False)) or has_windows
    packed = None
    if "packed.table" in arrays:
        packed = pack_mod.from_table(
            arrays["packed.table"], arrays["packed.pid_map"],
            int(flags["gn"]), bool(flags["has_mask"]),
            bool(flags["tri_attrs"]), "cpu",
            has_kinds=bool(flags.get("has_kinds", False)),
            kind_classes=tuple(flags.get("kind_classes", (KIND_TRIANGLE,))),
            has_motion=has_motion, has_win=has_windows,
            nf=int(flags.get("nf", pack_mod.N_FIELDS)), curve_rate=curve_rate)
    bvh_np = {k: arrays["bvh." + k] for k in
              ("node_lower", "node_upper", "node_child", "prim_order")}
    tab = {k: (np.asarray(arrays[k], np.float32) if k in arrays else
               np.zeros((0,) + shape, np.float32))
           for k, shape in _TABLES.items()}
    if "line_u0" not in arrays:          # segments: u spans 0..1
        tab["line_u0"] = np.zeros_like(tab["line_r0"])
        tab["line_u1"] = np.ones_like(tab["line_r0"])
    if "curve_n" not in arrays:          # no normal spline
        tab["curve_n"] = np.zeros(tab["curve_cp"].shape[:2] + (3,),
                                  np.float32)
        tab["curve_nb"] = tab["curve_n"]
    if "curve_prate" not in arrays:      # every curve at the scene's rate
        tab["curve_prate"] = np.full(tab["curve_cp"].shape[0], curve_rate,
                                     np.float32)
    T = arrays["prim_kind"].shape[0]
    prims = dict(kind=arrays["prim_kind"], geom=arrays["prim_geom"],
                 local=arrays["prim_local"], inst=arrays["prim_inst"],
                 data=arrays["prim_data"], mask=arrays["prim_mask"],
                 t0=arrays.get("prim_t0", np.zeros(T, np.float32)),
                 t1=arrays.get("prim_t1", np.ones(T, np.float32)))
    prims = {k: np.asarray(v).astype(np.float32 if k in ("t0", "t1")
                                     else np.int64)
             for k, v in prims.items()}
    obb = tuple(np.asarray(arrays.get(f"leaf_obb_{k}", np.zeros(
        (0,) + shape, np.float32)), np.float32)
        for k, shape in (("rot", (3, 3)), ("lo", (3,)), ("up", (3,))))
    min_width = (float(flags.get("min_width_factor", 0.0)),
                 float(flags.get("max_radius_scale", 1.0)))
    return _to_device(bvh_np, prims, tab, packed, kinds_present,
                      bool(flags.get("robust", False)), has_motion,
                      has_windows, dev, (curve_rate, rates), obb, min_width)


# =====================================================================
# queries — rtcIntersect* / rtcOccluded* analogs
# =====================================================================

def _flat(scene: CommittedScene, rays: RayBatch):
    if rays.device != scene.device:
        raise ValueError(f"rays are on {rays.device}, the scene on "
                         f"{scene.device}")
    shape = rays.shape
    return shape, rays.reshape(int(np.prod(shape)) if shape else 1)


def _use_kernel(scene: CommittedScene, backend: Optional[str]) -> bool:
    """The JAX package's route choice (scene.py:1531-1545). "jnp": the
    generic engine; "pallas": the kernel (its plain version on a CPU
    tensor), which needs the scene's packed table; None: the kernel
    wherever the scene has a packed table, the generic engine elsewhere.
    (The JAX package takes its kernel by default on its accelerator only;
    the port's device is the card, where the kernel is the default.)"""
    if backend == "jnp":
        return False
    if backend == "pallas":
        if scene.packed is None:
            raise ValueError("backend='pallas': the kernel does not serve "
                             "this scene (it has no packed table)")
        return True
    if backend is not None:
        raise ValueError(f"backend must be None, 'jnp' or 'pallas', got "
                         f"{backend!r}")
    return scene.packed is not None


def _scene_leaf_obb(scene: CommittedScene):
    """The hair tier's OBB tables for the generic engine, None when the
    tier is off (scene.py:1569-1575)."""
    if scene.leaf_obb_rot.shape[0] == 0:
        return None
    return (scene.leaf_obb_rot, scene.leaf_obb_lo, scene.leaf_obb_up)


def _ray_slice(rays: RayBatch, a: int, b: int) -> RayBatch:
    return RayBatch(*(getattr(rays, f.name)[a:b]
                      for f in dataclasses.fields(RayBatch)))


def _generic_select(scene: CommittedScene, flat: RayBatch, occlusion: bool):
    """best_prim from the generic engine, GENERIC_CHUNK rays at a time."""
    out = []
    for a in range(0, flat.shape[0], GENERIC_CHUNK):
        sub = _ray_slice(flat, a, a + GENERIC_CHUNK)
        res = traverse_generic.traverse(
            scene.bvh, _make_prim_test(scene, sub), sub.org, sub.dir,
            sub.tnear, sub.tfar, occlusion=occlusion,
            max_leaf_size=LEAF_SIZE, robust=scene.robust,
            leaf_obb=_scene_leaf_obb(scene))
        out.append(res.best_prim.long())
    return torch.cat(out)


def _select(scene: CommittedScene, flat: RayBatch, occlusion: bool,
            backend: Optional[str] = None):
    """Run traversal, return best_prim (merged-table index, -1 = miss)."""
    if not _use_kernel(scene, backend):
        return _generic_select(scene, flat, occlusion)
    _, best = traverse_packed(scene.packed, flat.org, flat.dir, flat.tnear,
                              flat.tfar, flat.mask, occlusion=occlusion,
                              robust=scene.robust, time=flat.time)
    return best


def intersect(scene: CommittedScene, rays: RayBatch,
              backend: Optional[str] = None,
              differentiable: bool = True) -> HitBatch:
    """Closest-hit query. Returns a HitBatch with the same leading shape as
    rays. ``backend``: None (route by the scene), "jnp" (the generic
    engine) or "pallas" (the kernel), as in the JAX package.

    differentiable=True: traversal only *selects* the winning primitive (no
    gradient through the structure); t/u/v/Ng are then recomputed in
    differentiable torch ops by re-intersecting it.

    differentiable=False: on pure-triangle scenes through the kernel,
    moving or not, the kernel emits the exact t/u/v/Ng itself (the fast
    path; no gradient flows through the returned hit); other scenes
    re-intersect the winning primitive as above.
    """
    shape, flat = _flat(scene, rays)
    kernel = _use_kernel(scene, backend)
    if not differentiable and kernel and scene.packed.tri_attrs:
        with torch.no_grad():
            t_k, best, attrs = traverse_packed(
                scene.packed, flat.org, flat.dir, flat.tnear, flat.tfar,
                flat.mask, occlusion=False, want_attrs=True,
                id_tables=(scene.prim_local, scene.prim_geom)
                + tuple(scene.prim_inst[:, j]
                        for j in range(scene.prim_inst.shape[1])),
                robust=scene.robust, time=flat.time)
            found = best >= 0
            inv = torch.tensor(INVALID_ID, dtype=torch.int64,
                               device=t_k.device)
            inst = torch.stack(attrs["ids"][2:], dim=-1)
            hit = HitBatch(
                t=torch.where(found, t_k, math.inf),
                u=torch.where(found, attrs["u"], 0.0),
                v=torch.where(found, attrs["v"], 0.0),
                ng=torch.where(found[:, None], attrs["ng"], 0.0),
                prim_id=torch.where(found, attrs["ids"][0], inv),
                geom_id=torch.where(found, attrs["ids"][1], inv),
                inst_id=torch.where(found[:, None], inst, inv))
        return hit.reshape(*shape)
    with torch.no_grad():
        best = _select(scene, flat, False, backend)
    return _reconstruct_hits(scene, flat, best, clip=not kernel) \
        .reshape(*shape)


def occluded(scene: CommittedScene, rays: RayBatch,
             backend: Optional[str] = None) -> torch.Tensor:
    """Any-hit query. Returns a bool tensor of the rays' shape."""
    shape, flat = _flat(scene, rays)
    with torch.no_grad():
        best = _select(scene, flat, True, backend)
    return (best >= 0).reshape(shape)


def _kind_test(scene: CommittedScene, k: int, didx, org, dir, time, tnear,
               tfar, clip: bool = False):
    """Closed-form intersect of prims of kind k with table rows ``didx`` at
    lerp weight ``time`` (scene.py:1310-1417). Returns (hit, t, u, v, ng).

    Min-width scenes enlarge radii with the distance from the ray origin
    (context.h:65-74). ``clip``: round lines reject hits inside a
    neighbor's capped cone, as on the JAX package's every route; the port
    clips on the generic engine's route only. The kernel has no neighbor
    fields, and the clip can reject its own hit and report a valid hit with
    t = inf there, so its hits are re-intersected with the kernel's test
    (ROADMAP C).

    Moving scenes lerp the tables as a * (1 - w) + b * w, vertex by vertex,
    as the JAX package's re-intersection does; the kernel lerps its fields
    (v0, e1, e2 for triangles) as a + w * (b - a), so the two agree to the
    last bits only (ROADMAP C). Flat curves run the ribbon at every rate of
    the scene, each curve keeping its own rate's result (:1396-1413); the
    kernel runs the scene's ``curve_rate``, which starts at 4 (ROADMAP
    C)."""
    mwf = scene.min_width_factor

    def minw(c, r):
        # radii grow with the distance from the ray origin so thin prims
        # stay at least min-width wide, up to max_radius_scale times
        if mwf <= 0.0:
            return r
        o = org.reshape(org.shape[:-1] + (1,) * (c.ndim - org.ndim) + (3,))
        dc = c - o
        d = sqrt_rn(torch.clamp(dc[..., 0] * dc[..., 0]
                                + dc[..., 1] * dc[..., 1]
                                + dc[..., 2] * dc[..., 2], min=0.0))
        return torch.minimum(torch.maximum(mwf * d, r),
                             scene.max_radius_scale * r)

    def rows(*names):
        n = getattr(scene, names[0]).shape[0]
        i = didx.clamp(0, max(n - 1, 0))
        return [getattr(scene, nm)[i] for nm in names]

    def lerp(*names):
        out = []
        for a, b in zip(rows(*names), rows(*(nm + "b" for nm in names))):
            if scene.has_motion:
                w = time.reshape(time.shape + (1,) * (a.ndim - didx.ndim))
                a = a * (1 - w) + b * w
            out.append(a)
        return out

    if k == KIND_TRIANGLE:
        # robust scenes use the watertight Plücker test
        fn = intersect_pluecker if scene.robust else intersect_moeller
        return fn(org, dir, *lerp("tri_v0", "tri_v1", "tri_v2"), tnear, tfar)
    if k == KIND_QUAD:
        (q,) = lerp("quad_v")
        (m,) = rows("quad_uvm")
        hit, t, u, v, ng = intersect_quad(org, dir, q[..., 0, :],
                                          q[..., 1, :], q[..., 2, :],
                                          q[..., 3, :], tnear, tfar)
        # affine uv frame: u_base = m0 + u*m2 + v*m4
        return (hit, t, m[..., 0] + u * m[..., 2] + v * m[..., 4],
                m[..., 1] + u * m[..., 3] + v * m[..., 5], ng)
    if k in (KIND_SPHERE, KIND_DISC, KIND_ORIENTED_DISC):
        c, r, n = lerp("pnt_c", "pnt_r", "pnt_n")
        r = minw(c, r)
        if k == KIND_SPHERE:
            return point_ops.intersect_sphere(org, dir, c, r, tnear, tfar)
        if k == KIND_DISC:
            return point_ops.intersect_disc(org, dir, c, r, tnear, tfar)
        return point_ops.intersect_oriented_disc(org, dir, c, r, n, tnear,
                                                 tfar)
    if k in CURVE_KINDS:
        (cp,) = lerp("curve_cp")
        if mwf > 0.0:
            cp = torch.cat([cp[..., :3],
                            minw(cp[..., :3], cp[..., 3])[..., None]], -1)
        if k == KIND_CURVE_DISTANCE:
            return curve_ops.intersect_distance(org, dir, cp, tnear, tfar)
        if k == KIND_CURVE_ROUND:
            return curve_ops.intersect_sweep(org, dir, cp, tnear, tfar)
        if k == KIND_CURVE_ORIENTED:
            (ncp,) = lerp("curve_n")
            return curve_ops.intersect_oriented(org, dir, cp, ncp, tnear,
                                                tfar)
        # one ribbon per distinct rate, each curve keeping its own rate's
        # (a low rate's faceting is part of the rendered shape)
        out = None
        (pr,) = rows("curve_prate")
        for rate in scene.curve_rates_present or (scene.curve_rate,):
            hr = curve_ops.intersect_ribbon(org, dir, cp, tnear, tfar,
                                            n_seg=int(rate))
            if out is None:
                out = list(hr)
            else:
                sel = pr == rate
                out = [torch.where(sel[..., None] if a.ndim > sel.ndim
                                   else sel, a, b) for a, b in zip(hr, out)]
        return tuple(out)
    p0, r0, p1, r1 = lerp("line_p0", "line_r0", "line_p1", "line_r1")
    r0 = minw(p0, r0)
    r1 = minw(p1, r1)
    if k == KIND_ROUND_LINE:
        (fl,) = rows("line_fl")
        neighbors = None
        if clip:
            pl, rl, pr_, rr = lerp("line_pL", "line_rL", "line_pR",
                                   "line_rR")
            if mwf > 0.0:
                rl = torch.where(rl >= 0, minw(pl, rl), rl)
                rr = torch.where(rr >= 0, minw(pr_, rr), rr)
            neighbors = (pl, rl, pr_, rr)
        hit, t, s, v, ng = line_ops.intersect_round_line(
            org, dir, p0, r0, p1, r1, tnear, tfar, begin_cap=fl < 0.5,
            neighbors=neighbors)
    else:
        hit, t, s, v, ng = line_ops.intersect_flat_line(
            org, dir, p0, r0, p1, r1, tnear, tfar)
    # the segment parameter mapped into the curve's u: segments span 0..1,
    # a tessellated curve's sub-segments their share of it
    u0, u1 = rows("line_u0", "line_u1")
    return hit, t, u0 * (1 - s) + u1 * s, v, ng


def _local_time(scene: CommittedScene, prim, time):
    """The lerp weight of each prim's window at the ray time, and whether
    the time lies in the window (scene.py:1494-1502, the MSMBlur itime
    analog). ``prim`` may have more dimensions than ``time``."""
    if not scene.has_windows:
        return time, None
    t0 = scene.prim_t0[prim]
    t1 = scene.prim_t1[prim]
    w = ((time - t0) / torch.clamp(t1 - t0, min=1e-9)).clamp(0.0, 1.0)
    return w, (time >= t0) & (time <= t1)


def _kinds_select(scene, prim, org, dir, time, tnear, tfar, clip=False):
    """Each ray's (hit, t, u, v, ng) from the test of its prim's kind, hits
    outside the prim's time window rejected. Each kind's test runs on the
    rays whose prim is of that kind only (a ray's arithmetic does not
    depend on which others run beside it). ``prim``: (n,)."""
    kind = scene.prim_kind[prim]
    didx = scene.prim_data[prim]
    w, in_win = _local_time(scene, prim, time)
    hit = torch.zeros(tnear.shape, dtype=torch.bool, device=tnear.device)
    t = torch.full_like(tnear, math.inf)
    u = torch.zeros_like(tnear)
    v = torch.zeros_like(tnear)
    ng = torch.zeros(tnear.shape + (3,), device=tnear.device)
    split = len(scene.kinds_present) > 1
    for k in scene.kinds_present:
        sel = kind == k
        if not split:
            hk, tk, uk, vk, ngk = _kind_test(scene, k, didx, org, dir, w,
                                             tnear, tfar, clip)
            hit = torch.where(sel, hk, hit)
            t = torch.where(sel, tk, t)
            u = torch.where(sel, uk, u)
            v = torch.where(sel, vk, v)
            ng = torch.where(sel[..., None], ngk, ng)
            continue
        i = sel.nonzero().squeeze(1)
        if i.numel() == 0:
            continue
        hk, tk, uk, vk, ngk = _kind_test(scene, k, didx[i], org[i], dir[i],
                                         w[i], tnear[i], tfar[i], clip)
        hit = hit.index_put((i,), hk)
        t = t.index_put((i,), tk)
        u = u.index_put((i,), uk)
        v = v.index_put((i,), vk)
        ng = ng.index_put((i,), ngk)
    if in_win is not None:
        hit = hit & in_win
    return hit, t, u, v, ng


def _make_prim_test(scene: CommittedScene, rays: RayBatch):
    """The generic engine's primitive test (scene.py:1505-1528, without
    filters): the test of each prim's kind with the neighbor clip, window
    and geometry-mask rejection. ``rays``: the batch the engine
    traverses."""
    def prim_test(ridx, prim, org, dir, tnear, tfar):
        hit, t, _, _, _ = _kinds_select(scene, prim.long(), org, dir,
                                        rays.time[ridx], tnear, tfar,
                                        clip=True)
        hit = hit & ((rays.mask[ridx] & scene.prim_mask[prim.long()]) != 0)
        return hit, t
    return prim_test


def _reconstruct_hits(scene: CommittedScene, rays: RayBatch,
                      best_prim, clip: bool = False) -> HitBatch:
    """Re-intersect the winning primitive per ray to recover t, u, v, Ng, ids.

    This pass carries the gradient: d(hit)/d(geometry, org, dir) flows
    through the closed-form solves, while the discrete selection is
    constant. ``clip``: the round-line neighbor clip (the generic engine's
    route, see ``_kind_test``). A large batch of a scene with seeded curve
    kinds is re-intersected GENERIC_CHUNK rays at a time.
    """
    n = best_prim.shape[0]
    if n > GENERIC_CHUNK and any(k in scene.kinds_present
                                 for k in SEEDED_KINDS):
        parts = [_reconstruct_hits(scene, _ray_slice(rays, a,
                                                     a + GENERIC_CHUNK),
                                   best_prim[a:a + GENERIC_CHUNK], clip)
                 for a in range(0, n, GENERIC_CHUNK)]
        return HitBatch(*(torch.cat([getattr(h, f.name) for h in parts])
                          for f in dataclasses.fields(HitBatch)))
    found = best_prim >= 0
    prim = torch.clamp(best_prim, min=0)
    # near bound: the ray's tnear minus an fp-wobble margin, not -inf:
    # multi-root prims (spheres, round lines) would otherwise report the
    # root behind the origin for rays starting inside them; tfar stays wide
    # (the nearest root >= tnear is unique for the fixed winning prim)
    wide_near = rays.tnear - 1e-4 * rays.tnear.abs() - 1e-5
    wide_far = torch.full_like(rays.tfar, math.inf)
    _, t, u, v, ng = _kinds_select(scene, prim, rays.org, rays.dir,
                                   rays.time, wide_near, wide_far, clip)
    miss = make_miss_hits(rays.shape, device=rays.device)
    hit = HitBatch(t=t, u=u, v=v, ng=ng,
                   prim_id=scene.prim_local[prim],
                   geom_id=scene.prim_geom[prim],
                   inst_id=scene.prim_inst[prim])
    return select_hits(found, hit, miss)


def intersect_brute(scene: CommittedScene, rays: RayBatch,
                    chunk: int = 256) -> HitBatch:
    """Ground-truth O(R*T) intersector for testing (no BVH). The nearest
    hit wins; among exact ties the lowest prim id (the JAX package's
    ascending scan with strict improvement). Round lines always take the
    neighbor clip, as the JAX package's brute force does (its
    ``_make_prim_test``, scene.py:1369-1380), whatever route the scene's
    queries take."""
    shape, flat = _flat(scene, rays)
    T = scene.num_prims
    R = flat.shape[0]
    dev = flat.device
    t_far = flat.tfar.clone()
    best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    with torch.no_grad():
        for p0 in range(0, T, chunk):
            prims = torch.arange(p0, min(p0 + chunk, T), device=dev)
            n = prims.shape[0]
            # (R, n) pairs as one flat batch
            pr = prims[None].expand(R, n).reshape(-1)
            rep = torch.arange(R, device=dev)[:, None].expand(R, n) \
                .reshape(-1)
            hit, t, _, _, _ = _kinds_select(
                scene, pr, flat.org[rep], flat.dir[rep], flat.time[rep],
                flat.tnear[rep], t_far[rep], clip=True)
            hit = (hit & ((flat.mask[rep] & scene.prim_mask[pr]) != 0)) \
                .reshape(R, n)
            t = t.reshape(R, n)
            tm = torch.where(hit, t, math.inf)
            tmin = tm.amin(dim=1)
            first = torch.where(hit & (tm == tmin[:, None]), prims[None],
                                T).amin(dim=1)
            any_hit = hit.any(dim=1)
            better = any_hit & ((tmin < t_far) | (best < 0))
            t_far = torch.where(better, tmin, t_far)
            best = torch.where(better, first, best)
    return _reconstruct_hits(scene, flat, best, clip=True).reshape(*shape)
