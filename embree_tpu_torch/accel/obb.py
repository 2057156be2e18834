"""Oriented-bounding-box (OBB) hair tier: strand-aligned leaf bounds.

A numpy copy of embree_tpu/accel/obb.py::leaf_obbs (:37-111), the role of
the reference's unaligned hair acceleration
(kernels/builders/bvh_builder_hair.h:19, heuristic_strand_array.h strand
splits, common/math/obbox.h, kernels/bvh/bvh_node_obb.h), redesigned for the
flat BVH:

- The internal tree stays axis-aligned; every LEAF of a hair scene carries a
  strand-aligned OBB fitted over its member curve and line primitives. The
  generic engine (traverse_generic.py) tests it at push time, so a diagonal
  strand whose AABB is mostly empty space is culled before its leaf is
  popped.
- The frame is fitted per leaf from the sign-aligned mean strand direction.
- Bounds are conservative by the Bezier convex-hull property: control
  points of both motion steps, dilated by the largest control radius, are
  bounded in the leaf frame.

Everything runs on host numpy at commit time; the output is three flat
arrays indexed by leaf start slot, read-only on the device.
"""
from __future__ import annotations

import numpy as np

from .bvh import INVALID_NODE, LEAF_COUNT_BITS, LEAF_COUNT_MASK


def leaf_obbs(node_child, prim_order, pts, axis, rmax, eligible=None):
    """Fit one OBB per leaf of a built BVH.

    Args:
      node_child: (n_nodes, W) int32 child refs (leaves encoded negative).
      prim_order: (n_prims,) int32 leaf-slot -> prim id permutation.
      pts: (T, P, 3) per-prim conservative point sets (convex hull points,
        both motion steps; padded by repeating a member point).
      axis: (T, 3) per-prim strand axis (need not be normalized).
      rmax: (T,) per-prim dilation radius (max control radius, min-width
        scaled).
      eligible: optional (T,) bool — prims allowed in an OBB leaf. Leaves
        with any ineligible member (e.g. a ground-plane triangle sharing
        the merged table with hair) keep the pass-through box.

    Returns:
      (rot, lo, up): rot (L, 3, 3) float32 row-major frames (rows = local
      x/y/z in world space; local coords = rot @ p), lo/up (L, 3) local
      bounds, L = n_prims, indexed by a leaf's start slot. Slots that are
      not a leaf start (or whose leaf is ineligible) hold a pass-through
      infinite box, so lookups never need a validity sidecar.
    """
    nc = np.asarray(node_child)
    po = np.asarray(prim_order)
    L = po.shape[0]
    BIG = np.float32(3e38)
    rot = np.tile(np.eye(3, dtype=np.float32), (L, 1, 1))
    lo = np.full((L, 3), -BIG, np.float32)
    up = np.full((L, 3), BIG, np.float32)

    leaf_mask = (nc < 0) & (nc != INVALID_NODE)
    refs = nc[leaf_mask]
    if refs.size == 0:
        return rot, lo, up
    packed = -(refs.astype(np.int64) + 1)
    start = (packed >> LEAF_COUNT_BITS).astype(np.int64)
    count = (packed & LEAF_COUNT_MASK).astype(np.int64)
    C = int(count.max())

    # member matrix (Nl, C), padded by repeating the last member
    sl = start[:, None] + np.minimum(np.arange(C)[None, :], count[:, None] - 1)
    mem = po[sl]                                     # (Nl, C)

    if eligible is not None:
        ok = np.asarray(eligible)[mem].all(axis=1)
        if not ok.any():
            return rot, lo, up
        start, count, sl, mem = start[ok], count[ok], sl[ok], mem[ok]

    # sign-aligned mean strand direction (strand clustering analog: the
    # anchor is the first member's axis; antiparallel members flip)
    ax = axis[mem].astype(np.float64)                # (Nl, C, 3)
    anchor = ax[:, :1]
    sgn = np.where((ax * anchor).sum(-1, keepdims=True) < 0.0, -1.0, 1.0)
    d = (ax * sgn).sum(axis=1)                       # (Nl, 3)
    nrm = np.linalg.norm(d, axis=-1, keepdims=True)
    # degenerate direction -> identity frame (OBB == AABB, still correct)
    z = np.where(nrm > 1e-12, d / np.maximum(nrm, 1e-300),
                 np.array([0.0, 0.0, 1.0]))
    helper = np.zeros_like(z)
    helper[np.arange(z.shape[0]), np.argmin(np.abs(z), axis=-1)] = 1.0
    x = np.cross(helper, z)
    x /= np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-300)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1).astype(np.float32)   # (Nl, 3, 3)

    q = np.einsum("lij,lcpj->lcpi", R, pts[mem])     # (Nl, C, P, 3)
    rm = rmax[mem][:, :, None, None]                 # (Nl, C, 1, 1)
    qlo = (q - rm).min(axis=(1, 2))
    qup = (q + rm).max(axis=(1, 2))

    rot[start] = R
    lo[start] = qlo
    up[start] = qup
    return rot, lo, up
