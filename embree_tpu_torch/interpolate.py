"""Vertex-attribute interpolation — the rtcInterpolate analog.

Port of embree_tpu/interpolate.py (role parity with rtcInterpolate0/1,
include/embree4/rtcore_geometry.h:283-302; InterpolateTrianglesTest /
Subdiv / Grid / Hair, verify.cpp:2042-2461): given hits (prim_id, u, v) on
one geometry and a per-vertex attribute buffer, evaluate the attribute at
each hit, in torch ops on the hits' device (differentiable in u, v and
the buffer). Each branch sums in the JAX package's order.
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import (CurveGeometry, GridGeometry, LineSegmentsGeometry,
                       QuadGeometry, SubdivisionGeometry, TriangleGeometry)
from .ops import curve as curve_ops


def _long(x, device):
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def _take(x, i):
    """x[i] as XLA gathers: a negative index counts from the end, and an
    index out of range is clamped (so a miss's INVALID_ID prim id reads
    the last row, as in the JAX package)."""
    n = x.shape[0]
    return x[torch.where(i < 0, i + n, i).clamp(0, n - 1)]


def interpolate(geometry, prim_id, u, v, buffer):
    """Evaluate a per-vertex attribute at hits (prim_id, u, v).

    Args:
      geometry: the (host-side) geometry object the hits belong to.
      prim_id: (...,) int hit prim ids of this geometry (tensor or array).
      u, v: (...,) float hit parameters.
      buffer: (n_verts, K) attribute buffer (K channels).
    Returns: (..., K) the interpolated attribute, on u's device (u's
    device when u is a tensor, else the buffer's, else the CPU).
    """
    dev = (u.device if torch.is_tensor(u) else
           buffer.device if torch.is_tensor(buffer) else torch.device("cpu"))
    buffer = torch.as_tensor(buffer, device=dev)
    u = torch.as_tensor(u, device=dev)
    v = torch.as_tensor(v, device=dev)
    prim_id = torch.as_tensor(prim_id, device=dev).long()

    if isinstance(geometry, TriangleGeometry):
        idx = _take(_long(geometry.indices, dev), prim_id)
        w = (1.0 - u - v)[..., None]
        return (w * _take(buffer, idx[..., 0])
                + u[..., None] * _take(buffer, idx[..., 1])
                + v[..., None] * _take(buffer, idx[..., 2]))

    if isinstance(geometry, QuadGeometry):
        idx = _take(_long(geometry.indices, dev), prim_id)
        a0, a1, a2, a3 = (_take(buffer, idx[..., k]) for k in range(4))
        uu, vv = u[..., None], v[..., None]
        return ((1 - uu) * (1 - vv) * a0 + uu * (1 - vv) * a1
                + uu * vv * a2 + (1 - uu) * vv * a3)

    if isinstance(geometry, LineSegmentsGeometry):
        idx = _take(_long(geometry.indices, dev), prim_id)
        return ((1.0 - u)[..., None] * _take(buffer, idx)
                + u[..., None] * _take(buffer, idx + 1))

    if isinstance(geometry, CurveGeometry):
        idx = _take(_long(geometry.indices, dev), prim_id)
        if geometry.basis == curve_ops.BASIS_HERMITE:
            z = torch.zeros_like(_take(buffer, idx))
            cp = torch.stack([_take(buffer, idx), z, _take(buffer, idx + 1),
                              z], dim=-2)
        else:
            cp = _take(buffer, idx[..., None] + torch.arange(4, device=dev))
        return curve_ops.eval_curve(geometry.basis, cp, u, pairwise=False)

    if isinstance(geometry, GridGeometry):
        # u/v span the whole grid (the grid index is the prim id)
        g = _take(_long(geometry.grids, dev), prim_id)
        start, stride, w_, h_ = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
        fx = u * (w_ - 1).to(u.dtype)
        fy = v * (h_ - 1).to(v.dtype)
        # float -> int32 truncates toward zero, as XLA's convert does
        x0 = torch.minimum(torch.clamp(fx.to(torch.int32).long(), min=0),
                           w_ - 2)
        y0 = torch.minimum(torch.clamp(fy.to(torch.int32).long(), min=0),
                           h_ - 2)
        ax, ay = fx - x0.to(fx.dtype), fy - y0.to(fy.dtype)
        base = start + y0 * stride + x0
        a0 = _take(buffer, base)
        a1 = _take(buffer, base + 1)
        a2 = _take(buffer, base + stride)
        a3 = _take(buffer, base + stride + 1)
        axx, ayy = ax[..., None], ay[..., None]
        return ((1 - axx) * (1 - ayy) * a0 + axx * (1 - ayy) * a1
                + (1 - axx) * ayy * a2 + axx * ayy * a3)

    if isinstance(geometry, SubdivisionGeometry):
        # base-face prim ids, bilinear over the face's first four corners:
        # the JAX package's documented approximation of the limit surface
        fc = np.asarray(geometry.face_counts, np.int64)
        offs = _long(np.concatenate([[0], np.cumsum(fc)])[:-1], dev)
        idx_flat = _long(geometry.indices, dev)
        o = _take(offs, prim_id)
        a0, a1, a2, a3 = (_take(buffer, _take(idx_flat, o + k))
                          for k in range(4))
        uu, vv = u[..., None], v[..., None]
        return ((1 - uu) * (1 - vv) * a0 + uu * (1 - vv) * a1
                + uu * vv * a2 + (1 - uu) * vv * a3)

    raise TypeError(f"interpolate: unsupported geometry {type(geometry)}")
