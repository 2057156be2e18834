"""Triangle intersection in differentiable torch ops.

Port of embree_tpu/ops/triangle.py:20-103: Möller-Trumbore with precomputed
edges (kernels/geometry/triangle_intersector_moeller.h:9-16), branch-free
over any batch shape. Autograd through the closed-form solve gives dt/dverts
and the other hit derivatives.
"""
from __future__ import annotations

import torch

from ..core.math import cross, dot


def intersect_moeller(org, dir, v0, v1, v2, tnear, tfar):
    """Möller-Trumbore ray/triangle test.

    Args:
      org, dir: (..., 3) ray origin and direction.
      v0, v1, v2: (..., 3) triangle vertices (broadcast against rays).
      tnear, tfar: (...,) valid t interval.
    Returns:
      (hit, t, u, v, ng): boolean mask and hit params; ng is the unnormalized
      geometric normal cross(e1, e2).
    """
    e1 = v1 - v0
    e2 = v2 - v0
    ng = cross(e1, e2)

    pvec = cross(dir, e2)
    det = dot(e1, pvec)
    # no backface culling (reference default: EMBREE_BACKFACE_CULLING off);
    # the safe denominator keeps the unused branch's gradient finite
    det_ok = det.abs() > 1e-24
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tvec = org - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(dir, qvec) * inv_det
    t = dot(e2, qvec) * inv_det

    hit = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= tnear) & (t <= tfar))
    return hit, t, u, v, ng


def intersect_pluecker(org, dir, v0, v1, v2, tnear, tfar):
    """Watertight Plücker test (robust scenes): signed volumes U, V, W of the
    ray against the three edges; a hit needs all three of one sign.

    Port of embree_tpu/ops/triangle.py:58-98
    (kernels/geometry/triangle_intersector_pluecker.h). u/v follow the
    Möller convention p = (1-u-v) v0 + u v1 + v v2: u from V, v from W.
    """
    a = v0 - org
    b = v1 - org
    c = v2 - org
    U = dot(cross(c, b), dir)
    V = dot(cross(a, c), dir)
    W = dot(cross(b, a), dir)
    min_uvw = torch.minimum(torch.minimum(U, V), W)
    max_uvw = torch.maximum(torch.maximum(U, V), W)
    valid_side = (min_uvw >= 0.0) | (max_uvw <= 0.0)

    ng = cross(v1 - v0, v2 - v0)
    den = dot(ng, dir)
    den_ok = den.abs() > 1e-30
    t = dot(ng, a) * torch.where(den_ok, 1.0 / torch.where(den_ok, den, 1.0),
                                 0.0)
    uvw = U + V + W
    uvw_ok = uvw.abs() > 1e-30
    inv_uvw = torch.where(uvw_ok, 1.0 / torch.where(uvw_ok, uvw, 1.0), 0.0)
    u = torch.clamp(V * inv_uvw, 0.0, 1.0)
    v = torch.clamp(W * inv_uvw, 0.0, 1.0)
    hit = valid_side & den_ok & (t >= tnear) & (t <= tfar)
    return hit, t, u, v, ng


def interpolate_attribute(attr_v0, attr_v1, attr_v2, u, v):
    """Barycentric vertex-attribute interpolation (rtcInterpolate analog,
    embree_tpu/ops/triangle.py:100): (1 - u - v) a0 + u a1 + v a2, summed
    in that order. Differentiable."""
    w = (1.0 - u - v)[..., None]
    return w * attr_v0 + u[..., None] * attr_v1 + v[..., None] * attr_v2
