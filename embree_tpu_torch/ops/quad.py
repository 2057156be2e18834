"""Quad intersection: a pair of triangles with one u/v parameterization.

Port of embree_tpu/ops/quad.py:15-30 (kernels/geometry/
quad_intersector_moeller.h): a quad (v0, v1, v2, v3) is the triangles
(v0, v1, v3) and (v2, v3, v1); hits on the second map to u' = 1-u,
v' = 1-v.
"""
from __future__ import annotations

import torch

from .triangle import intersect_moeller


def intersect_quad(org, dir, v0, v1, v2, v3, tnear, tfar):
    """Returns (hit, t, u, v, ng) for the quad as two triangles."""
    h0, t0, u0, vv0, ng0 = intersect_moeller(org, dir, v0, v1, v3, tnear,
                                             tfar)
    h1, t1, u1, vv1, ng1 = intersect_moeller(org, dir, v2, v3, v1, tnear,
                                             tfar)
    pick1 = h1 & (~h0 | (t1 < t0))
    t = torch.where(pick1, t1, t0)
    u = torch.where(pick1, 1.0 - u1, u0)
    v = torch.where(pick1, 1.0 - vv1, vv0)
    ng = torch.where(pick1[..., None], ng1, ng0)
    return h0 | h1, t, u, v, ng
