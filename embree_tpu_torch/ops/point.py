"""Point primitives: sphere, ray-facing disc, oriented disc.

Port of embree_tpu/ops/point.py:15-60 (kernels/geometry/
sphere_intersector.h, disc_intersector.h). Points are (center, radius).
"""
from __future__ import annotations

import torch

from ..core.math import dot, sqrt_rn


def _safe_div(a, b, ok):
    """a / b where ok, with a finite gradient where not."""
    return a / torch.where(ok, b, torch.ones_like(b))


def intersect_sphere(org, dir, center, radius, tnear, tfar):
    """Nearest root in [tnear, tfar], else the far root (ray from inside)."""
    oc = org - center
    a = dot(dir, dir)
    b = 2.0 * dot(oc, dir)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4 * a * c
    ok = disc >= 0
    sq = sqrt_rn(torch.clamp(disc, min=0.0))
    inv2a = 1.0 / torch.clamp(2 * a, min=1e-30)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t0_valid = ok & (t0 >= tnear) & (t0 <= tfar)
    t1_valid = ok & (t1 >= tnear) & (t1 <= tfar)
    t = torch.where(t0_valid, t0, t1)
    ng = org + dir * t[..., None] - center
    z = torch.zeros_like(t)
    return t0_valid | t1_valid, t, z, z, ng


def intersect_disc(org, dir, center, radius, tnear, tfar):
    """Disc through the center, facing the ray (disc_intersector.h)."""
    t = dot(center - org, dir) / torch.clamp(dot(dir, dir), min=1e-30)
    p = org + dir * t[..., None]
    r2 = dot(p - center, p - center)
    hit = (t >= tnear) & (t <= tfar) & (r2 <= radius * radius)
    z = torch.zeros_like(t)
    return hit, t, z, z, torch.broadcast_to(-dir, p.shape)


def intersect_oriented_disc(org, dir, center, radius, normal, tnear, tfar):
    """Disc with an explicit normal (ORIENTED_DISC_POINT)."""
    den = dot(dir, normal)
    ok = den.abs() > 1e-12
    t = _safe_div(dot(center - org, normal), den, ok)
    p = org + dir * t[..., None]
    r2 = dot(p - center, p - center)
    hit = ok & (t >= tnear) & (t <= tfar) & (r2 <= radius * radius)
    z = torch.zeros_like(t)
    return hit, t, z, z, torch.broadcast_to(normal, p.shape)
