"""Line segments: round (tangent cone + end spheres) and flat (ray-facing).

Port of embree_tpu/ops/line.py:27-218:
- round: kernels/geometry/roundline_intersector.h. The surface is the cone
  tangent to the end spheres p0/r0 and p1/r1, united with the spheres; the
  begin sphere belongs to a segment only at the start of a chain, and hits
  inside a neighbor's capped cone are interior to the union.
- flat: kernels/geometry/line_intersector.h, closest approach in the plane
  perpendicular to the ray; Ng is the segment tangent.
"""
from __future__ import annotations

import math

import torch

from ..core.math import dot, fmax, fmin, sqrt_rn

SELF_INTERSECTION_AVOIDANCE = 2.0   # the reference's CMake default
_EPS = 1.19209290e-07


def intersect_round_line(org, dir, p0, r0, p1, r1, tnear, tfar,
                         begin_cap=True, neighbors=None):
    """Ray vs tangent cone-sphere segment. Returns (hit, t, u, v, ng).

    begin_cap: the begin sphere p0/r0 is part of this segment (only at the
    start of a chain; interior joints belong to the previous segment's end
    sphere). neighbors: optional (pL, rL, pR, rR), the far endpoints of the
    left and right neighbor segments (rL/rR < 0: absent); candidate hits
    inside a neighbor's capped cone are rejected.
    """
    dOdO = dot(dir, dir)
    rcp_dOdO = 1.0 / torch.clamp(dOdO, min=1e-30)
    center = 0.5 * (p0 + p1)
    dt = dot(center - org, dir) * rcp_dOdO
    o = org + dt[..., None] * dir

    dP = p1 - p0
    dPdP = dot(dP, dP)
    dr = r1 - r0
    r0dr = r0 * dr
    g = dPdP - dr * dr

    O = o - p0
    OdP = dot(O, dP)
    dOdP = dot(dir, dP)
    yp = OdP + r0dr

    # tangent cone (roundline_intersector.h:308-345)
    OO = dot(O, O)
    OdO = dot(dir, O)
    A = g * dOdO - dOdP * dOdP
    B = 2.0 * (g * OdO - dOdP * yp)
    C = g * OO - OdP * OdP - r0 * r0 * dPdP - 2.0 * r0dr * OdP
    D = B * B - 4.0 * A * C
    cone_ok = (D >= 0.0) & (g > 0.0) & (A.abs() > 1e-18)
    Q = sqrt_rn(torch.clamp(D, min=0.0))
    rcp2A = 1.0 / torch.where(cone_ok, 2.0 * A, torch.ones_like(A))
    tcf = (-B - Q) * rcp2A
    tcb = (-B + Q) * rcp2A
    ycf = yp + tcf * dOdP
    ycb = yp + tcb * dOdP
    cf_ok = cone_ok & (ycf > -_EPS) & (ycf <= g)
    cb_ok = cone_ok & (ycb > -_EPS) & (ycb <= g)

    def sphere(c, r):
        O1 = o - c
        O1dO = dot(O1, dir)
        h2 = O1dO * O1dO - dOdO * (dot(O1, O1) - r * r)
        rt = sqrt_rn(torch.clamp(h2, min=0.0))
        return h2 >= 0.0, (-O1dO - rt) * rcp_dOdO, (-O1dO + rt) * rcp_dOdO

    s0_ok, ts0f, ts0b = sphere(p0, r0)
    s1_ok, ts1f, ts1b = sphere(p1, r1)
    s0_ok = s0_ok & begin_cap
    # sphere hits inside the cone's y-range belong to the cone; the y > g
    # clip holds for degenerate cones too (roundline_intersector.h:557)
    s0f_ok = s0_ok & (yp + ts0f * dOdP < 0.0)
    s0b_ok = s0_ok & (yp + ts0b * dOdP < 0.0)
    s1f_ok = s1_ok & (yp + ts1f * dOdP > g)
    s1b_ok = s1_ok & (yp + ts1b * dOdP > g)

    if neighbors is not None:
        pL, rL, pR, rR = neighbors
        has_l = rL >= 0.0
        has_r = rR >= 0.0

        def inside_capped_cone(t_loc, c0, cN, rr0, rrN, hasN):
            """isInsideCappedCone (roundline_intersector.h:562-568)."""
            p = o + t_loc[..., None] * dir
            dPn = cN - c0
            dPnPn = dot(dPn, dPn)
            drn = rrN - rr0
            gn = dPnPn - drn * drn
            p0p = p - c0
            y = dot(p0p, dPn)
            cap0 = -rr0 * drn + _EPS
            cap1 = dPnPn - rrN * drn
            return (hasN & (y > cap0) & (y < cap1)
                    & (dot(p0p, p0p) * gn - y * y
                       < dPnPn * rr0 * rr0 + 2.0 * rr0 * drn * y))

        def not_interior(t_loc):
            return ~(inside_capped_cone(t_loc, p0, pL, r0, rL, has_l)
                     | inside_capped_cone(t_loc, p1, pR, r1, rR, has_r))

        def sph1_plane_ok(t_loc):
            # end-sphere hits are clipped by the right neighbor cone's
            # start plane only (isClippedByPlane, roundline_intersector.h:130)
            p = o + t_loc[..., None] * dir
            y = dot(p - p1, pR - p1)
            return ~(has_r & (y > -r1 * (rR - r1) + _EPS))

        cf_ok = cf_ok & not_interior(tcf)
        cb_ok = cb_ok & not_interior(tcb)
        s1f_ok = s1f_ok & sph1_plane_ok(ts1f)
        s1b_ok = s1b_ok & sph1_plane_ok(ts1b)

    # CSG interval union (roundline_intersector.h:584-600): the surface
    # interval is [min of the front roots, max of the back roots]
    t_lower = torch.full_like(tcf, math.inf)
    for tc, okc in ((tcf, cf_ok), (ts0f, s0f_ok), (ts1f, s1f_ok)):
        t_lower = torch.where(okc, torch.minimum(t_lower, tc), t_lower)
    t_upper = torch.full_like(tcf, -math.inf)
    for tc, okc in ((tcb, cb_ok), (ts0b, s0b_ok), (ts1b, s1b_ok)):
        t_upper = torch.where(okc, torch.maximum(t_upper, tc), t_upper)

    ok_lower = ((t_lower < math.inf) & (tnear <= dt + t_lower)
                & (dt + t_lower <= tfar))
    ok_upper = ((t_upper > -math.inf) & (tnear <= dt + t_upper)
                & (dt + t_upper <= tfar))
    hit = ok_lower | ok_upper
    t_loc = torch.where(ok_lower, t_lower, t_upper)
    # finite stand-in where no root exists keeps the unused branches finite
    t_loc = torch.where(hit, t_loc, torch.zeros_like(t_loc))
    t_best = torch.where(hit, dt + t_loc, math.inf)

    cone_first = (t_loc == tcf) | (t_loc == tcb)
    sph0_first = (t_loc == ts0f) | (t_loc == ts0b)
    y_at = yp + t_loc * dOdP
    h = O + t_loc[..., None] * dir
    ng_cone = g[..., None] * h - dP * y_at[..., None]
    ng_s1 = (o - p1) + t_loc[..., None] * dir
    ng = torch.where(cone_first[..., None], ng_cone,
                     torch.where(sph0_first[..., None], h, ng_s1))
    u = torch.where(cone_first,
                    torch.clamp(y_at / torch.clamp(g, min=1e-30), 0.0, 1.0),
                    torch.where(sph0_first, 0.0, 1.0))
    return hit, t_best, u, torch.zeros_like(u), ng


def intersect_flat_line(org, dir, p0, r0, p1, r1, tnear, tfar):
    """Ray-facing flat segment. Returns (hit, t, u, v, ng)."""
    dOdO = torch.clamp(dot(dir, dir), min=1e-30)
    inv_dOdO = 1.0 / dOdO
    v = p1 - p0
    w = p0 - org
    wv = dot(w, v) - dot(w, dir) * dot(v, dir) * inv_dOdO
    vv = dot(v, v) - dot(v, dir) * dot(v, dir) * inv_dOdO
    ok = vv > 1e-20
    u = torch.clamp(torch.where(ok, -wv / torch.where(ok, vv, 1.0), 0.0),
                    0.0, 1.0)
    m = w + u[..., None] * v
    md = dot(m, dir)
    t = md * inv_dOdO
    d2 = dot(m, m) - md * md * inv_dOdO
    r = r0 + u * (r1 - r0)
    # self-intersection avoidance (line_intersector.h:77), with 1/sqrt as
    # the traversal kernel takes it, so re-intersecting the kernel's hit
    # passes the same threshold
    t_min = SELF_INTERSECTION_AVOIDANCE * r * (1.0 / sqrt_rn(dOdO))
    hit = ((d2 <= r * r) & (t >= tnear) & (t <= tfar) & (t > t_min)
           # degenerate segments never hit (line_intersector.h:82-84)
           & (v != 0.0).any(-1))
    ng = torch.broadcast_to(v, m.shape)
    return hit, torch.where(hit, t, math.inf), u, torch.zeros_like(u), ng


def line_bounds(p0, r0, p1, r1):
    """Per-segment AABBs over both end spheres (embree_tpu/ops/line.py:215)."""
    lo = fmin(p0 - r0[..., None], p1 - r1[..., None])
    up = fmax(p0 + r0[..., None], p1 + r1[..., None])
    return lo, up
