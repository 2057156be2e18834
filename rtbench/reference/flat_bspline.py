"""Flat cubic B-spline curves: Embree's ribbon intersector
(curve_intersector_ribbon.h, quad_intersector.h) on the curve's Bezier
control points, in the ray's curve frame.

- Each curve is four consecutive control points (x, y, z, radius) from its
  index; the uniform B-spline converts to Bezier by
  [[1,4,1,0],[0,4,2,0],[0,2,4,0],[0,1,4,1]] / 6 (radius included).
- The ray frame (curve_intersector_precalculations.h): ds = 1 / |d|,
  n = d ds; x axis (0, n_z, -n_y) or (-n_z, 0, n_x), the longer,
  normalized; y = normalize(n x x); z = n ds. Control points go to
  (rel . x, rel . y, rel . z, r), rel = P - o.
- ``rate`` segments between the knots k / rate: at each knot the point and
  the derivative; where the derivative's largest component is below
  eps = 4 * 2^-23 * max |ray-space control values|, the segment's chord
  stands in for it. A segment is culled where the 2D origin lies farther
  from its chord's line than the larger knot radius.
- The segment's quad has corners p0 +- r0 n0 and p1 +- r1 n1, n the unit
  2D normal of the derivative; it is split along the diagonal (lp1, up0)
  at the side the origin falls on, and the half tested in 2D with
  backface culling (both edge functions <= 0). t = (v0 . Ng) / Ng_z for
  Ng = e1 x e0; accepted where tnear <= t <= tfar and t > 2 r(u) ds
  (self-intersection avoidance at the CMake default 2).
- u = (segment + u_quad) / rate along the curve, v = 2 v_quad - 1 across
  it, Ng = the world-space Bezier derivative at u; the nearest accepted
  segment of the nearest curve wins.
"""
from __future__ import annotations

import torch

from . import common

EPS_FACTOR = 4.0 * 1.19209290e-07
SELF_INTERSECTION = 2.0
TO_BEZIER = [[1, 4, 1, 0], [0, 4, 2, 0], [0, 2, 4, 0], [0, 1, 4, 1]]


def _bezier(cp, u):
    """Point of Bezier control values cp (..., 4, C) at u (...,)."""
    s = 1 - u
    w = (s * s * s, 3 * s * s * u, 3 * s * u * u, u * u * u)
    return sum(w[k][..., None] * cp[..., k, :] for k in range(4))


def _bezier_du(cp, u):
    s = 1 - u
    w = (s * s, 2 * s * u, u * u)
    return 3 * sum(w[k][..., None] * (cp[..., k + 1, :] - cp[..., k, :])
                   for k in range(3))


def prepare(arrays: dict, device) -> dict:
    v = torch.as_tensor(arrays["vertices"], device=device)
    i = torch.as_tensor(arrays["indices"], device=device).long()
    rate = int(arrays["rate"])
    bsp = v[i[:, None] + torch.arange(4, device=device)]   # (C, 4, 4)
    m = torch.tensor(TO_BEZIER, dtype=torch.float64, device=device) / 6
    bez = torch.einsum("ij,cjk->cik", m, bsp.double())
    # bounding spheres of each segment's quads: chord midpoint, half chord
    # plus the larger knot radius
    u = torch.arange(rate + 1, dtype=torch.float64, device=device) / rate
    knots = _bezier(bez[:, None], u[None].expand(bez.shape[0], -1))
    a, b = knots[:, :-1], knots[:, 1:]
    center = (a[..., :3] + b[..., :3]) / 2
    radius = (torch.linalg.vector_norm(b[..., :3] - a[..., :3], dim=-1) / 2
              + torch.maximum(a[..., 3], b[..., 3]).abs())
    radius = radius * (1 + 1e-6) + 1e-7
    return {"bspline": bsp, "rate": rate,
            "center": center.reshape(-1, 3).float(),
            "radius": radius.reshape(-1).float()}


def _frame(d):
    ds = 1 / torch.linalg.vector_norm(d, dim=1).clamp(min=1e-18)
    n = d * ds[:, None]
    z = torch.zeros_like(n[:, 0])
    x0 = torch.stack([z, n[:, 2], -n[:, 1]], 1)
    x1 = torch.stack([-n[:, 2], z, n[:, 0]], 1)
    x = torch.where(((x0 * x0).sum(1) > (x1 * x1).sum(1))[:, None], x0, x1)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    y = torch.linalg.cross(n, x)
    y = y / torch.linalg.vector_norm(y, dim=1, keepdim=True)
    return x, y, n * ds[:, None], ds


def _test(prep, ray, seg, org, dir, tnear, tfar, dtype):
    rate = prep["rate"]
    curve, k = seg // rate, seg % rate
    m = torch.tensor(TO_BEZIER, dtype=dtype, device=org.device) / 6
    bez = torch.einsum("ij,cjk->cik", m, prep["bspline"][curve].to(dtype))
    o, d = org[ray].to(dtype), dir[ray].to(dtype)
    fx, fy, fz, ds = _frame(d)
    rel = bez[..., :3] - o[:, None]
    c2 = torch.stack([(rel * fx[:, None]).sum(-1),
                      (rel * fy[:, None]).sum(-1),
                      (rel * fz[:, None]).sum(-1), bez[..., 3]], -1)
    eps = EPS_FACTOR * c2.abs().amax(dim=(1, 2))
    u0 = k.to(dtype) / rate
    u1 = (k + 1).to(dtype) / rate
    p0, p1 = _bezier(c2, u0), _bezier(c2, u1)
    g0, g1 = _bezier_du(c2, u0), _bezier_du(c2, u1)
    chord = p1 - p0
    d0 = torch.where((g0[:, :3].abs().amax(1) < eps)[:, None],
                     chord[:, :3], g0[:, :3])
    d1 = torch.where((g1[:, :3].abs().amax(1) < eps)[:, None],
                     chord[:, :3], g1[:, :3])
    num = chord[:, 0] * p0[:, 1] - chord[:, 1] * p0[:, 0]
    rmax = torch.maximum(p0[:, 3], p1[:, 3])
    ok = num * num <= rmax * rmax * (chord[:, 0] ** 2 + chord[:, 1] ** 2)

    def offsets(p, g):
        nrm = torch.stack([g[:, 1], -g[:, 0], torch.zeros_like(g[:, 0])], 1)
        nrm = nrm / torch.linalg.vector_norm(nrm, dim=1,
                                             keepdim=True).clamp(min=1e-18)
        return p[:, :3] + p[:, 3:] * nrm, p[:, :3] - p[:, 3:] * nrm

    lp0, up0 = offsets(p0, d0)
    lp1, up1 = offsets(p1, d1)
    diag = lp1 - up0
    side = (up0[:, 0] * diag[:, 1] - up0[:, 1] * diag[:, 0] <= 0)[:, None]
    v0 = torch.where(side, lp0, up1)
    v1 = torch.where(side, lp1, up0)
    v2 = torch.where(side, up0, lp1)
    e0 = v2 - v0
    e1 = v0 - v1
    uu = v0[:, 0] * e0[:, 1] - v0[:, 1] * e0[:, 0]
    vv = v1[:, 0] * e1[:, 1] - v1[:, 1] * e1[:, 0]
    ok &= torch.maximum(uu, vv) <= 0
    ng = torch.linalg.cross(e1, e0)
    den_ok = ng[:, 2] != 0
    rden = 1 / torch.where(den_ok, ng[:, 2], torch.ones_like(ng[:, 2]))
    t = (v0 * ng).sum(1) * rden
    ok &= den_ok & (t >= tnear[ray].to(dtype)) & (t <= tfar[ray].to(dtype))
    uq = torch.where(side[:, 0], uu * rden, 1 - uu * rden)
    vq = torch.where(side[:, 0], vv * rden, 1 - vv * rden)
    r_at = p0[:, 3] * (1 - uq) + p1[:, 3] * uq
    ok &= t > SELF_INTERSECTION * r_at * ds
    u = (k.to(dtype) + uq) / rate
    ngw = _bezier_du(bez[..., :3], u)
    return ok, t, u, 2 * vq - 1, ngw


def _accepted(prep, org, dir, tnear, tfar, dtype):
    ray, seg = common.candidates(prep["center"], prep["radius"], org, dir,
                                 tnear)
    out = []
    for s in common.blocks(ray.shape[0]):
        ok, t, u, v, ng = _test(prep, ray[s], seg[s], org, dir, tnear,
                                tfar, dtype)
        out.append((ray[s][ok], seg[s][ok], t[ok], u[ok], v[ok], ng[ok]))
    if not out:
        e = torch.zeros(0, dtype=dtype, device=org.device)
        i = torch.zeros(0, dtype=torch.int64, device=org.device)
        return i, i, e, e, e, e.reshape(0, 3)
    return tuple(torch.cat(x) for x in zip(*out))


def closest(prep, org, dir, tnear, tfar, dtype) -> dict:
    ray, seg, t, u, v, ng = _accepted(prep, org, dir, tnear, tfar, dtype)
    valid, t, a = common.nearest(org.shape[0], ray, seg, t,
                                 {"u": u, "v": v, "ng": ng, "seg": seg},
                                 dtype)
    prim = torch.where(valid, a["seg"] // prep["rate"], -1)
    return {"valid": valid, "t": t, "u": a["u"], "v": a["v"], "ng": a["ng"],
            "prim": prim}


def any_hit(prep, org, dir, tnear, tfar, dtype):
    ray = _accepted(prep, org, dir, tnear, tfar, dtype)[0]
    hit = torch.zeros(org.shape[0], dtype=torch.bool, device=org.device)
    hit[ray] = True
    return hit
