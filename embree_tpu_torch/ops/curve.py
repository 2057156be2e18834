"""Cubic curve bases, the Bezier conversion, the flat-curve ribbon test and
the tessellation into line segments.

Port of embree_tpu/ops/curve.py:26-136 (bases, evaluation, ``to_bezier``),
:146-163 (``_ray_frame``), :166 and :214-297 (``intersect_ribbon``) and
:606-625 (``tessellate_segments``); behavior parity with the reference's
kernels/subdiv/{bezier,bspline,hermite,catmullrom}_curve.h and
kernels/geometry/curve_intersector_ribbon.h. Plain torch functions on
tensors, differentiable like ops/line.py. Sums are written out term by term
in one fixed order, as core/math.py does. The round (swept-circle),
oriented and distance intersectors wait for the generic engine.
"""
from __future__ import annotations

import numpy as np
import torch

BASIS_LINEAR = "linear"
BASIS_BEZIER = "bezier"
BASIS_BSPLINE = "bspline"
BASIS_HERMITE = "hermite"
BASIS_CATMULL_ROM = "catmull_rom"

SELF_INTERSECTION_AVOIDANCE = 2.0   # the reference's CMake default


def _bezier_weights(t):
    s = 1.0 - t
    return (s * s * s, 3 * s * s * t, 3 * s * t * t, t * t * t)


def _bspline_weights(t):
    t2, t3 = t * t, t * t * t
    return ((1 - 3 * t + 3 * t2 - t3) / 6.0,
            (4 - 6 * t2 + 3 * t3) / 6.0,
            (1 + 3 * t + 3 * t2 - 3 * t3) / 6.0,
            t3 / 6.0)


def _catmull_rom_weights(t):
    t2, t3 = t * t, t * t * t
    return (0.5 * (-t + 2 * t2 - t3),
            0.5 * (2 - 5 * t2 + 3 * t3),
            0.5 * (t + 4 * t2 - 3 * t3),
            0.5 * (-t2 + t3))


def _hermite_weights(t):
    """Hermite control data is (p0, m0, p1, m1)."""
    t2, t3 = t * t, t * t * t
    return (2 * t3 - 3 * t2 + 1,
            t3 - 2 * t2 + t,
            -2 * t3 + 3 * t2,
            t3 - t2)


_WEIGHTS = {
    BASIS_BEZIER: _bezier_weights,
    BASIS_BSPLINE: _bspline_weights,
    BASIS_CATMULL_ROM: _catmull_rom_weights,
    BASIS_HERMITE: _hermite_weights,
}


def _combine(w, cp):
    """sum_k w[k] * cp[..., k, :], left to right; w: weights (...)."""
    acc = w[0][..., None] * cp[..., 0, :]
    for k in range(1, len(w)):
        acc = acc + w[k][..., None] * cp[..., k, :]
    return acc


def eval_curve(basis: str, cp, t):
    """Evaluate a curve at parameter t. cp: (..., 4, C) control data
    (hermite: p0, m0, p1, m1); t: (...,). Returns (..., C)."""
    if basis == BASIS_LINEAR:
        return (cp[..., 0, :] * (1 - t)[..., None]
                + cp[..., 1, :] * t[..., None])
    return _combine(_WEIGHTS[basis](t), cp)


# Every cubic basis converts exactly to Bezier control points of the same
# span (a linear map), so the intersectors handle Bezier only.
_TO_BEZIER = {
    BASIS_BEZIER: np.eye(4, dtype=np.float32),
    # uniform cubic B-spline
    BASIS_BSPLINE: np.array([[1, 4, 1, 0], [0, 4, 2, 0],
                             [0, 2, 4, 0], [0, 1, 4, 1]], np.float32) / 6.0,
    # Catmull-Rom (p0..p3, the curve runs from p1 to p2)
    BASIS_CATMULL_ROM: np.array(
        [[0, 6, 0, 0], [-1, 6, 1, 0], [0, 1, 6, -1], [0, 0, 6, 0]],
        np.float32) / 6.0,
    # Hermite (p0, m0, p1, m1)
    BASIS_HERMITE: np.array([[3, 0, 0, 0], [3, 1, 0, 0],
                             [0, 0, 3, -1], [0, 0, 3, 0]], np.float32) / 3.0,
}


def to_bezier(basis: str, cp):
    """Convert (..., 4, C) control data of a cubic basis to Bezier CPs."""
    m = _TO_BEZIER[basis]
    rows = []
    for i in range(4):
        acc = float(m[i, 0]) * cp[..., 0, :]
        for j in range(1, 4):
            acc = acc + float(m[i, j]) * cp[..., j, :]
        rows.append(acc)
    return torch.stack(rows, dim=-2)


def eval_bezier(cp, u):
    """Evaluate Bezier (..., 4, C) at u (...,) -> (..., C)."""
    return _combine(_bezier_weights(u), cp)


def eval_bezier_du(cp, u):
    """Exact derivative: 3 * sum (b[i+1] - b[i]) * B2_i(u)."""
    d = 3.0 * (cp[..., 1:, :] - cp[..., :-1, :])      # (..., 3, C)
    s = 1.0 - u
    return _combine((s * s, 2 * s * u, u * u), d)


def _sum3(a):
    return a[..., 0] + a[..., 1] + a[..., 2]


def _ray_frame(dir):
    """The reference's curve ray space (curve_intersector_precalculations.h:
    depth_scale = 1 / |d|; rows = frame(normalize(d)) with the z row
    scaled by depth_scale). Returns (vx, vy, vz_scaled, depth_scale)."""
    ds = 1.0 / torch.sqrt(torch.clamp(_sum3(dir * dir), min=1e-36))[..., None]
    n = dir * ds
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    zero = torch.zeros_like(nx)
    dx0 = torch.cat([zero, nz, -ny], -1)
    dx1 = torch.cat([-nz, zero, nx], -1)
    pick = (_sum3(dx0 * dx0) > _sum3(dx1 * dx1))[..., None]
    dx = torch.where(pick, dx0, dx1)
    dx = dx / torch.sqrt(torch.clamp(_sum3(dx * dx), min=1e-36))[..., None]
    dy = torch.cross(n, dx, dim=-1)
    dy = dy / torch.sqrt(torch.clamp(_sum3(dy * dy), min=1e-36))[..., None]
    return dx, dy, n * ds, ds[..., 0]


def intersect_ribbon(org, dir, cp, tnear, tfar, n_seg: int = 4):
    """Flat-curve ribbon test (curve_intersector_ribbon.h:73-177): the
    Bezier CPs into ray space, n_seg ruled quads between the +-r offset
    curves, backface-culling 2D quad tests, u along the curve, v across
    [-1, 1], Ng the 3D curve tangent.

    org/dir (..., 3); cp (..., 4, 4) world-space Bezier xyz+r; tnear/tfar
    (...,); n_seg is the geometry's tessellation rate. Returns
    (hit, t, u, v, ng)."""
    vx, vy, vz, ds = _ray_frame(dir)
    rel = cp[..., :3] - org[..., None, :]
    cx = _sum3(rel * vx[..., None, :])
    c2 = torch.stack([cx, _sum3(rel * vy[..., None, :]),
                      _sum3(rel * vz[..., None, :]),
                      cp[..., 3].expand(cx.shape)], -1)
    eps = (4.0 * 1.19209290e-07) * c2.abs().amax(dim=(-1, -2))

    ts = torch.from_numpy(np.linspace(0.0, 1.0, n_seg + 1, dtype=np.float32))
    uk = ts.to(cp.device).expand(c2.shape[:-2] + (n_seg + 1,))
    pk = eval_bezier(c2[..., None, :, :], uk)           # (..., n_seg+1, 4)
    dk = eval_bezier_du(c2[..., None, :, :], uk)
    small = dk[..., :3].abs().amax(-1) < eps[..., None]
    seg_d = pk[..., 1:, :] - pk[..., :-1, :]            # (..., n_seg, 4)
    d0 = torch.where(small[..., :-1, None], seg_d[..., :3], dk[..., :-1, :3])
    d1 = torch.where(small[..., 1:, None], seg_d[..., :3], dk[..., 1:, :3])
    p0, p1 = pk[..., :-1, :], pk[..., 1:, :]

    # cylinder culling against the 2D origin (ribbon.h:66-71)
    num = seg_d[..., 0] * p0[..., 1] - seg_d[..., 1] * p0[..., 0]
    den2 = seg_d[..., 0] ** 2 + seg_d[..., 1] ** 2
    rmax = torch.maximum(p0[..., 3], p1[..., 3])
    valid = num * num <= rmax * rmax * den2

    def offs(p, dpdt):
        n = torch.stack([dpdt[..., 1], -dpdt[..., 0],
                         torch.zeros_like(dpdt[..., 0])], -1)
        nn = n / torch.sqrt(torch.clamp(_sum3(n * n), min=1e-36))[..., None]
        return p[..., :3] + p[..., 3:4] * nn, p[..., :3] - p[..., 3:4] * nn

    lp0, up0 = offs(p0, d0)
    lp1, up1 = offs(p1, d1)

    # quad (lp0, lp1, up1, up0) vs the ray (O = 0, D = +z), the
    # backface-culling variant (quad_intersector.h:15-74)
    va, vb, vc, vd = lp0, lp1, up1, up0
    edb = vb - vd
    ww = vd[..., 0] * edb[..., 1] - vd[..., 1] * edb[..., 0]
    sel = ww <= 0.0
    v0 = torch.where(sel[..., None], va, vc)
    v1 = torch.where(sel[..., None], vb, vd)
    v2 = torch.where(sel[..., None], vd, vb)
    e0 = v2 - v0
    e1 = v0 - v1
    uu = v0[..., 0] * e0[..., 1] - v0[..., 1] * e0[..., 0]
    vv = v1[..., 0] * e1[..., 1] - v1[..., 1] * e1[..., 0]
    valid = valid & (torch.maximum(uu, vv) <= 0.0)
    ng2 = torch.cross(e1, e0, dim=-1)
    den = ng2[..., 2]
    rcp_den = torch.where(den != 0.0,
                          1.0 / torch.where(den == 0, torch.ones_like(den),
                                            den),
                          torch.zeros_like(den))
    t = rcp_den * _sum3(v0 * ng2)
    valid = (valid & (tnear[..., None] <= t) & (t <= tfar[..., None])
             & (den != 0.0))
    uq = torch.where(sel, uu * rcp_den, 1.0 - uu * rcp_den)
    vq = torch.where(sel, vv * rcp_den, 1.0 - vv * rcp_den)
    # self-intersection avoidance (ribbon.h:117-120)
    r_at = p0[..., 3] * (1 - uq) + p1[..., 3] * uq
    valid = valid & (t > SELF_INTERSECTION_AVOIDANCE * r_at * ds[..., None])

    u_full = (torch.arange(n_seg, dtype=uq.dtype, device=uq.device)
              + uq) / n_seg
    v_full = 2.0 * vq - 1.0
    tbig = torch.where(valid, t, torch.full_like(t, float("inf")))
    best = tbig.argmin(dim=-1, keepdim=True)
    hit = valid.gather(-1, best)[..., 0]
    t_o = t.gather(-1, best)[..., 0]
    u_o = u_full.gather(-1, best)[..., 0]
    v_o = v_full.gather(-1, best)[..., 0]
    ng = eval_bezier_du(cp, u_o)[..., :3]               # world tangent = Ng
    return hit, t_o, u_o, v_o, ng


def curve_knots(n: int):
    """n + 1 knots over [0, 1] as the JAX package's jnp.linspace rounds them
    (i * float32(1 / n), the last exactly 1)."""
    ts = torch.arange(n + 1, dtype=torch.float32) * (np.float32(1.0)
                                                     / np.float32(n))
    ts[-1] = 1.0
    return ts


def tessellate_segments(basis: str, cp, n_sub: int):
    """Tessellate each curve into n_sub linear (p, r) sub-segments.

    cp: (n_curves, 4, 4) control points (x, y, z, radius). Returns p0, r0,
    p1, r1 ((n_curves * n_sub, ...) endpoints with radii) and u0, u1 (the
    curve-parameter range of each sub-segment)."""
    ts = curve_knots(n_sub).to(cp.device)
    pts = eval_curve(basis, cp[:, None, :, :],
                     ts.expand(cp.shape[0], n_sub + 1))
    p = pts[..., :3]                                    # (n, n_sub+1, 3)
    r = torch.clamp(pts[..., 3], min=0.0)
    return (p[:, :-1].reshape(-1, 3), r[:, :-1].reshape(-1),
            p[:, 1:].reshape(-1, 3), r[:, 1:].reshape(-1),
            ts[:-1].expand(cp.shape[0], n_sub).reshape(-1),
            ts[1:].expand(cp.shape[0], n_sub).reshape(-1))
