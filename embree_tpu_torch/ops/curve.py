"""Cubic curve bases, the Bezier conversion, the native curve intersectors
and the tessellation into line segments.

Port of embree_tpu/ops/curve.py:20-143 (``_rsqrt``, bases, evaluation,
``to_bezier``, the Bezier derivatives), :146-163 (``_ray_frame``), :166-297
(``intersect_distance``, ``intersect_ribbon``), :300-603
(``intersect_sweep``, ``intersect_oriented``) and :606-625
(``tessellate_segments``); behavior parity with the reference's
kernels/subdiv/{bezier,bspline,hermite,catmullrom}_curve.h and
kernels/geometry/curve_intersector_{ribbon,sweep,oriented,distance}.h.
Plain torch functions on tensors, differentiable like ops/line.py. Sums are
written out term by term in one fixed order, as core/math.py does; an
argmin over seeds or segments takes the first minimum, as jnp.argmin does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import cross, sqrt_rn


def _rsqrt(x):
    """1 / sqrt(x), correctly rounded (the JAX package's ``_rsqrt``: an
    approximate reciprocal square root defeats the Newton solvers'
    ulp-scale convergence tests)."""
    return 1.0 / sqrt_rn(x)


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


def eval_curve(basis: str, cp, t, pairwise: bool = True):
    """Evaluate a curve at parameter t. cp: (..., 4, C) control data
    (hermite: p0, m0, p1, m1); t: (...,). Returns (..., C). The four
    products sum pairwise, (0 + 1) + (2 + 3), as XLA's dot does in the JAX
    package's einsum over the tessellation knots, so tessellated segments
    are bit-equal; ``pairwise=False`` sums them in order, as XLA does the
    batched einsum of one parameter per curve (interpolate.py)."""
    if basis == BASIS_LINEAR:
        return (cp[..., 0, :] * (1 - t)[..., None]
                + cp[..., 1, :] * t[..., None])
    w = _WEIGHTS[basis](t)
    a = [w[k][..., None] * cp[..., k, :] for k in range(4)]
    if not pairwise:
        return a[0] + a[1] + a[2] + a[3]
    return (a[0] + a[1]) + (a[2] + a[3])


def eval_curve_derivative(basis: str, cp, t, eps=1e-4):
    """Tangent by central differences (embree_tpu/ops/curve.py:92; enough
    for tessellation normals). One parameter per curve: the four products
    sum in order, as XLA's batched einsum does."""
    f0 = eval_curve(basis, cp, torch.clamp(t - eps, 0.0, 1.0), False)
    f1 = eval_curve(basis, cp, torch.clamp(t + eps, 0.0, 1.0), False)
    return (f1 - f0) / (2 * eps)


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
    """Convert (..., 4, C) control data of a cubic basis to Bezier CPs.
    Each row sums its four products pairwise, (0 + 1) + (2 + 3), as XLA's
    dot does in the JAX package's einsum, so the CPs are bit-equal."""
    m = _TO_BEZIER[basis]
    rows = []
    for i in range(4):
        a = [float(m[i, j]) * cp[..., j, :] for j in range(4)]
        rows.append((a[0] + a[1]) + (a[2] + a[3]))
    return torch.stack(rows, dim=-2)


def eval_bezier(cp, u, pairwise: bool = False):
    """Evaluate Bezier (..., 4, C) at u (...,) -> (..., C). ``pairwise``:
    sum the four products as (0 + 1) + (2 + 3), as XLA's dot does where
    the JAX package's einsum evaluates one curve at many parameters (the
    knots or seeds of a curve: cp broadcast over u's last axis); where each
    curve takes one parameter it sums left to right."""
    if not pairwise:
        return _combine(_bezier_weights(u), cp)
    a = [w[..., None] * cp[..., k, :]
         for k, w in enumerate(_bezier_weights(u))]
    return (a[0] + a[1]) + (a[2] + a[3])


def eval_bezier_du(cp, u):
    """Exact derivative: 3 * sum (b[i+1] - b[i]) * B2_i(u)."""
    d = 3.0 * (cp[..., 1:, :] - cp[..., :-1, :])      # (..., 3, C)
    s = 1.0 - u
    return _combine((s * s, 2 * s * u, u * u), d)


def eval_bezier_ddu(cp, u):
    """Second derivative: 6 * sum (b[i+2] - 2 b[i+1] + b[i]) * B1_i(u)."""
    d = 6.0 * (cp[..., 2:, :] - 2 * cp[..., 1:-1, :] + cp[..., :-2, :])
    return _combine((1.0 - u, u), d)


def _sum3(a):
    return a[..., 0] + a[..., 1] + a[..., 2]


def _sum4(a):
    return a[..., 0] + a[..., 1] + a[..., 2] + a[..., 3]


def _first_min(x):
    """(..., n) -> (..., 1) index of the first minimum (jnp.argmin)."""
    return x.argmin(dim=-1, keepdim=True)


def _pick(x, best):
    return x.gather(-1, best)[..., 0]


def _ray_frame(dir):
    """The reference's curve ray space (curve_intersector_precalculations.h:
    depth_scale = 1 / |d|; rows = frame(normalize(d)) with the z row
    scaled by depth_scale). Returns (vx, vy, vz_scaled, depth_scale)."""
    ds = 1.0 / sqrt_rn(torch.clamp(_sum3(dir * dir), min=1e-36))[..., None]
    n = dir * ds
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    zero = torch.zeros_like(nx)
    dx0 = torch.cat([zero, nz, -ny], -1)
    dx1 = torch.cat([-nz, zero, nx], -1)
    pick = (_sum3(dx0 * dx0) > _sum3(dx1 * dx1))[..., None]
    dx = torch.where(pick, dx0, dx1)
    dx = dx / sqrt_rn(torch.clamp(_sum3(dx * dx), min=1e-36))[..., None]
    dy = cross(n, dx)
    dy = dy / sqrt_rn(torch.clamp(_sum3(dy * dy), min=1e-36))[..., None]
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
    pk = eval_bezier(c2[..., None, :, :], uk, True)     # (..., n_seg+1, 4)
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
        nn = n / sqrt_rn(torch.clamp(_sum3(n * n), min=1e-36))[..., None]
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
    ng2 = cross(e1, e0)
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

    u_full = _per_seg(torch.arange(n_seg, dtype=uq.dtype, device=uq.device)
                      + uq, n_seg)
    v_full = 2.0 * vq - 1.0
    tbig = torch.where(valid, t, torch.full_like(t, float("inf")))
    best = tbig.argmin(dim=-1, keepdim=True)
    hit = valid.gather(-1, best)[..., 0]
    t_o = t.gather(-1, best)[..., 0]
    u_o = u_full.gather(-1, best)[..., 0]
    v_o = v_full.gather(-1, best)[..., 0]
    ng = eval_bezier_du(cp, u_o)[..., :3]               # world tangent = Ng
    return hit, t_o, u_o, v_o, ng


def _seg_knots(n_seg, like):
    """The n_seg + 1 knots of np.linspace(0, 1, n_seg + 1) in float32."""
    ts = np.linspace(0.0, 1.0, n_seg + 1, dtype=np.float32)
    return torch.from_numpy(ts).to(like.device)


def _seg_index(n_seg, like):
    return torch.arange(n_seg, dtype=torch.float32, device=like.device)


def _per_seg(x, n_seg):
    """x / n_seg, divided exactly on every device (PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal)."""
    return x / torch.full((), float(n_seg), device=x.device)


def intersect_distance(org, dir, cp, tnear, tfar, n_seg: int = 8):
    """Distance curve test (curve_intersector_distance.h:86-180): the
    ray-space curve as n_seg linear segments, the closest 2D approach of
    each, a hit where the squared distance is within the interpolated
    radius; t = p.z * depth_scale, v = 0, u = (i + u_local) / n_seg, Ng the
    curve tangent, and the self-intersection rejection t > 2 r ds.

    cp: (..., 4, 4) world-space Bezier xyz+r. Returns (hit, t, u, v, ng)."""
    dx, dy, dzs, ds = _ray_frame(dir)
    rel = cp[..., :3] - org[..., None, :]
    px = _sum3(rel * dx[..., None, :])
    cp2 = torch.stack([px, _sum3(rel * dy[..., None, :]),
                       _sum3(rel * dzs[..., None, :]),
                       cp[..., 3].expand(px.shape)], -1)
    uk = _seg_knots(n_seg, cp).expand(cp.shape[:-2] + (n_seg + 1,))
    pk = eval_bezier(cp2[..., None, :, :], uk, True)    # (..., n_seg+1, 4)
    p0 = pk[..., :-1, :]
    p1 = pk[..., 1:, :]
    v = p1 - p0
    w = -p0
    d0 = w[..., 0] * v[..., 0] + w[..., 1] * v[..., 1]
    d1 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
    u = torch.clamp(d0 / torch.where(d1.abs() > 1e-30, d1,
                                     torch.ones_like(d1)), 0.0, 1.0)
    p = p0 + u[..., None] * v
    t = p[..., 2] * ds[..., None]
    d2 = p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
    r = p[..., 3]
    ok = ((d2 <= r * r) & (tnear[..., None] <= t) & (t <= tfar[..., None])
          & (t > SELF_INTERSECTION_AVOIDANCE * r * ds[..., None]))
    u_full = _per_seg(_seg_index(n_seg, u) + u, n_seg)
    best = _first_min(torch.where(ok, t, torch.full_like(t, float("inf"))))
    u_o = _pick(u_full, best)
    ng = eval_bezier_du(cp, u_o)[..., :3]
    return _pick(ok, best), _pick(t, best), u_o, torch.zeros_like(u_o), ng


_ERR = 16.0 * 1.19209290e-07      # the sweep's error-bound factor


def intersect_sweep(org, dir, cp, tnear, tfar, n_seg: int = 16,
                    n_iter: int = 5):
    """Round-curve swept-circle test: the reference's Jacobian Newton solve
    (curve_intersector_sweep.h:59-141) from 2 n_seg seeds per ray, an
    entry-side and an exit-side bank at each of n_seg uniform u; the
    nearest root accepted within [tnear, tfar] and u in [0, 1] wins, with
    Ng = cross(V, U) at it (sweep.h:133-137).

    cp: (..., 4, 4) world-space Bezier xyz+r. Returns (hit, t, u, v = 0,
    ng); the seeds take (..., 2 n_seg) memory per intermediate."""
    d2 = _sum3(dir * dir)
    # recenter the ray near the curve for float32 robustness (the dt shift)
    center = _sum4(cp[..., :3].transpose(-1, -2)) / 4
    dt = _sum3((center - org) * dir) / torch.clamp(d2, min=1e-36)
    org_c = org + dt[..., None] * dir
    rel = torch.cat([cp[..., :3] - org_c[..., None, :], cp[..., 3:]], -1)
    box_max = rel.abs().amax(dim=(-1, -2))
    p_err = _ERR * box_max
    len_dir = sqrt_rn(torch.clamp(d2, min=1e-36))

    useed = _per_seg(_seg_index(n_seg, cp) + 0.5, n_seg)
    u = useed.expand(org.shape[:-1] + (n_seg,))
    # t seed: closest approach of the recentered ray to P(u_seed), pulled
    # back toward the entry root by the expected half-chord (and a second
    # bank pushed forward to the exit root, for origins inside the curve)
    relx = rel[..., None, :, :]
    pu = eval_bezier(relx, u, True)
    d2e = torch.clamp(d2[..., None], min=1e-36)
    t = _sum3(pu[..., :3] * dir[..., None, :]) / d2e
    r0v = t[..., None] * dir[..., None, :] - pu[..., :3]
    perp2 = _sum3(r0v * r0v)
    r0 = pu[..., 3]
    half_chord = sqrt_rn(torch.maximum(r0 * r0 - perp2, 0.25 * r0 * r0))
    hc = half_chord / sqrt_rn(d2e)
    u = torch.cat([u, u], -1)
    t = torch.cat([t - hc, t + hc], -1)

    dirn = dir[..., None, :]
    p_err1 = p_err[..., None]
    done = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    hit_t = torch.full_like(u, float("inf"))
    hit_u = torch.zeros_like(u)
    hit_f = torch.zeros_like(done)
    for _ in range(n_iter + 1):      # +1: accept roots found on the last step
        q = t[..., None] * dirn
        p4 = eval_bezier(relx, u, True)
        dp4 = eval_bezier_du(relx, u)
        ddp = eval_bezier_ddu(relx, u)[..., :3]
        p, r = p4[..., :3], p4[..., 3]
        dpdu, drdu = dp4[..., :3], dp4[..., 3]
        rr = q - p
        rr2 = _sum3(rr * rr)
        len_r = sqrt_rn(torch.clamp(rr2, min=0.0))
        q_err = _ERR * len_dir[..., None] * t
        r_err = torch.maximum(q_err, p_err1)
        dpdu2 = _sum3(dpdu * dpdu)
        rcp_len = _rsqrt(torch.clamp(dpdu2, min=1e-36))
        tan = dpdu * rcp_len[..., None]
        dtdu = ((ddp * dpdu2[..., None]
                 - dpdu * _sum3(dpdu * ddp)[..., None])
                * (rcp_len * rcp_len * rcp_len)[..., None])
        cos_err = p_err1 * rcp_len
        f = _sum3(rr * tan)
        f_err = len_r * p_err1 + r_err + cos_err * (1.0 + len_r)
        dfdu = _sum3(-dpdu * tan) + _sum3(rr * dtdu)
        dfdt = _sum3(dirn * tan)
        k = torch.clamp(rr2 - f * f, min=0.0)
        dkdu = _sum3(rr * -dpdu) - f * dfdu
        dkdt = _sum3(rr * dirn) - f * dfdt
        rsk = _rsqrt(torch.clamp(k, min=1e-36))
        g = sqrt_rn(k) - r
        g_err = r_err + f_err + _ERR * box_max[..., None]
        dgdu = dkdu * rsk - drdu
        dgdt = dkdt * rsk
        det = dfdu * dgdt - dfdt * dgdu
        rdet = torch.where(det.abs() > 1e-30, 1.0 / det,
                           torch.zeros_like(det))
        du = (dgdt * f - dfdt * g) * rdet
        dtt = (-dgdu * f + dfdu * g) * rdet
        conv = (f.abs() < f_err) & (g.abs() < g_err) & ~done
        tw = t + dt[..., None]
        ok = (conv & (tnear[..., None] <= tw) & (tw <= tfar[..., None])
              & (u >= 0.0) & (u <= 1.0))
        # the first accepted root of each seed
        hit_t = torch.where(ok, tw, hit_t)
        hit_u = torch.where(ok, u, hit_u)
        hit_f = hit_f | ok
        done = done | conv
        u = torch.where(done, u, u - du)
        t = torch.where(done, t, t - dtt)

    best = _first_min(torch.where(hit_f, hit_t,
                                  torch.full_like(hit_t, float("inf"))))
    t_o = _pick(hit_t, best)
    u_o = _pick(hit_u, best)
    # Ng at the root: R = normalize(Q - P); U = r' R + dP/du;
    # V = cross(dP/du, R)
    p4 = eval_bezier(cp, u_o)
    dp4 = eval_bezier_du(cp, u_o)
    rn = org + t_o[..., None] * dir - p4[..., :3]
    rn = rn / sqrt_rn(torch.clamp(_sum3(rn * rn), min=1e-36))[..., None]
    uv = dp4[..., 3:4] * rn + dp4[..., :3]
    vv = cross(dp4[..., :3], rn)
    return (_pick(hit_f, best), t_o, u_o, torch.zeros_like(u_o),
            cross(vv, uv))


def _quad_test_3d(va, vb, vc, vd, d, tnear, tfar):
    """The backface-culled quad test in general position
    (quad_intersector.h:15-74) with the ray origin at 0 and direction d."""
    edb = vb - vd
    ww = _sum3(cross(vd, edb) * d)
    sel = ww <= 0.0
    s3 = sel[..., None]
    v0 = torch.where(s3, va, vc)
    v1 = torch.where(s3, vb, vd)
    v2 = torch.where(s3, vd, vb)
    e0 = v2 - v0
    e1 = v0 - v1
    uu = _sum3(cross(v0, e0) * d)
    vv = _sum3(cross(v1, e1) * d)
    ok = torch.maximum(uu, vv) <= 0.0
    ngq = cross(e1, e0)
    den = _sum3(ngq * d)
    rcp_den = torch.where(den != 0.0,
                          1.0 / torch.where(den == 0, torch.ones_like(den),
                                            den),
                          torch.zeros_like(den))
    tq = rcp_den * _sum3(v0 * ngq)
    ok = ok & (tnear[..., None] <= tq) & (tq <= tfar[..., None]) & (den != 0.0)
    uq = uu * rcp_den
    vq = vv * rcp_den
    return (ok, tq, torch.where(sel, uq, 1.0 - uq),
            torch.where(sel, vq, 1.0 - vq))


def intersect_oriented(org, dir, cp, ncp, tnear, tfar, n_seg: int = 64):
    """Normal-oriented curve test: the ruled surface between the edge
    curves L, R = p -/+ r normalize(cross(n, dp)), each a cubic Hermite fit
    of its end values and derivatives (linear_bezier_patch.h
    fromCenterAndNormalCurve), intersected as n_seg double-sided quads, then
    polished by 8 Newton steps on the exact patch from the best chord hit
    and from the closest-approach segment
    (curve_intersector_oriented.h:82-144); the nearest converged root wins,
    the chord hit only as a fallback. Ng = cross(dP/du, dP/dv).

    cp: (..., 4, 4) Bezier xyz+r; ncp: (..., 4, 3) Bezier normal spline.
    Returns (hit, t, u, v, ng)."""
    def at(u0):
        u = torch.full(cp.shape[:-2], u0, dtype=torch.float32,
                       device=cp.device)
        p = eval_bezier(cp, u)
        dp = eval_bezier_du(cp, u)
        n = eval_bezier(ncp, u)
        dn = eval_bezier_du(ncp, u)
        bt = cross(n, dp[..., :3])
        dbt = cross(dn, dp[..., :3])     # ddp taken as 0 (reference note)
        bt2 = _sum3(bt * bt)[..., None]
        rl = _rsqrt(torch.clamp(bt2, min=1e-36))
        k = bt * rl
        dk = ((dbt * bt2 - bt * _sum3(bt * dbt)[..., None])
              * (rl * rl * rl))
        w, dw = p[..., 3:4], dp[..., 3:4]
        return (p[..., :3] - w * k, dp[..., :3] - (dw * k + w * dk),
                p[..., :3] + w * k, dp[..., :3] + (dw * k + w * dk))

    l0, dl0, r0, dr0 = at(0.0)
    l1, dl1, r1, dr1 = at(1.0)
    third = 1.0 / 3.0
    lcp = torch.stack([l0, l0 + third * dl0, l1 - third * dl1, l1], -2)
    rcp = torch.stack([r0, r0 + third * dr0, r1 - third * dr1, r1], -2)

    uk = _seg_knots(n_seg, cp).expand(cp.shape[:-2] + (n_seg + 1,))
    lpk = eval_bezier(lcp[..., None, :, :], uk, True)  # v = 0 edge (L)
    upk = eval_bezier(rcp[..., None, :, :], uk, True)  # v = 1 edge (R)
    lp0, lp1 = lpk[..., :-1, :], lpk[..., 1:, :]
    up0, up1 = upk[..., :-1, :], upk[..., 1:, :]
    o = org[..., None, :]
    d = dir[..., None, :]
    # double-sided: both windings, at most one accepts per ray
    ok_f, t_f, u_f, v_f = _quad_test_3d(lp0 - o, lp1 - o, up1 - o, up0 - o,
                                        d, tnear, tfar)
    ok_b, t_b, u_b, v_b = _quad_test_3d(up0 - o, up1 - o, lp1 - o, lp0 - o,
                                        d, tnear, tfar)
    valid = ok_f | ok_b
    t = torch.where(ok_f, t_f, t_b)
    uq = torch.where(ok_f, u_f, u_b)
    vq = torch.where(ok_f, v_f, 1.0 - v_b)     # the back winding flips v
    u_full = _per_seg(_seg_index(n_seg, uq) + uq, n_seg)
    best = _first_min(torch.where(valid, t, torch.full_like(t, float("inf"))))
    hit = _pick(valid, best)
    t_o = _pick(t, best)
    u_o = _pick(u_full, best)
    v_o = _pick(vq, best)

    # the Newton endgame on f(u, v) = [e1, e2] . (P(u, v) - O), with an
    # absolute tolerance of 32 ulp of the projected extent
    dd = _sum3(dir * dir)[..., None]
    dnrm = dir * _rsqrt(torch.clamp(dd, min=1e-30))
    axes = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=dir.device)
    ax = torch.where(dnrm[..., 0:1].abs() < 0.9, axes[0], axes[1])
    e1 = cross(dnrm, ax)
    e1 = e1 * _rsqrt(torch.clamp(_sum3(e1 * e1)[..., None], min=1e-30))
    e2 = cross(dnrm, e1)
    pc = torch.cat([lcp, rcp], -2) - org[..., None, :]
    ext = torch.maximum(_sum3(pc * e1[..., None, :]).abs().amax(-1),
                        _sum3(pc * e2[..., None, :]).abs().amax(-1))
    eps = (32.0 * 1.1920929e-07) * torch.clamp(ext, min=1e-20)
    # seed (b): the segment whose midline passes closest to the ray
    mid = 0.5 * (lp0 + lp1 + up0 + up1) - o
    m1 = _sum3(mid * e1[..., None, :])
    m2 = _sum3(mid * e2[..., None, :])
    kb = _first_min(m1 * m1 + m2 * m2)[..., 0]
    u_seed_b = _per_seg(kb.to(torch.float32) + 0.5, n_seg)

    def newton(u, v):
        for _ in range(8):
            lu = eval_bezier(lcp, u)
            ru = eval_bezier(rcp, u)
            p = (1.0 - v[..., None]) * lu + v[..., None] * ru - org
            f1 = _sum3(p * e1)
            f2 = _sum3(p * e2)
            du_ = ((1.0 - v[..., None]) * eval_bezier_du(lcp, u)
                   + v[..., None] * eval_bezier_du(rcp, u))
            dv_ = ru - lu
            a = _sum3(du_ * e1)
            b = _sum3(dv_ * e1)
            c = _sum3(du_ * e2)
            d_ = _sum3(dv_ * e2)
            det = a * d_ - b * c
            inv = torch.where(det.abs() > 1e-30,
                              1.0 / torch.where(det == 0,
                                                torch.ones_like(det), det),
                              torch.zeros_like(det))
            u = u - (d_ * f1 - b * f2) * inv
            v = v - (-c * f1 + a * f2) * inv
        p = ((1.0 - v[..., None]) * eval_bezier(lcp, u)
             + v[..., None] * eval_bezier(rcp, u))
        f1 = _sum3((p - org) * e1)
        f2 = _sum3((p - org) * e2)
        tn = _sum3((p - org) * dir) / dd[..., 0]
        okn = ((torch.maximum(f1.abs(), f2.abs()) < eps)
               & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
               & (tn >= tnear) & (tn <= tfar))
        return okn, tn, u, v

    ok_a, t_a, u_a, v_a = newton(u_o, v_o)
    ok_b2, t_b2, u_b2, v_b2 = newton(u_seed_b, torch.full_like(u_seed_b,
                                                               0.5))
    use_b = ok_b2 & (~ok_a | (t_b2 < t_a))
    okn = ok_a | ok_b2
    hit = hit | okn
    t_o = torch.where(okn, torch.where(use_b, t_b2, t_a), t_o)
    u_o = torch.where(okn, torch.where(use_b, u_b2, u_a), u_o)
    v_o = torch.where(okn, torch.where(use_b, v_b2, v_a), v_o)
    # Ng = cross(dP/du, dP/dv) on P(u, v) = (1 - v) L(u) + v R(u)
    dpdu = ((1.0 - v_o[..., None]) * eval_bezier_du(lcp, u_o)
            + v_o[..., None] * eval_bezier_du(rcp, u_o))
    dpdv = eval_bezier(rcp, u_o) - eval_bezier(lcp, u_o)
    return hit, t_o, u_o, v_o, cross(dpdu, dpdv)


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
