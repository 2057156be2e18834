"""Triangles: Möller-Trumbore without backface culling, as Embree's
triangle_intersector_moeller.h states it: e1 = v1 - v0, e2 = v2 - v0,
P = d x e2, det = e1 . P (|det| > 1e-24), T = o - v0, u = T . P / det,
Q = T x e1, v = d . Q / det, t = e2 . Q / det; a hit needs u >= 0,
v >= 0, u + v <= 1 and tnear <= t <= tfar; Ng = e1 x e2, unnormalized.
"""
from __future__ import annotations

import torch

from . import common


def prepare(arrays: dict, device) -> dict:
    v = torch.as_tensor(arrays["vertices"], device=device)
    i = torch.as_tensor(arrays["indices"], device=device).long()
    tri = v[i].double()                                  # (T, 3, 3)
    center = tri.mean(1)
    radius = torch.linalg.vector_norm(tri - center[:, None], dim=2) \
        .amax(1) * (1 + 1e-6) + 1e-7
    return {"tri": v[i], "center": center.float(), "radius": radius.float()}


def _test(prep, ray, prim, org, dir, tnear, tfar, dtype):
    tri = prep["tri"][prim].to(dtype)
    o, d = org[ray].to(dtype), dir[ray].to(dtype)
    v0 = tri[:, 0]
    e1 = tri[:, 1] - v0
    e2 = tri[:, 2] - v0
    p = torch.linalg.cross(d, e2)
    det = (e1 * p).sum(1)
    det_ok = det.abs() > 1e-24
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    tv = o - v0
    u = (tv * p).sum(1) * inv
    q = torch.linalg.cross(tv, e1)
    v = (d * q).sum(1) * inv
    t = (e2 * q).sum(1) * inv
    ok = (det_ok & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (t >= tnear[ray].to(dtype)) & (t <= tfar[ray].to(dtype)))
    return ok, t, u, v, torch.linalg.cross(e1, e2)


def _accepted(prep, org, dir, tnear, tfar, dtype):
    ray, prim = common.candidates(prep["center"], prep["radius"], org, dir,
                                  tnear)
    out = []
    for s in common.blocks(ray.shape[0]):
        ok, t, u, v, ng = _test(prep, ray[s], prim[s], org, dir, tnear,
                                tfar, dtype)
        out.append((ray[s][ok], prim[s][ok], t[ok], u[ok], v[ok], ng[ok]))
    if not out:
        e = torch.zeros(0, dtype=dtype, device=org.device)
        i = torch.zeros(0, dtype=torch.int64, device=org.device)
        return i, i, e, e, e, e.reshape(0, 3)
    return tuple(torch.cat(x) for x in zip(*out))


def closest(prep, org, dir, tnear, tfar, dtype) -> dict:
    ray, prim, t, u, v, ng = _accepted(prep, org, dir, tnear, tfar, dtype)
    valid, t, a = common.nearest(org.shape[0], ray, prim, t,
                                 {"u": u, "v": v, "ng": ng, "prim": prim},
                                 dtype)
    prim = torch.where(valid, a["prim"], -1)
    return {"valid": valid, "t": t, "u": a["u"], "v": a["v"], "ng": a["ng"],
            "prim": prim}


def any_hit(prep, org, dir, tnear, tfar, dtype):
    ray = _accepted(prep, org, dir, tnear, tfar, dtype)[0]
    hit = torch.zeros(org.shape[0], dtype=torch.bool, device=org.device)
    hit[ray] = True
    return hit
