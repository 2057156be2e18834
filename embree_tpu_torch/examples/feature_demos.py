"""Runnable feature demos, one function per reference tutorial family
(intersection_filter, user_geometry, closest_point, collide,
instanced_geometry, motion_blur_geometry, interpolation, gradients,
grid_geometry, subdivision_geometry, curve_geometry,
quaternion_motion_blur, instance_array_geometry).

Port of examples/feature_demos.py: the same 13 demos on the same scenes,
with the same asserts and printed lines. Each demo takes the device it
runs on; the gradient demo differentiates through autograd.

Run: python -m embree_tpu_torch.examples.feature_demos [--cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch


def _t(x, dev):
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def demo_intersection_filter(pt, dev):
    """tutorials/intersection_filter: a filter callback rejects hits on the
    front plate, so rays pass through to the back plate."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    i = np.array([[0, 1, 2]], np.int32)

    def reject_front(org, dir, t, u, v_, ng, prim_id, geom_id):
        return t > 5.0          # accept only the far plate

    s = pt.Scene()
    s.attach(pt.TriangleGeometry(v, i, filter=reject_front))          # near
    s.attach(pt.TriangleGeometry(v + np.array([0, 0, -8], np.float32), i))
    cs = s.commit(device=dev)
    h = pt.intersect(cs, pt.make_rays(_t([[0.0, 0.0, 4.0]], dev),
                                      _t([[0.0, 0.0, -1.0]], dev)))
    assert bool(h.valid[0]) and abs(float(h.t[0]) - 12.0) < 1e-4
    print(f"intersection_filter: front plate filtered, hit t={float(h.t[0])}")


def demo_user_geometry(pt, dev):
    """tutorials/user_geometry: bounds + an intersect callback implementing
    an analytic sphere."""
    center = _t([0.0, 0.0, 0.0], dev)

    def sphere_isect(local_id, org, dir, tnear, tfar):
        oc = org - center
        dd = (dir * dir).sum(-1)
        b = 2.0 * (oc * dir).sum(-1)
        c = (oc * oc).sum(-1) - 1.0
        disc = b * b - 4.0 * dd * c
        t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * dd)
        hit = (disc >= 0) & (t >= tnear) & (t <= tfar)
        p = org + t[..., None] * dir
        return hit, t, torch.zeros_like(t), torch.zeros_like(t), p - center

    s = pt.Scene()
    s.attach(pt.UserGeometry(np.array([[-1, -1, -1]], np.float32),
                             np.array([[1, 1, 1]], np.float32),
                             intersect_fn=sphere_isect))
    cs = s.commit(device=dev)
    h = pt.intersect(cs, pt.make_rays(_t([[0.0, 0.0, 3.0]], dev),
                                      _t([[0.0, 0.0, -1.0]], dev)))
    assert bool(h.valid[0]) and abs(float(h.t[0]) - 2.0) < 1e-5
    print(f"user_geometry: analytic sphere hit t={float(h.t[0])}")


def demo_closest_point(pt, dev):
    """tutorials/closest_point: rtcPointQuery analog."""
    from ..query import point_query_scene
    v = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float32)
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(v, np.array([[0, 1, 2]], np.int32)))
    cs = s.commit(device=dev)
    res = point_query_scene(cs, _t([[0.5, 0.5, 3.0]], dev), _t([10.0], dev))
    d = float(res.dist[0])
    assert abs(d - 3.0) < 1e-5
    print(f"closest_point: dist={d} prim={int(res.prim[0])}")


def demo_collide(pt, dev):
    """tutorials/collide: BVH-vs-BVH triangle collision detection."""
    from ..query import collide_scenes
    v1 = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    s1 = pt.Scene()
    s1.attach(pt.TriangleGeometry(v1, np.array([[0, 1, 2]], np.int32)))
    v2 = v1 + np.array([0.2, 0.2, 0.0], np.float32)  # overlapping, coplanar
    v2[2, 2] += 0.5   # tilt so the triangles genuinely cross
    v2[0, 2] -= 0.5
    s2 = pt.Scene()
    s2.attach(pt.TriangleGeometry(v2, np.array([[0, 1, 2]], np.int32)))
    res = collide_scenes(s1.commit(device=dev), s2.commit(device=dev))
    n = int(res.count)
    assert n >= 1
    print(f"collide: {n} intersecting pair(s)")


def demo_instancing(pt, dev):
    """tutorials/instanced_geometry: one BLAS, many transforms; hits carry
    the instance id stack."""
    base = pt.Scene()
    base.attach(pt.TriangleGeometry(
        np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32),
        np.array([[0, 1, 2]], np.int32)))
    top = pt.Scene()
    for k in range(4):
        xf = np.zeros((3, 4), np.float32)
        xf[:, :3] = np.eye(3)
        xf[0, 3] = 3.0 * k
        top.attach(pt.InstanceGeometry(base, xf))
    cs = top.commit(device=dev)
    h = pt.intersect(cs, pt.make_rays(_t([[6.0, 0.0, 5.0]], dev),
                                      _t([[0.0, 0.0, -1.0]], dev)))
    assert bool(h.valid[0]) and int(h.inst_id[0, 0]) == 2
    print(f"instancing: hit instance {int(h.inst_id[0, 0])} at x=6")


def demo_motion_blur_time_range(pt, dev):
    """tutorials/motion_blur_geometry + rtcSetGeometryTimeRange: the
    geometry exists only within its sub-[0,1] time range."""
    verts = np.stack([
        np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32),
        np.array([[-1, -1, 4], [1, -1, 4], [0, 1, 4]], np.float32)])
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(verts, np.array([[0, 1, 2]], np.int32),
                                 time_range=(0.25, 0.75)))
    cs = s.commit(device=dev)
    h = pt.intersect(cs, pt.make_rays(
        _t([[0.0, 0.0, 10.0]] * 3, dev), _t([[0.0, 0.0, -1.0]] * 3, dev),
        time=_t([0.0, 0.5, 1.0], dev)))
    assert [bool(x) for x in h.valid] == [False, True, False]
    print(f"motion_blur_time_range: visible only at t=0.5 "
          f"(t={float(h.t[1])})")


def demo_interpolation(pt, dev):
    """tutorials/interpolation: rtcInterpolate over vertex attributes."""
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    g = pt.TriangleGeometry(v, np.array([[0, 1, 2]], np.int32))
    attr = np.array([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]], np.float32)
    out = pt.interpolate(g, torch.tensor([0], device=dev), _t([0.25], dev),
                         _t([0.5], dev), attr)
    got = out[0].cpu().numpy()
    np.testing.assert_allclose(got, [0.25, 0.25], atol=1e-6)
    print(f"interpolation: attr at (u=0.25,v=0.5) = {got}")


def demo_gradients(pt, dev):
    """Differentiable rendering (no reference analog): d(depth)/d(vertex),
    through autograd."""
    v = np.array([[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]],
                 np.float32)
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(v, np.array([[0, 1, 2]], np.int32)))
    cs = s.commit(device=dev)
    rays = pt.make_rays(_t([[0.0, 0.0, 5.0]], dev),
                        _t([[0.0, 0.0, -1.0]], dev))

    def depth(dz):
        shift = _t([0.0, 0.0, 1.0], dev) * dz
        s2 = dataclasses.replace(
            cs, tri_v0=cs.tri_v0 + shift, tri_v1=cs.tri_v1 + shift,
            tri_v2=cs.tri_v2 + shift, tri_v0b=cs.tri_v0b + shift,
            tri_v1b=cs.tri_v1b + shift, tri_v2b=cs.tri_v2b + shift)
        return pt.intersect(s2, rays).t.sum()

    dz = torch.zeros((), device=dev, requires_grad=True)
    g = float(torch.autograd.grad(depth(dz), dz)[0])
    assert abs(g + 1.0) < 1e-4
    print(f"gradients: d(depth)/d(vertex_z) = {g} (exact -1)")


def demo_grid_geometry(pt, dev):
    """tutorials/grid_geometry: a regular height-field grid (RTCGrid 12-byte
    prims); hits report grid-global uv."""
    w, h = 9, 7
    gx, gy = np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h))
    verts = np.stack([gx, gy, 0.1 * np.sin(3 * gx) * np.cos(3 * gy)],
                     -1).reshape(-1, 3).astype(np.float32)
    s = pt.Scene()
    s.attach(pt.GridGeometry(verts, np.array([[0, w, w, h]], np.int32)))
    cs = s.commit(device=dev)
    h0 = pt.intersect(cs, pt.make_rays(_t([[0.25, 0.25, 2.0]], dev),
                                       _t([[0.0, 0.0, -1.0]], dev)))
    u, v = float(h0.u[0]), float(h0.v[0])
    assert bool(h0.valid[0]) and abs(u - 0.625) < 0.1 and abs(v - 0.625) < 0.1
    print(f"grid_geometry: hit grid at uv=({u:.3f},{v:.3f})")


def demo_subdivision_geometry(pt, dev):
    """tutorials/subdivision_geometry: a Catmull-Clark cube shrinks toward
    its smooth limit surface; an edge crease keeps one edge sharp."""
    v = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                  [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32)
    faces = np.full(6, 4, np.int32)
    idx = np.array([0, 1, 2, 3, 4, 7, 6, 5, 0, 4, 5, 1,
                    1, 5, 6, 2, 2, 6, 7, 3, 3, 7, 4, 0], np.int32)
    rays = pt.make_rays(_t([[0.0, 0.0, 4.0]], dev),
                        _t([[0.0, 0.0, -1.0]], dev))
    s = pt.Scene()
    s.attach(pt.SubdivisionGeometry(v, faces, idx, levels=3))
    t_smooth = float(pt.intersect(s.commit(device=dev), rays).t[0])
    s2 = pt.Scene()
    s2.attach(pt.SubdivisionGeometry(
        v, faces, idx, levels=3,
        creases={(0, 1): 10.0, (4, 5): 10.0, (0, 4): 10.0, (1, 5): 10.0}))
    t_crease = float(pt.intersect(s2.commit(device=dev), rays).t[0])
    # the smooth limit surface sits INSIDE the cage (center t > 3); creasing
    # the bottom face's edges pulls the limit surface back toward the cage
    assert 3.05 < t_smooth < 3.4 and 3.0 < t_crease < t_smooth - 0.01
    print(f"subdivision_geometry: smooth center t={t_smooth:.3f} (cage 3.0)"
          f" -> {t_crease:.3f} with bottom-face creases")


def demo_curve_geometry(pt, dev):
    """tutorials/curve_geometry + hair_geometry: flat (ribbon) vs round
    (swept-tube) Bezier curves; the round tube is hit from any side."""
    cp = np.array([[0, -1, 0, 0.2], [0, -0.3, 0, 0.2],
                   [0, 0.3, 0, 0.2], [0, 1, 0, 0.2]], np.float32)
    hits = {}
    for kind in ("flat", "round"):
        s = pt.Scene()
        s.attach(pt.CurveGeometry(cp, np.array([0], np.int32),
                                  basis="bezier", kind=kind))
        hits[kind] = pt.intersect(s.commit(device=dev), pt.make_rays(
            _t([[2.0, 0.0, 0.0]], dev), _t([[-1.0, 0.0, 0.0]], dev)))
    assert bool(hits["round"].valid[0])
    t = float(hits["round"].t[0])
    assert abs(t - 1.8) < 0.05          # tube surface at x = 0.2
    print(f"curve_geometry: round tube hit t={t:.3f} (expect 1.8); "
          f"flat ribbon edge-on hit={bool(hits['flat'].valid[0])}")


def demo_quaternion_motion_blur(pt, dev):
    """tutorials/quaternion_motion_blur: an instance rotating 90deg via
    quaternion slerp; rays at t=0 and t=1 see it at different angles."""
    inner = pt.Scene()
    inner.attach(pt.TriangleGeometry(
        np.array([[2, -1, -0.01], [2, 1, -0.01], [2, 0, 0.01]], np.float32),
        np.array([[0, 1, 2]], np.int32)))
    eye34 = np.eye(3, 4, dtype=np.float32)
    zero3 = np.zeros(3, np.float32)
    q0 = pt.QuaternionDecomposition(
        eye34, np.array([1.0, 0.0, 0.0, 0.0], np.float32), zero3)
    a = np.pi / 2
    q1 = pt.QuaternionDecomposition(                 # 90deg about z
        eye34, np.array([np.cos(a / 2), 0.0, 0.0, np.sin(a / 2)],
                        np.float32), zero3)
    s = pt.Scene()
    s.attach(pt.InstanceGeometry(inner, [q0, q1]))
    cs = s.commit(device=dev)
    org = _t([[0.0, 0.0, 5.0], [0.0, 0.0, 5.0]], dev)
    d = _t([[2.0, 0.0, 0.0], [0.0, 2.0, 0.0]], dev) - org
    rays = pt.make_rays(org, d / torch.linalg.norm(d, dim=-1, keepdim=True),
                        time=_t([0.0, 1.0], dev))
    h = pt.intersect(cs, rays)
    # t=0: triangle at +x (first ray hits); t=1: rotated to +y (second hits)
    assert bool(h.valid[0]) and bool(h.valid[1])
    print("quaternion_motion_blur: hit at +x (t=0) and +y (t=1) "
          "through slerp-resampled transforms")


def demo_instance_array(pt, dev):
    """tutorials/instance_array_geometry: ONE scene, N transforms sharing
    the BLAS (scene_instance_array.cpp): a row of spheres from one proto."""
    proto = pt.Scene()
    th = np.linspace(0, np.pi, 9)
    ph = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    sv = 0.3 * np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),
                         np.cos(t)], -1).reshape(-1, 3).astype(np.float32)
    si = []
    for i in range(8):
        for j in range(12):
            a = i * 12 + j
            b = i * 12 + (j + 1) % 12
            si += [[a, b, a + 12], [b, b + 12, a + 12]]
    proto.attach(pt.TriangleGeometry(sv, np.asarray(si, np.int32)))
    xf = np.tile(np.eye(3, 4, dtype=np.float32), (5, 1, 1))
    xf[:, 0, 3] = np.arange(5, dtype=np.float32) * 2.0    # x = 0,2,4,6,8
    s = pt.Scene()
    s.attach(pt.InstanceArrayGeometry(proto, xf))
    cs = s.commit(device=dev)
    org = _t([[2.0 * k, 0.0, 5.0] for k in range(5)], dev)
    rays = pt.make_rays(org, _t([[0.0, 0.0, -1.0]] * 5, dev))
    h = pt.intersect(cs, rays)
    t = h.t.cpu().numpy()
    inst = h.inst_id.cpu().numpy()[:, 0]
    # every ray hits ITS translated copy at the same local depth; instID is
    # the array geometry's id (the element index is the reference's
    # instPrimID, instance_array_intersector.cpp)
    assert bool(h.valid.all())
    assert np.allclose(t, t[0], atol=1e-4) and (inst == inst[0]).all()
    print(f"instance_array: 5 copies of one BLAS each hit at t={t[0]:.2f}")


DEMOS = (demo_intersection_filter, demo_user_geometry, demo_closest_point,
         demo_collide, demo_instancing, demo_motion_blur_time_range,
         demo_interpolation, demo_gradients, demo_grid_geometry,
         demo_subdivision_geometry, demo_curve_geometry,
         demo_quaternion_motion_blur, demo_instance_array)


def main(argv=None):
    """Runs every demo in order; returns their names."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    import embree_tpu_torch as pt
    dev = "cpu" if args.cpu else "cuda"
    ran = []
    for fn in DEMOS:
        fn(pt, dev)
        ran.append(fn.__name__[len("demo_"):])
    print("all feature demos OK")
    return ran


if __name__ == "__main__":
    main()
