"""Port Scene -> commit -> intersect/occluded vs the JAX package.

Mirrors tests/test_bvh.py:80-138. Both packages commit through the native
builder with one thread (EMBREE_TPU_NATIVE_BUILD=1 on the JAX side; the
port always takes that route), so they build the same BVH8 and pack the same
records. The JAX side answers with its jnp engine, held at that file's own
bar: equal hit masks, t within rtol 1e-4, > 95% equal prim ids.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as pt
from embree_tpu_torch.scene import BuildQuality
from test_bvh import make_sphere_mesh
from test_torch_round import one_thread  # noqa: F401 (module-wide autouse)
from test_torch_traverse import jax_native_ready


@pytest.fixture(autouse=True)
def _native(monkeypatch):
    monkeypatch.setenv("EMBREE_TPU_NATIVE_BUILD", "1")
    jax_native_ready()


def _rays(n, seed, spread=3.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    aim = rng.uniform(-1, 1, (n // 2, 3)).astype(np.float32)
    d[:n // 2] = aim - org[:n // 2]
    return org, d


def _both(geoms):
    sj, sp = et.Scene(threads=1), pt.Scene(threads=1)
    for v, i, kw in geoms:
        sj.attach(et.TriangleGeometry(v, i, **kw))
        sp.attach(pt.TriangleGeometry(v, i, **kw))
    return sj.commit(), sp.commit(device="cpu")


def _np(x):
    return np.asarray(x).astype(np.float64) if not isinstance(
        x, torch.Tensor) else x.detach().numpy().astype(np.float64)


def test_commit_packs_same_records():
    verts, idx = make_sphere_mesh()
    cj, cp = _both([(verts, idx, {})])
    table = np.asarray(cj.packed.table)
    recs = table.transpose(0, 2, 1).reshape(-1, table.shape[1])
    nn, nl = cp.packed.nodes.shape[0], cp.packed.leaves.shape[0]
    np.testing.assert_array_equal(cp.packed.nodes.numpy(), recs[:nn, :32])
    gn = cj.packed.gn * 128
    np.testing.assert_array_equal(cp.packed.leaves.numpy(),
                                  recs[gn:gn + nl, :72])
    np.testing.assert_array_equal(cp.packed.pid_map.numpy(),
                                  np.asarray(cj.packed.pid_map)[:nl * 8])
    for k in ("node_child", "prim_order"):
        np.testing.assert_array_equal(getattr(cp.bvh, k).numpy(),
                                      np.asarray(getattr(cj.bvh, k)))


@pytest.mark.parametrize("differentiable", [True, False])
def test_matches_jax_jnp_engine(differentiable):
    verts, idx = make_sphere_mesh()
    cj, cp = _both([(verts, idx, {})])
    org, d = _rays(512, 3)
    hj = jax.jit(lambda c, r: et.intersect(c, r, backend="jnp"))(
        cj, et.make_rays(jnp.asarray(org), jnp.asarray(d)))
    hp = pt.intersect(cp, pt.make_rays(org, d, device="cpu"),
                      differentiable=differentiable)
    m = np.asarray(hj.valid)
    assert m.sum() > 100
    np.testing.assert_array_equal(hp.valid.numpy(), m)
    np.testing.assert_allclose(_np(hp.t)[m], _np(hj.t)[m], rtol=1e-4)
    np.testing.assert_allclose(_np(hp.u)[m], _np(hj.u)[m], atol=1e-4)
    np.testing.assert_allclose(_np(hp.v)[m], _np(hj.v)[m], atol=1e-4)
    np.testing.assert_allclose(_np(hp.ng)[m], _np(hj.ng)[m], rtol=1e-4,
                               atol=1e-6)
    same = _np(hp.prim_id)[m] == _np(hj.prim_id)[m]
    assert same.mean() > 0.95
    # misses carry the JAX package's miss values
    for f in ("t", "u", "v", "ng", "prim_id", "geom_id", "inst_id"):
        np.testing.assert_array_equal(_np(getattr(hp, f))[~m],
                                      _np(getattr(hj, f))[~m], err_msg=f)
    oj = jax.jit(lambda c, r: et.occluded(c, r, backend="jnp"))(
        cj, et.make_rays(jnp.asarray(org), jnp.asarray(d)))
    op = pt.occluded(cp, pt.make_rays(org, d, device="cpu"))
    np.testing.assert_array_equal(op.numpy(), np.asarray(oj))


def test_both_modes_agree():
    """The kernel-attribute fast path and the re-intersection path pick the
    same hits; t agrees to the re-intersection's fp wobble."""
    verts, idx = make_sphere_mesh(8, 12)
    _, cp = _both([(verts, idx, {})])
    org, d = _rays(256, 11)
    r = pt.make_rays(org, d, device="cpu")
    a = pt.intersect(cp, r, differentiable=False)
    b = pt.intersect(cp, r)
    np.testing.assert_array_equal(a.valid.numpy(), b.valid.numpy())
    np.testing.assert_array_equal(a.prim_id.numpy(), b.prim_id.numpy())
    m = a.valid.numpy()
    np.testing.assert_allclose(a.t.numpy()[m], b.t.numpy()[m], rtol=1e-6)


def test_occluded_matches_intersect():
    verts, idx = make_sphere_mesh(8, 12)
    _, cp = _both([(verts, idx, {})])
    org, d = _rays(256, 11)
    r = pt.make_rays(org, d, device="cpu")
    np.testing.assert_array_equal(pt.occluded(cp, r).numpy(),
                                  pt.intersect(cp, r).valid.numpy())


def test_two_geometries_ids():
    v1, i1 = make_sphere_mesh(6, 8, radius=1.0, center=(-2.0, 0, 0))
    v2, i2 = make_sphere_mesh(6, 8, radius=1.0, center=(2.0, 0, 0))
    cj, cp = _both([(v1, i1, {}), (v2, i2, {})])
    org = np.array([[-2.0, 0.0, 5.0], [2.0, 0.0, 5.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], np.float32)
    for diff in (True, False):
        h = pt.intersect(cp, pt.make_rays(org, d, device="cpu"),
                         differentiable=diff)
        assert h.valid.all()
        np.testing.assert_array_equal(h.geom_id.numpy(), [0, 1])
    hj = et.intersect(cj, et.make_rays(jnp.asarray(org), jnp.asarray(d)))
    # the rays pass through a pole vertex, where several triangles tie at
    # the same t; the jnp engine breaks that tie differently (ROADMAP C)
    np.testing.assert_allclose(h.t.numpy(), np.asarray(hj.t), rtol=1e-6)
    np.testing.assert_array_equal(h.geom_id.numpy(), np.asarray(hj.geom_id))
    np.testing.assert_array_equal(h.inst_id.numpy(), np.asarray(hj.inst_id))


@pytest.mark.parametrize("geom_mask", [0x1, 0xFFFFFFFF])
def test_ray_masks(geom_mask):
    """RayMasksTest analog (verify.cpp:2626), with a per-slot mask scene and
    a mask-free scene (ray mask folded into activation)."""
    verts, idx = make_sphere_mesh(6, 8)
    _, cp = _both([(verts, idx, {"mask": geom_mask})])
    assert cp.packed.has_mask == (geom_mask != 0xFFFFFFFF)
    org = np.array([[0.0, 0.0, 5.0]] * 3, np.float32)
    d = np.array([[0.0, 0.0, -1.0]] * 3, np.float32)
    r = pt.make_rays(org, d, mask=np.array([0x1, 0x2, 0x0], np.uint32),
                     device="cpu")
    want = [True, geom_mask == 0xFFFFFFFF, False]
    for diff in (True, False):
        np.testing.assert_array_equal(
            pt.intersect(cp, r, differentiable=diff).valid.numpy(), want)
    np.testing.assert_array_equal(pt.occluded(cp, r).numpy(), want)
    np.testing.assert_array_equal(pt.intersect_brute(cp, r).valid.numpy(),
                                  want)


def test_single_triangle_scene():
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(
        np.array([[0., 0., 0.], [1., 0., 0.], [0., 1., 0.]], np.float32),
        np.array([[0, 1, 2]], np.int32)))
    cs = s.commit(device="cpu")
    r = pt.make_rays(np.array([[0.2, 0.2, 1.0]], np.float32),
                     np.array([[0., 0., -1.]], np.float32), device="cpu")
    for diff in (True, False):
        h = pt.intersect(cs, r, differentiable=diff)
        assert bool(h.valid[0])
        assert float(h.t[0]) == pytest.approx(1.0)
        assert float(h.u[0]) == pytest.approx(0.2)
        assert float(h.v[0]) == pytest.approx(0.2)


@pytest.mark.parametrize("n_rays", [512])
def test_bvh_matches_brute_force(n_rays):
    verts, idx = make_sphere_mesh()
    _, cp = _both([(verts, idx, {})])
    org, d = _rays(n_rays, 3)
    r = pt.make_rays(org, d, device="cpu")
    hb = pt.intersect(cp, r)
    hr = pt.intersect_brute(cp, r)
    np.testing.assert_array_equal(hb.valid.numpy(), hr.valid.numpy())
    m = hr.valid.numpy()
    np.testing.assert_allclose(hb.t.numpy()[m], hr.t.numpy()[m], rtol=1e-4)
    same = hb.prim_id.numpy()[m] == hr.prim_id.numpy()[m]
    t_close = np.isclose(hb.t.numpy()[m], hr.t.numpy()[m], rtol=1e-4)
    assert (same | t_close).all()


def test_reconstruct_carries_gradient():
    """The differentiable path's hit t has a gradient w.r.t. the ray origin
    (dt/dorg = -n / dot(n, dir) along the plane normal)."""
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(
        np.array([[-1., -1., 0.], [1., -1., 0.], [0., 1., 0.]], np.float32),
        np.array([[0, 1, 2]], np.int32)))
    cs = s.commit(device="cpu")
    org = torch.tensor([[0.1, 0.0, 2.0]], requires_grad=True)
    r = pt.make_rays(org, torch.tensor([[0.0, 0.0, -1.0]]))
    h = pt.intersect(cs, r)
    h.t.sum().backward()
    np.testing.assert_allclose(org.grad.numpy(), [[0.0, 0.0, 1.0]],
                               atol=1e-6)


def test_commit_needs_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(np.eye(3, dtype=np.float32),
                                 np.array([[0, 1, 2]], np.int32)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.commit()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.make_rays(np.zeros((1, 3)), np.ones((1, 3)))
    assert s.commit(device="cpu").device.type == "cpu"


def _tri():
    return (np.array([[0., 0., 0.], [1., 0., 0.], [0., 1., 0.]], np.float32),
            np.array([[0, 1, 2]], np.int32))


def _fat_chain():
    # tests/test_geometries.py:414-421: joint radius 1 on unit segments
    return pt.LineSegmentsGeometry(
        np.array([[0, 1, 0, 1.0], [0, 2, 0, 1.0], [0, 2.8, 0, 0.1]],
                 np.float32), np.array([0, 1], np.int32), kind="round")


def _round_curve():
    return pt.CurveGeometry(
        np.array([[0, 0, 0, 0.1], [1, 0, 0, 0.1], [2, 0, 0, 0.1],
                  [3, 0, 0, 0.1]], np.float32),
        np.array([0], np.int32), basis="bezier", kind="round")


# cases the port refused until it covered them: each now commits, and its
# hits agree with brute force (compact: with the same scene not compact;
# two-level: with brute force on the same scene flattened); the instanced
# ones also agree with the JAX package on the same inputs
NOW_SERVED = ("curve", "min_width", "filter", "compact", "high", "refit",
              "fat_joint", "moving_instance", "two_level")
INSTANCED = ("fat_joint", "moving_instance", "two_level")


def _geom_verts(g):
    if isinstance(g, pt.InstanceGeometry):
        xf = np.asarray(g.transform, np.float32).reshape(-1, 3, 4)[0]
        v = np.concatenate([_geom_verts(c) for c in g.scene._geoms.values()])
        return v @ xf[:, :3].T + xf[:, 3]
    return np.asarray(g.vertices)[..., :3].reshape(-1, 3)


def _brute_rays(s):
    rng = np.random.default_rng(5)
    org = rng.uniform(-2, 3, (256, 3)).astype(np.float32)
    v = np.concatenate([_geom_verts(g) for g in s._geoms.values()])
    aim = v[rng.integers(0, len(v), 256)] + rng.normal(0, 0.3, (256, 3))
    return org, (aim - org).astype(np.float32), \
        rng.uniform(0, 1, 256).astype(np.float32)


def _agree_with_brute(cs, s):
    org, d, time = _brute_rays(s)
    r = pt.make_rays(org, d, time=time, device="cpu")
    h = pt.intersect(cs, r)
    if isinstance(cs, pt.TwoLevelScene):
        hb = pt.intersect_brute(s.commit(device="cpu", two_level=False), r)
    elif cs.compact:
        s.compact = False
        hb = pt.intersect(s.commit(device="cpu"), r, differentiable=False)
    else:
        hb = pt.intersect_brute(cs, r)
    m = hb.valid.numpy()
    assert m.sum() > 10
    np.testing.assert_array_equal(h.valid.numpy(), m)
    np.testing.assert_allclose(h.t.numpy()[m], hb.t.numpy()[m], rtol=1e-5)
    return h


def _instanced_case(et, case):
    """The instanced cases in either package (``et``): a fat-jointed
    chain under an identity instance, a triangle under a 2-step transform
    (tests/test_geometries.py:252) and a triangle committed two-level."""
    v, i = _tri()
    s = et.Scene()
    if case == "fat_joint":
        child = et.Scene()
        child.attach(et.LineSegmentsGeometry(
            np.asarray(_fat_chain().vertices), np.array([0, 1], np.int32),
            kind="round"))
        s.attach(et.InstanceGeometry(child, np.eye(3, 4, dtype=np.float32)))
    elif case == "moving_instance":
        child = et.Scene()
        child.attach(et.TriangleGeometry(v, i))
        xf = np.zeros((2, 3, 4), np.float32)
        xf[:, :, :3] = np.eye(3)
        xf[1, 0, 3] = 2.0
        s.attach(et.InstanceGeometry(child, xf))
    else:
        s.attach(et.TriangleGeometry(v, i))
    return s


@pytest.mark.parametrize("case", ["curve", "fat_joint", "min_width",
                                  "moving_instance", "filter", "compact",
                                  "high", "refit", "two_level",
                                  "from_arrays_motion_curve"])
def test_refused_scenes(case):
    """The cases the port refused until it covered them now commit and
    agree with brute force: filters (here on a native round curve), HIGH
    quality (with min-width and without), compact scenes, REFIT quality,
    instances (of a fat-jointed chain, and moving) and two-level scenes;
    the instanced ones also agree with the JAX package. A scene carried
    across whose flags count filters that are not given raises
    ValueError."""
    v, i = _tri()
    kw = {}
    if case == "compact":
        kw = {case: True}
    if case == "min_width":
        kw = {"min_width_factor": 1.0, "quality": BuildQuality.HIGH}
    if case == "high":
        kw = {"quality": BuildQuality.HIGH}
    if case == "refit":
        kw = {"quality": BuildQuality.REFIT}
    s = pt.Scene(**kw)
    if case == "curve":
        g = _round_curve()
        g.filter = lambda *a: True
        s.attach(g)
    elif case in INSTANCED:
        s = _instanced_case(pt, case)
    elif case == "filter":
        s.attach(pt.TriangleGeometry(v, i, filter=lambda *a: True))
    else:
        s.attach(pt.TriangleGeometry(v, i))
    if case in NOW_SERVED:
        cs = s.commit(device="cpu", two_level=case == "two_level" or None)
        if case == "refit":           # a second commit refits the first
            s.get(0).vertices = v + np.float32(0.5)
            cs = s.commit(device="cpu")
        h = _agree_with_brute(cs, s)
        if case in INSTANCED:
            org, d, time = _brute_rays(s)
            sj = _instanced_case(et, case)
            cj = sj.commit(two_level=True) if case == "two_level" \
                else sj.commit()
            hj = et.intersect(cj, et.make_rays(
                jnp.asarray(org), jnp.asarray(d), time=jnp.asarray(time)))
            m = np.asarray(hj.valid)
            np.testing.assert_array_equal(h.valid.numpy(), m)
            np.testing.assert_allclose(h.t.numpy()[m], np.asarray(hj.t)[m],
                                       rtol=1e-4)
            np.testing.assert_array_equal(h.inst_id.numpy()[m],
                                          np.asarray(hj.inst_id)[m])
    elif case == "from_arrays_motion_curve":
        # a moving round-curve scene whose flags count a filter that is
        # not passed in
        with pytest.raises(ValueError):
            pt.from_arrays({}, {"has_motion": True, "has_windows": True,
                                "kinds_present": (0, 9), "filters": True},
                           "cpu")


@pytest.mark.parametrize("case", ["curve", "fat_joint", "min_width"])
def test_served_scenes(case):
    """A native round curve, a fat-jointed chain and a min-width scene
    commit without a packed table (the generic engine, as in the JAX
    package), and the rays that graze them hit as brute force says."""
    s = pt.Scene(min_width_factor=0.5 if case == "min_width" else 0.0,
                 max_radius_scale=8.0)
    if case == "curve":
        s.attach(_round_curve())
    else:
        s.attach(_fat_chain())
    cs = s.commit(device="cpu")
    assert cs.packed is None
    rng = np.random.default_rng(3)
    org = rng.uniform(-2, 4, (256, 3)).astype(np.float32)
    aim = np.asarray(s._geoms[0].vertices)[rng.integers(0, 3, 256), :3]
    r = pt.make_rays(org, aim + rng.normal(0, 0.3, (256, 3)) - org,
                     device="cpu")
    h = pt.intersect(cs, r)
    hb = pt.intersect_brute(cs, r)
    m = hb.valid.numpy()
    assert m.sum() > 20
    np.testing.assert_array_equal(h.valid.numpy(), m)
    np.testing.assert_allclose(h.t.numpy()[m], hb.t.numpy()[m], rtol=1e-5)


def test_detach_and_disabled():
    v, i = _tri()
    s = pt.Scene()
    g0 = s.attach(pt.TriangleGeometry(v, i))
    g1 = s.attach(pt.TriangleGeometry(v + np.float32(5), i))
    s.detach(g0)
    cs = s.commit(device="cpu")
    assert cs.num_prims == 1 and int(cs.prim_geom[0]) == g1
    assert dataclasses.is_dataclass(cs)
