"""The generic engine and the scene kinds it serves: the port vs the JAX
package.

Native round, oriented and distance curves, flat curves of several rates,
fat round-line joints and min-width ride the JAX package's generic engine
(embree_tpu/accel/traverse.py; the port's accel/traverse_generic.py), the
hair tier's leaf OBBs among them. The JAX side runs in four subprocesses at
once with XLA limited to AVX and its algebraic simplifier off, as in
test_torch_curves.py; each scene is committed there (native builder, one
thread) and carried into the port with ``from_arrays``, BVH and leaf OBBs
included, so both engines walk the same tree.

1. Ops: ``intersect_distance``, ``intersect_oriented`` and
   ``eval_bezier_ddu`` bit-equal to the JAX ops (jitted) on seeded inputs;
   ``intersect_sweep``: equal hit masks, t and u within 1e-5 of the larger
   of 1 and their size, Ng within 1e-4 of the larger of 1 and |Ng|. XLA's
   CPU dot products contract with FMA (the small einsums of the sweep's 32
   seeds), so the seeds start an ulp apart, and a Newton root is fixed only
   to within its own error bound: u moves by up to 4e-6 and Ng, a cross
   product of the derivatives at u, by up to 2e-5 of its length.
2. Engine: the port's ``traverse_generic.traverse`` against the JAX
   engine's ``traverse`` on eight scenes (round, oriented and distance
   curves; flat curves of two rates; fat round-line and tessellated-curve
   joints; min-width; hair with the OBB tier; triangles), closest and any
   hit: equal best prims, equal lockstep step counts, no dropped push,
   hit t within 1e-5 relative. Scene level: ``intersect(backend="jnp")``
   (both modes) and ``occluded`` against the JAX package's: equal hit
   masks, prim and geometry ids, t/u/v within 1e-5 relative (of the larger
   of 1 and their size), Ng within 1e-5 of the larger of 1 and |Ng| (1e-4
   where round curves are hit, as in 1).
3. Routing: the port's own commit of each scene gets a packed table exactly
   where the JAX package's does, and the same leaf OBBs; the round-line
   joint repair (a 2-step chain fat only at its second step rides the
   kernel in both packages, with equal hits); the ``backend`` argument;
   the ``mixed`` viewer goldens.

The card-only test at the end imports no JAX: run it on the card with
``python -m pytest --noconftest tests/test_torch_generic.py -m cuda``.
"""
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

import embree_tpu_torch as pt
from embree_tpu_torch import scene as pscene
from embree_tpu_torch.accel import traverse_generic as tg
from embree_tpu_torch.ops import curve as curve_ops
from test_torch_curves import (BACKDROP, build, fat_curves, ribbon_inputs,
                               steps_of, strand)
from test_torch_round import round_geoms
from test_torch_traverse import bits, ray_set
import torch_jaxref

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@pytest.fixture(scope="module", autouse=True)
def _native_route():
    """The port's commits take the JAX side's build route: the native
    builder (EMBREE_TPU_NATIVE_BUILD=1) at every prim count, so both
    packages pack the same tree."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EMBREE_TPU_NATIVE_BUILD", "1")
        yield


F32 = np.float32
LEAF_SIZE = 8

# ---------------------------------------------------------------------------
# scenes, built the same way in both packages (``et`` is either)
# ---------------------------------------------------------------------------


def unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(F32)


def oriented_geoms(et):
    """Oriented curves: fat Bezier curves with per-CP normals, a hermite
    strand with normals and normal derivatives, a B-spline strand; the
    backdrop triangle."""
    rng = np.random.default_rng(13)
    cp, idx = fat_curves(rng, 12)
    hv = strand(rng, 4, r0=0.12, r1=0.08)
    tan = np.concatenate([rng.normal(size=(4, 3)) * 0.3,
                          np.full((4, 1), -0.01)], 1).astype(F32)
    return [et.CurveGeometry(cp, idx, basis="bezier", kind="oriented",
                             normals=unit(rng, 48)),
            et.CurveGeometry(hv, np.arange(3, dtype=np.int32),
                             basis="hermite", kind="oriented", tangents=tan,
                             normals=unit(rng, 4),
                             normal_derivatives=(0.2 * rng.normal(
                                 size=(4, 3))).astype(F32)),
            et.CurveGeometry(strand(rng, 7, r0=0.1, r1=0.06),
                             np.arange(4, dtype=np.int32), basis="bspline",
                             kind="oriented", normals=unit(rng, 7)),
            et.TriangleGeometry(*BACKDROP)]


def distance_geoms(et):
    """Distance curves (algorithm="distance") accelerating along x over 3
    steps (two windows) beside the static backdrop triangle."""
    cp, idx = fat_curves(np.random.default_rng(14), 16)
    return [et.CurveGeometry(steps_of(cp, (0.6, 0, 0), 3), idx,
                             basis="bezier", kind="flat",
                             algorithm="distance"),
            et.TriangleGeometry(*BACKDROP)]


def mixed_rate_geoms(et):
    """Flat curves of two rates (4 and 6): the kernel runs one rate per
    scene, so the scene rides the engine, which keeps each curve's own
    (masks 0x2, 0x1 and the triangle's 0x3)."""
    rng = np.random.default_rng(15)
    cp, idx = fat_curves(rng, 12)
    cp2, idx2 = fat_curves(rng, 12)
    geoms = [et.CurveGeometry(cp, idx, basis="bezier", kind="flat"),
             et.CurveGeometry(cp2, idx2, basis="bspline", kind="flat",
                              tessellation_rate=6),
             et.TriangleGeometry(*BACKDROP)]
    for g, m in zip(geoms, (0x2, 0x1, 0x3)):
        g.mask = m
    return geoms


def fat_chain_geoms(et):
    """Fat round-line joints: the chain of test_geometries.py:414-421
    (joint radius 1 on unit segments), a random fat chain moving over 2
    steps, and a fat round B-spline strand tessellated at rate 16; flat
    segments beside them."""
    rng = np.random.default_rng(16)
    chain = np.array([[0, 1, 0, 1.0], [0, 2, 0, 1.0], [0, 2.8, 0, 0.1]],
                     F32)
    walk = np.concatenate([np.cumsum(rng.normal(0, 0.3, (10, 3)), 0) - 1.0,
                           rng.uniform(0.15, 0.3, (10, 1))], 1).astype(F32)
    cp, idx = fat_curves(rng, 2)
    return [et.LineSegmentsGeometry(chain, np.array([0, 1], np.int32),
                                    kind="round"),
            et.LineSegmentsGeometry(steps_of(walk, (0, 0, 0.3), 2),
                                    np.arange(9, dtype=np.int32),
                                    kind="round"),
            et.CurveGeometry(cp, idx, basis="bspline", kind="round",
                             algorithm="tessellate", tessellation_rate=16),
            et.LineSegmentsGeometry(walk + F32(0.5), np.arange(
                0, 9, 2, dtype=np.int32), kind="flat")]


def min_width_geoms(et):
    """Thin prims of every radius-carrying kind: spheres, discs, round and
    flat segments, round and flat curves (with min_width_factor 0.02 and
    max_radius_scale 4: radii grow with the distance from the ray
    origin)."""
    rng = np.random.default_rng(17)
    pts = np.concatenate([rng.uniform(-1.5, 1.5, (24, 3)),
                          rng.uniform(0.005, 0.02, (24, 1))], 1).astype(F32)
    lv = np.concatenate([rng.uniform(-1.5, 1.5, (12, 3)),
                         rng.uniform(0.005, 0.02, (12, 1))], 1).astype(F32)
    cp, idx = fat_curves(rng, 8)
    cp[:, 3] *= F32(0.1)
    return [et.PointGeometry(pts[:12], kind="sphere"),
            et.PointGeometry(pts[12:], kind="disc"),
            et.LineSegmentsGeometry(lv, np.arange(0, 12, 2, dtype=np.int32),
                                    kind="round"),
            et.LineSegmentsGeometry(lv + F32(0.3), np.arange(
                0, 12, 2, dtype=np.int32), kind="flat"),
            et.CurveGeometry(cp[:16], idx[:4], basis="bezier", kind="round"),
            et.CurveGeometry(cp[16:], idx[:4], basis="bezier", kind="flat")]


def hair_geoms(et):
    """Hair: 32 thin round B-spline strands of 6 CPs (96 native curves), so
    the hair tier fits leaf OBBs, and 16 of their neighbours as flat
    curves."""
    rng = np.random.default_rng(18)
    sv = np.concatenate([strand(rng, 6, r0=0.03, r1=0.01, step=0.3)
                         for _ in range(48)])
    idx = (6 * np.arange(48))[:, None] + np.arange(3)[None]
    idx = idx.reshape(-1).astype(np.int32)
    return [et.CurveGeometry(sv[:32 * 6], idx[:96], basis="bspline",
                             kind="round"),
            et.CurveGeometry(sv[32 * 6:], idx[:48], basis="bspline",
                             kind="flat")]


def triangle_geoms(et):
    """The sphere of test_pallas_kernel.py:24-28, geometry mask 0x2."""
    from test_bvh import make_sphere_mesh
    verts, idx = make_sphere_mesh(8, 12)
    return [et.TriangleGeometry(verts, idx, mask=0x2)]


# name -> (geometry builder, scene keywords, knot times or None, masked
# rays); every scene here rides the generic engine in the JAX package but
# the triangles, which the engine answers through backend="jnp"
SCENES = {
    "round": (round_geoms, {}, None, False),
    "oriented": (oriented_geoms, {}, None, False),
    "distance": (distance_geoms, {}, (0.0, 0.5, 1.0), False),
    "mixed_rates": (mixed_rate_geoms, {}, None, True),
    "fat_chain": (fat_chain_geoms, {}, (0.0, 1.0), False),
    "min_width": (min_width_geoms, dict(min_width_factor=0.02,
                                        max_radius_scale=4.0), None, False),
    "hair": (hair_geoms, {}, None, False),
    "triangles": (triangle_geoms, {}, None, True),
}
PACKED = ("triangles",)
# the four subprocesses of the JAX side, about equal in time
JAX_PARTS = (("round", "triangles", "repair"), ("oriented", "distance"),
             ("mixed_rates", "fat_chain", "hair"), ("min_width", "ops"))


def scene_points(geoms):
    """The xyz of every vertex, point and control point of the scene."""
    out = []
    for g in geoms:
        a = getattr(g, "points", None)
        if a is None:
            a = g.vertices
        a = np.asarray(a, F32)
        out.append(a.reshape(-1, a.shape[-1])[:, :3])
    return np.concatenate(out)


def rays_for(name):
    """test_torch_traverse.py's ray_set (NaN and zero directions, mask-0
    and tnear > tfar rays among the first 32; random masks for the masked
    scenes), 96 of its random rays aimed near vertices of the scene (numpy
    seed 4), and for moving scenes times: 32 at the knot times, 16 outside
    [0, 1], the rest U[0, 1)."""
    geoms, _, knots, masked = SCENES[name]
    org, d, tn, tf, mask = ray_set("sphere_mask" if masked else name)
    rng = np.random.default_rng(4)
    pts = scene_points(geoms(pt))
    aim = pts[rng.integers(0, len(pts), 96)] + rng.normal(0, 0.05, (96, 3))
    d[128:224] = (aim - org[128:224]).astype(F32)
    time = rng.uniform(0, 1, org.shape[0]).astype(F32)
    if knots is not None:
        time[32:64] = np.resize(np.asarray(knots, F32), 32)
        time[64:80] = np.resize(np.array([-0.25, 1.25], F32), 16)
    return org, d, tn, tf, mask, time


def repair_geoms(et):
    """A 2-step round-line chain whose joints are fat at the second step
    only (radius 0.1 -> 0.7 on unit segments)."""
    a = np.array([[0, 0, 0, 0.1], [1, 0, 0, 0.1], [2, 0.5, 0, 0.1],
                  [3, 0.5, 0.5, 0.1]], F32)
    b = a.copy()
    b[:, 3] = 0.7
    b[:, 1] += 0.3
    return [et.LineSegmentsGeometry(np.stack([a, b]),
                                    np.arange(3, dtype=np.int32),
                                    kind="round")]


def repair_rays():
    rng = np.random.default_rng(19)
    n = 256
    org = np.concatenate([rng.uniform(-1, 4, (n, 2)),
                          np.full((n, 1), 3.0)], 1).astype(F32)
    d = np.concatenate([rng.normal(0, 0.1, (n, 2)),
                        np.full((n, 1), -1.0)], 1).astype(F32)
    return org, d, rng.uniform(0, 1, n).astype(F32)


# ---------------------------------------------------------------------------
# op inputs
# ---------------------------------------------------------------------------

def oriented_normals(n=2048, seed=5):
    return np.random.default_rng(seed).normal(size=(n, 4, 3)).astype(F32)


def ddu_inputs(seed=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(512, 4, 4)).astype(F32),
            rng.uniform(0, 1, 512).astype(F32))


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

# CommittedScene tables carried across (the port's names)
TABLES = ("tri_v0", "tri_v1", "tri_v2", "tri_v0b", "tri_v1b", "tri_v2b",
          "quad_v", "quad_vb", "quad_uvm", "pnt_c", "pnt_r", "pnt_n",
          "pnt_cb", "pnt_rb", "pnt_nb", "line_p0", "line_r0", "line_p1",
          "line_r1", "line_fl", "line_u0", "line_u1", "line_pL", "line_rL",
          "line_pR", "line_rR", "line_p0b", "line_r0b", "line_p1b",
          "line_r1b", "line_pLb", "line_rLb", "line_pRb", "line_rRb",
          "curve_cp", "curve_cpb", "curve_n", "curve_nb", "curve_prate",
          "leaf_obb_rot", "leaf_obb_lo", "leaf_obb_up")
PRIMS = ("prim_kind", "prim_geom", "prim_local", "prim_inst", "prim_data",
         "prim_mask", "prim_t0", "prim_t1")


def _scene_flags(cs):
    f = dict(kinds_present=list(cs.kinds_present), robust=cs.robust,
             has_motion=cs.has_motion, has_windows=cs.has_windows,
             curve_rate=cs.curve_rate,
             curve_rates_present=list(cs.curve_rates_present),
             min_width_factor=cs.min_width_factor,
             max_radius_scale=cs.max_radius_scale,
             packed=cs.packed is not None)
    if cs.packed is not None:
        pk = cs.packed
        f.update(gn=pk.gn, has_mask=pk.has_mask, tri_attrs=pk.tri_attrs,
                 has_kinds=pk.has_kinds, kind_classes=list(pk.kind_classes),
                 nf=pk.nf)
    return np.array(json.dumps(f))


def _jax_ops(res):
    import jax
    from embree_tpu.ops import curve as jc
    x = ribbon_inputs(2048, seed=3)
    args = (x["org"], x["dir"], x["cp"], x["tnear"], x["tfar"])
    for name, out in (
            ("sweep", jax.jit(jc.intersect_sweep)(*args)),
            ("distance", jax.jit(jc.intersect_distance)(*args)),
            ("oriented", jax.jit(jc.intersect_oriented)(
                x["org"], x["dir"], x["cp"], oriented_normals(), x["tnear"],
                x["tfar"]))):
        for k, a in enumerate(out):
            res[f"op/{name}/{k}"] = np.asarray(a)
    cp, u = ddu_inputs()
    res["op/ddu"] = np.asarray(jc.eval_bezier_ddu(cp, u))


def _hit_record(res, key, h):
    for f in ("valid", "t", "u", "v", "ng", "prim_id", "geom_id"):
        res[f"{key}/{f}"] = np.asarray(getattr(h, f))


def _jax_reference(out_path, part):
    """One part of the JAX side: the ops, each scene's committed arrays,
    its engine traversal (closest and any hit: best prim, t, steps,
    overflow) and its hits; the repair scene through the Pallas path."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import embree_tpu as et
    from embree_tpu import scene as es
    from embree_tpu.accel import traverse as tm
    from test_torch_traverse import jax_native_ready

    jax_native_ready()
    res = {}

    @functools.partial(jax.jit, static_argnums=2)
    def engine(cs, r, occlusion):
        return tm.traverse(cs.bvh, es._make_prim_test(cs, r), r.org, r.dir,
                           r.tnear, r.tfar, occlusion=occlusion,
                           max_leaf_size=es.LEAF_SIZE, robust=cs.robust,
                           leaf_obb=es._scene_leaf_obb(cs))

    def jax_rays(org, d, tn, tf, mask, time):
        return et.make_rays(jnp.asarray(org), jnp.asarray(d),
                            jnp.asarray(tn), jnp.asarray(tf),
                            jnp.asarray(time), jnp.asarray(mask))

    for name in JAX_PARTS[part]:
        if name == "ops":
            _jax_ops(res)
            continue
        if name == "repair":
            cs = build(et, repair_geoms, threads=1).commit()
            res["repair/packed"] = np.array(cs.packed is not None)
            org, d, time = repair_rays()
            r = et.make_rays(jnp.asarray(org), jnp.asarray(d),
                             time=jnp.asarray(time))
            _hit_record(res, "repair/hit",
                        et.intersect(cs, r, backend="pallas"))
            continue
        geoms, kw, _, _ = SCENES[name]
        cs = build(et, geoms, threads=1, **kw).commit()
        for k in PRIMS + tuple(t for t in TABLES if hasattr(cs, t)):
            res[f"{name}/{k}"] = np.asarray(getattr(cs, k))
        for k in ("node_lower", "node_upper", "node_child", "prim_order"):
            res[f"{name}/bvh.{k}"] = np.asarray(getattr(cs.bvh, k))
        if cs.packed is not None:
            res[f"{name}/packed.table"] = np.asarray(cs.packed.table)
            res[f"{name}/packed.pid_map"] = np.asarray(cs.packed.pid_map)
        res[f"{name}/flags"] = _scene_flags(cs)
        r = jax_rays(*rays_for(name))
        for occ in (False, True):
            out = engine(cs, r, occ)
            key = f"{name}/{'occ' if occ else 'closest'}"
            res[f"{key}/best"] = np.asarray(out.best_prim)
            res[f"{key}/tfar"] = np.asarray(out.tfar)
            res[f"{key}/steps"] = np.asarray(out.steps)
            res[f"{key}/overflow"] = np.asarray(out.overflow)
            if not occ:
                _hit_record(res, f"{name}/hit",
                            jax.jit(es._reconstruct_hits)(cs, r,
                                                          out.best_prim))
    np.savez(out_path, **res)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one CPU thread: its tensors are small,
    and under the test run's parallel workers (and the JAX side's
    subprocesses) a thread pool per process oversubscribes the cores
    several times over. Elementwise ops, exact min/max and integer sums
    give the same bits on any thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jaxref_generic")
    shared = torch_jaxref.shared_dir(tmp_path_factory)
    env = torch_jaxref.env("--xla_cpu_max_isa=AVX "
                           "--xla_disable_hlo_passes=algsimp",
                           EMBREE_TPU_NATIVE_BUILD="1")
    paths = [str(out / f"ref{k}.npz") for k in range(len(JAX_PARTS))]
    torch_jaxref.run([torch_jaxref.script(__file__, path, k)
                      for k, path in enumerate(paths)], shared, env)
    ref = {}
    for path in paths:
        ref.update(np.load(path))
    return ref


def port_scene(ref, name):
    arrays = {k.split("/", 1)[1]: v for k, v in ref.items()
              if k.startswith(name + "/") and k.count("/") == 1
              and not k.endswith("/flags")}
    flags = json.loads(str(ref[f"{name}/flags"]))
    return pt.from_arrays(arrays, flags, "cpu")


def port_batch(name, device="cpu"):
    org, d, tn, tf, mask, time = rays_for(name)
    return pt.make_rays(org, d, tn, tf, time, mask, device=device)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(a, b, tol=1e-5, norm=False):
    """|a - b| within tol of max(|b|, 1), per component, or of the larger
    of 1 and the row's norm (``norm``)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = (np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1.0)
             if norm else np.maximum(np.abs(b), 1.0))
    return bool((np.abs(a - b) <= tol * scale).all())


# ---------------------------------------------------------------------------
# 1. ops against the JAX ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sweep", "distance", "oriented"])
def test_curve_op_matches_jax(jax_ref, op):
    """The native curve intersectors against the JAX ops: distance and
    oriented bit-equal, the sweep as the module docstring says."""
    x = {k: _t(v) for k, v in ribbon_inputs(2048, seed=3).items()}
    args = (x["org"], x["dir"], x["cp"], x["tnear"], x["tfar"])
    if op == "sweep":
        got = curve_ops.intersect_sweep(*args)
    elif op == "distance":
        got = curve_ops.intersect_distance(*args)
    else:
        got = curve_ops.intersect_oriented(
            x["org"], x["dir"], x["cp"], _t(oriented_normals()), x["tnear"],
            x["tfar"])
    hit = jax_ref[f"op/{op}/0"]
    assert 0.2 < hit.mean() < 0.8
    np.testing.assert_array_equal(got[0].numpy(), hit)
    for k, name in enumerate(("t", "u", "v", "ng"), 1):
        a, b = got[k].numpy()[hit], jax_ref[f"op/{op}/{k}"][hit]
        if op != "sweep":
            np.testing.assert_array_equal(bits(a), bits(b), err_msg=name)
        elif name == "ng":
            assert _close(a, b, 1e-4, norm=True), name
        else:
            assert _close(a, b), name


def test_eval_bezier_ddu_bits(jax_ref):
    cp, u = ddu_inputs()
    got = curve_ops.eval_bezier_ddu(_t(cp), _t(u)).numpy()
    np.testing.assert_array_equal(bits(got), bits(jax_ref["op/ddu"]))


# ---------------------------------------------------------------------------
# 2. the engine and the scene level against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("occ", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_engine_matches_jax(jax_ref, name, occ):
    """The port's engine on the carried-across scene: the JAX engine's best
    prims, lockstep step count and overflow (0); t of the hits within 1e-5
    relative."""
    cs = port_scene(jax_ref, name)
    assert (cs.packed is None) == (name not in PACKED)
    if name == "hair":
        assert cs.leaf_obb_rot.shape[0] > 0
    r = port_batch(name)
    res = tg.traverse(cs.bvh, pscene._make_prim_test(cs, r), r.org, r.dir,
                      r.tnear, r.tfar, occlusion=occ, max_leaf_size=LEAF_SIZE,
                      robust=cs.robust, leaf_obb=pscene._scene_leaf_obb(cs))
    key = f"{name}/{'occ' if occ else 'closest'}"
    best = jax_ref[f"{key}/best"]
    assert (best >= 0).sum() > 20
    np.testing.assert_array_equal(res.best_prim.numpy(), best)
    assert res.steps == int(jax_ref[f"{key}/steps"])
    assert res.overflow == 0 == int(jax_ref[f"{key}/overflow"])
    if not occ:
        hit = best >= 0
        np.testing.assert_allclose(res.tfar.numpy()[hit],
                                   jax_ref[f"{key}/tfar"][hit], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_intersect_matches_jax(jax_ref, name):
    """intersect(backend="jnp") and occluded against the JAX package's
    generic engine: equal hit masks and ids, t/u/v/Ng close. Both intersect
    modes take the same route on the engine (traversal, then the
    re-intersection); the three slowest scenes on the CPU run one."""
    cs = port_scene(jax_ref, name)
    r = port_batch(name)
    key = f"{name}/hit"
    m = jax_ref[f"{key}/valid"]
    assert m.sum() > 20
    for diff in (True,) if name in ("round", "oriented", "hair") else (
            True, False):
        h = pt.intersect(cs, r, backend="jnp", differentiable=diff)
        np.testing.assert_array_equal(h.valid.numpy(), m)
        np.testing.assert_array_equal(h.prim_id.numpy()[m],
                                      jax_ref[f"{key}/prim_id"][m])
        np.testing.assert_array_equal(h.geom_id.numpy()[m],
                                      jax_ref[f"{key}/geom_id"][m])
        for f in ("t", "u", "v"):
            assert _close(getattr(h, f).detach().numpy()[m],
                          jax_ref[f"{key}/{f}"][m]), f
        best = jax_ref[f"{name}/closest/best"]
        round_hit = (cs.prim_kind.numpy()[np.maximum(best, 0)] == 9) & m
        ng, ng_ref = h.ng.detach().numpy(), jax_ref[f"{key}/ng"]
        assert _close(ng[m & ~round_hit], ng_ref[m & ~round_hit],
                      norm=True), "ng"
        assert _close(ng[round_hit], ng_ref[round_hit], 1e-4, norm=True), \
            "ng of round curves"
    np.testing.assert_array_equal(pt.occluded(cs, r, backend="jnp").numpy(),
                                  jax_ref[f"{name}/occ/best"] >= 0)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_commit_routes_as_jax(jax_ref, name):
    """The port's own commit: a packed table exactly where the JAX
    package's commit has one, the same kinds, curve rates and min-width
    settings, and (the same native build) the same leaf OBBs."""
    geoms, kw, _, _ = SCENES[name]
    cs = build(pt, geoms, threads=1, **kw).commit(device="cpu")
    flags = json.loads(str(jax_ref[f"{name}/flags"]))
    assert (cs.packed is not None) == flags["packed"]
    assert list(cs.kinds_present) == flags["kinds_present"]
    assert list(cs.curve_rates_present) == flags["curve_rates_present"]
    assert cs.curve_rate == flags["curve_rate"]
    assert (cs.min_width_factor, cs.max_radius_scale) == (
        flags["min_width_factor"], flags["max_radius_scale"])
    np.testing.assert_array_equal(cs.bvh.node_child.numpy(),
                                  jax_ref[f"{name}/bvh.node_child"])
    for k in ("leaf_obb_rot", "leaf_obb_lo", "leaf_obb_up", "curve_prate"):
        np.testing.assert_array_equal(getattr(cs, k).numpy(),
                                      jax_ref[f"{name}/{k}"], err_msg=k)


def test_brute_matches_engine():
    """intersect_brute (no BVH, the neighbor clip on) against the engine on
    the fat chain and the oriented curves (rays with a direction: brute
    force tests a zero direction against every prim, traversal finds no
    box)."""
    for name in ("fat_chain", "oriented"):
        geoms, kw, _, _ = SCENES[name]
        cs = build(pt, geoms, **kw).commit(device="cpu")
        org, d, tn, tf, mask, time = rays_for(name)
        r = pt.make_rays(org[32:], d[32:], tn[32:], tf[32:], time[32:],
                         mask[32:], device="cpu")
        hb = pt.intersect_brute(cs, r)
        he = pt.intersect(cs, r)
        m = hb.valid.numpy()
        assert m.sum() > 20
        np.testing.assert_array_equal(he.valid.numpy(), m)
        np.testing.assert_allclose(he.t.numpy()[m], hb.t.numpy()[m],
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# 3. routing
# ---------------------------------------------------------------------------

def test_fat_joint_at_step_b_rides_kernel(jax_ref):
    """The repaired predicate reads the first time step only, as the JAX
    merger does (scene.py:552-557): a 2-step chain fat only at its second
    step gets a packed table in both packages, and the port's kernel route
    (its plain version) gives the JAX package's Pallas hits."""
    assert bool(jax_ref["repair/packed"])
    cs = build(pt, repair_geoms).commit(device="cpu")
    assert cs.packed is not None and cs.has_motion
    org, d, time = repair_rays()
    h = pt.intersect(cs, pt.make_rays(org, d, time=time, device="cpu"))
    m = jax_ref["repair/hit/valid"]
    assert 20 < m.sum() < m.size
    np.testing.assert_array_equal(h.valid.numpy(), m)
    np.testing.assert_array_equal(h.prim_id.numpy()[m],
                                  jax_ref["repair/hit/prim_id"][m])


def test_backend_argument():
    """backend="jnp" answers a packed scene with the engine (the kernel's
    hits here), "pallas" needs a packed table, other values raise."""
    geoms, kw, _, _ = SCENES["triangles"]
    cs = build(pt, geoms, **kw).commit(device="cpu")
    r = port_batch("triangles")
    hk = pt.intersect(cs, r, backend="pallas")
    hj = pt.intersect(cs, r, backend="jnp")
    np.testing.assert_array_equal(hk.valid.numpy(), hj.valid.numpy())
    np.testing.assert_array_equal(hk.prim_id.numpy(), hj.prim_id.numpy())
    np.testing.assert_array_equal(pt.occluded(cs, r, backend="jnp").numpy(),
                                  hk.valid.numpy())
    cs = build(pt, round_geoms).commit(device="cpu")
    with pytest.raises(ValueError):
        pt.intersect(cs, r, backend="pallas")
    with pytest.raises(ValueError):
        pt.occluded(cs, r, backend="cuda")


@pytest.mark.parametrize("sh", ["eyelight", "primID", "uv"])
def test_mixed_golden(sh):
    """The viewer's ``mixed`` scene (a quad floor, two spheres and a round
    Bezier curve: the generic engine) within 10 wrong pixels of
    tests/golden/mixed_*.pfm, the bar of test_golden_images.py:48."""
    from embree_tpu_torch.models.camera import Camera
    from embree_tpu_torch.models.viewer import render
    from embree_tpu_torch.tools.viewer import build_scene
    from embree_tpu_torch.utils.image import compare_images, load_pfm
    scene, eye = build_scene("mixed", pt)
    cs = scene.commit(device="cpu")
    assert cs.packed is None
    cam = Camera(from_point=np.asarray(eye, F32), to_point=np.zeros(3, F32),
                 up=np.array([0, 1, 0], F32))
    img = render(cs, cam, 96, 96, shader=sh).numpy()
    ref = load_pfm(os.path.join(HERE, "golden", f"mixed_{sh}.pfm"))
    assert compare_images(img, ref) <= 10


# ---------------------------------------------------------------------------
# card-only: the engine on CUDA tensors
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_engine_on_card_matches_cpu():
    """On an NVIDIA GPU: the engine on CUDA tensors gives the CPU's best
    prims, steps and hit masks on every scene."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    for name, (geoms, kw, _, _) in SCENES.items():
        out = {}
        for dev in ("cpu", "cuda"):
            cs = build(pt, geoms, threads=1, **kw).commit(device=dev)
            r = port_batch(name, dev)
            res = tg.traverse(cs.bvh, pscene._make_prim_test(cs, r), r.org,
                              r.dir, r.tnear, r.tfar,
                              max_leaf_size=LEAF_SIZE, robust=cs.robust,
                              leaf_obb=pscene._scene_leaf_obb(cs))
            out[dev] = (res.best_prim.cpu(), res.steps)
        assert torch.equal(out["cpu"][0], out["cuda"][0]), name
        assert out["cpu"][1] == out["cuda"][1], name


if __name__ == "__main__":
    _jax_reference(sys.argv[1], int(sys.argv[2]))
