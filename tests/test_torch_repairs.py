"""Repairs of the port, the first three held against the JAX package.

1. Moving normal derivatives do not make a scene move. The JAX merger
   drops the motion flag of a hermite curve's ``normal_derivatives``
   (``dn, dnb, _ = self._steps(...)``, embree_tpu/scene.py:628-630), so a
   scene whose only moving buffer they are stays static: ``has_motion`` is
   False and the oriented test reads the first step's normal spline at
   every ray time. The port's merger follows it.
2. ``intersect_brute`` always takes the round-line neighbor clip, as the
   JAX brute force does through ``_make_prim_test`` and ``_kind_test``
   (embree_tpu/scene.py:1369-1380, :1505-1528), also on scenes whose
   queries ride the kernel (a chain of thin round lines is packed).
3. A scene whose geometries hold no prims is empty. ``commit()`` counts
   the merged rows, as the JAX package does (``m.total() == 0``,
   embree_tpu/scene.py:285), and raises ``ValueError("commit() on empty
   scene")``; the port's merger appends a block of no rows for each such
   geometry, which passed its old check and failed in the native builder.

4. Fault C.2: B6's moving masked kind-tag closest-hit launches sometimes
   walked the tree twice for a few rays of a warp. At the 128-register
   bound ptxas left out the wait of the pop's shared-memory load in those
   two variants: the loop read the next record's register before the load
   landed, and took the value set just before it, the root (launch.cuh,
   ``kMotionKindsMinBlocks``). ``perf/sass_hazards.py`` finds such reads
   in a library's SASS; its cases here run on listings written out, and
   on the toolkit (``-m cuda``) it checks the built traversal library. The
   card test repeats the launch that showed it, phase 9's moving masked
   kind check scene at 65,536 rays, 100 times on each build route and in
   normal and robust mode, each launch bit-equal to the plain version (t,
   prim, step counts). Run those with ``python -m pytest --noconftest
   tests/test_torch_repairs.py -m cuda``.

5. A library that is up to date still gives its compiler output. The
   build keeps it beside the library (``<library>.log``), so a second
   process that finds the library built reads the same ptxas lines in
   ``_build.BUILD_LOGS``; it used to find none, and the smoke run's check
   of the traversal kernels' registers failed in a second run of one
   checkout.

The JAX side runs in this process: the checks of 1-3 hold the port to a
tolerance (t within 1e-4 relative), not to the bit.
"""
import os
import sys

import numpy as np
import pytest
import torch

import embree_tpu_torch as pt

F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for this module's small torch ops (see
    test_torch_round.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import embree_tpu as et
    return jax, et


def _aimed_rays(targets, n, seed):
    """n rays from a shell of radius 2-3 around each target point in turn,
    aimed at it with a small jitter; times U(0, 1], none at 0."""
    rng = np.random.default_rng(seed)
    tgt = targets[np.arange(n) % len(targets)]
    v = rng.normal(size=(n, 3))
    org = tgt + v / np.linalg.norm(v, axis=1, keepdims=True) * \
        rng.uniform(2, 3, (n, 1))
    aim = tgt + rng.normal(0, 0.03, (n, 3))
    time = 1.0 - rng.uniform(0, 1, n)
    return (org.astype(F32), (aim - org).astype(F32), time.astype(F32))


def _hermite_geoms(et):
    """A hermite oriented strand: static vertices, tangents and normals;
    normal derivatives over 2 time steps, which differ a lot."""
    rng = np.random.default_rng(31)
    p = np.zeros((5, 4), F32)
    p[:, 0] = np.linspace(-1, 1, 5)
    p[:, 1] = 0.2 * rng.normal(size=5)
    p[:, 3] = 0.15
    tan = np.concatenate([np.tile([[0.5, 0, 0]], (5, 1)),
                          np.zeros((5, 1))], 1).astype(F32)
    nrm = rng.normal(size=(5, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(F32)
    dn = np.stack([np.zeros((5, 3)), 3.0 * rng.normal(size=(5, 3))]) \
        .astype(F32)
    return [et.CurveGeometry(p, np.arange(4, dtype=np.int32),
                             basis="hermite", kind="oriented", tangents=tan,
                             normals=nrm, normal_derivatives=dn)], p[:, :3]


def test_moving_normal_derivatives_stay_static():
    """Repair 1: the hermite oriented strand whose only moving buffer is
    its normal derivatives; rays at times in (0, 1]. Both packages commit
    a static scene (has_motion False), hit masks are equal and t agrees
    within 1e-4 relative."""
    jax, et = _jax()
    import jax.numpy as jnp
    scenes = []
    for pkg in (et, pt):
        geoms, pts = _hermite_geoms(pkg)
        s = pkg.Scene()
        for g in geoms:
            s.attach(g)
        scenes.append(s)
    cs_j = scenes[0].commit()
    cs_p = scenes[1].commit(device="cpu")
    assert not cs_j.has_motion and not cs_p.has_motion
    org, d, time = _aimed_rays(pts, 192, 5)
    hj = jax.jit(et.intersect)(cs_j, et.make_rays(
        jnp.asarray(org), jnp.asarray(d), time=jnp.asarray(time)))
    hp = pt.intersect(cs_p, pt.make_rays(org, d, time=time, device="cpu"))
    vj, vp = np.asarray(hj.valid), hp.valid.numpy()
    assert vj.sum() > 60
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_allclose(hp.t.numpy()[vj], np.asarray(hj.t)[vj],
                               rtol=1e-4)
    np.testing.assert_array_equal(hp.prim_id.numpy()[vj],
                                  np.asarray(hj.prim_id)[vj])


def _chain_geoms(et):
    """A zigzag chain of 12 thin round lines (radius 0.04-0.06, no fat
    joint, so the port and the JAX package both pack it for the kernel)."""
    rng = np.random.default_rng(32)
    v = np.zeros((13, 4), F32)
    v[:, 0] = np.linspace(-1.2, 1.2, 13)
    v[:, 1] = np.where(np.arange(13) % 2, 0.25, -0.25)
    v[:, 2] = 0.1 * rng.normal(size=13)
    v[:, 3] = rng.uniform(0.04, 0.06, 13)
    return et.LineSegmentsGeometry(v, np.arange(12, dtype=np.int32),
                                   kind="round"), v[:, :3]


def test_brute_force_clips_like_jax():
    """Repair 2: on the packed chain of thin round lines, rays aimed at
    the joints (into a neighbor's capped cone): the port's brute force
    equals the JAX package's, hit masks and prim ids equal, t within 1e-4
    relative."""
    jax, et = _jax()
    import jax.numpy as jnp
    gj, joints = _chain_geoms(et)
    gp, _ = _chain_geoms(pt)
    sj, sp = et.Scene(), pt.Scene()
    sj.attach(gj)
    sp.attach(gp)
    cs_j, cs_p = sj.commit(), sp.commit(device="cpu")
    assert cs_p.packed is not None
    org, d, _ = _aimed_rays(joints[1:-1], 256, 6)
    hj = jax.jit(et.intersect_brute)(cs_j, et.make_rays(
        jnp.asarray(org), jnp.asarray(d)))
    hp = pt.intersect_brute(cs_p, pt.make_rays(org, d, device="cpu"))
    vj = np.asarray(hj.valid)
    assert vj.sum() > 100
    np.testing.assert_array_equal(hp.valid.numpy(), vj)
    np.testing.assert_array_equal(hp.prim_id.numpy()[vj],
                                  np.asarray(hj.prim_id)[vj])
    np.testing.assert_allclose(hp.t.numpy()[vj], np.asarray(hj.t)[vj],
                               rtol=1e-4)


def _empty(pkg, kind):
    """One geometry of ``kind`` with no prims, in package ``pkg``."""
    z = np.zeros
    return {
        "triangles": lambda: pkg.TriangleGeometry(
            z((3, 3), F32), z((0, 3), np.int32)),
        "quads": lambda: pkg.QuadGeometry(z((4, 3), F32), z((0, 4), np.int32)),
        "points": lambda: pkg.PointGeometry(z((0, 4), F32), kind="sphere"),
        "lines": lambda: pkg.LineSegmentsGeometry(
            z((2, 4), F32), z((0,), np.int32), kind="round"),
        "curves": lambda: pkg.CurveGeometry(
            z((4, 4), F32), z((0,), np.int32), basis="bezier", kind="flat"),
    }[kind]()


EMPTY_KINDS = ("triangles", "quads", "points", "lines", "curves")


@pytest.mark.parametrize("kind", EMPTY_KINDS)
def test_empty_geometry_alone_raises(kind):
    """Repair 3: a scene of one empty geometry of each packed kind raises
    ValueError in both packages."""
    _, et = _jax()
    for pkg, kw in ((et, {}), (pt, {"device": "cpu"})):
        s = pkg.Scene()
        s.attach(_empty(pkg, kind))
        with pytest.raises(ValueError, match="empty scene"):
            s.commit(**kw)


@pytest.mark.parametrize("kind", EMPTY_KINDS)
def test_empty_geometry_beside_mesh(kind):
    """Repair 3: an empty geometry of each packed kind beside a triangle
    sphere commits in both packages, and 256 rays hit alike: hit masks,
    prim and geometry ids equal, t within 1e-4 relative."""
    jax, et = _jax()
    import jax.numpy as jnp
    from embree_tpu_torch.tools.viewer import sphere_mesh
    v, idx = sphere_mesh(8, 12)
    rng = np.random.default_rng(33)
    org = rng.uniform(-2, 2, (256, 3)).astype(F32)
    d = (rng.uniform(-0.5, 0.5, (256, 3)) - org).astype(F32)
    out = []
    for pkg in (et, pt):
        s = pkg.Scene()
        s.attach(_empty(pkg, kind))
        s.attach(pkg.TriangleGeometry(v, idx))
        if pkg is et:
            h = jax.jit(et.intersect)(s.commit(), et.make_rays(
                jnp.asarray(org), jnp.asarray(d)))
        else:
            h = pt.intersect(s.commit(device="cpu"),
                             pt.make_rays(org, d, device="cpu"))
        out.append([np.asarray(getattr(h, f)) for f in
                    ("valid", "t", "prim_id", "geom_id")])
    (vj, tj, pj, gj), (vp, tp, pp, gp) = out
    assert vj.sum() > 100
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_array_equal(pp[vj], pj[vj])
    np.testing.assert_array_equal(gp[vj], gj[vj])
    np.testing.assert_allclose(tp[vj], tj[vj], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["1", "auto"])
def test_masked_kinds_motion_launches_repeat(route, monkeypatch):
    """Fault C.2: 100 launches of each of B6's masked kind-tag closest-hit
    variants (normal and robust) on phase 9's moving scene, every one
    bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from embree_tpu_torch.accel import traverse as tr
    monkeypatch.setenv("EMBREE_TPU_NATIVE_BUILD", route)
    org, d = cs.incoherent_rays(cs.KINDS_RAYS, 0)
    rmask = np.random.default_rng(1).choice(np.array([1, 2, 3], np.uint32),
                                            cs.KINDS_RAYS)
    for robust in (False, True):
        c = cs.mixed_check_scene(pt, True, robust, 2).commit(device="cuda")
        x = cs.sorted_inputs(tr, pt.make_rays(
            org, d, time=cs.ray_times(cs.KINDS_RAYS), mask=rmask,
            device="cuda"))
        p = cs.run_plain(tr, c.packed, x, robust=robust)
        for _ in range(100):
            k = cs.run_kernel(tr, c.packed, x, robust=robust)
            torch.cuda.synchronize()
            assert torch.equal(k.best, p.best)
            assert torch.equal(k.t.view(torch.int32), p.t.view(torch.int32))
            assert torch.equal(k.visits, p.visits)
            assert int(k.overflow) == 0


def test_build_log_kept_for_an_up_to_date_library(tmp_path):
    """A second build of an unchanged library compiles nothing and reads
    the first build's compiler output."""
    import shutil
    from embree_tpu_torch import _build
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    src = tmp_path / "warn.c"
    src.write_text('#warning "a line of compiler output"\nint f(void) '
                   '{ return 1; }\n')
    target = _build.Target(str(tmp_path / "libwarn.so"), (str(src),), (),
                           ("g++", "-shared", "-fPIC"))
    targets = {"warn_probe": target}
    _build.BUILD_LOGS.pop("warn_probe", None)
    _build.build_all(["warn_probe"], targets)
    first = _build.BUILD_LOGS.pop("warn_probe")
    assert "a line of compiler output" in first
    built = os.path.getmtime(target.path)
    _build.build_all(["warn_probe"], targets)
    assert os.path.getmtime(target.path) == built
    assert _build.BUILD_LOGS.pop("warn_probe") == first


def _sass(*rows, name="kernel"):
    """A cuobjdump -sass listing of one function: rows of (text, write
    barrier, read barrier, wait mask), 7 for no barrier."""
    lines = [f"\t\tFunction : {name}"]
    for k, (text, wbar, rbar, wait) in enumerate(rows):
        hi = ((1 | wbar << 5 | rbar << 8 | wait << 11) << 41) | 0x800
        lines.append(f"        /*{16 * k:04x}*/  {text} ;  "
                     f"/* 0x{k:016x} */")
        lines.append(f"                       /* 0x{hi:016x} */")
    return "\n".join(lines) + "\n"


# the pop of fault C.2: a guarded shared-memory load of the next record,
# then a branch back to the loop that reads it
C2_POP = [("HFMA2.MMA R5, -RZ, RZ, 0, 0", 7, 7, 0),
          ("@!P0 LDS R5, [R12]", 1, 0, 0),
          ("IADD3 R12, R6, R0, RZ", 7, 7, 1 << 0)]


@pytest.mark.parametrize("case,expect", [
    # the loop reads R5 with no wait on barrier 1: fault C.2's SASS
    ("no_wait", [("RAW", 1, "R5")]),
    # a wait on barrier 1 before the read
    ("wait", []),
    # a DEPBAR on barrier 1 before the read
    ("depbar", []),
    # overwritten under the complementary guard: one of the two ran
    ("complement", []),
    # the same guard: both may run
    ("same_guard", [("WAW", 1, "R5")]),
    # the read sits in a case of a jump table after the load
    ("jump_table", [("RAW", 1, "R5")]),
    # a second shared-memory load into R5: one queue, in order
    ("same_queue", []),
    # a global load into R5 may land first
    ("other_queue", [("WAW", 1, "R5")]),
])
def test_sass_hazards(case, expect):
    """Fault C.2's check: a read of a register whose shared-memory load
    no wait covers is found on every path to it, and only there."""
    from embree_tpu_torch.perf import sass_hazards as sh
    rows = list(C2_POP)
    if case == "no_wait":
        rows += [("BRA 0x50", 7, 7, 0), ("NOP", 7, 7, 0),
                 ("ISETP.GT.AND P1, PT, R5, -0x1, PT", 7, 7, 0),
                 ("EXIT", 7, 7, 0)]
    elif case == "wait":
        rows += [("ISETP.GT.AND P1, PT, R5, -0x1, PT", 7, 7, 1 << 1),
                 ("EXIT", 7, 7, 0)]
    elif case == "depbar":
        rows += [("DEPBAR.LE SB1, 0x0", 7, 7, 0),
                 ("VIMNMX R12, R5, UR6, PT", 7, 7, 0), ("EXIT", 7, 7, 0)]
    elif case in ("complement", "same_guard"):
        g = "@P0" if case == "complement" else "@!P0"
        rows += [(f"{g} MOV R5, 0x1", 7, 7, 0), ("EXIT", 7, 7, 0)]
    elif case in ("same_queue", "other_queue"):
        load = ("@!P0 LDS R5, [R12+0x4]" if case == "same_queue"
                else "LDG.E R5, desc[UR8][R2.64]")
        rows += [(load, 2, 7, 0), ("EXIT", 7, 7, 0)]
    else:
        rows += [("LDC R2, c[0x2][R0]", 0, 7, 0),
                 ("BRX R2 -0x50", 7, 7, 1 << 0),
                 ("BRA 0x70", 7, 7, 0),
                 ("ISETP.GE.AND P2, PT, R5, RZ, PT", 7, 7, 0),
                 ("EXIT", 7, 7, 0)]
    funcs = sh.parse(_sass(*rows))
    found = sh.hazards(funcs["kernel"])
    assert [(h.kind, h.barrier, h.reg) for h in found] == expect
    for h in found:
        assert h.source.text == "@!P0 LDS R5, [R12]"


def test_sass_hazards_reads_every_function():
    """Each function of a listing is checked on its own, and the report
    counts the hazards of all of them."""
    from embree_tpu_torch.perf import sass_hazards as sh
    text = (_sass(*C2_POP, ("ISETP.LT.AND P0, PT, R5, RZ, P0", 7, 7, 0),
                  ("EXIT", 7, 7, 0), name="faulty")
            + _sass(*C2_POP, ("ISETP.LT.AND P0, PT, R5, RZ, P0", 7, 7, 2),
                    ("EXIT", 7, 7, 0), name="repaired"))
    funcs = sh.parse(text)
    assert sorted(funcs) == ["faulty", "repaired"]
    assert [len(c) for c in funcs.values()] == [5, 5]
    assert len(sh.hazards(funcs["faulty"])) == 1
    assert sh.hazards(funcs["repaired"]) == []
    assert sh.report(funcs) == 1


@pytest.mark.cuda
def test_traversal_library_sass_has_no_hazard():
    """Fault C.2: no function of the built traversal library reads or
    overwrites a register before the wait on its load (needs nvcc and
    cuobjdump)."""
    import shutil
    if shutil.which("cuobjdump") is None and not os.path.exists(
            "/usr/local/cuda/bin/cuobjdump"):
        pytest.skip("needs the CUDA toolkit; run on the card")
    from embree_tpu_torch.perf import sass_hazards as sh
    funcs = sh.parse(sh.library_sass("traverse_cuda", []))
    assert sum("persistent_kernel" in f for f in funcs) == 72
    assert sh.report(funcs) == 0
