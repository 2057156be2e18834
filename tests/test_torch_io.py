"""Scene files: the port's copies of the JAX package's loaders and writers.

1. The port's counterparts of the 4 cases of tests/test_io.py (PLY ascii
   and binary, the XML writer's round trip through ``to_scene`` and the
   port's commit and hits, hermite tangents under a transform).
2. A PLY, an OBJ (with its .mtl) and an XML scene (every geometry tag the
   loader reads, transforms, a time range, motion steps, materials, every
   light tag and a camera), and an EXR image, loaded by both packages: the
   geometry objects equal field for field, the lights, Kd colors, cameras
   and OBJ materials equal, and the scene's merged rows and tables (what
   ``commit`` packs) bit-equal between the two packages' mergers.

Everything here is numpy on both sides, so the JAX package runs in-process.
"""
import struct

import numpy as np
import pytest
import torch

import embree_tpu_torch as pt
from embree_tpu_torch.utils.exr import compare_images, read_exr, write_exr
from embree_tpu_torch.utils.obj import load_obj, obj_to_scene
from embree_tpu_torch.utils.ply import load_ply, load_ply_scene, write_xml
from embree_tpu_torch.utils.xml_scene import XMLScene, load_xml, to_scene
from test_torch_round import one_thread  # noqa: F401 (module-wide autouse)
from test_torch_traverse import bits

F32 = np.float32
CPU = "cpu"


@pytest.fixture(autouse=True)
def _default_route(monkeypatch):
    monkeypatch.delenv("EMBREE_TPU_NATIVE_BUILD", raising=False)


def _mesh():
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0.5, 0.5, 1]], F32)
    faces = [(0, 1, 2, 3), (0, 1, 4)]       # one quad (fans) + one tri
    return v, faces


def write_ply_ascii(p, v, faces):
    with open(p, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(v)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for row in v:
            f.write(" ".join(map(str, row)) + "\n")
        for fc in faces:
            f.write(f"{len(fc)} " + " ".join(map(str, fc)) + "\n")


def write_ply_binary(p, v, faces):
    with open(p, "wb") as f:
        hdr = ("ply\nformat binary_little_endian 1.0\n"
               f"element vertex {len(v)}\n"
               "property float x\nproperty float y\nproperty float z\n"
               f"element face {len(faces)}\n"
               "property list uchar int vertex_indices\nend_header\n")
        f.write(hdr.encode())
        for row in v:
            f.write(struct.pack("<fff", *row))
        for fc in faces:
            f.write(struct.pack("<B", len(fc))
                    + struct.pack(f"<{len(fc)}i", *fc))


# ---------------------------------------------------------------------------
# 1. the counterparts of tests/test_io.py
# ---------------------------------------------------------------------------

def test_ply_ascii_roundtrip(tmp_path):
    v, faces = _mesh()
    p = tmp_path / "m.ply"
    write_ply_ascii(p, v, faces)
    lv, li = load_ply(p)
    np.testing.assert_allclose(lv, v)
    assert li.shape == (3, 3)               # quad fans into 2 tris + 1 tri


def test_ply_binary_roundtrip(tmp_path):
    v, faces = _mesh()
    p = tmp_path / "m.ply"
    write_ply_binary(p, v, faces)
    lv, li = load_ply(p)
    np.testing.assert_allclose(lv, v)
    assert li.shape == (3, 3)


def test_xml_writer_roundtrip(tmp_path):
    """write_xml -> load_xml -> commit reproduces the committed scene:
    identical hit distances for a ray batch (an animated mesh with a time
    range included)."""
    rng = np.random.default_rng(3)
    tri_v = rng.uniform(-1, 1, (9, 3)).astype(F32)
    tri_i = np.arange(9, dtype=np.int32).reshape(3, 3)
    anim_v = np.stack([tri_v, tri_v + F32(0.5)])
    pts = rng.uniform(-1, 1, (5, 4)).astype(F32)
    pts[:, 3] = 0.3

    xs = XMLScene()
    xs.geometries.append(pt.TriangleGeometry(tri_v, tri_i))
    xs.geometries.append(pt.TriangleGeometry(anim_v, tri_i,
                                             time_range=(0.2, 0.8)))
    xs.geometries.append(pt.PointGeometry(pts, kind="sphere"))
    xs.kd = [np.ones(3, F32)] * 3
    xs.camera = dict(from_=np.zeros(3), to=np.ones(3),
                     up=np.array([0.0, 1.0, 0.0]), fov=45.0)

    p = tmp_path / "scene.xml"
    write_xml(p, xs)
    xs2 = load_xml(p)
    assert len(xs2.geometries) == 3
    np.testing.assert_allclose(xs2.geometries[1].time_range, (0.2, 0.8),
                               rtol=1e-6)
    assert xs2.camera is not None and xs2.camera["fov"] == 45.0

    cs1 = to_scene(xs).commit(device=CPU)
    cs2 = to_scene(xs2).commit(device=CPU)
    org = rng.uniform(-2, 2, (64, 3)).astype(F32)
    d = rng.normal(size=(64, 3)).astype(F32)
    t = rng.uniform(0, 1, 64).astype(F32)
    h1 = pt.intersect(cs1, pt.make_rays(org, d, time=t, device=CPU))
    h2 = pt.intersect(cs2, pt.make_rays(org, d, time=t, device=CPU))
    np.testing.assert_array_equal(h1.valid.numpy(), h2.valid.numpy())
    m = h1.valid.numpy()
    assert m.any()
    np.testing.assert_allclose(h1.t.detach().numpy()[m],
                               h2.t.detach().numpy()[m], rtol=1e-5)


def test_hermite_tangents_not_translated(tmp_path):
    """Hermite tangents are derivatives: a Transform's translation must not
    leak into them (xml_loader.cpp loadHermiteCurves + xfmVector baking)."""
    xml = """<?xml version="1.0"?>
<scene><Group>
  <Transform>
    <AffineSpace translate="5 7 -3"/>
    <Curves basis="hermite" type="normal_oriented">
      <positions>0 0 0 0.1  0 0 1 0.1</positions>
      <tangents>0 0 1 0.0  0 0 1 0.0</tangents>
      <normals>1 0 0  0 1 0</normals>
      <normal_derivatives>0 1 0  -1 0 0</normal_derivatives>
      <indices>0</indices>
    </Curves>
  </Transform>
</Group></scene>"""
    p = tmp_path / "herm.xml"
    p.write_text(xml)
    xs = load_xml(p)
    g = [x for x in xs.geometries if isinstance(x, pt.CurveGeometry)][0]
    np.testing.assert_allclose(np.asarray(g.vertices)[0, :3], [5, 7, -3],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(g.tangents),
                               [[0, 0, 1, 0], [0, 0, 1, 0]], atol=1e-6)
    np.testing.assert_allclose(np.asarray(g.normals)[0], [1, 0, 0],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(g.normal_derivatives)[1],
                               [-1, 0, 0], atol=1e-6)


# ---------------------------------------------------------------------------
# 2. the same files through both packages
# ---------------------------------------------------------------------------

SCENE_XML = """<?xml version="1.0"?>
<scene>
  <PerspectiveCamera name="main" from="0 2 6" to="0 0 0" up="0 1 0"
                     fov="45"/>
  <PerspectiveCamera name="top" from="0 9 0" to="0 0 0" up="0 0 1"/>
  <AmbientLight><L>0.1 0.1 0.2</L></AmbientLight>
  <PointLight><P>0 4 0</P><I>20 20 20</I></PointLight>
  <DirectionalLight><D>0.3 -1 0.2</D><E>0.5 0.4 0.3</E></DirectionalLight>
  <SpotLight><P>1 3 1</P><D>0 -1 0</D><I>15 12 9</I>
    <angleMin>20</angleMin><angleMax>30</angleMax></SpotLight>
  <QuadLight><v0>-1 5 -1</v0><v1>1 5 -1</v1><v2>1 5 1</v2><v3>-1 5 1</v3>
    <L>4 4 4</L></QuadLight>
  <Group>
    <Transform>
      <AffineSpace>0.8 0 0 1  0 1 0 0.5  0 0 1.2 -1</AffineSpace>
      <TriangleMesh id="floor">
        <material><code>"OBJ"</code><parameters>
          <float3 name="Kd">0.6 0.5 0.4</float3></parameters></material>
        <positions>-5 0 -5  5 0 -5  5 0 5  -5 0 5</positions>
        <triangles>0 1 2  0 2 3</triangles>
      </TriangleMesh>
    </Transform>
    <Transform>
      <AffineSpace rotate_y="30"/>
      <QuadMesh>
        <positions>0 0 0  1 0 0  1 1 0  0 1 0</positions>
        <indices>0 1 2 3</indices>
      </QuadMesh>
    </Transform>
    <GridMesh>
      <positions>0 0 2  1 0 2  2 0 2  0 1 2  1 1 2  2 1 2</positions>
      <grids>0 3 3 2</grids>
    </GridMesh>
    <SubdivisionMesh>
      <positions>-1 -1 -1  1 -1 -1  1 1 -1  -1 1 -1  0 2 0</positions>
      <position_indices>0 1 2 3  2 4 3</position_indices>
      <faces>4 3</faces>
      <edge_creases>0 1  1 2</edge_creases>
      <edge_crease_weights>2 1.5</edge_crease_weights>
    </SubdivisionMesh>
    <Curves basis="bspline" type="round">
      <positions>0 0 3 0.1  0 1 3 0.1  1 2 3 0.1  1 3 3 0.1  2 4 3 0.1
      </positions>
      <indices>0 1</indices>
    </Curves>
    <Curves basis="bezier" type="flat">
      <positions>0 0 4 0.05  0 1 4 0.05  1 1 4 0.05  1 2 4 0.05</positions>
      <indices>0</indices>
    </Curves>
    <LineSegments>
      <positions>0 0 5 0.1  1 0 5 0.1  2 1 5 0.1</positions>
      <indices>0 1</indices>
    </LineSegments>
    <Points type="disc">
      <positions>3 0 0 0.2  3 1 0 0.3</positions>
    </Points>
    <TimeRange time="0.25 0.75">
      <TriangleMesh>
        <animated_positions>
          <positions>0 0 -3  1 0 -3  0 1 -3</positions>
          <positions>0.5 0 -3  1.5 0 -3  0.5 1 -3</positions>
        </animated_positions>
        <triangles>0 1 2</triangles>
      </TriangleMesh>
    </TimeRange>
    <ref id="floor"/>
  </Group>
</scene>
"""

OBJ = """mtllib scene.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
v 2 0 0
usemtl red
f 1 2 3 4
f 1/1 2/2 5/3
usemtl lamp
f 2//1 6//1 3//1
f -1 -4 -3
"""

MTL = """newmtl red
Kd 0.8 0.1 0.1
Ns 12
newmtl lamp
Kd 1 1 1
Ke 5 5 4
"""


def same_value(a, b, label):
    """Equal field values: arrays bit for bit, containers element-wise."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), label
        for k in a:
            same_value(a[k], b[k], f"{label}.{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(b, np.ndarray):
        assert len(a) == len(b), label
        for i, (x, y) in enumerate(zip(a, b)):
            same_value(x, y, f"{label}[{i}]")
    elif a is None or isinstance(a, (str, bool, int, float)):
        assert a == b, label
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, label
        assert bits(x).tobytes() == bits(y).tobytes(), label


def same_geometry(gj, gp, label):
    assert type(gj).__name__ == type(gp).__name__, label
    assert sorted(vars(gj)) == sorted(vars(gp)), label
    for k, x in vars(gj).items():
        if k in ("filter",):
            assert x is None and vars(gp)[k] is None, label
            continue
        same_value(x, vars(gp)[k], f"{label}.{k}")


# the JAX merger's row columns in the port's order (kind, gid, local,
# data, mask, filter slot, instance ids of levels 0 and 1)
_JAX_COLS = (0, 1, 2, 5, 6, 7, 3, 4)


def same_merged_tables(jgeoms, pgeoms):
    """Both packages' mergers on the loaded geometries: rows, windows and
    every table bit-equal (what ``commit`` builds its tree and records
    from)."""
    from embree_tpu.scene import _Merger as JMerger
    jm = JMerger()
    for gid, g in enumerate(jgeoms):
        jm.add(g, gid, inst_stack=(), inst_mask=0xFFFFFFFF, xf=None)
    pm = pt.scene._Merger()
    for gid, g in enumerate(pgeoms):
        pm.add(g, gid)
    jrows = np.concatenate(jm.rows)[:, _JAX_COLS]
    jrows[:, 4] &= 0xFFFFFFFF
    np.testing.assert_array_equal(np.concatenate(pm.rows), jrows)
    np.testing.assert_array_equal(bits(np.concatenate(pm.windows)),
                                  bits(np.concatenate(jm.prim_t01)))
    assert pm.has_motion == jm.has_motion
    tab = pm.tables()
    n = 0
    for name, cols in (("tri", ("v0", "v1", "v2", "v0b", "v1b", "v2b")),
                       ("quad", ("v", "vb", "uvm")),
                       ("pnt", ("c", "r", "n", "cb", "rb", "nb")),
                       ("line", ("p0", "r0", "p1", "r1", "p0b", "r0b",
                                 "p1b", "r1b"))):
        for c in cols:
            parts = getattr(jm, name)[c]
            if not parts:
                continue
            ref = np.concatenate(parts).astype(F32)
            got = tab[f"{name}_{c}"].reshape(ref.shape)
            np.testing.assert_array_equal(bits(got), bits(ref),
                                          err_msg=f"{name}_{c}")
            n += 1
    return n


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("files")
    v, faces = _mesh()
    write_ply_binary(d / "m.ply", v, faces)
    (d / "scene.xml").write_text(SCENE_XML)
    (d / "scene.obj").write_text(OBJ)
    (d / "scene.mtl").write_text(MTL)
    return d


@pytest.fixture(scope="module")
def xml_committed(scene_files):
    """The XML scene, loaded and committed by the port (its subdivision
    mesh refines at the loader's level 5 on the host)."""
    xs = load_xml(scene_files / "scene.xml")
    return xs, to_scene(xs).commit(device=CPU)


def test_xml_scene_loads_alike(scene_files, xml_committed):
    from embree_tpu.utils import xml_scene as jx
    xj = jx.load_xml(scene_files / "scene.xml")
    xp = load_xml(scene_files / "scene.xml")
    assert len(xp.geometries) == len(xj.geometries) == 10
    for i, (gj, gp) in enumerate(zip(xj.geometries, xp.geometries)):
        same_geometry(gj, gp, f"geometry {i}")
    same_value(xj.kd, xp.kd, "kd")
    same_value(xj.camera, xp.camera, "camera")
    same_value(xj.cameras, xp.cameras, "cameras")
    assert [t for t, _ in xp.lights] == [
        "AmbientLight", "PointLight", "DirectionalLight", "SpotLight",
        "QuadLight"]
    same_value(xj.lights, xp.lights, "lights")
    assert same_merged_tables(xj.geometries, xp.geometries) >= 10
    # the port's commit of the loaded scene serves its rays
    cs = xml_committed[1]
    rays = pt.make_rays([[0.0, 3.0, 0.0], [0.5, 0.5, 5.0]],
                        [[0.0, -1.0, 0.0], [0.0, 0.0, -1.0]], device=CPU)
    h = pt.intersect(cs, rays)
    assert bool(h.valid.all())


def test_ply_scene_loads_alike(scene_files):
    from embree_tpu.utils import ply as jply
    xj = jply.load_ply_scene(scene_files / "m.ply")
    xp = load_ply_scene(scene_files / "m.ply")
    same_geometry(xj.geometries[0], xp.geometries[0], "ply")
    same_value(xj.kd, xp.kd, "kd")
    assert same_merged_tables(xj.geometries, xp.geometries) >= 6


def test_obj_scene_loads_alike(scene_files):
    from embree_tpu import Scene as JScene, TriangleGeometry as JTri
    from embree_tpu.utils import obj as jobj
    mj, matj = jobj.load_obj(str(scene_files / "scene.obj"))
    mp, matp = load_obj(str(scene_files / "scene.obj"))
    assert [m.name for m in mp] == [m.name for m in mj] == ["red", "lamp"]
    for a, b in zip(mj, mp):
        same_value(vars(a), vars(b), a.name)
    assert sorted(matp) == sorted(matj) == ["lamp", "red"]
    for k in matj:
        same_value(vars(matj[k]), vars(matp[k]), k)
    sj, mapj = jobj.obj_to_scene(str(scene_files / "scene.obj"), JScene, JTri)
    sp, mapp = obj_to_scene(str(scene_files / "scene.obj"), pt.Scene,
                            pt.TriangleGeometry)
    assert sorted(mapj) == sorted(mapp)
    gj = [sj._geoms[g] for g in sorted(sj._geoms)]
    gp = [sp._geoms[g] for g in sorted(sp._geoms)]
    assert same_merged_tables(gj, gp) >= 6


def test_exr_alike(tmp_path):
    from embree_tpu.utils import exr as jexr
    img = np.random.default_rng(2).uniform(0, 4, (9, 13, 3)).astype(F32)
    write_exr(tmp_path / "p.exr", img)
    jexr.write_exr(tmp_path / "j.exr", img)
    assert (tmp_path / "p.exr").read_bytes() == \
        (tmp_path / "j.exr").read_bytes()
    back = read_exr(tmp_path / "p.exr")
    assert back.tobytes() == jexr.read_exr(tmp_path / "p.exr").tobytes()
    np.testing.assert_array_equal(back[..., :3], img)
    other = img + F32(0.01)
    assert compare_images(img, other) == jexr.compare_images(img, other)


def test_loaded_scene_renders_with_its_lights(xml_committed):
    """The path tracer on a loaded XML scene, its point light from the
    file: finite radiance, and the lit floor brighter than the ambient."""
    from embree_tpu_torch.models import lights as tl
    from embree_tpu_torch.models import materials as tm
    from embree_tpu_torch.models import pathtracer as tpt
    xs, cs = xml_committed
    b = tl.LightSetBuilder()
    for tag, prm in xs.lights:
        if tag == "PointLight":
            b.point(prm["P"], prm["I"])
        elif tag == "AmbientLight":
            b.ambient(prm["L"])
    mats = tm.make_materials(
        len(xs.geometries),
        {g: (tm.MATTE, tuple(kd), 0.0) for g, kd in enumerate(xs.kd)},
        device=CPU)
    rays = pt.make_rays([[0.5, 3.0, -1.0]], [[0.0, -1.0, 0.0]], device=CPU)
    L = tpt.trace_paths(cs, mats, b.build(device=CPU), rays,
                        tpt.Draws.seeded(0, CPU), max_depth=1)
    assert bool(torch.isfinite(L).all()) and float(L.min()) > 0.1
