"""The viewer's scenes: an OBJ file or a built-in procedural scene.

Port of embree_tpu/tools/viewer.py::build_scene (:21-71): an ``.obj`` path
(its meshes as triangle geometries), the cube + ground plane, the UV
sphere (built with vectorized numpy) and the ``mixed`` scene (a quad
floor, two spheres and a native round Bezier curve, which rides the
generic engine).
"""
from __future__ import annotations

import numpy as np


def sphere_mesh(n_theta: int, n_phi: int, radius: float = 1.0):
    """Triangulated UV sphere with the index order of the JAX package's
    loops (bench.py:18-35, tools/viewer.py:43-55): per (i, j) cell the
    triangles (a, b, d) then (a, d, c)."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([radius * np.sin(t) * np.cos(p),
                      radius * np.sin(t) * np.sin(p),
                      radius * np.cos(t)], axis=-1).reshape(-1, 3) \
        .astype(np.float32)
    i, j = np.meshgrid(np.arange(n_theta), np.arange(n_phi), indexing="ij")
    a = i * n_phi + j
    b = i * n_phi + (j + 1) % n_phi
    c = (i + 1) * n_phi + j
    d = (i + 1) * n_phi + (j + 1) % n_phi
    idx = np.stack([np.stack([a, b, d], -1), np.stack([a, d, c], -1)],
                   axis=2).reshape(-1, 3).astype(np.int32)
    return verts, idx


def cube_plane():
    """The unit cube and a ground plane just below it, as two (vertices,
    indices) meshes."""
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32)
    i = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]], np.int32)
    p = np.array([[-6, -1.01, -6], [6, -1.01, -6], [6, -1.01, 6],
                  [-6, -1.01, 6]], np.float32)
    return [(v, i), (p, np.array([[0, 1, 2], [0, 2, 3]], np.int32))]


def build_scene(name: str, et):
    """Returns (Scene, eye point) for an ``.obj`` path or a built-in scene;
    ``et`` is the package whose Scene and geometry classes to use."""
    if name.endswith(".obj"):
        from ..utils.obj import load_obj
        meshes, _ = load_obj(name)
        s = et.Scene()
        for m in meshes:
            s.attach(et.TriangleGeometry(m.vertices, m.indices))
        return s, (3.0, 2.0, 3.0)
    if name == "cube":
        s = et.Scene()
        for v, i in cube_plane():
            s.attach(et.TriangleGeometry(v, i))
        return s, (3.0, 2.5, 3.5)
    if name == "sphere":
        verts, idx = sphere_mesh(32, 64)
        s = et.Scene()
        s.attach(et.TriangleGeometry(verts, idx))
        return s, (0.0, 0.8, 3.0)
    if name == "mixed":
        s = et.Scene()
        s.attach(et.QuadGeometry(
            np.array([[-4, -1, -4], [4, -1, -4], [4, -1, 4], [-4, -1, 4]],
                     np.float32), np.array([[0, 1, 2, 3]], np.int32)))
        s.attach(et.PointGeometry(
            np.array([[-1, 0, 0, 0.5], [1, 0, 0.5, 0.4]], np.float32),
            kind="sphere"))
        s.attach(et.CurveGeometry(
            np.array([[-1, 0.5, 0, 0.06], [-0.4, 1.4, 0, 0.06],
                      [0.4, 1.4, 0, 0.06], [1, 0.5, 0.5, 0.06]], np.float32),
            np.array([0], np.int32), basis="bezier", kind="round",
            tessellation_rate=12))
        return s, (0.0, 1.5, 4.5)
    raise ValueError(f"unknown scene '{name}'")
