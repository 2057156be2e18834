"""Embree's procedural triangle sphere, ``SceneGraph::createTriangleSphere
(center, radius, numPhi)`` (tutorials/common/scenegraph/
geometry_creation.cpp), the scene of verify.cpp's ray benchmarks.

A (numPhi + 1) x 2 numPhi latitude-longitude grid of vertices (the pole
rows hold 2 numPhi coincident vertices each); one triangle per cell of the
first and last bands, two per cell of the others: 4 numPhi (numPhi - 1)
triangles. The index order and the pole bands' quirk (they reference the
pole rows' last and first vertices) are the reference's.

``sphere_grid`` and ``triangle_sphere`` are frozen copies of
embree_tpu_torch/tools/parity_models.py's ``_sphere_grid`` and the
triangle branch of ``prim_sphere``. The seed does not change the mesh.
"""
from __future__ import annotations

import numpy as np


def sphere_grid(center, radius, num_phi):
    n_phi = int(num_phi)
    n_theta = 2 * n_phi
    phi = np.arange(n_phi + 1)[:, None] * np.pi / n_phi
    theta = np.arange(n_theta)[None, :] * 2.0 * np.pi / n_theta
    c = np.asarray(center, np.float32)
    x = c[0] + radius * np.sin(phi) * np.sin(theta)
    y = (c[1] + radius * np.cos(phi)) * np.ones_like(theta)
    z = c[2] + radius * np.sin(phi) * np.cos(theta)
    return x, y, z


def triangle_sphere(center, radius, num_phi):
    """(V, 3) float32 vertices and (N, 3) int32 triangles."""
    n_phi = int(num_phi)
    n_theta = 2 * n_phi
    x, y, z = sphere_grid(center, radius, num_phi)
    pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    th = np.arange(1, n_theta + 1)
    rows = []
    for p in range(1, n_phi + 1):
        p00 = (p - 1) * n_theta + th - 1
        p01 = (p - 1) * n_theta + th % n_theta
        p10 = p * n_theta + th - 1
        p11 = p * n_theta + th % n_theta
        if p == 1:
            rows.append(np.stack([p10, np.full_like(p10, n_theta - 1), p11],
                                 -1))
        elif p == n_phi:
            rows.append(np.stack([np.full_like(p00, n_phi * n_theta), p00,
                                  p01], -1))
        else:
            rows.append(np.stack([np.stack([p10, p00, p11], -1),
                                  np.stack([p01, p11, p00], -1)], 1)
                        .reshape(-1, 3))
    return pos, np.concatenate(rows).astype(np.int32)


def generate(sizes: dict, seed: int) -> dict:
    verts, idx = triangle_sphere(sizes["center"], sizes["radius"],
                                 sizes["num_phi"])
    return {"kind": "triangle", "vertices": verts, "indices": idx}


def attach(pt, arrays):
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(arrays["vertices"], arrays["indices"]))
    return s
