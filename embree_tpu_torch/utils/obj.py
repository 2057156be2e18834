"""Wavefront OBJ loader (a copy of embree_tpu/utils/obj.py, numpy only).

Role parity with the reference OBJ loader
(tutorials/common/scenegraph/obj_loader.cpp): v/vn/vt/f parsing, polygon
triangulation (fan), per-usemtl grouping into separate geometries, basic .mtl
(Kd / Ke) material extraction. Numpy-vectorized line parsing for large files.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class ObjMesh:
    name: str
    vertices: np.ndarray         # (n, 3) float32
    indices: np.ndarray          # (m, 3) int32
    normals: Optional[np.ndarray] = None
    material: Optional[str] = None


@dataclass
class ObjMaterial:
    name: str
    kd: np.ndarray = field(default_factory=lambda: np.array([0.8, 0.8, 0.8], np.float32))
    ke: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    ns: float = 0.0


def load_mtl(path: str) -> Dict[str, ObjMaterial]:
    mats: Dict[str, ObjMaterial] = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "newmtl":
                cur = ObjMaterial(parts[1])
                mats[parts[1]] = cur
            elif cur is not None and parts[0] == "Kd":
                cur.kd = np.array(list(map(float, parts[1:4])), np.float32)
            elif cur is not None and parts[0] == "Ke":
                cur.ke = np.array(list(map(float, parts[1:4])), np.float32)
            elif cur is not None and parts[0] == "Ns":
                cur.ns = float(parts[1])
    return mats


def load_obj(path: str):
    """Returns (meshes: List[ObjMesh], materials: Dict[str, ObjMaterial])."""
    verts: List[List[float]] = []
    groups: Dict[str, List[List[int]]] = {}
    cur_mat = ""
    materials: Dict[str, ObjMaterial] = {}
    base = os.path.dirname(os.path.abspath(path))

    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    vi = tok.split("/")[0]
                    i = int(vi)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                # fan-triangulate polygons (obj_loader.cpp does the same)
                tris = groups.setdefault(cur_mat, [])
                for k in range(1, len(idx) - 1):
                    tris.append([idx[0], idx[k], idx[k + 1]])
            elif line.startswith("usemtl"):
                cur_mat = line.split(maxsplit=1)[1].strip()
            elif line.startswith("mtllib"):
                materials.update(load_mtl(
                    os.path.join(base, line.split(maxsplit=1)[1].strip())))

    v = np.asarray(verts, np.float32)
    meshes = []
    for mat, tris in groups.items():
        meshes.append(ObjMesh(
            name=mat or "default",
            vertices=v,
            indices=np.asarray(tris, np.int32),
            material=mat or None))
    return meshes, materials


def obj_to_scene(path: str, scene_cls, tri_cls):
    """Load an OBJ straight into a Scene; returns (scene, geom_id->mesh)."""
    meshes, materials = load_obj(path)
    scene = scene_cls()
    mapping = {}
    for mesh in meshes:
        gid = scene.attach(tri_cls(mesh.vertices, mesh.indices))
        mapping[gid] = (mesh, materials.get(mesh.material))
    return scene, mapping
