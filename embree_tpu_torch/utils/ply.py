"""PLY mesh loader + XML scene writer (a copy of embree_tpu/utils/ply.py,
numpy only, on the port's geometry classes) — the remaining SceneGraph I/O
surfaces (tutorials/common/scenegraph/ply_loader.cpp:327 loadPLY;
xml_writer.cpp store). Behavior parity, fresh implementation: the loader
handles ascii and binary_little/big_endian PLY with vertex x/y/z
properties and face vertex-index lists (triangulated by fanning, matching
the reference's polygon handling); the writer emits the subset of the XML
dialect our loader reads back (round-trip tested).
"""
from __future__ import annotations

import struct

import numpy as np

_STRUCT = {"char": "b", "int8": "b", "uchar": "B", "uint8": "B",
           "short": "h", "int16": "h", "ushort": "H", "uint16": "H",
           "int": "i", "int32": "i", "uint": "I", "uint32": "I",
           "float": "f", "float32": "f", "double": "d", "float64": "d"}


def load_ply(path):
    """Parse a PLY mesh. Returns (vertices (n,3) f32, triangles (m,3) i32).
    Polygonal faces are fan-triangulated (ply_loader.cpp triangle fan)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"ply"):
        raise ValueError(f"{path}: not a PLY file")
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end:]

    fmt = None
    elements = []          # (name, count, [(prop, type) or ('list', it, dt, name)])
    for line in header[1:]:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append([tok[1], int(tok[2]), []])
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append((tok[2], tok[1]))   # (name, type)
    if fmt is None:
        raise ValueError(f"{path}: missing format line")

    verts = None
    faces = []
    if fmt == "ascii":
        toks = body.split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.array(toks[pos:pos + count * width],
                               dtype=np.float32).reshape(count, width)
                cols = [p[0] for p in props]
                verts = arr[:, [cols.index("x"), cols.index("y"),
                                cols.index("z")]]
                pos += count * width
            elif name == "face":
                for _ in range(count):
                    n = int(toks[pos]); pos += 1
                    idx = [int(t) for t in toks[pos:pos + n]]; pos += n
                    for k in range(1, n - 1):
                        faces.append((idx[0], idx[k], idx[k + 1]))
            else:
                # skip unknown ascii elements conservatively (fixed props)
                pos += count * len(props)
    else:
        bo = "<" if fmt == "binary_little_endian" else ">"
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(len(p) == 2 for p in props):
                fmts = bo + "".join(_STRUCT[p[1]] for p in props)
                sz = struct.calcsize(fmts)
                rows = [struct.unpack_from(fmts, body, off + i * sz)
                        for i in range(count)]
                off += count * sz
                cols = [p[0] for p in props]
                arr = np.asarray(rows, np.float32)
                verts = arr[:, [cols.index("x"), cols.index("y"),
                                cols.index("z")]]
            elif name == "face":
                for _ in range(count):
                    for p in props:
                        if p[0] == "list":
                            cf = bo + _STRUCT[p[1]]
                            n = struct.unpack_from(cf, body, off)[0]
                            off += struct.calcsize(cf)
                            df = bo + _STRUCT[p[2]] * n
                            idx = struct.unpack_from(df, body, off)
                            off += struct.calcsize(df)
                            if p[3] in ("vertex_index", "vertex_indices"):
                                for k in range(1, n - 1):
                                    faces.append((idx[0], idx[k],
                                                  idx[k + 1]))
                        else:
                            off += struct.calcsize(bo + _STRUCT[p[1]])
            else:
                fmts = bo + "".join(_STRUCT[p[1]] for p in props
                                    if len(p) == 2)
                off += count * struct.calcsize(fmts)
    if verts is None:
        raise ValueError(f"{path}: no vertex element")
    return (np.ascontiguousarray(verts, np.float32),
            np.asarray(faces, np.int32).reshape(-1, 3))


def load_ply_scene(path):
    """PLY -> XMLScene (single TriangleGeometry; SceneGraph::loadPLY role)."""
    from ..geometry import TriangleGeometry
    from .xml_scene import XMLScene
    v, i = load_ply(path)
    out = XMLScene()
    out.geometries.append(TriangleGeometry(v, i))
    out.kd.append(np.array([0.5, 0.5, 0.5], np.float32))
    return out


# ---------------------------------------------------------------------------
# XML writer (xml_writer.cpp role): emit the dialect utils/xml_scene.py reads
# ---------------------------------------------------------------------------

def _fmt(a):
    return " ".join(repr(float(x)) for x in np.asarray(a).reshape(-1))


def write_xml(path, xs):
    """Serialize an XMLScene's geometries (+first camera) to the tutorial
    XML dialect. Supports the types the loader emits; animated buffers
    write <animated_*> blocks; geometry time ranges write TimeRange tags."""
    from ..geometry import (CurveGeometry, GridGeometry,
                            LineSegmentsGeometry, PointGeometry,
                            QuadGeometry, SubdivisionGeometry,
                            TriangleGeometry)

    def buf(tag, arr):
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 3:
            inner = "".join(f"<positions>{_fmt(s)}</positions>"
                            for s in arr) if tag == "positions" else \
                "".join(f"<{tag}>{_fmt(s)}</{tag}>" for s in arr)
            return f"<animated_{tag}>{inner}</animated_{tag}>"
        return f"<{tag}>{_fmt(arr)}</{tag}>"

    parts = ['<?xml version="1.0"?>\n<scene>\n']
    cam = xs.camera
    if cam:
        parts.append(
            f'<PerspectiveCamera name="default" from="{_fmt(cam["from_"])}"'
            f' to="{_fmt(cam["to"])}" up="{_fmt(cam["up"])}"'
            f' fov="{cam["fov"]}"/>\n')
    for g in xs.geometries:
        tr = tuple(getattr(g, "time_range", (0.0, 1.0)))
        open_tr = tr != (0.0, 1.0)
        if open_tr:
            parts.append(f'<TimeRange time="{tr[0]} {tr[1]}">\n')
        if isinstance(g, TriangleGeometry):
            parts.append("<TriangleMesh>" + buf("positions", g.vertices)
                         + "<triangles>"
                         + " ".join(map(str, np.asarray(g.indices).reshape(-1)))
                         + "</triangles></TriangleMesh>\n")
        elif isinstance(g, QuadGeometry):
            parts.append("<QuadMesh>" + buf("positions", g.vertices)
                         + "<indices>"
                         + " ".join(map(str, np.asarray(g.indices).reshape(-1)))
                         + "</indices></QuadMesh>\n")
        elif isinstance(g, GridGeometry):
            parts.append("<GridMesh>" + buf("positions", g.vertices)
                         + "<grids>"
                         + " ".join(map(str, np.asarray(g.grids).reshape(-1)))
                         + "</grids></GridMesh>\n")
        elif isinstance(g, PointGeometry):
            t = {"sphere": "sphere", "disc": "disc",
                 "oriented_disc": "oriented"}[g.kind]
            inner = buf("positions", g.points)
            if g.normals is not None:
                inner += buf("normals", g.normals)
            parts.append(f'<Points type="{t}">{inner}</Points>\n')
        elif isinstance(g, LineSegmentsGeometry):
            tag = "RoundLineSegments" if g.kind == "round" else "LineSegments"
            parts.append(f"<{tag}>" + buf("positions", g.vertices)
                         + "<indices>"
                         + " ".join(map(str, np.asarray(g.indices).reshape(-1)))
                         + f"</indices></{tag}>\n")
        elif isinstance(g, CurveGeometry):
            t = {"flat": "flat", "round": "round",
                 "oriented": "normal_oriented"}[g.kind]
            inner = buf("positions", g.vertices)
            if g.tangents is not None:
                inner += buf("tangents", g.tangents)
            if g.normals is not None:
                inner += buf("normals", g.normals)
            inner += ("<indices>"
                      + " ".join(map(str, np.asarray(g.indices).reshape(-1)))
                      + "</indices>")
            parts.append(f'<Curves basis="{g.basis}" type="{t}" '
                         f'tessellation_rate="{g.tessellation_rate}">'
                         f"{inner}</Curves>\n")
        elif isinstance(g, SubdivisionGeometry):
            parts.append(
                "<SubdivisionMesh>" + buf("positions", g.vertices)
                + "<faces>"
                + " ".join(map(str, np.asarray(g.face_counts).reshape(-1)))
                + "</faces><position_indices>"
                + " ".join(map(str, np.asarray(g.indices).reshape(-1)))
                + "</position_indices></SubdivisionMesh>\n")
        else:
            raise TypeError(f"write_xml: unsupported {type(g).__name__}")
        if open_tr:
            parts.append("</TimeRange>\n")
    parts.append("</scene>\n")
    with open(path, "w") as f:
        f.write("".join(parts))
