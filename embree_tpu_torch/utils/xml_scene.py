"""Embree tutorial XML scene loader.

A copy of embree_tpu/utils/xml_scene.py (numpy only) that builds the port's
geometry classes, and in ``to_scene`` the port's ``Scene``.

Parses the scene format consumed by the reference's SceneGraph XML loader
(tutorials/common/scenegraph/xml_loader.cpp) — the format of every scene in
Embree's tests/primitives/*.xml and tutorials/models/*.xml — into a
Scene plus camera/light metadata. Only behavior is mirrored, not
code: this is a ~200-line ElementTree walk instead of a 2k-line DOM stack.

Supported elements: PerspectiveCamera, TriangleMesh, QuadMesh, GridMesh,
SubdivisionMesh, Curves (all 5 bases x flat/round/normal_oriented),
LineSegments, Points (sphere/disc/oriented), Transform/Group/Instance
(static affine), animated_positions (2-step motion), obj/hair legacy tags.
Materials are parsed to a Kd color (the viewer's default shader need);
lights are collected for the pathtracer.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from ..geometry import (CurveGeometry, GridGeometry, LineSegmentsGeometry,
                        PointGeometry, QuadGeometry, SubdivisionGeometry,
                        TriangleGeometry)


def _floats(text):
    if not text:
        return np.zeros(0, np.float32)
    return np.array(text.replace("+inf", "inf").split(), dtype=np.float32)


# loader context for binary buffers (<tag ofs=.. size=..> reads from the
# sibling .bin file — XMLLoader::loadBinary, xml_loader.cpp:452) and for
# <assign type=scene>/<ref id> indirection (sceneMap, xml_loader.cpp:1709)
_CTX = {"bin": None, "scene_map": {}, "material_map": {}}


def _nums(node, comps=1, dtype=np.float32):
    if node is None:
        return np.zeros(0, np.float32)
    if node.get("ofs") is not None and _CTX["bin"] is not None:
        ofs = int(node.get("ofs"))
        size = int(node.get("size") or node.get("num") or 0)
        raw = np.frombuffer(_CTX["bin"], dtype=dtype, count=size * comps,
                            offset=ofs)
        return raw.astype(np.float32) if dtype == np.float32 else raw
    if node.text is None:
        return np.zeros(0, np.float32)
    return _floats(node.text)


def _ints(node, comps=1):
    return _nums(node, comps, np.int32).astype(np.int32)


def _buffer(elem, tag, comps):
    """Read <tag> (static) or <animated_tag> (S time steps — the
    rtcSetGeometryTimeStepCount surface; msmblur scenes carry 3-4 steps).
    Returns (n, comps), (S, n, comps), or None if absent."""
    anim = elem.find("animated_" + tag)
    if anim is not None:
        steps = [c for c in anim if c.tag.startswith(tag)]
        arrs = [_nums(c, comps).reshape(-1, comps) for c in steps]
        if len(arrs) == 1:
            arrs.append(arrs[0])
        return np.stack(arrs)
    node = elem.find(tag)
    if node is None:
        return None
    return _nums(node, comps).reshape(-1, comps)


def _positions(elem, comps):
    return _buffer(elem, "positions", comps)


def _apply_xfm(xfm, pts, w=1.0):
    """Apply a (3,4) affine to (..., 3) points (w=1) or vectors (w=0)."""
    return pts @ xfm[:, :3].T + w * xfm[:, 3]


def _xfm_positions(xfm, pos, radius_col=False):
    if xfm is None:
        return pos
    scale = np.abs(np.linalg.det(xfm[:, :3])) ** (1.0 / 3.0)
    if radius_col:
        xyz = _apply_xfm(xfm, pos[..., :3])
        return np.concatenate([xyz, pos[..., 3:] * scale], axis=-1)
    return _apply_xfm(xfm, pos)


def _furball(elem, xfm):
    """Procedural fur ball (xml_loader.cpp:1312 loadFurBall): a triangle
    sphere + N hairs placed with the loader's manual LCG (seed 1234) —
    reproduced exactly so the models-tier goldens compare pixel-for-pixel."""
    p = lambda name, dv: float(elem.get(name, dv))
    r = p("radius", 10.0)
    slices = int(p("slices", 60))
    slabs = int(p("slabs", 60))
    nhairs = int(p("nhairs", 30000))
    # NOTE: int() truncation on the defaults mirrors the reference's
    # (accidental) int cast of parm_float for hairwidth/hairlength
    hairwidth = int(p("hairwidth", 0)) if elem.get("hairwidth") else r / 100.0
    hairlength = int(p("hairlength", 0)) if elem.get("hairlength") else r / 10.0
    ht = elem.get("hairtype", "bezier_round")
    basis, kind = (("linear", "flat") if ht == "linear_flat" else
                   ("linear", "round") if ht == "linear_round" else
                   tuple(ht.rsplit("_", 1)))
    kind = {"flat": "flat", "round": "round",
            "normaloriented": "oriented"}[kind]
    basis = {"catmulrom": "catmull_rom", "bezier": "bezier",
             "bspline": "bspline", "hermite": "hermite",
             "linear": "linear"}[basis]

    # --- sphere mesh ---
    nv = slices * (slabs - 1) + 2
    data = np.zeros((nv, 3), np.float32)
    phi = np.pi / slabs * (np.arange(1, slabs)[:, None])
    theta = 2.0 * np.pi / slices * np.arange(slices)[None, :]
    data[: slices * (slabs - 1)] = np.stack(
        [r * np.sin(phi) * np.cos(theta),
         (r * np.cos(phi)) * np.ones_like(theta),
         r * np.sin(phi) * np.sin(theta)], -1).reshape(-1, 3)
    top, bot = nv - 2, nv - 1
    data[top] = (0, r, 0)
    data[bot] = (0, -r, 0)
    tris = []
    sl = np.arange(slices)
    sl1 = (sl + 1) % slices
    tris.append(np.stack([np.full(slices, top), sl, sl1], -1))
    for slab in range(slabs - 2):
        a, b = slab * slices, (slab + 1) * slices
        tris.append(np.stack([a + sl, b + sl, b + sl1], -1))
        tris.append(np.stack([a + sl, b + sl1, a + sl1], -1))
    tris.append(np.stack([np.full(slices, bot), bot - slices - 1 + sl,
                          bot - slices - 1 + sl1], -1))
    tri_idx = np.concatenate(tris).astype(np.int32)
    geoms = [TriangleGeometry(_xfm_positions(xfm, data), tri_idx)]

    # --- hairs: manual LCG (glibc-like constants), exact bit sequence,
    # vectorized by block jumping: s_{i+j} = a^j s_i + c (a^j-1)/(a-1) mod m
    # — the per-block coefficients are built sequentially (B+n/B python
    # steps) and each block expands with one vector op ---
    a_, c_, m_ = 1103515245, 12345, 1 << 31
    n_draw = max(2 + nhairs * 3 + (nhairs if basis == "bspline" else 0), 8)
    B = 1024
    A = np.empty(B, np.uint64)
    C = np.empty(B, np.uint64)
    Aj, Cj = 1, 0
    for j in range(B):
        A[j] = Aj
        C[j] = Cj
        Aj = (a_ * Aj) % m_
        Cj = (a_ * Cj + c_) % m_
    nb = -(-(n_draw + 1) // B)
    starts = np.empty(nb, np.uint64)
    sblk = 1234
    for bi in range(nb):
        starts[bi] = sblk
        sblk = (Aj * sblk + Cj) % m_
    states = (A[None, :] * starts[:, None] + C[None, :]) % np.uint64(m_)
    # seq[i] is the state AFTER i+1 LCG steps (the loop advanced first)
    states = states.reshape(-1)[1:n_draw + 1]
    seq = states.astype(np.float64) / float(m_)
    k = 0

    def draw(n):
        nonlocal k
        v = seq[k:k + n]
        k += n
        return v

    t0 = 2.0 * np.pi * draw(1)[0]
    p0 = np.arccos(1 - 2 * draw(1)[0])
    last = np.array([np.sin(p0) * np.cos(t0), np.cos(p0),
                     np.sin(p0) * np.sin(t0)], np.float32)
    is_hermite = basis == "hermite"
    npts = 2 if is_hermite else 4
    # --- vectorized hair generation (bit-identical to the reference's
    # per-hair loop): draws per hair are strided slices of the LCG
    # sequence; only the perpendicular chain pp_i = norm(cross(d_i,
    # pp_{i-1})) is inherently sequential and runs as hand-rolled scalar
    # float math (np.cross per hair was ~40us x millions of calls) ---
    stride = 4 if basis == "bspline" else 3
    th_a = 2.0 * np.pi * seq[2:2 + nhairs * stride:stride]
    ph_a = np.arccos(1 - 2 * seq[3:3 + nhairs * stride:stride])
    stop_r1 = seq[4:4 + nhairs * stride:stride]
    d_a = np.stack([np.sin(ph_a) * np.cos(th_a), np.cos(ph_a),
                    np.sin(ph_a) * np.sin(th_a)], -1).astype(np.float32)
    k += nhairs * stride
    pp_a = np.empty((nhairs, 3), np.float32)
    px, py, pz = float(last[0]), float(last[1]), float(last[2])
    dl = d_a.tolist()
    for i in range(nhairs):
        dx_, dy_, dz_ = dl[i]
        cx = dy_ * pz - dz_ * py
        cy = dz_ * px - dx_ * pz
        cz = dx_ * py - dy_ * px
        n_ = (cx * cx + cy * cy + cz * cz) ** 0.5
        if n_ < 1e-20:
            n_ = 1e-20
        px, py, pz = cx / n_, cy / n_, cz / n_
        pp_a[i, 0] = px
        pp_a[i, 1] = py
        pp_a[i, 2] = pz
    d_a64 = d_a.astype(np.float64)
    pp64 = pp_a.astype(np.float64)
    start_a = d_a64 * (r * (1.0 - 0.01 * hairlength))
    mid_a = d_a64 * (r * (1.0 + 0.03 * hairlength))
    mid2_a = d_a64 * (r * (1.0 + 0.07 * hairlength))
    stop_a = d_a64 * (r * (1.0 + 0.07 * hairlength)
                      + r * 0.03 * hairlength * stop_r1[:, None])
    if basis == "bezier":
        stop_a = stop_a + pp64 * (r * 0.051 * hairlength)
    elif basis == "linear":
        mid_a = mid_a + pp64 * (r * 0.001 * hairlength)
        mid2_a = mid2_a + pp64 * (r * 0.021 * hairlength)
        stop_a = stop_a + pp64 * (r * 0.051 * hairlength)
    elif basis == "bspline":
        stop_r2 = seq[5:5 + nhairs * stride:stride]
        mid2_a = mid2_a + pp64 * (r * 0.021 * hairlength)
        stop_a = d_a64 * (r * (1.0 + 0.07 * hairlength)
                          + r * 0.13 * hairlength * stop_r2[:, None]) \
            + pp64 * (r * 0.081 * hairlength)

    def _norm_rows(a):
        n_ = np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-20)
        return a / n_

    pos = np.zeros((nhairs * npts, 4), np.float32)
    nrm = np.zeros((nhairs * npts, 3), np.float32)
    tans = np.zeros((nhairs * npts, 4), np.float32)
    if is_hermite:
        pos[0::2, :3] = start_a
        pos[0::2, 3] = hairwidth
        pos[1::2, :3] = stop_a
        tans[0::2, :3] = _norm_rows(d_a64)
        tans[0::2, 3] = 0.2
        tans[1::2, :3] = _norm_rows(pp64)
        tans[1::2, 3] = 0.8
        n0 = _norm_rows(np.cross(d_a64, pp64))
        nrm[0::2] = n0
        nrm[1::2] = n0
    else:
        pos[0::4, :3] = start_a
        pos[0::4, 3] = hairwidth
        pos[1::4, :3] = mid_a
        pos[1::4, 3] = hairwidth
        pos[2::4, 0] = mid_a[:, 0]
        pos[2::4, 1] = mid2_a[:, 1]
        pos[2::4, 2] = mid2_a[:, 2]
        pos[2::4, 3] = hairwidth * 0.5
        pos[3::4, :3] = stop_a
        if kind == "oriented":
            nrm[0::4] = _norm_rows(np.cross(d_a64, pp64))
            nrm[1::4] = _norm_rows(np.cross(start_a - mid_a, pp64))
            nrm[2::4] = _norm_rows(np.cross(mid_a - mid2_a, pp64))
            nrm[3::4] = _norm_rows(np.cross(mid2_a - stop_a, pp64))
    if basis in ("bspline", "catmull_rom"):
        # tip-width tweak (xml_loader.cpp:1526)
        pos[1::4, 3] = 0.5 * hairwidth
        pos[2::4, 3] = 0.01 * hairwidth
        pos[3::4, 3] = 0.0
    # (fix_bspline_end_points only rewrites NaN control points — no-op here,
    # xml_loader.cpp:1166-1179)
    pos = _xfm_positions(xfm, pos, radius_col=True)
    if basis == "linear":
        idx = (np.arange(nhairs)[:, None] * 4
               + np.arange(3)[None, :]).reshape(-1).astype(np.int32)
        geoms.append(LineSegmentsGeometry(
            pos, idx, kind="round" if kind == "round" else "flat"))
    else:
        idx = (np.arange(nhairs) * npts).astype(np.int32)
        nr = nrm if kind == "oriented" else None
        if nr is not None and xfm is not None:
            nr = _apply_xfm(xfm, nr, w=0.0)
        geoms.append(CurveGeometry(
            pos, idx, basis=basis, kind=kind,
            tangents=tans if is_hermite else None, normals=nr))
    return geoms


class XMLScene:
    """Parsed scene: geometries + camera + lights + material colors."""

    def __init__(self):
        self.geometries = []        # list of geometry objects
        self.kd = []                # per-geometry Kd color (default shader)
        self.camera = None          # dict(from_, to, up, fov) or None
        self.cameras = {}           # name -> camera dict (--camera NAME)
        self.lights = []            # list of (type, params) tuples


def _parse_material_kd(elem):
    mat = elem.find("material")
    if mat is not None:
        for f3 in mat.iter("float3"):
            if f3.get("name") == "Kd":
                return _nums(f3)[:3]
    return np.array([0.5, 0.5, 0.5], np.float32)


def _rot_axis(axis, deg):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    t = np.deg2rad(deg)
    c, s_, C = np.cos(t), np.sin(t), 1 - np.cos(t)
    x, y, z = a
    R = np.array([[c + x*x*C, x*y*C - z*s_, x*z*C + y*s_],
                  [y*x*C + z*s_, c + y*y*C, y*z*C - x*s_],
                  [z*x*C - y*s_, z*y*C + x*s_, c + z*z*C]])
    out = np.zeros((3, 4), np.float32)
    out[:, :3] = R
    return out


def _parse_affine(node):
    """<AffineSpace>: 12/16 floats, or the attribute forms translate=/
    scale=/rotate_x|y|z=/axis+angle (xml_loader.cpp:374-399)."""
    for k in ("translate", "scale"):
        if node.get(k):
            v = _floats(node.get(k))
            out = np.zeros((3, 4), np.float32)
            if k == "translate":
                out[:, :3] = np.eye(3)
                out[:, 3] = v[:3]
            else:
                out[:, :3] = np.diag(v[:3] if v.size >= 3
                                     else np.repeat(v[0], 3))
            return out
    for ax, vec in (("rotate_x", (1, 0, 0)), ("rotate_y", (0, 1, 0)),
                    ("rotate_z", (0, 0, 1))):
        if node.get(ax):
            return _rot_axis(vec, float(node.get(ax)))
    if node.get("angle") and node.get("axis"):
        out = _rot_axis(_floats(node.get("axis")), float(node.get("angle")))
        if node.get("point"):
            p = _floats(node.get("point"))[:3]
            out[:, 3] = p - out[:, :3] @ p
        return out
    v = _nums(node)
    if v.size == 16:
        v = v.reshape(4, 4)[:3]
    else:
        v = v.reshape(3, 4)
    return v.astype(np.float32)


def _compose(a, b):
    if a is None:
        return b
    if b is None:
        return a
    out = np.zeros((3, 4), np.float32)
    out[:, :3] = a[:, :3] @ b[:, :3]
    out[:, 3] = a[:, :3] @ b[:, 3] + a[:, 3]
    return out


# ---------------------------------------------------------------------------
# animated transforms (TransformAnimation / multi-space Transform nodes) and
# quaternion decompositions (xml_loader.cpp:1651 loadTransformAnimationNode,
# loadQuaternion; decode per affinespace.h:222
# quaternionDecompositionToAffineSpace)
# ---------------------------------------------------------------------------

_QUAT_RESAMPLE = 8   # sub-knots per quaternion segment (geometry.QUAT_RESAMPLE)


def _parse_quaternion(node):
    """<Quaternion> 16-float body or attribute form -> (S(3,4), quat(wxyz),
    D-translation(3)): transform = D + R(q) @ (S_lin x + S_shift).
    Body grid columns are (vx,vy,vz,p) with the quaternion in the w row and
    the post-rotation translation stuffed in vx.y/vx.z/vy.z
    (affinespace.h:222)."""
    v = _nums(node)
    if v.size == 16:
        B = v.reshape(4, 4)
        S = np.array([[B[0, 0], B[0, 1], B[0, 2], B[0, 3]],
                      [0.0,     B[1, 1], B[1, 2], B[1, 3]],
                      [0.0,     0.0,     B[2, 2], B[2, 3]]], np.float32)
        quat = np.array([B[3, 3], B[3, 0], B[3, 1], B[3, 2]], np.float32)
        D = np.array([B[1, 0], B[2, 0], B[2, 1]], np.float32)
        return S, quat, D
    scale = _floats(node.get("scale") or "1 1 1")
    shift = _floats(node.get("shift") or "0 0 0")
    skew = _floats(node.get("skew") or "0 0 0")
    translate = _floats(node.get("translate") or "0 0 0")
    quat = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    if node.get("rotate"):
        r = _floats(node.get("rotate"))
        ax = r[:3] / max(np.linalg.norm(r[:3]), 1e-20)
        half = 0.5 * np.deg2rad(r[3])
        quat = np.array([np.cos(half), *(np.sin(half) * ax)], np.float32)
    if node.get("quaternion"):
        q = _floats(node.get("quaternion"))
        quat = np.array([q[3], q[0], q[1], q[2]], np.float32)
    S = np.array([[scale[0], skew[0], skew[1], shift[0]],
                  [0.0, scale[1], skew[2], shift[1]],
                  [0.0, 0.0, scale[2], shift[2]]], np.float32)
    # attribute form: shift is pre-rotation, translate post-rotation
    return S, quat, translate[:3].astype(np.float32)


def _quat_mat(q):
    w, x, y, z = [float(v) for v in q / max(np.linalg.norm(q), 1e-20)]
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _qd_affine(qd):
    S, q, D = qd
    R = _quat_mat(q)
    out = np.zeros((3, 4), np.float32)
    out[:, :3] = R @ S[:, :3]
    out[:, 3] = R @ S[:, 3] + D
    return out


def _qd_slerp(a, b, t):
    Sa, qa, Da = a
    Sb, qb, Db = b
    qb = -qb if float(np.dot(qa, qb)) < 0 else qb
    cosom = np.clip(abs(float(np.dot(qa, qb))
                        / max(np.linalg.norm(qa) * np.linalg.norm(qb), 1e-20)),
                    -1.0, 1.0)
    om = np.arccos(cosom)
    if np.sin(om) < 1e-4:
        w0, w1 = 1.0 - t, t
    else:
        w0 = np.sin((1.0 - t) * om) / np.sin(om)
        w1 = np.sin(t * om) / np.sin(om)
    q = w0 * qa + w1 * qb
    return ((1 - t) * Sa + t * Sb, q / max(np.linalg.norm(q), 1e-20),
            (1 - t) * Da + t * Db)


def _resample_qd_steps(qds):
    """Slerp-resample a quaternion animation onto a dense affine knot stack
    (piecewise-linear approximation of the rotational motion, matching
    geometry.instance_transform_steps QUAT_RESAMPLE semantics)."""
    L = len(qds)
    if L == 1:
        return _qd_affine(qds[0])[None]
    q = _QUAT_RESAMPLE
    while (L - 1) * q + 1 > 129 and q > 1:
        q //= 2
    mats = []
    for seg in range(L - 1):
        for j in range(q):
            mats.append(_qd_affine(_qd_slerp(qds[seg], qds[seg + 1], j / q)))
    mats.append(_qd_affine(qds[-1]))
    return np.stack(mats)


class _XF:
    """Effective transform on the walk path: optional animated knot stack
    (steps, spanning trange) over an accumulated static affine.
    effective_k = steps[k] ∘ static."""

    __slots__ = ("static", "steps", "trange")

    def __init__(self, static=None, steps=None, trange=(0.0, 1.0)):
        self.static = static
        self.steps = steps
        self.trange = trange

    def compose_static(self, aff):
        # static accumulates BELOW any animation: eff_k = steps[k] ∘ static
        return _XF(_compose(self.static, aff), self.steps, self.trange)

    def enter_anim(self, steps, trange):
        steps = np.asarray(steps, np.float32)
        if self.steps is None:
            comp = (np.stack([_compose(self.static, m) for m in steps])
                    if self.static is not None else steps)
            return _XF(None, comp, trange)
        # nested animation: resample BOTH animations onto one uniform knot
        # grid over the union span and compose per knot —
        # eff(t) = outer(t) ∘ static ∘ inner(t). Each factor is piecewise
        # linear, so the product is piecewise quadratic; a denser grid
        # bounds the chord error (the flatten-of-nested-TransformNodes
        # role, scenegraph.cpp flatten)
        t0 = min(self.trange[0], trange[0])
        t1 = max(self.trange[1], trange[1])
        S = min(33, 4 * max(self.steps.shape[0], steps.shape[0]) + 1)
        comp = []
        for k in range(S):
            tk = t0 + (t1 - t0) * k / (S - 1)
            outer = _sample_affine(self.steps, tk, self.trange)
            inner = _sample_affine(steps, tk, trange)
            comp.append(_compose(outer, _compose(self.static, inner)))
        return _XF(None, np.stack(comp), (t0, t1))

    def sample(self, k):
        """Full affine of knot k (compose static below the animation)."""
        return _compose(self.steps[k], self.static)


def _sample_affine(steps, t, trange):
    """Sample an (S,3,4) affine knot stack at global time t (knots uniform
    over trange; linear matrix lerp, extrapolated outside)."""
    S = steps.shape[0]
    x = (float(t) - trange[0]) / (trange[1] - trange[0]) * (S - 1)
    k = min(max(int(np.floor(x)), 0), S - 2)
    w = np.float32(x - k)
    return ((1.0 - w) * steps[k] + w * steps[k + 1]).astype(np.float32)


def _sample_lin(pos, t, S_child):
    """Sample a (P,n,C) buffer at global t (child knots uniform on [0,1]),
    with linear extrapolation outside."""
    P = pos.shape[0]
    x = float(t) * (P - 1)
    k = min(max(int(np.floor(x)), 0), P - 2)
    w = np.float32(x - k)
    return ((1.0 - w) * pos[k] + w * pos[k + 1]).astype(np.float32)


def _xf_positions_anim(xf: "_XF", pos, radius_col=False):
    """Apply an _XF to a static (n,C) or animated (P,n,C) buffer. Animated
    transforms bake into an (S,n,C) knot stack over xf.trange (the
    SceneGraph::flatten role): result_k = M_k @ buffer(t_k)."""
    if pos is None:
        return None
    pos = np.asarray(pos, np.float32)
    if xf is None or xf.steps is None:
        return _xfm_positions(xf.static if xf is not None else None,
                              pos, radius_col)
    S = xf.steps.shape[0]
    outs = []
    for k in range(S):
        tk = k / (S - 1)            # child buffers span [0,1] locally
        pk = _sample_lin(pos, tk, S) if pos.ndim == 3 else pos
        outs.append(_xfm_positions(xf.sample(k), pk, radius_col))
    return np.stack(outs)


def _xf_vectors_anim(xf: "_XF", vec, radius_col=False):
    """Transform direction vectors (w=0) through an _XF. radius_col=True
    treats a 4th component as a radius DERIVATIVE (hermite tangent dr):
    scaled like radii, never translated."""
    if vec is None:
        return None
    vec = np.asarray(vec, np.float32)
    if xf is None or (xf.static is None and xf.steps is None):
        return vec

    def one(m, v):
        if radius_col:
            scale = np.abs(np.linalg.det(m[:, :3])) ** (1.0 / 3.0)
            return np.concatenate([_apply_xfm(m, v[..., :3], w=0.0),
                                   v[..., 3:] * scale], axis=-1)
        return _apply_xfm(m, v, w=0.0)

    if xf.steps is None:
        return one(xf.static, vec)
    S = xf.steps.shape[0]
    outs = []
    for k in range(S):
        vk = _sample_lin(vec, k / (S - 1), S) if vec.ndim == 3 else vec
        outs.append(one(xf.sample(k), vk))
    return np.stack(outs)


def _add_geometry(out: XMLScene, elem, xf, trange=None):
    tag = elem.tag
    kd = _parse_material_kd(elem)
    n0 = len(out.geometries)

    if tag == "TriangleMesh" or tag == "Mesh":
        pos = _xf_positions_anim(xf, _positions(elem, 3))
        idx = _ints(elem.find("triangles"), 3).reshape(-1, 3)
        out.geometries.append(TriangleGeometry(pos, idx))
    elif tag == "QuadMesh":
        pos = _xf_positions_anim(xf, _positions(elem, 3))
        idx = _ints(elem.find("indices"), 4).reshape(-1, 4)
        out.geometries.append(QuadGeometry(pos, idx))
    elif tag == "GridMesh":
        pos = _xf_positions_anim(xf, _positions(elem, 3))
        grids = _ints(elem.find("grids"), 4).reshape(-1, 4)
        out.geometries.append(GridGeometry(pos, grids))
    elif tag == "SubdivisionMesh":
        pos = _xf_positions_anim(xf, _positions(elem, 3))
        pie = elem.find("position_indices")
        idx = _ints(pie)
        pmode = pie.get("subdiv_mode") if pie is not None else None
        faces = _ints(elem.find("faces"))
        creases = {}
        ec = _ints(elem.find("edge_creases")).reshape(-1, 2)
        ew = _nums(elem.find("edge_crease_weights"))
        for (a, b), w in zip(ec, ew):
            creases[tuple(sorted((int(a), int(b))))] = float(w)
        vcreases = {}
        vc = elem.find("vertex_creases")
        if vc is not None:
            vids = _ints(vc)
            vws = _nums(elem.find("vertex_crease_weights"))
            for vid, w in zip(vids, vws):
                if w > 0:
                    vcreases[int(vid)] = float(w)
        holes = _ints(elem.find("holes")) \
            if elem.find("holes") is not None else None
        tcs = _buffer(elem, "texcoords", 2)
        tcie = elem.find("texcoord_indices")
        tci = _ints(tcie) if tcie is not None else None
        tcmode = tcie.get("subdiv_mode") if tcie is not None else None
        # level 5 approximates the reference's adaptive tessellation of the
        # limit surface closely enough for golden-image parity
        sg = SubdivisionGeometry(
            pos, faces, idx, levels=5, creases=creases or None,
            vertex_creases=vcreases or None, holes=holes,
            texcoords=tcs, texcoord_indices=tci,
            texcoord_mode=tcmode, position_mode=pmode)
        if tcs is not None:
            # texcoords also ride the vertex-attribute SLOT registry
            # (RTC_BUFFER_TYPE_VERTEX_ATTRIBUTE slot 0 — the reference's
            # rtcSetGeometryVertexAttributeCount + buffer path the
            # tutorials' texcoord shaders use)
            from ..buffer import (BUFFER_TYPE_VERTEX_ATTRIBUTE,
                                  set_geometry_buffer,
                                  set_vertex_attribute_count)
            set_vertex_attribute_count(sg, 1)
            set_geometry_buffer(sg, BUFFER_TYPE_VERTEX_ATTRIBUTE, 0,
                                np.asarray(tcs, np.float32))
        out.geometries.append(sg)
    elif tag in ("Curves", "BezierCurves", "BSplineCurves", "BSplineHair",
                 "BezierHair", "Hair"):
        # per-tag defaults mirror loadNode's RTC type choices
        # (xml_loader.cpp:1850-1870): *Curves = round, *Hair = flat
        basis = elem.get("basis", "bezier")
        ctype = elem.get("type", "flat")
        if tag in ("BezierHair", "Hair"):
            basis, ctype = "bezier", "flat"
        elif tag == "BezierCurves":
            basis, ctype = "bezier", "round"
        elif tag == "BSplineHair":
            basis, ctype = "bspline", "flat"
        elif tag == "BSplineCurves":
            basis, ctype = "bspline", "round"
        pos = _xf_positions_anim(xf, _positions(elem, 4), radius_col=True)
        idx = _ints(elem.find("indices"))
        if tag in ("Hair", "BezierHair", "BezierCurves"):
            # these tags route through the reference's loadBezierCurves,
            # whose indices are (start_vertex, curve_id) PAIRS
            # (xml_loader.cpp:1197 loadVec2iArray); the BSpline*/Curves tags
            # use plain start arrays (loadCurves, xml_loader.cpp:1260)
            idx = idx.reshape(-1, 2)[:, 0].copy()
        if basis == "bspline":
            # NaN end control points trigger the b-spline edge rule
            # (xml_loader.cpp:1166 fix_bspline_end_points)
            pos = np.array(pos, np.float32)
            flat_steps = pos if pos.ndim == 3 else pos[None]
            for st in flat_steps:
                for i0 in idx:
                    v = st[i0:i0 + 4]
                    if np.isnan(v[0]).any():
                        v[0] = 2.0 * v[1] - v[2]
                    if np.isnan(v[3]).any():
                        v[3] = 2.0 * v[2] - v[1]
            pos = flat_steps if pos.ndim == 3 else flat_steps[0]
        if basis == "linear":
            out.geometries.append(LineSegmentsGeometry(
                pos, idx, kind="round" if ctype == "round" else "flat"))
        else:
            # hermite tangents are DERIVATIVES: linear part only (no
            # translation; xml_loader.cpp loadHermiteCurves keeps tangents
            # in the node's space and SceneGraph xfmVector-bakes them)
            tan = _xf_vectors_anim(xf, _buffer(elem, "tangents", 4),
                                   radius_col=True) \
                if elem.find("tangents") is not None \
                or elem.find("animated_tangents") is not None else None
            nrm = _xf_vectors_anim(xf, _buffer(elem, "normals", 3))
            dnrm = _xf_vectors_anim(xf, _buffer(elem, "normal_derivatives", 3))
            kind = {"flat": "flat", "ribbon": "flat", "round": "round",
                    "surface": "round", "normal_oriented": "oriented"}[ctype]
            rate = int(float(elem.get("tessellation_rate", 4)))
            out.geometries.append(CurveGeometry(
                pos, idx, basis=basis, kind=kind, tangents=tan, normals=nrm,
                normal_derivatives=dnrm, tessellation_rate=rate))
    elif tag == "FurBall":
        assert xf is None or xf.steps is None, "animated FurBall unsupported"
        for g in _furball(elem, xf.static if xf is not None else None):
            out.geometries.append(g)
            out.kd.append(kd)
        return True
    elif tag in ("LineSegments", "RoundLineSegments", "ConeSegments"):
        pos = _xf_positions_anim(xf, _positions(elem, 4), radius_col=True)
        idx = _ints(elem.find("indices"))
        kind = "round" if tag != "LineSegments" else "flat"
        out.geometries.append(LineSegmentsGeometry(pos, idx, kind=kind))
    elif tag == "Points":
        ptype = elem.get("type", "sphere")
        pos = _xf_positions_anim(xf, _positions(elem, 4), radius_col=True)
        nrm = _xf_vectors_anim(xf, _buffer(elem, "normals", 3))
        kind = {"sphere": "sphere", "disc": "disc",
                "oriented": "oriented_disc",
                "oriented_disc": "oriented_disc"}[ptype]
        out.geometries.append(PointGeometry(pos, kind=kind, normals=nrm))
    else:
        return False
    out.kd.append(kd)
    # time range (rtcSetGeometryTimeRange analog): an animated transform
    # carries its own span; otherwise a pending <TimeRange> applies to the
    # geometry's motion buffers (SceneGraph::set_time_range semantics)
    tr = xf.trange if (xf is not None and xf.steps is not None) else trange
    if tr is not None:
        for g in out.geometries[n0:]:
            g.time_range = (float(tr[0]), float(tr[1]))
    return True


def _walk(out: XMLScene, elem, xf, trange=None):
    """Walk the scene DOM carrying an _XF (static + optional animated
    transform) and a pending <TimeRange> (consumed by the first
    transform-animation or mesh boundary — SceneGraph::set_time_range
    stops at TransformNode/mesh nodes, scenegraph.cpp:1196)."""
    tag = elem.tag
    if tag == "PerspectiveCamera":
        cam = dict(
            from_=_floats(elem.get("from")), to=_floats(elem.get("to")),
            up=_floats(elem.get("up")), fov=float(elem.get("fov", 90)))
        if out.camera is None:
            out.camera = cam
        name = elem.get("name") or elem.get("id")
        if name:
            out.cameras[name] = cam
        return
    if tag in ("AmbientLight", "PointLight", "DirectionalLight", "DistantLight",
               "SpotLight", "QuadLight", "TriangleLight"):
        params = {c.tag: _nums(c) for c in elem}
        out.lights.append((tag, params))
        return
    if tag == "assign":
        # symbol definitions: not instantiated until <ref> (xml_loader:1709)
        if elem.get("type") == "scene" and len(elem):
            key = elem.get("id") or elem[0].get("id")
            _CTX["scene_map"][key] = elem[0]
        elif elem.get("type") == "material" and len(elem):
            key = elem.get("id") or elem[0].get("id")
            _CTX["material_map"][key] = elem[0]
        return
    if elem.get("id") is not None and tag != "ref":
        # every id-carrying node is referenceable once seen (loadNode)
        _CTX["scene_map"].setdefault(elem.get("id"), elem)
    if tag == "ref":
        target = _CTX["scene_map"].get(elem.get("id"))
        if target is not None:
            _walk(out, target, xf, trange)
        return
    if tag == "TimeRange":
        a, b = [float(v) for v in _floats(elem.get("time"))[:2]]
        for c in elem:
            _walk(out, c, xf, trange=(a, b))
        return
    if tag in ("Transform", "TransformAnimation"):
        spaces = []          # (kind, payload) in document order
        children = []
        quaternion = False
        for c in elem:
            if c.tag == "AffineSpace":
                spaces.append(_parse_affine(c))
            elif c.tag == "Quaternion":
                spaces.append(_parse_quaternion(c))
                quaternion = True
            else:
                children.append(c)
        if len(spaces) <= 1 and tag == "Transform":
            if quaternion:
                sub = _qd_affine(spaces[0]) if spaces else None
            else:
                sub = spaces[0] if spaces else None
            new_xf = (xf or _XF()).compose_static(sub) if sub is not None \
                else (xf or _XF())
            # a static TransformNode consumes (and discards) the pending
            # time range — set_time_range stops at TransformNode
            for c in children:
                _walk(out, c, new_xf, None)
            return
        # animated transform: bake the knot stack (flatten role)
        steps = _resample_qd_steps(spaces) if quaternion \
            else np.stack(spaces)
        new_xf = (xf or _XF()).enter_anim(steps, trange or (0.0, 1.0))
        for c in children:
            _walk(out, c, new_xf, None)
        return
    if tag in ("Group", "scene", "Instance", "Flatten"):
        for c in elem:
            _walk(out, c, xf, trange)
        return
    if _add_geometry(out, elem, xf, trange):
        return
    # unknown containers: recurse
    for c in elem:
        _walk(out, c, xf, trange)


def load_xml(path) -> XMLScene:
    import os
    root = ET.parse(path).getroot()
    out = XMLScene()
    _CTX["scene_map"] = {}
    _CTX["material_map"] = {}
    _CTX["bin"] = None
    binpath = os.path.splitext(str(path))[0] + ".bin"
    if os.path.exists(binpath):
        with open(binpath, "rb") as f:
            _CTX["bin"] = f.read()
    try:
        _walk(out, root, _XF())
    finally:
        _CTX["bin"] = None
        _CTX["scene_map"] = {}
        _CTX["material_map"] = {}
    return out


def to_scene(xs: XMLScene, **scene_kwargs):
    """Build a Scene (the port's) from a parsed XMLScene."""
    from ..scene import Scene
    s = Scene(**scene_kwargs)
    for g in xs.geometries:
        s.attach(g)
    return s
