"""Catmull-Clark subdivision (host-side, numpy).

A copy of embree_tpu/ops/subdiv.py, line for line, so that the refined
vertices, quads, base-face ids and uv frames are bit-equal with the JAX
package's (the port imports nothing of embree_tpu).

Behavior parity with the reference subdivision kernel (kernels/subdiv/:
catmullclark_ring.h vertex/edge/face rules, scene_subdiv_mesh.cpp half-edge
build; RTC_SUBDIVISION_MODE boundary handling rtcore_geometry.h:56-63;
vertex creases RTC_BUFFER_TYPE_VERTEX_CREASE_* with +inf = pinned corner).

TPU-first divergence (SURVEY.md §7 hard-part 6): the reference evaluates
patches lazily per-ray through a tessellation cache; here meshes are uniformly
subdivided ahead-of-time at commit into quads, then pushed onto the LIMIT
surface with the closed-form Catmull-Clark limit stencils (the refined
control cage alone sits measurably inside the limit surface the reference
renders). Crease weights follow the blended sharp/smooth rule: a crease of
weight w >= 1 uses the sharp rule for one more level then decrements (the
DeRose fractional-sharpness scheme).

Each refined quad also carries its base-face parameter rectangle (an affine
uv frame), so hits report uv spanning the BASE face like the reference's
patch uv — for quad base faces; n-gon sub-faces keep sub-quad-local uv
(documented divergence).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _face_list(face_counts, indices):
    faces = []
    off = 0
    for c in face_counts:
        faces.append(list(indices[off:off + c]))
        off += c
    return faces


def catmull_clark(vertices: np.ndarray, face_counts: np.ndarray,
                  indices: np.ndarray, levels: int = 2,
                  creases: Optional[Dict[Tuple[int, int], float]] = None,
                  vertex_creases: Optional[Dict[int, float]] = None,
                  boundary_interpolation: bool = True,
                  to_limit: bool = True,
                  boundary_mode: Optional[str] = None):
    """Uniformly subdivide `levels` times, then project to the limit surface.

    Args:
      vertices: (n, 3) or (S, n, 3) float32 (motion steps share topology).
      face_counts: (F,) verts per face (arbitrary valence).
      indices: flat vertex indices (sum(face_counts),).
      creases: optional {(v0, v1) sorted tuple: weight} edge crease map.
      vertex_creases: optional {vertex: weight} (np.inf pins forever).
      boundary_interpolation: smooth boundary rule (True) vs corners pinned.
      to_limit: push the final cage onto the Catmull-Clark limit surface.
    Returns:
      (verts, quad_indices (Q, 4) int32, base_face (Q,) int32,
       quad_uvm (Q, 6) float32): the all-quad refined mesh, the base-face id
      each quad came from, and the affine quad-local->base-face uv frame
      [ou, ov, m2, m3, m4, m5] consumed as (scene.py _kind_test quad path):
        u_base = ou + u*m2 + v*m4 ; v_base = ov + u*m3 + v*m5
      (m2,m3 = d(u_base,v_base)/du_local; m4,m5 = d(u_base,v_base)/dv_local).
      verts has the same leading motion axis as the input.
    """
    Vin = np.asarray(vertices, np.float64)
    multi = Vin.ndim == 3
    Vs = Vin if multi else Vin[None]
    faces = _face_list(np.asarray(face_counts, np.int64),
                       np.asarray(indices, np.int64))
    base = list(range(len(faces)))
    crease = dict(creases or {})
    vcrease = dict(vertex_creases or {})
    # RTC_SUBDIVISION_MODE (rtcore_geometry.h:56-63) pinning: pinned
    # vertices never move and skip limit projection; pin_boundary also pins
    # every newly created boundary edge midpoint; pin_all degenerates the
    # whole refinement to linear face splitting (limit = cage)
    pinned: set = set()
    if boundary_mode in ("pin_boundary", "pin_corners", "pin_all"):
        ef: Dict[Tuple[int, int], int] = {}
        vf: Dict[int, int] = {}
        for f in faces:
            n = len(f)
            for k in range(n):
                e = tuple(sorted((f[k], f[(k + 1) % n])))
                ef[e] = ef.get(e, 0) + 1
            for v in f:
                vf[v] = vf.get(v, 0) + 1
        bverts = {v for e, c in ef.items() if c == 1 for v in e}
        if boundary_mode == "pin_all":
            pinned = set(range(Vs[0].shape[0]))
        elif boundary_mode == "pin_boundary":
            pinned = bverts
        else:
            pinned = {v for v in bverts if vf.get(v, 0) == 1}
    # base-face uv corners: exact for quads, None for n-gons
    fuv = [[(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
           if len(f) == 4 else None for f in faces]

    Vs = list(Vs)
    for _ in range(max(levels, 0)):
        out = _subdivide_once(Vs, faces, base, crease, vcrease, fuv,
                              boundary_interpolation, pinned,
                              boundary_mode)
        Vs, faces, base, crease, vcrease, fuv, pinned = out

    if to_limit:
        Vs = [_limit_project(V, faces, crease, vcrease,
                             boundary_interpolation, pinned) for V in Vs]

    # after >=1 level everything is quads; with levels=0 fan-split non-quads
    quads = []
    qbase = []
    quvm = []

    def uvm_of(uv):
        if uv is None or len(uv) != 4:
            return [0.0, 0.0, 1.0, 0.0, 0.0, 1.0]
        (ou, ov), (bu, bv), _, (du, dv) = uv
        return [ou, ov, bu - ou, bv - ov, du - ou, dv - ov]

    for f, b, uv in zip(faces, base, fuv):
        if len(f) == 4:
            quads.append(f)
            qbase.append(b)
            quvm.append(uvm_of(uv))
        elif len(f) == 3:
            quads.append([f[0], f[1], f[2], f[2]])
            qbase.append(b)
            quvm.append(uvm_of(None))
        else:
            for k in range(1, len(f) - 1):
                quads.append([f[0], f[k], f[k + 1], f[k + 1]])
                qbase.append(b)
                quvm.append(uvm_of(None))
    V_out = np.stack([V.astype(np.float32) for V in Vs])
    if not multi:
        V_out = V_out[0]
    return (V_out, np.asarray(quads, np.int32),
            np.asarray(qbase, np.int32), np.asarray(quvm, np.float32))


def _mid_uv(a, b):
    return (0.5 * (a[0] + b[0]), 0.5 * (a[1] + b[1]))


def _eff_w(e, crease, edge_faces):
    """Effective crease weight: boundary edges are infinite creases
    (catmullclark_ring.h:182 border ring slots get crease inf)."""
    if len(edge_faces.get(e, ())) == 1:
        return float("inf")
    return crease.get(e, 0.0)


def _subdivide_once(Vs, faces, base, crease, vcrease, fuv, smooth_boundary,
                    pinned=frozenset(), boundary_mode=None):
    nv = Vs[0].shape[0]
    # --- adjacency ---
    edge_faces: Dict[Tuple[int, int], List[int]] = {}
    for fi, f in enumerate(faces):
        n = len(f)
        for k in range(n):
            e = tuple(sorted((f[k], f[(k + 1) % n])))
            edge_faces.setdefault(e, []).append(fi)

    edge_order = list(edge_faces.keys())
    ep_idx = {e: nv + len(faces) + i for i, e in enumerate(edge_order)}
    fp_idx = {fi: nv + fi for fi in range(len(faces))}

    vert_edges: Dict[int, List[Tuple[int, int]]] = {}
    vert_faces: Dict[int, List[int]] = {}
    for e in edge_order:
        for v in e:
            vert_edges.setdefault(v, []).append(e)
    for fi, f in enumerate(faces):
        for v in f:
            vert_faces.setdefault(v, []).append(fi)

    newVs = []
    for V in Vs:
        # --- face points ---
        fp = np.array([V[f].mean(axis=0) for f in faces])

        # --- edge points ---
        ep_list = []
        for e in edge_order:
            efs = edge_faces[e]
            mid = 0.5 * (V[e[0]] + V[e[1]])
            # PIN_ALL sets edge_crease = inf on EVERY edge
            # (scene_subdiv_mesh.cpp:556): refinement degenerates to linear
            # face splitting — edge points are pure midpoints
            w = np.inf if boundary_mode == "pin_all" else crease.get(e, 0.0)
            if len(efs) == 2 and w < 1.0:
                smooth = 0.25 * (V[e[0]] + V[e[1]] + fp[efs[0]] + fp[efs[1]])
                pt = (1 - w) * smooth + w * mid
            else:
                pt = mid  # boundary or sharp crease
            ep_list.append(pt)

        # --- vertex points (catmullclark_ring.h subdivide() vertex rules:
        # creases count as ANY w > 0, boundary edges are infinite creases,
        # 2-crease vertices blend smooth<->sharp by 0.5*(w0+w1)) ---
        VP = V.copy()
        for v in range(nv):
            if v in pinned:
                continue              # pinned: never moves
            edges = vert_edges.get(v, [])
            fcs = vert_faces.get(v, [])
            if not edges:
                continue
            n = len(fcs)
            interior = n > 0 and len(edges) == n
            if interior:
                Q = fp[fcs].mean(axis=0)
                Rm = np.array([0.5 * (V[e[0]] + V[e[1]])
                               for e in edges]).mean(axis=0)
                v_smooth = (Q + 2.0 * Rm + (n - 3.0) * V[v]) / n
            else:
                v_smooth = V[v]
            vw = vcrease.get(v, 0.0)
            if vw > 0.0:
                # vertex crease pre-empts edge-crease rules (ring returns)
                if vw < 1.0:
                    VP[v] = (1.0 - vw) * v_smooth + vw * V[v]
                continue
            cre = [(e, _eff_w(e, crease, edge_faces)) for e in edges]
            cre = [(e, w) for e, w in cre if w > 0.0]
            if not smooth_boundary and any(
                    len(edge_faces[e]) == 1 for e in edges):
                continue          # pin-corners boundary mode
            if len(cre) >= 3:
                continue          # corner: pinned
            if len(cre) == 2:
                (e0, w0), (e1, w1) = cre
                o0 = e0[0] if e0[1] == v else e0[1]
                o1 = e1[0] if e1[1] == v else e1[1]
                v_sharp = (V[o0] + 6.0 * V[v] + V[o1]) / 8.0
                blend = min(0.5 * (w0 + w1), 1.0)
                VP[v] = (1.0 - blend) * v_smooth + blend * v_sharp
            elif interior:
                VP[v] = v_smooth   # smooth / dart

        newVs.append(np.concatenate([VP, fp, np.asarray(ep_list)], axis=0))

    # --- propagate pinning to the refined mesh. Only ORIGINAL vertices are
    # ever pinned (the reference implements the pin modes as inf
    # vertex-crease weights on base-mesh vertices, scene_subdiv_mesh.cpp:
    # 544-557, surviving subdivision via w-1 = inf; newly created edge/face
    # points get NO vertex crease and follow the ordinary rules — for
    # pin_boundary the border stays a straight polyline because all its
    # points are collinear between pinned originals, NOT because midpoints
    # are pinned, and their parametric spacing follows the crease rules) ---
    new_pinned = set(pinned)
    if boundary_mode == "pin_all":
        new_pinned = set(range(nv + len(faces) + len(edge_order)))

    # --- new faces: one quad per (face, corner), with uv frames ---
    new_faces = []
    new_base = []
    new_fuv = []
    for fi, f in enumerate(faces):
        n = len(f)
        uv = fuv[fi]
        for k in range(n):
            v = f[k]
            e_prev = tuple(sorted((f[(k - 1) % n], v)))
            e_next = tuple(sorted((v, f[(k + 1) % n])))
            new_faces.append([v, ep_idx[e_next], fp_idx[fi], ep_idx[e_prev]])
            new_base.append(base[fi])
            if uv is not None and n == 4:
                A = uv[k]
                B = uv[(k + 1) % 4]
                C = (0.25 * sum(p[0] for p in uv),
                     0.25 * sum(p[1] for p in uv))
                D = uv[(k - 1) % 4]
                new_fuv.append([A, _mid_uv(A, B), C, _mid_uv(D, A)])
            elif n != 4:
                # irregular (general) face: child k owns the 2x2 uv block at
                # (k%4, k//4) with its unit square centered — the reference's
                # SubdividedGeneralPatch parameterization
                # (patch_eval.h:58-64: l=floor(U/2), u=2*frac(U/2)-0.5)
                l, h = k % 4, k // 4
                new_fuv.append([(2 * l + 0.5, 2 * h + 0.5),
                                (2 * l + 1.5, 2 * h + 0.5),
                                (2 * l + 1.5, 2 * h + 1.5),
                                (2 * l + 0.5, 2 * h + 1.5)])
            else:
                new_fuv.append(None)

    # --- propagate creases: Chaikin rule at 2-crease vertices, else w-1
    # (catmullclark_ring.h:289-291; sub-edge (v, mid) takes its weight from
    # endpoint v's rule, matching the ring-local storage) ---
    new_crease: Dict[Tuple[int, int], float] = {}
    for e, w in crease.items():
        if w <= 0:
            continue
        ei = ep_idx.get(e)
        if ei is None:
            continue
        for v in e:
            cre = [(e2, _eff_w(e2, crease, edge_faces))
                   for e2 in vert_edges.get(v, [])]
            cre = [(e2, w2) for e2, w2 in cre if w2 > 0.0]
            if len(cre) == 2 and vcrease.get(v, 0.0) <= 0.0:
                others = [w2 for e2, w2 in cre if e2 != e]
                w_other = others[0] if others else w
                nw = max(0.25 * (3.0 * w + w_other) - 1.0, 0.0)
            else:
                nw = max(w - 1.0, 0.0)
            if nw > 0.0:
                new_crease[tuple(sorted((v, ei)))] = nw
    new_vcrease = {v: (w if not np.isfinite(w) else w - 1.0)
                   for v, w in vcrease.items()
                   if not np.isfinite(w) or w > 1.0}
    return (newVs, new_faces, new_base, new_crease, new_vcrease, new_fuv,
            new_pinned)


def _limit_project(V, faces, crease, vcrease, smooth_boundary,
                   pinned=frozenset()):
    """Push a refined control cage onto the Catmull-Clark limit surface.

    Closed-form limit stencils (catmullclark_ring.h getLimitVertex roles):
      interior valence-n vertex:  (n^2 v + 4 sum(edge mids) + sum(face
        centroids)) / (n (n+5))
      crease/boundary vertex:     (e0 + 4 v + e1) / 6
      corners / pinned:           v
    """
    edge_faces: Dict[Tuple[int, int], List[int]] = {}
    for fi, f in enumerate(faces):
        n = len(f)
        for k in range(n):
            e = tuple(sorted((f[k], f[(k + 1) % n])))
            edge_faces.setdefault(e, []).append(fi)
    vert_edges: Dict[int, List[Tuple[int, int]]] = {}
    vert_faces: Dict[int, List[int]] = {}
    for e in edge_faces:
        for v in e:
            vert_edges.setdefault(v, []).append(e)
    for fi, f in enumerate(faces):
        for v in f:
            vert_faces.setdefault(v, []).append(fi)

    out = V.copy()
    for v, edges in vert_edges.items():
        if v in pinned:
            continue                  # pinned: limit = cage position
        fcs = vert_faces.get(v, [])
        n = len(fcs)
        interior = n > 0 and len(edges) == n
        if interior:
            E = np.array([0.5 * (V[e[0]] + V[e[1]])
                          for e in edges]).sum(axis=0)
            Fc = np.array([V[faces[fi]].mean(axis=0)
                           for fi in fcs]).sum(axis=0)
            l_smooth = (n * n * V[v] + 4.0 * E + Fc) / (n * (n + 5.0))
        else:
            l_smooth = V[v]
        vw = vcrease.get(v, 0.0)
        if vw > 0:
            if vw < 1.0:                   # semi-sharp vertex crease blend
                out[v] = (1.0 - vw) * l_smooth + vw * V[v]
            continue                       # >=1: pinned
        cre = [(e, _eff_w(e, crease, edge_faces)) for e in edges]
        cre = [(e, w) for e, w in cre if w > 0.0]
        if not smooth_boundary and any(
                len(edge_faces[e]) == 1 for e in edges):
            continue                       # pin-corners boundary mode
        if len(cre) >= 3:
            continue                       # corner stays
        if len(cre) == 2:
            (e0, w0), (e1, w1) = cre
            o0 = e0[0] if e0[1] == v else e0[1]
            o1 = e1[0] if e1[1] == v else e1[1]
            l_sharp = (V[o0] + 4.0 * V[v] + V[o1]) / 6.0
            blend = min(0.5 * (w0 + w1), 1.0)
            out[v] = (1.0 - blend) * l_smooth + blend * l_sharp
        elif interior:
            out[v] = l_smooth
    return out
