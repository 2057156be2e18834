"""Spatial pre-splitting for HIGH build quality.

A copy of embree_tpu/accel/presplit.py (numpy only, so the port keeps its
own copy instead of importing the JAX package). Role parity with the
reference's HIGH-quality tier (kernels/builders/primrefgen_presplit.h:231
pre-split replication, heuristic_spatial_array.h spatial splits, the
replication budget max_spatial_split_replications, state.h:117): oversized
primitive refs are split against spatial planes BEFORE the build, so the
builder sees tighter, replicated refs and long or diagonal prims stop
inflating node bounds. Triangles are clipped exactly (Sutherland-Hodgman
against the axis plane); other kinds split their AABB at the plane, which
stays a correct (conservative) bound of each clipped half.

Host-side numpy, vectorized over the whole split batch per round.
"""
from __future__ import annotations

import numpy as np


def _clip_triangle_bounds(v0, v1, v2, axis, pos):
    """Exact AABBs of a triangle clipped by the plane x[axis] = pos.
    Returns (lo_left, up_left, lo_right, up_right), each (n, 3)."""
    n = v0.shape[0]
    verts = np.stack([v0, v1, v2], axis=1)         # (n, 3, 3)
    INF = np.float32(np.inf)
    lo_l = np.full((n, 3), INF); up_l = np.full((n, 3), -INF)
    lo_r = np.full((n, 3), INF); up_r = np.full((n, 3), -INF)

    def acc(side_lo, side_up, pts, m):
        m3 = m[:, None]
        side_lo[:] = np.minimum(side_lo, np.where(m3, pts, INF))
        side_up[:] = np.maximum(side_up, np.where(m3, pts, -INF))

    for i in range(3):
        a = verts[:, i]
        b = verts[:, (i + 1) % 3]
        da = a[:, axis] - pos
        db = b[:, axis] - pos
        acc(lo_l, up_l, a, da <= 0)
        acc(lo_r, up_r, a, da >= 0)
        crosses = (da * db) < 0
        t = np.where(crosses, da / np.where(da == db, 1.0, da - db), 0.0)
        p = a + t[:, None] * (b - a)
        p[:, axis] = pos                            # exact on the plane
        acc(lo_l, up_l, p, crosses)
        acc(lo_r, up_r, p, crosses)
    return lo_l, up_l, lo_r, up_r


def _half_area(lo, up):
    d = np.maximum(up - lo, 0)
    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]


def presplit(lo, up, ref_ids, tri_sel, tri_v0, tri_v1, tri_v2,
             budget_factor: float = 1.5, rounds: int = 3):
    """Replicate oversized refs by spatial splitting.

    Args:
      lo, up: (T, 3) primitive bounds.
      ref_ids: (T,) merged prim index per ref.
      tri_sel: (T,) bool — refs that are triangles (exact clipping).
      tri_v0/v1/v2: (T, 3) triangle vertices (junk rows where ~tri_sel).
      budget_factor: max refs / prims (max_spatial_split_replications role).
    Returns (lo, up, ref_ids) with replicated refs.
    """
    T0 = lo.shape[0]
    budget = int(T0 * (budget_factor - 1.0))
    if budget <= 0 or T0 < 2:
        return lo, up, ref_ids
    lo = lo.copy(); up = up.copy(); ref_ids = ref_ids.copy()
    tri_v0 = np.asarray(tri_v0); tri_v1 = np.asarray(tri_v1)
    tri_v2 = np.asarray(tri_v2)
    tri_sel = np.asarray(tri_sel)

    for _ in range(rounds):
        if budget <= 0:
            break
        area = _half_area(lo, up)
        # spend the replication budget on the largest refs first (the
        # priority-queue budget spending of primrefgen_presplit.h); skip
        # refs already degenerate along their longest axis
        ext = up - lo
        splittable = ext.max(1) > 1e-12
        order = np.argsort(-np.where(splittable, area, -1.0))
        k = min(budget, max(lo.shape[0] // 3, 1), int(splittable.sum()))
        if k <= 0:
            break
        pick = order[:k]
        ext = up[pick] - lo[pick]
        axis = np.argmax(ext, axis=1)
        pos = 0.5 * (lo[pick, axis] + up[pick, axis])
        src = ref_ids[pick]
        is_tri = tri_sel[pick]

        lo_l = lo[pick].copy(); up_l = up[pick].copy()
        lo_r = lo[pick].copy(); up_r = up[pick].copy()
        # AABB split (all kinds; conservative)
        up_l[np.arange(k), axis] = pos
        lo_r[np.arange(k), axis] = pos
        # exact triangle clip per axis batch
        for ax in range(3):
            sel = is_tri & (axis == ax)
            if not sel.any():
                continue
            p = pick[sel]
            cll, cul, clr, cur = _clip_triangle_bounds(
                tri_v0[p], tri_v1[p], tri_v2[p], ax, pos[sel])
            # intersect with the original ref bounds (refs may already be
            # fragments of a previous round)
            tl, tu = np.maximum(cll, lo[p]), np.minimum(cul, up[p])
            tu[:, ax] = np.minimum(tu[:, ax], pos[sel])
            lo_l[sel], up_l[sel] = tl, tu
            tl, tu = np.maximum(clr, lo[p]), np.minimum(cur, up[p])
            tl[:, ax] = np.maximum(tl[:, ax], pos[sel])
            lo_r[sel], up_r[sel] = tl, tu
        # degenerate halves (prim entirely on one side) collapse to a point
        # box inside the other half — harmless duplicates
        bad_l = (lo_l > up_l).any(1)
        lo_l[bad_l] = lo[pick][bad_l]; up_l[bad_l] = lo[pick][bad_l]
        bad_r = (lo_r > up_r).any(1)
        lo_r[bad_r] = lo[pick][bad_r]; up_r[bad_r] = lo[pick][bad_r]

        lo[pick] = lo_l; up[pick] = up_l
        lo = np.concatenate([lo, lo_r]); up = np.concatenate([up, up_r])
        ref_ids = np.concatenate([ref_ids, src])
        tri_sel = np.concatenate([tri_sel, is_tri])
        tri_v0 = np.concatenate([tri_v0, tri_v0[pick]])
        tri_v1 = np.concatenate([tri_v1, tri_v1[pick]])
        tri_v2 = np.concatenate([tri_v2, tri_v2[pick]])
        budget -= k
    return lo.astype(np.float32), up.astype(np.float32), ref_ids
