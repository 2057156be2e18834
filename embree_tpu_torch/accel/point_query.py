"""Point queries: the closest triangle point within a radius, over the BVH.

Port of embree_tpu/accel/point_query.py (behavior parity with rtcPointQuery,
kernels/common/point_query.h and bvh_intersector1.cpp:211; ClosestPointTest
verify.cpp:3970): a branch-and-bound descent ordered by node distance that
shrinks the query radius as closer triangles are found.

The JAX package runs every query in lockstep inside one
``jax.lax.while_loop``; the port steps the same way in torch ops on the
BVH's device, with the same stack, child order (a stable sort of the box
distances, as ``jnp.argsort``), leaf loop and arithmetic order, so each
query takes the same path. Only the queries still walking take part in a
step (finished ones are compacted out), which leaves each query's
arithmetic unchanged; a leaf's slots are tested together and taken in
order. Each step waits on the host a few times (the walking queries, their
split into nodes and leaves).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import dot, sqrt_rn
from .bvh import BVH, INVALID_NODE, LEAF_COUNT_BITS, LEAF_COUNT_MASK

STACK_DEPTH = 64
LEAF_SLOTS = 15          # the leaf encoding's count mask


def _sum3(x):
    """The sum over the trailing 3 entries, in index order (XLA's CPU
    reduction of jnp.sum over a length-3 axis)."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def closest_point_triangle(p, a, b, c):
    """Closest point on triangle abc to p (Ericson, Real-Time Collision
    Detection 5.1.5; the reference's closest_point tutorial), the JAX
    package's region decomposition term for term."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot(ab, ap)
    d2 = dot(ac, ap)
    bp = p - b
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)
    cp = p - c
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    def safe(den):
        return torch.where(den.abs() > 1e-30, den, torch.ones_like(den))

    s = va + vb + vc
    denom_uv = safe(s)
    v_in = vb / denom_uv
    w_in = vc / denom_uv
    p_in = a + v_in[..., None] * ab + w_in[..., None] * ac

    d13 = d1 - d3
    v_ab = torch.where(d13.abs() > 1e-30, d1 / safe(d13),
                       torch.zeros_like(d1)).clamp(0.0, 1.0)
    p_ab = a + v_ab[..., None] * ab
    d26 = d2 - d6
    w_ac = torch.where(d26.abs() > 1e-30, d2 / safe(d26),
                       torch.zeros_like(d2)).clamp(0.0, 1.0)
    p_ac = a + w_ac[..., None] * ac
    d43 = d4 - d3
    d56 = d5 - d6
    w_bc = (d43 / safe(d43 + d56)).clamp(0.0, 1.0)
    p_bc = b + w_bc[..., None] * (c - b)

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = ~in_a & ~in_b & ~in_c & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = ~in_a & ~in_b & ~in_c & ~on_ab & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (~in_a & ~in_b & ~in_c & ~on_ab & ~on_ac
             & (va <= 0) & (d43 >= 0) & (d56 >= 0))

    out = p_in
    for sel, q in ((on_bc, p_bc), (on_ac, p_ac), (on_ab, p_ab), (in_c, c),
                   (in_b, b), (in_a, a)):
        out = torch.where(sel[..., None], q.expand_as(out), out)
    return out


def _aabb_dist2(lo, up, p):
    """Squared distance from each point to its W boxes: lo, up (n, W, 3),
    p (n, 3) -> (n, W)."""
    pp = p[:, None, :]
    d = torch.clamp(torch.maximum(lo - pp, pp - up), min=0.0)
    return _sum3(d * d)


class PointQueryResult(NamedTuple):
    dist: torch.Tensor    # (Q,) distance to the closest triangle (the
    #                       radius when none lies within it)
    point: torch.Tensor   # (Q, 3) the closest point
    prim: torch.Tensor    # (Q,) merged prim index, -1 if none
    steps: int = 0        # lockstep steps the walk took


def point_query(bvh: BVH, tri_v0, tri_v1, tri_v2, prim_is_tri,
                points, radius) -> PointQueryResult:
    """Closest triangle point within ``radius`` for each query point.

    tri_v0..2: (T, 3) the vertices of each merged prim (rows of other
    kinds are ignored through ``prim_is_tri``, (T,) bool); points (Q, 3);
    radius a scalar or (Q,). Tensors on the BVH's device."""
    dev = points.device
    Q = points.shape[0]
    W = bvh.width
    inv = int(INVALID_NODE)
    n_prims = bvh.prim_order.shape[0]
    n_tri = tri_v0.shape[0]
    radius = torch.broadcast_to(
        torch.as_tensor(radius, dtype=torch.float32, device=dev), (Q,))
    cur = torch.zeros(Q, dtype=torch.int64, device=dev)
    # column STACK_DEPTH takes the pushes that fall off (never read)
    stack = torch.zeros((Q, STACK_DEPTH + 1), dtype=torch.int64, device=dev)
    sp = torch.zeros(Q, dtype=torch.int64, device=dev)
    best_d2 = radius * radius
    best_p = torch.zeros((Q, 3), dtype=torch.float32, device=dev)
    best_prim = torch.full((Q,), -1, dtype=torch.int64, device=dev)
    push_k = torch.arange(W - 1, 0, -1, device=dev)
    act = torch.arange(Q, device=dev)
    steps = 0
    while act.numel() > 0:
        steps += 1
        c = cur[act]
        is_node = c >= 0
        is_leaf = (c < 0) & (c != inv)
        pop = is_leaf.clone()

        node_pos = is_node.nonzero().squeeze(1)
        if node_pos.numel():
            na = act[node_pos]
            node = c[node_pos]
            child = bvh.node_child[node].long()
            d2 = _aabb_dist2(bvh.node_lower[node], bvh.node_upper[node],
                             points[na])
            hit = (d2 <= best_d2[na, None]) & (child != inv)
            dist = torch.where(hit, d2, torch.full_like(d2, float("inf")))
            order = torch.argsort(dist, dim=-1, stable=True)
            child_s = child.gather(1, order)
            hit_s = hit.gather(1, order)
            num_hits = hit.sum(-1)
            want = hit_s[:, push_k]
            before = torch.cumsum(want.long(), 1) - want.long()
            pos = sp[na, None] + before
            ok = want & (pos < STACK_DEPTH)
            stack[na[:, None], torch.where(ok, pos, STACK_DEPTH)] = \
                child_s[:, push_k]
            sp[na] = sp[na] + ok.sum(1)
            descend = num_hits > 0
            cur[na] = torch.where(descend, child_s[:, 0], c[node_pos])
            pop[node_pos] = ~descend

        leaf_pos = is_leaf.nonzero().squeeze(1)
        if leaf_pos.numel():
            la = act[leaf_pos]
            packed = -(c[leaf_pos] + 1)
            start = packed >> LEAF_COUNT_BITS
            count = packed & LEAF_COUNT_MASK
            # every slot of the leaf at once, then the slots in order (the
            # JAX loop's strict < against the running best): no host wait
            # per slot
            k = torch.arange(LEAF_SLOTS, device=dev)
            prim = bvh.prim_order[(start[:, None] + k).clamp(
                0, n_prims - 1)].long()                   # (L, width)
            i = prim.clamp(0, n_tri - 1)
            p = points[la][:, None, :].expand(-1, LEAF_SLOTS, -1)
            cp = closest_point_triangle(p, tri_v0[i], tri_v1[i], tri_v2[i])
            e = p - cp
            dd = _sum3(e * e)
            ok = prim_is_tri[prim] & (k < count[:, None])
            ld2, lp, lprim = best_d2[la], best_p[la], best_prim[la]
            for j in range(LEAF_SLOTS):
                better = ok[:, j] & (dd[:, j] < ld2)
                ld2 = torch.where(better, dd[:, j], ld2)
                lp = torch.where(better[:, None], cp[:, j], lp)
                lprim = torch.where(better, prim[:, j], lprim)
            best_d2[la], best_p[la], best_prim[la] = ld2, lp, lprim

        pop_pos = pop.nonzero().squeeze(1)
        done = torch.zeros_like(is_node)
        if pop_pos.numel():
            pa = act[pop_pos]
            has = sp[pa] > 0
            new_sp = torch.where(has, sp[pa] - 1, sp[pa])
            top = stack[pa].gather(1, new_sp[:, None])[:, 0]
            cur[pa] = torch.where(has, top, torch.full_like(top, inv))
            sp[pa] = new_sp
            done[pop_pos] = ~has
        act = act[~done]
    return PointQueryResult(dist=sqrt_rn(best_d2), point=best_p,
                            prim=best_prim.to(torch.int32), steps=steps)
