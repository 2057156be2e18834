"""Collision detection: triangle pairs within overlapping BVH leaves.

Port of embree_tpu/accel/collide.py (behavior parity with rtcCollide,
rtcore_scene.h:346, kernels/bvh/bvh_collider.{h,cpp} with the tri/tri
test of triangle_triangle_intersector.h): every prim of scene A runs a box
query against scene B's BVH in lockstep, its first MAX_PAIRS_PER_PRIM leaf
prims become candidates, and the candidate pairs take Möller's interval
overlap test.

The JAX package runs the walk inside one ``jax.lax.while_loop``; the port
steps the same way in torch ops on the BVH's device (the same stack, push
order and candidate cap), with the finished queries compacted out, and the
pairs come out in the JAX package's order: a stable sort puts the
overlapping pairs first, in (prim of A, candidate slot) order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import cross
from .bvh import BVH, INVALID_NODE, LEAF_COUNT_BITS, LEAF_COUNT_MASK
from .point_query import LEAF_SLOTS, _sum3

STACK_DEPTH = 64
MAX_PAIRS_PER_PRIM = 16


def _dot(a, b):
    return _sum3(a * b)


def tri_tri_overlap(a0, a1, a2, b0, b1, b2, eps=1e-7):
    """Conservative triangle-triangle intersection test (Möller '97
    interval method), the JAX package's expressions term for term."""
    n_b = cross(b1 - b0, b2 - b0)
    d_b = -_dot(n_b, b0)
    da = _dot(n_b, a0) + d_b
    db = _dot(n_b, a1) + d_b
    dc = _dot(n_b, a2) + d_b
    same_side_a = (((da > eps) & (db > eps) & (dc > eps))
                   | ((da < -eps) & (db < -eps) & (dc < -eps)))

    n_a = cross(a1 - a0, a2 - a0)
    d_a = -_dot(n_a, a0)
    ea = _dot(n_a, b0) + d_a
    eb = _dot(n_a, b1) + d_a
    ec = _dot(n_a, b2) + d_a
    same_side_b = (((ea > eps) & (eb > eps) & (ec > eps))
                   | ((ea < -eps) & (eb < -eps) & (ec < -eps)))

    # interval overlap on the intersection line L = n_a x n_b
    d = cross(n_a, n_b)
    axis = torch.argmax(d.abs(), dim=-1)

    def proj(p):
        p = torch.broadcast_to(p, d.shape)
        return p.gather(-1, axis[..., None])[..., 0]

    def seg(vx, vy, dx, dy):
        den = torch.where((dx - dy).abs() > 1e-30, dx - dy,
                          torch.ones_like(dx))
        return vx + (vy - vx) * dx / den

    def interval(p0, p1, p2, d0, d1, d2):
        """Parametric interval of the triangle on L (Möller's t1/t2),
        from the vertex alone on its side of the other plane."""
        v0, v1, v2 = proj(p0), proj(p1), proj(p2)
        s0, s1, s2 = torch.sign(d0), torch.sign(d1), torch.sign(d2)
        alone0 = (s0 != s1) & (s0 != s2)
        alone1 = (s1 != s0) & (s1 != s2)
        va = torch.where(alone0, v0, torch.where(alone1, v1, v2))
        via = torch.where(alone0, d0, torch.where(alone1, d1, d2))
        vb_ = torch.where(alone0, v1, v0)
        vc_ = torch.where(alone0, v2, torch.where(alone1, v2, v1))
        dbq = torch.where(alone0, d1, d0)
        dcq = torch.where(alone0, d2, torch.where(alone1, d2, d1))
        t1 = seg(va, vb_, via, dbq)
        t2 = seg(va, vc_, via, dcq)
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    a_lo, a_hi = interval(a0, a1, a2, da, db, dc)
    b_lo, b_hi = interval(b0, b1, b2, ea, eb, ec)
    overlap = (a_lo <= b_hi) & (b_lo <= a_hi)
    return ~same_side_a & ~same_side_b & overlap


class CollisionResult(NamedTuple):
    pairs: torch.Tensor   # (P, 2) int32 (prim of A, prim of B), overlapping
    #                       pairs first, then rows of -1
    count: torch.Tensor   # () int32 number of overlapping pairs
    steps: int = 0        # lockstep steps the walk took


def collide(bvh_b: BVH, b_v0, b_v1, b_v2,
            a_lo, a_up, a_v0, a_v1, a_v2) -> CollisionResult:
    """All overlapping (triangle of A, triangle of B) pairs: A given by its
    bounds and vertices (Q rows), B by its BVH and the vertices of each of
    its merged prims (rtcCollide analog)."""
    dev = a_lo.device
    Q = a_lo.shape[0]
    M = MAX_PAIRS_PER_PRIM
    inv = int(INVALID_NODE)
    n_prims = bvh_b.prim_order.shape[0]
    cur = torch.zeros(Q, dtype=torch.int64, device=dev)
    stack = torch.zeros((Q, STACK_DEPTH + 1), dtype=torch.int64, device=dev)
    sp = torch.zeros(Q, dtype=torch.int64, device=dev)
    n_cand = torch.zeros(Q, dtype=torch.int64, device=dev)
    # column M takes the candidates past the cap (never read)
    cands = torch.full((Q, M + 1), -1, dtype=torch.int64, device=dev)
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
            child = bvh_b.node_child[node].long()
            lo2, up2 = a_lo[na, None, :], a_up[na, None, :]
            hit = ((bvh_b.node_lower[node] <= up2)
                   & (lo2 <= bvh_b.node_upper[node])).all(-1)
            hit = hit & (child != inv)
            # the first hit child (in slot order) is next, the others are
            # pushed in slot order
            first_k = torch.argmax(hit.to(torch.int8), dim=-1)
            rest = hit.clone()
            rest[torch.arange(rest.shape[0], device=dev), first_k] = False
            before = torch.cumsum(rest.long(), 1) - rest.long()
            pos = sp[na, None] + before
            ok = rest & (pos < STACK_DEPTH)
            stack[na[:, None], torch.where(ok, pos, STACK_DEPTH)] = child
            sp[na] = sp[na] + ok.sum(1)
            descend = hit.any(-1)
            cur[na] = torch.where(descend, child.gather(1, first_k[:, None])
                                  [:, 0], c[node_pos])
            pop[node_pos] = ~descend

        leaf_pos = is_leaf.nonzero().squeeze(1)
        if leaf_pos.numel():
            la = act[leaf_pos]
            packed = -(c[leaf_pos] + 1)
            start = packed >> LEAF_COUNT_BITS
            count = packed & LEAF_COUNT_MASK
            # the leaf's first slots, up to the cap: candidates in order
            k = torch.arange(LEAF_SLOTS, device=dev)
            room = (M - n_cand[la]).clamp(min=0)
            take = (k < count[:, None]) & (k < room[:, None])
            prim = bvh_b.prim_order[(start[:, None] + k).clamp(
                0, n_prims - 1)].long()
            posc = torch.where(take, n_cand[la, None] + k, M)
            cands[la[:, None], posc] = torch.where(take, prim, -1)
            n_cand[la] = n_cand[la] + take.sum(1)

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

    cand = cands[:, :M]
    valid = cand >= 0
    bi = cand.clamp(0, b_v0.shape[0] - 1)
    isect = tri_tri_overlap(a_v0[:, None, :], a_v1[:, None, :],
                            a_v2[:, None, :], b_v0[bi], b_v1[bi], b_v2[bi])
    good = (valid & isect).reshape(-1)
    flat_a = torch.arange(Q, device=dev)[:, None].expand(Q, M).reshape(-1)
    flat_b = cand.reshape(-1)
    order = torch.argsort((~good).to(torch.int8), stable=True)
    g = good[order]
    neg = torch.full_like(flat_a, -1)
    pairs = torch.stack([torch.where(g, flat_a[order], neg),
                         torch.where(g, flat_b[order], neg)], dim=-1)
    return CollisionResult(pairs=pairs.to(torch.int32),
                           count=good.sum().to(torch.int32), steps=steps)
