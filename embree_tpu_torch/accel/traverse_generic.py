"""BVH traversal with an arbitrary primitive test: the generic engine.

The counterpart of embree_tpu/accel/traverse.py (``slab_test``,
``TraversalResult``, ``_pop``, ``traverse``); the port's accel/traverse.py
holds the packed kernel, the port of traverse_pallas.py. Role parity with the
reference's traversal stack machines (kernels/bvh/bvh_intersector1.cpp:31-115
ordered single-ray traversal, bvh_traverser1.h:58 distance-sorted push,
node_intersector1.h:426 N-wide slab test).

All rays step in lockstep, as in the JAX engine: each step, every ray still
active either tests the W children of its node (slab test, the hair tier's
leaf OBBs, children sorted by entry distance, the far ones pushed) or tests
the prims of its leaf one slot after another with the caller's
``prim_test``, then pops. A step's count, its stack discipline, its tie rule
and the order of its arithmetic are the JAX engine's, so ``steps`` and
``overflow`` come back as there. Only the rays that need a piece of work
take part in it: rays that are done drop out of the step, a leaf slot is
tested only for the rays whose leaf has that slot. Each ray's arithmetic is
unchanged by that; the JAX engine computes the others too and masks them
out.

Memory: the stack is R x 65 int32 (one spill column) and a primitive test
may hold several per-ray intermediates (the round-curve sweep: 32 seeds per
ray); the scene's entry points split a large batch into chunks
(scene.GENERIC_CHUNK rays each).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.math import rcp_safe
from .bvh import BVH, INVALID_NODE, LEAF_COUNT_BITS, LEAF_COUNT_MASK

STACK_DEPTH = 64
MAX_STEPS = 200_000      # runaway guard (a ray whose node ref is invalid)

# robust-mode slab widening (node_intersector1.h:106-110: near/far
# reciprocal directions scaled by 1 -/+ 3 ulp), rounded to float32
ROUND_DOWN = float(np.float32(1.0 - 3.0 * 1.19209290e-07))
ROUND_UP = float(np.float32(1.0 + 3.0 * 1.19209290e-07))


def slab_test(node_lo, node_up, org, rdir, tnear, tfar, robust: bool = False):
    """Ray/AABB slab test over a trailing child axis.

    node_lo, node_up: (..., W, 3); org, rdir: (..., 3); tnear, tfar: (...,).
    robust: widen the slab interval by +-3 ulp (RTC_SCENE_FLAG_ROBUST).
    Returns (hit, t_entry), each (..., W)."""
    t0 = (node_lo - org[..., None, :]) * rdir[..., None, :]
    t1 = (node_up - org[..., None, :]) * rdir[..., None, :]
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    if robust:
        tmin = tmin * ROUND_DOWN
        tmax = tmax * ROUND_UP
    t_entry = torch.maximum(tmin.amax(-1), tnear[..., None])
    t_exit = torch.minimum(tmax.amin(-1), tfar[..., None])
    return t_entry <= t_exit, t_entry


class TraversalResult(NamedTuple):
    tfar: torch.Tensor       # (R,) hit distance (tfar where nothing was hit)
    best_prim: torch.Tensor  # (R,) int32 prim id, -1 on a miss
    steps: int               # lockstep iterations (stat.h counters role)
    overflow: int = 0        # dropped stack pushes (must be 0)


def _pop(stack, sp, active):
    """Pop the rays' stacks; rays with an empty stack become inactive.
    stack: (n, >= STACK_DEPTH), sp and active: (n,). Returns (cur, sp,
    active)."""
    has = sp > 0
    new_sp = torch.where(has, sp - 1, sp)
    top = stack.gather(1, new_sp.clamp(min=0)[:, None])[:, 0]
    cur = torch.where(has, top, torch.full_like(top, int(INVALID_NODE)))
    return cur, new_sp, active & has


def _to_local(rot, v):
    """rot @ v per child: rot (n, W, 3, 3), v (n, 3) -> (n, W, 3), each
    row an explicit 3-term sum in index order (the JAX engine's einsum)."""
    v = v[:, None, None, :]
    return rot[..., 0] * v[..., 0] + rot[..., 1] * v[..., 1] \
        + rot[..., 2] * v[..., 2]


def traverse(bvh: BVH, prim_test: Callable, org, dir, tnear, tfar,
             occlusion: bool = False, max_leaf_size: int = 1,
             robust: bool = False, leaf_obb=None) -> TraversalResult:
    """Closest (or, with ``occlusion``, any) primitive hit along each ray.

    prim_test(ray_idx, prim, org, dir, tnear, tfar) -> (hit, t): tests prim
    ``prim[i]`` against ray ``ray_idx[i]`` (an index into this batch) whose
    org/dir/tnear/tfar are given, all 1-D over the rays of the call.
    max_leaf_size: prims per leaf at most (the leaf loop ends earlier when no
    ray's leaf has another slot). leaf_obb: optional (rot, lo, up)
    strand-aligned leaf bounds indexed by leaf start slot (accel/obb.py);
    leaf children then also slab-test in their local frame at push time."""
    dev = org.device
    R = org.shape[0]
    W = bvh.width
    n_prims = bvh.n_prims
    rdir = rcp_safe(dir)
    inv = int(INVALID_NODE)
    cur = torch.zeros(R, dtype=torch.int32, device=dev)
    # column STACK_DEPTH takes the pushes that fall off (never read)
    stack = torch.zeros((R, STACK_DEPTH + 1), dtype=torch.int32, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    t_far = tfar.clone()
    best = torch.full((R,), -1, dtype=torch.int32, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    push_k = torch.arange(W - 1, 0, -1, device=dev)      # push order
    act = torch.arange(R, device=dev)
    steps = 0
    while act.numel() > 0 and steps < MAX_STEPS:
        steps += 1
        c = cur[act]
        is_node = c >= 0
        is_leaf = (c < 0) & (c != inv)
        pop = is_leaf.clone()

        # ---- internal nodes: W-wide slab test + ordered push ----
        node_pos = is_node.nonzero().squeeze(1)
        if node_pos.numel():
            na = act[node_pos]
            node = c[node_pos].long()
            child = bvh.node_child[node]                  # (n, W)
            hit, t_entry = slab_test(bvh.node_lower[node],
                                     bvh.node_upper[node], org[na], rdir[na],
                                     tnear[na], t_far[na], robust)
            hit = hit & (child != inv)
            if leaf_obb is not None:
                # hair tier: leaf children re-test in their strand frame;
                # other slots read the pass-through box of slot 0
                obb_rot, obb_lo, obb_up = leaf_obb
                child_leaf = (child < 0) & (child != inv)
                start_c = torch.where(
                    child_leaf, (-(child + 1)) >> LEAF_COUNT_BITS,
                    torch.zeros_like(child)).long()
                cr = obb_rot[start_c]                     # (n, W, 3, 3)
                org_l = _to_local(cr, org[na])
                rdir_l = rcp_safe(_to_local(cr, dir[na]))
                o0 = (obb_lo[start_c] - org_l) * rdir_l
                o1 = (obb_up[start_c] - org_l) * rdir_l
                omin = torch.minimum(o0, o1)
                omax = torch.maximum(o0, o1)
                if robust:
                    omin = omin * ROUND_DOWN
                    omax = omax * ROUND_UP
                oin = torch.maximum(omin.amax(-1), tnear[na, None])
                oout = torch.minimum(omax.amin(-1), t_far[na, None])
                hit = hit & (~child_leaf | (oin <= oout))
            dist = torch.where(hit, t_entry, torch.full_like(t_entry,
                                                             float("inf")))
            # children by entry distance, misses to the back; stable, as
            # jnp.argsort: equal distances (misses, or rays starting inside
            # several boxes) keep their slot order
            order = torch.argsort(dist, dim=-1, stable=True)
            child_s = child.gather(1, order)
            hit_s = hit.gather(1, order)
            num_hits = hit.sum(-1)
            # push the far hit children W-1 .. 1; a push that finds the
            # stack full is dropped and counted
            want = hit_s[:, push_k]                       # (n, W-1)
            before = torch.cumsum(want.long(), 1) - want.long()
            pos = sp[na, None] + before
            ok = want & (pos < STACK_DEPTH)
            dropped += (want & ~ok).sum()
            stack[na[:, None], torch.where(ok, pos, STACK_DEPTH)] = \
                child_s[:, push_k]
            sp[na] = sp[na] + ok.sum(1)
            descend = num_hits > 0
            cur[na] = torch.where(descend, child_s[:, 0], c[node_pos])
            pop[node_pos] = ~descend

        # ---- leaves: test up to max_leaf_size prims, one slot at a time --
        leaf_pos = is_leaf.nonzero().squeeze(1)
        if leaf_pos.numel():
            la = act[leaf_pos]
            packed = -(c[leaf_pos].long() + 1)
            start = packed >> LEAF_COUNT_BITS
            count = packed & LEAF_COUNT_MASK
            leaf_tfar = t_far[la]
            leaf_best = best[la]
            for k in range(max_leaf_size):
                sub = (k < count).nonzero().squeeze(1)
                if sub.numel() == 0:
                    break
                rows = la[sub]
                prim = bvh.prim_order[(start[sub] + k).clamp(0, n_prims - 1)]
                lt = leaf_tfar[sub]
                lb = leaf_best[sub]
                p_hit, p_t = prim_test(rows, prim, org[rows], dir[rows],
                                       tnear[rows], lt)
                # deterministic tie-break: on exactly equal t the LOWER prim
                # id wins (segments sharing an endpoint give bit-identical
                # cap hits)
                better = p_hit & ((p_t < lt) | (lb < 0)
                                  | ((p_t == lt) & (prim < lb)))
                leaf_tfar[sub] = torch.where(better, p_t, lt)
                leaf_best[sub] = torch.where(better, prim, lb)
            t_far[la] = leaf_tfar
            best[la] = leaf_best

        # ---- advance: leaf rays and nodes without a hit child pop ----
        pop_pos = pop.nonzero().squeeze(1)
        if pop_pos.numel():
            pa = act[pop_pos]
            cur[pa], sp[pa], active[pa] = _pop(stack[pa], sp[pa], active[pa])
        if occlusion:
            active[act] = active[act] & (best[act] < 0)
        act = act[active[act]]
    return TraversalResult(tfar=t_far, best_prim=best, steps=steps,
                           overflow=int(dropped))
