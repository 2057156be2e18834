"""User-facing generic BVH build — the rtcBuildBVH analog.

Port of embree_tpu/builder_api.py (role parity with the builder C API,
include/embree4/rtcore_builder.h:53-113, and the bvh_builder and bvh_access
tutorials): the caller supplies primitive bounds and callbacks and receives
its own node structure. The flat BVH8 is built first with the port's
builders, on the route of the scene's commit (``_native_build_enabled``:
the native builder on the host from 50,000 prims on unless LOW; below it,
or at LOW, the binned-SAH builder or the LBVH and the BVH8 collapse as
torch ops on the device the caller names), and the finished tree is then
replayed depth-first through the callbacks (create_node /
set_node_children / set_node_bounds / create_leaf).

``walk_bvh`` gives direct node access to a committed scene's BVH.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .accel.bvh import BVH, INVALID_NODE, decode_leaf
from .accel.collapse import collapse
from .accel.lbvh import build_lbvh
from .accel.sah import build_sah
from .core.ray import resolve_device
from .native import build_bvh8_native
from .scene import BuildQuality, _native_build_enabled


def _build_internal(lo, up, quality, leaf_size, device):
    """(node_lower, node_upper, node_child, prim_order) as numpy arrays."""
    if _native_build_enabled(lo.shape[0]) and quality != BuildQuality.LOW:
        nl, nu, nc, order, _ = build_bvh8_native(lo, up, leaf_size=leaf_size)
        return nl, nu, nc, order
    device = resolve_device(device)
    tl, tu = torch.from_numpy(lo).to(device), torch.from_numpy(up).to(device)
    if quality == BuildQuality.LOW:
        bvh2 = build_lbvh(tl, tu)
    else:
        bvh2 = build_sah(tl, tu, leaf_size=leaf_size)
    bvh8, _ = collapse(bvh2, width=8)
    return tuple(getattr(bvh8, k).cpu().numpy() for k in
                 ("node_lower", "node_upper", "node_child", "prim_order"))


def build_bvh(bounds_lower, bounds_upper, *,
              create_node: Callable,
              set_node_children: Callable,
              set_node_bounds: Callable,
              create_leaf: Callable,
              prim_ids: Optional[Sequence[int]] = None,
              quality: int = BuildQuality.MEDIUM,
              leaf_size: int = 4,
              device=None):
    """Build a BVH over user primitives, materialized through callbacks.

    Args (rtcore_builder.h:26-49 roles):
      bounds_lower/upper: (n, 3) primitive AABBs (RTCBuildPrimitive bounds).
      create_node(n_children) -> node object
      set_node_children(node, children_list)
      set_node_bounds(node, lower_list, upper_list)  # per child (3,) arrays
      create_leaf(prim_ids, lower, upper) -> leaf object
      prim_ids: optional user primID array (default arange).
      quality: BuildQuality.LOW (Morton) or MEDIUM/HIGH (binned SAH).
      leaf_size: max prims per leaf (<= 15).
      device: where the SAH builder or the LBVH runs (CUDA unless the
        caller passes device='cpu'); the native builder runs on the host.
    Returns the user root object.
    """
    lo = np.ascontiguousarray(bounds_lower, np.float32)
    up = np.ascontiguousarray(bounds_upper, np.float32)
    ids = (np.arange(lo.shape[0], dtype=np.int64) if prim_ids is None
           else np.asarray(prim_ids))
    nlo, nup, child, order = _build_internal(lo, up, quality, leaf_size,
                                             device)
    starts, counts = decode_leaf(child)

    def leaf_bounds(s, c):
        sel = order[s:s + c]
        return lo[sel].min(0), up[sel].max(0)

    def replay(node_id):
        ch = child[node_id]
        kids, kl, ku = [], [], []
        for k in range(ch.shape[0]):
            if ch[k] == int(INVALID_NODE):
                continue
            if ch[k] < 0:
                s, c = int(starts[node_id, k]), int(counts[node_id, k])
                bl, bu = leaf_bounds(s, c)
                kids.append(create_leaf(ids[order[s:s + c]], bl, bu))
            else:
                kids.append(replay(int(ch[k])))
            kl.append(nlo[node_id, k].copy())
            ku.append(nup[node_id, k].copy())
        node = create_node(len(kids))
        set_node_children(node, kids)
        set_node_bounds(node, kl, ku)
        return node

    return replay(0)


def walk_bvh(bvh: BVH, visit_node: Callable, visit_leaf: Callable,
             node_id: int = 0, depth: int = 0):
    """Depth-first walk of a committed scene's BVH (the bvh_access
    tutorial's role): visit_node(node_id, depth, child_lower (W, 3),
    child_upper (W, 3)) and visit_leaf(prim_ids, depth), numpy arrays."""
    child = bvh.node_child.cpu().numpy()
    nlo = bvh.node_lower.cpu().numpy()
    nup = bvh.node_upper.cpu().numpy()
    order = bvh.prim_order.cpu().numpy()
    starts, counts = decode_leaf(child)

    def rec(nid, depth):
        visit_node(nid, depth, nlo[nid], nup[nid])
        for k in range(child.shape[1]):
            c = child[nid, k]
            if c == int(INVALID_NODE):
                continue
            if c < 0:
                s, cnt = int(starts[nid, k]), int(counts[nid, k])
                visit_leaf(order[s:s + cnt], depth + 1)
            else:
                rec(int(c), depth + 1)

    rec(node_id, depth)
