"""BVH refit: bottom-up bounds refresh over an existing topology.

Port of embree_tpu/accel/refit.py (parity with the reference refitter,
kernels/bvh/bvh_refit.h:13-50: leaf bounds recomputed, internal bounds
propagated bottom-up) as passes of torch ops on the tree's device, repeated
until nothing changes (at most 96; one host read per pass). Used by
REFIT-quality re-commits. Every min and max puts -0.0 below +0.0, as XLA
does.
"""
from __future__ import annotations

import torch

from ..core.math import amax, amin, fmax, fmin
from .bvh import BVH, INVALID_NODE

_MAX_PASSES = 96


def refit_bvh(bvh: BVH, prim_lower, prim_upper) -> BVH:
    """Recompute node bounds for updated primitive bounds (same topology).

    prim_lower/upper: (T, 3) float32 tensors in merged prim order, on the
    tree's device; bvh.prim_order maps leaf slots to prims.
    """
    W = bvh.width
    child = bvh.node_child.long()                 # (N, W)
    order = bvh.prim_order.long()
    lo_sorted = prim_lower[order]
    up_sorted = prim_upper[order]
    n = order.shape[0]
    N = child.shape[0]
    dev = child.device
    inf = float("inf")

    is_leaf = (child < 0) & (child != int(INVALID_NODE))
    packed = torch.where(is_leaf, -(child + 1), torch.zeros_like(child))
    start = packed >> 4
    count = packed & 0xF

    # leaf-block bounds (they depend on the prim bounds only)
    leaf_lo = torch.full((N, W, 3), inf, device=dev)
    leaf_up = torch.full((N, W, 3), -inf, device=dev)
    for k in range(15):
        m = ((k < count) & is_leaf)[..., None]
        si = (start + k).clamp(0, n - 1)
        leaf_lo = torch.where(m, fmin(leaf_lo, lo_sorted[si]), leaf_lo)
        leaf_up = torch.where(m, fmax(leaf_up, up_sorted[si]), leaf_up)

    is_int = (child >= 0)[..., None]
    node_i = torch.where(child >= 0, child, torch.zeros_like(child))
    lo = torch.where(is_leaf[..., None], leaf_lo, inf)
    up = torch.where(is_leaf[..., None], leaf_up, -inf)
    for _ in range(_MAX_PASSES):
        new_lo = torch.where(is_int, amin(lo, 1)[node_i], leaf_lo)
        new_up = torch.where(is_int, amax(up, 1)[node_i], leaf_up)
        changed = bool(((new_lo != lo).any() | (new_up != up).any()).item())
        lo, up = new_lo, new_up
        if not changed:
            break
    return BVH(node_lower=lo, node_upper=up, node_child=bvh.node_child,
               prim_order=bvh.prim_order)
