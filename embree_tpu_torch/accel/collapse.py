"""Binary BVH -> wide (BVH8) collapse.

Port of embree_tpu/accel/collapse.py: a level-synchronous BFS in which each
wide node adopts the frontier reached by expanding its binary subtree
log2(W) levels deep (leaf refs stop the expansion). Wide ids are allocated
in row-major order of the frontier, as in the JAX package. The JAX package
sweeps every wide slot at each level under a mask; here the live frontier's
bounds are host integers (one read per level), so each level touches only
its frontier's rows, and the result is the same.
"""
from __future__ import annotations

import torch

from .bvh import BVH, INVALID_NODE

_MAX_LEVELS = 24
_INV = int(INVALID_NODE)


def collapse(bvh: BVH, width: int = 8):
    """Collapse a W=2 BVH into a width-W BVH (W is 4 or 8), on the tree's
    device. Returns (wide_bvh, n_wide): n_wide (an int) counts the live wide
    nodes; the arrays keep one row per binary node, as in the JAX package."""
    assert bvh.width == 2 and width in (4, 8)
    depth = {4: 2, 8: 3}[width]
    dev = bvh.node_child.device
    M = bvh.n_nodes
    child2 = bvh.node_child.long()      # (M, 2)
    lo2 = bvh.node_lower                # (M, 2, 3)
    up2 = bvh.node_upper

    def expand(b):
        """Expand binary nodes b up to ``depth`` levels -> (refs (n, W),
        lo (n, W, 3), up (n, W, 3)); refs >= 0 are binary internal nodes,
        < 0 leaf refs, INVALID empty."""
        refs, los, ups = child2[b], lo2[b], up2[b]
        for _ in range(depth - 1):
            w_cur = refs.shape[-1]
            is_int = refs >= 0
            safe = torch.where(is_int, refs, torch.zeros_like(refs))
            # element i -> slots 2i, 2i+1: its children if internal, else
            # [element, INVALID]
            keep_ref = torch.stack([refs, torch.full_like(refs, _INV)], -1)
            keep_lo = torch.stack([los, los], -2)
            keep_up = torch.stack([ups, ups], -2)
            refs = torch.where(is_int[..., None], child2[safe],
                               keep_ref).reshape(-1, 2 * w_cur)
            los = torch.where(is_int[..., None, None], lo2[safe],
                              keep_lo).reshape(-1, 2 * w_cur, 3)
            ups = torch.where(is_int[..., None, None], up2[safe],
                              keep_up).reshape(-1, 2 * w_cur, 3)
        return refs, los, ups

    wide_root = torch.full((M,), -1, dtype=torch.int64, device=dev)
    wide_root[0] = 0
    out_child = torch.full((M, width), _INV, dtype=torch.int64, device=dev)
    out_lo = torch.zeros((M, width, 3), dtype=torch.float32, device=dev)
    out_up = torch.zeros((M, width, 3), dtype=torch.float32, device=dev)
    start, n_wide = 0, 1
    for _ in range(_MAX_LEVELS):
        if start >= n_wide:
            break
        refs, los, ups = expand(wide_root[start:n_wide])
        # new wide ids for internal elements, in row-major order
        is_int = refs >= 0
        flat = is_int.reshape(-1).to(torch.int64)
        new_wide = (n_wide + flat.cumsum(0) - flat).reshape(refs.shape)
        n_new = int(flat.sum())
        out_child[start:n_wide] = torch.where(is_int, new_wide, refs)
        out_lo[start:n_wide] = los
        out_up[start:n_wide] = ups
        # record the binary roots of the new wide nodes
        sel = is_int & (new_wide < M)
        wide_root[new_wide[sel]] = refs[sel]
        start, n_wide = n_wide, n_wide + n_new
    return BVH(node_lower=out_lo, node_upper=out_up,
               node_child=out_child.to(torch.int32),
               prim_order=bvh.prim_order), n_wide
