"""LBVH (Morton/radix-tree) builder: the LOW-quality tier's building block.

Port of embree_tpu/accel/lbvh.py (parity with the reference Morton builder,
kernels/builders/bvh_builder_morton.h:14) as data-parallel torch passes on
the bounds' device:

  1. centroid -> 30-bit Morton code (quantized against the centroid bounds)
  2. a stable sort of the codes (equal codes keep prim order)
  3. Karras-style radix-tree construction: every internal node's range and
     split come from branchless binary searches of 32 fixed steps
  4. bottom-up bounds by passes repeated until nothing changes (at most 63;
     one host read per pass)

Keys are int64 (the JAX package's are uint32; the values are equal, and the
32-bit count of leading zeros is taken of the low 32 bits). Ties are broken
by appending the prim index to the key, as the reference splits equal codes
mid-range. Every min and max puts -0.0 below +0.0, as XLA does.
"""
from __future__ import annotations

import torch

from ..core.math import amax, amin, morton_code
from .bvh import BVH, INVALID_NODE, encode_leaf

_KEY_BITS = 62  # 30 morton + 32 index
_CLZ_STEPS = ((16, 0xFFFF0000), (8, 0xFF000000), (4, 0xF0000000),
              (2, 0xC0000000), (1, 0x80000000))


def _clz32(x):
    """Branchless count of leading zeros of the low 32 bits of int64 x."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros_like(x)
    for shift, mask in _CLZ_STEPS:
        cond = (x & mask) == 0
        n = torch.where(cond, n + shift, n)
        x = torch.where(cond, (x << shift) & 0xFFFFFFFF, x)
    return torch.where(x == 0, torch.full_like(n, 32), n)


def single_prim_bvh(prim_lower, prim_upper):
    """The one-node tree of a single prim (lbvh.py:52-58, sah.py:52-58)."""
    dev = prim_lower.device
    return BVH(
        node_lower=torch.stack([prim_lower, prim_lower], 1),
        node_upper=torch.stack([prim_upper, prim_upper], 1),
        node_child=torch.tensor([[encode_leaf(0, 1), int(INVALID_NODE)]],
                                dtype=torch.int32, device=dev),
        prim_order=torch.zeros(1, dtype=torch.int32, device=dev))


def morton_sort(prim_lower, prim_upper):
    """Prim centroids' Morton codes against the centroid bounds, stably
    sorted: (sorted codes, order) as int64 (lbvh.py:60-68, sah.py:65-70)."""
    centers = 0.5 * (prim_lower + prim_upper)
    cb_lo = amin(centers, 0)
    cb_up = amax(centers, 0)
    extent = torch.clamp(cb_up - cb_lo, min=1e-20)
    codes = morton_code((centers - cb_lo) / extent)
    order = torch.argsort(codes, stable=True)
    return codes[order], order


def build_lbvh(prim_lower, prim_upper):
    """Build a binary (W=2) LBVH over primitive AABBs.

    Args:
      prim_lower, prim_upper: (n, 3) float32 tensors of per-primitive
        bounds, n >= 1; the tree is built on their device.
    Returns:
      BVH with W=2, n-1 internal nodes (1 if n == 1), single-prim leaves.
    """
    n = prim_lower.shape[0]
    if n == 1:
        return single_prim_bvh(prim_lower, prim_upper)
    dev = prim_lower.device
    codes, order = morton_sort(prim_lower, prim_upper)
    prim_order = order.to(torch.int32)
    idx = torch.arange(n, device=dev)

    def delta(i, j):
        """Common-prefix length of sorted keys i and j, -1 out of range."""
        valid = (j >= 0) & (j <= n - 1)
        jj = j.clamp(0, n - 1)
        ci, cj = codes[i], codes[jj]
        # equal codes: extend the prefix with the index bits
        d = torch.where(ci == cj, 32 + _clz32(i ^ jj), _clz32(ci ^ cj))
        return torch.where(valid, d, torch.full_like(d, -1))

    # per-internal-node ranges (Karras alg. 1)
    i = idx[:n - 1]
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    delta_min = delta(i, i - d)
    lmax = torch.full((n - 1,), 2, dtype=torch.int64, device=dev)
    done = torch.zeros(n - 1, dtype=torch.bool, device=dev)
    for _ in range(32):
        grow = ~done & (delta(i, i + lmax * d) > delta_min)
        lmax = torch.where(grow, lmax * 2, lmax)
        done = done | ~grow
    ln = torch.zeros(n - 1, dtype=torch.int64, device=dev)
    t = lmax // 2
    for _ in range(32):
        cond = (t >= 1) & (delta(i, i + (ln + t) * d) > delta_min)
        ln = torch.where(cond, ln + t, ln)
        t = t // 2
    j = i + ln * d

    # split positions (Karras alg. 2)
    first = torch.minimum(i, j)
    last = torch.maximum(i, j)
    delta_node = delta(i, j)
    s = torch.zeros(n - 1, dtype=torch.int64, device=dev)
    t = (ln + 1) // 2
    for _ in range(32):
        cond = (t >= 1) & (delta(i, i + (s + t) * d) > delta_node)
        s = torch.where(cond, s + t, s)
        t = torch.where(t > 1, (t + 1) // 2, torch.zeros_like(t))
    gamma = i + s * d + torch.clamp(d, max=0)

    # children: [first..gamma] and [gamma+1..last]
    left = torch.where(first == gamma, encode_leaf(gamma, 1), gamma)
    right = torch.where(last == gamma + 1, encode_leaf(gamma + 1, 1),
                        gamma + 1)
    node_child = torch.stack([left, right], 1)

    # bottom-up bounds: passes to a fixpoint (depth <= key bits)
    leaf_lo = prim_lower[order]
    leaf_up = prim_upper[order]

    def child_bounds(ref, agg_lo, agg_up):
        leaf = ref < 0
        prim_i = torch.where(leaf, -(ref + 1) >> 4, torch.zeros_like(ref))
        node_i = torch.where(leaf, torch.zeros_like(ref), ref)
        lo = torch.where(leaf[:, None], leaf_lo[prim_i], agg_lo[node_i])
        up = torch.where(leaf[:, None], leaf_up[prim_i], agg_up[node_i])
        return lo, up

    node_lo = torch.zeros((n - 1, 2, 3), dtype=torch.float32, device=dev)
    node_up = torch.zeros((n - 1, 2, 3), dtype=torch.float32, device=dev)
    for _ in range(_KEY_BITS + 1):
        agg_lo, agg_up = amin(node_lo, 1), amax(node_up, 1)
        l_lo, l_up = child_bounds(node_child[:, 0], agg_lo, agg_up)
        r_lo, r_up = child_bounds(node_child[:, 1], agg_lo, agg_up)
        new_lo = torch.stack([l_lo, r_lo], 1)
        new_up = torch.stack([l_up, r_up], 1)
        changed = bool(((new_lo != node_lo).any()
                        | (new_up != node_up).any()).item())
        node_lo, node_up = new_lo, new_up
        if not changed:
            break
    return BVH(node_lower=node_lo, node_upper=node_up,
               node_child=node_child.to(torch.int32), prim_order=prim_order)
