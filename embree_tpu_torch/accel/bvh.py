"""BVH container: a dataclass of flat tensors (no pointers, no allocator).

Port of embree_tpu/accel/bvh.py:25-98 (the analog of the reference's BVHN +
NodeRef, kernels/bvh/bvh.h:42, bvh_node_ref.h):

- ``node_lower/node_upper``: (n_nodes, W, 3) child AABBs.
- ``node_child``: (n_nodes, W) int32 child refs. ref >= 0 -> internal node;
  ref < 0 -> leaf encoding (start, count) into ``prim_order``;
  ref == INVALID_NODE -> empty slot.
- ``prim_order``: (n_prims,) int32 permutation from leaf slots to prim ids.

The leaf helpers use only operators, so they take numpy arrays and tensors.
``sah_cost`` is the tree's SAH cost, the builders' quality metric.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math import aabb_half_area, amax, amin

INVALID_NODE = np.int32(-0x7FFFFFFF)  # empty child slot sentinel
LEAF_COUNT_BITS = 4
LEAF_COUNT_MASK = (1 << LEAF_COUNT_BITS) - 1  # max 15 prims per leaf


def encode_leaf(start, count):
    """Pack a leaf reference: negative int32 carrying (start, count)."""
    return -((start << LEAF_COUNT_BITS) | count) - 1


def decode_leaf(ref):
    packed = -(ref + 1)
    return packed >> LEAF_COUNT_BITS, packed & LEAF_COUNT_MASK


def is_leaf(ref):
    return (ref < 0) & (ref != INVALID_NODE)


@dataclasses.dataclass
class BVH:
    """Width-W BVH over a primitive array. Node 0 is the root."""
    node_lower: torch.Tensor  # (n_nodes, W, 3) float32
    node_upper: torch.Tensor  # (n_nodes, W, 3) float32
    node_child: torch.Tensor  # (n_nodes, W) int32
    prim_order: torch.Tensor  # (n_prims,) int32

    @property
    def width(self):
        return self.node_child.shape[1]

    @property
    def n_nodes(self):
        return self.node_child.shape[0]

    @property
    def n_prims(self):
        return self.prim_order.shape[0]


def _row_sums(x):
    """Each row of a 2-D tensor summed from zero, element by element."""
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def tree_sum(x, window: int = 32):
    """The float32 sum of every element of x, in the order XLA's CPU backend
    sums (its tree-reduction rewrite): the leading dimension is padded with
    zeros, evenly at both ends, to a multiple of ``window`` rows, each
    window of rows is summed in row-major order, and the partial sums are
    reduced the same way until ``window`` or fewer remain, which are summed
    in order. So the result is bit-equal with the JAX package's
    ``jnp.sum``."""
    x = x.reshape(x.shape[0], -1)
    n = x.shape[0]
    if n <= window:
        return _row_sums(x.reshape(1, -1))[0]
    p = -(-n // window) * window
    lo = (p - n) // 2
    xp = torch.nn.functional.pad(x, (0, 0, lo, p - n - lo))
    return tree_sum(_row_sums(xp.reshape(p // window, -1)), window)


def scene_bounds(bvh: BVH):
    """Scene bounds: the union over the root's valid children."""
    valid = (bvh.node_child[0] != int(INVALID_NODE))[:, None]
    inf = torch.tensor(float("inf"), device=bvh.node_lower.device)
    lo = amin(torch.where(valid, bvh.node_lower[0], inf), 0)
    up = amax(torch.where(valid, bvh.node_upper[0], -inf), 0)
    return lo, up


def sah_cost(bvh: BVH, trav_cost: float = 1.0, int_cost: float = 1.0):
    """SAH cost of the tree relative to its root's area (the parity metric
    of the reference's bvh_statistics.cpp; embree_tpu/accel/bvh.py:82-98).
    A 0-d float32 tensor on the tree's device, bit-equal with the JAX
    package's on the same tree."""
    child = bvh.node_child.long()
    valid = child != int(INVALID_NODE)
    leaf = is_leaf(child)
    area = aabb_half_area(bvh.node_lower, bvh.node_upper)
    area = torch.where(valid, area, torch.zeros_like(area))
    _, counts = decode_leaf(child)
    counts = torch.where(leaf, counts, torch.zeros_like(counts))
    root_lo, root_up = scene_bounds(bvh)
    root_area = torch.clamp(aabb_half_area(root_lo, root_up), min=1e-30)
    cost_internal = trav_cost * tree_sum(
        torch.where(valid & ~leaf, area, torch.zeros_like(area)))
    cost_leaf = int_cost * tree_sum(area * counts.to(area.dtype))
    return (cost_internal + cost_leaf) / root_area
