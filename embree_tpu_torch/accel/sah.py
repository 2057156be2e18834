"""Binned-SAH builder (the MEDIUM tier; LOW is its zero-level case).

Port of embree_tpu/accel/sah.py (parity with the reference's default
builder, kernels/builders/bvh_builder_sah.h:216, heuristic_binning.h:210 and
:339) as bulk-synchronous torch passes on the bounds' device:

  Phase 0: Morton-sort the primitives once (the partitions below are
    stable, so every segment stays sorted).
  Phase A: level-synchronous SAH splitting of a frontier of contiguous prim
    ranges ("segments"): per-level binning keyed by (segment, bin) through
    segment reductions, the SAH sweep through prefix and suffix scans over
    the bins, a stable in-segment partition through exclusive cumsums, and
    the median split where binning degenerates. One host read per level
    (its split count decides whether another level runs).
  Phase B: one segmented Karras radix pass builds every remaining subtree at
    once (segment boundaries act as -1 prefixes), subtrees of at most
    ``leaf_size`` prims becoming blocked leaves; their bounds are refit by
    passes until nothing changes (one host read per pass).

The result is a W=2 BVH in the flat-array container, equal node for node to
the JAX package's: Morton keys are int64 (the same values as its uint32),
empty segments reduce to +inf/-inf as ``jax.ops.segment_min``/``max`` do,
every min and max puts -0.0 below +0.0 as XLA does (core/math.py), and
``.at[...].set(mode="drop")`` writes to a padding row that is cut off.
"""
from __future__ import annotations

import torch

from ..core.math import (aabb_half_area, amax, amin, cummax, cummin, fmax,
                         fmin, segment_reduce)
from .bvh import BVH, INVALID_NODE, encode_leaf
from .lbvh import _clz32, morton_sort, single_prim_bvh

_KEY_BITS = 62
_INV = int(INVALID_NODE)


def _seg_min(x, seg, num):
    return segment_reduce(x, seg, num, "amin")


def _seg_max(x, seg, num):
    return segment_reduce(x, seg, num, "amax")


def _set_drop(arr, index, val):
    """``arr.at[index].set(val, mode="drop")`` for non-negative indices
    whose first component may equal ``arr.shape[0]`` (out of range): those
    writes land in a padding row that is cut off. Live indices are unique,
    so the result does not depend on the order of the writes."""
    if not isinstance(index, tuple):
        index = (index,)
    n = arr.shape[0]
    out = torch.cat([arr, arr[:1]])
    out[(index[0].clamp(max=n),) + index[1:]] = val
    return out[:n]


def build_sah(prim_lower, prim_upper, *, leaf_size: int = 4, n_bins: int = 16,
              max_top_levels: int = 16, max_segments: int = 4096,
              freeze_below: int = 16):
    """Build a binned-SAH BVH over primitive AABBs. Returns a W=2 BVH.

    Args:
      prim_lower, prim_upper: (n, 3) float32 tensors, n >= 1; the tree is
        built on their device.
      leaf_size: max prims per (blocked) leaf, <= 15.
      n_bins: SAH bins per axis.
      max_top_levels / max_segments: the phase-A budget; below it the
        segmented radix pass finishes the tree (0 levels: the LOW tier).
      freeze_below: segments of at most this many prims are left to
        phase B.
    """
    n = prim_lower.shape[0]
    assert leaf_size <= 15
    if n == 1:
        return single_prim_bvh(prim_lower, prim_upper)
    dev = prim_lower.device
    F = int(min(max_segments, max(2, n // max(freeze_below // 2, 1))))
    T = F + 1          # top node slots: 0 = pseudo-root, 1..F split nodes

    def i64(*shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int64, device=dev)

    # ---------------- phase 0: Morton sort ----------------
    codes, order = morton_sort(prim_lower, prim_upper)
    seg_count = i64(F)
    seg_count[0] = n
    seg_parent = i64(F, fill=-1)
    seg_parent[0] = 0
    seg_alive = torch.zeros(F, dtype=torch.bool, device=dev)
    seg_alive[0] = True
    s = dict(
        seg_of_prim=i64(n), seg_start=i64(F), seg_count=seg_count,
        seg_parent=seg_parent, seg_side=i64(F), seg_alive=seg_alive,
        seg_alloc=i64(fill=1), node_alloc=i64(fill=1),
        node_child=i64(T, 2, fill=_INV),
        node_lower=torch.zeros((T, 2, 3), dtype=torch.float32, device=dev),
        node_upper=torch.zeros((T, 2, 3), dtype=torch.float32, device=dev),
        lo=prim_lower[order], up=prim_upper[order], codes=codes,
        prim_order=order)

    # ---------------- phase A: SAH levels ----------------
    for _ in range(max_top_levels):
        s = _sah_level(s, n=n, F=F, B=n_bins, freeze_below=freeze_below)
        if int(s["last_splits"]) == 0:
            break

    # ---------------- phase B: segmented Karras ----------------
    kchild, kreal, kroot_of_seg, leafref_of_seg = _segmented_karras(
        s["codes"], s["seg_of_prim"], s["seg_start"], s["seg_count"],
        s["seg_alive"], T, leaf_size)

    # patch every live segment's subtree ref and bounds into its parent slot
    lo, up = s["lo"], s["up"]
    seg_lo = _seg_min(lo, s["seg_of_prim"], F)
    seg_up = _seg_max(up, s["seg_of_prim"], F)
    parent = torch.where(s["seg_alive"], s["seg_parent"], T)
    side = s["seg_side"]
    ref = torch.where(leafref_of_seg != _INV, leafref_of_seg, kroot_of_seg)
    node_child = _set_drop(s["node_child"], (parent, side), ref)
    node_lower = _set_drop(s["node_lower"], (parent, side), seg_lo)
    node_upper = _set_drop(s["node_upper"], (parent, side), seg_up)

    all_child = torch.cat([node_child, kchild])
    all_lower, all_upper = _refit_karras(node_lower, node_upper, kchild, lo,
                                         up, T, leaf_size)
    return BVH(node_lower=all_lower, node_upper=all_upper,
               node_child=all_child.to(torch.int32),
               prim_order=s["prim_order"].to(torch.int32))


# =============================================================================
# phase A: one SAH level
# =============================================================================

def _sah_level(s, *, n, F, B, freeze_below):
    dev = s["lo"].device
    lo, up = s["lo"], s["up"]
    seg = s["seg_of_prim"]
    seg_start, seg_count = s["seg_start"], s["seg_count"]
    centers = 0.5 * (lo + up)
    arange_n = torch.arange(n, device=dev)

    # segment centroid bounds for binning
    c_lo = _seg_min(centers, seg, F)
    c_up = _seg_max(centers, seg, F)
    extent = torch.clamp(c_up - c_lo, min=1e-20)
    # per-prim bin per axis (heuristic_binning.h BinMapping); a tensor
    # divisor, so CUDA divides exactly instead of by a reciprocal
    relc = (centers - c_lo[seg]) / extent[seg]
    bins = (relc * B).to(torch.int64).clamp(0, B - 1)          # (n, 3)

    active = s["seg_alive"] & (seg_count > freeze_below) & (s["seg_alloc"] < F)

    best_axis = torch.zeros(F, dtype=torch.int64, device=dev)
    best_k = torch.zeros(F, dtype=torch.int64, device=dev)
    best_cost = torch.full((F,), float("inf"), device=dev)
    best_valid = torch.zeros(F, dtype=torch.bool, device=dev)
    nleft_of = torch.zeros(F, dtype=torch.int64, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for axis in range(3):
        key = seg * B + bins[:, axis]
        cnt = torch.bincount(key, minlength=F * B).reshape(F, B)
        blo = _seg_min(lo, key, F * B).reshape(F, B, 3)
        bup = _seg_max(up, key, F * B).reshape(F, B, 3)
        # sweep: left prefix / right suffix (heuristic_binning.h:339)
        cnt_l = cnt.cumsum(1)
        lo_l = cummin(blo, 1)
        up_l = cummax(bup, 1)
        cnt_r = cnt.flip(1).cumsum(1).flip(1)
        lo_r = cummin(blo.flip(1), 1).flip(1)
        up_r = cummax(bup.flip(1), 1).flip(1)
        # split after bin k: left = bins [0..k], right = [k+1..B-1]
        a_l = aabb_half_area(lo_l[:, :-1], up_l[:, :-1])
        a_r = aabb_half_area(lo_r[:, 1:], up_r[:, 1:])
        n_l = cnt_l[:, :-1]
        n_r = cnt_r[:, 1:]
        cost = torch.where((n_l > 0) & (n_r > 0),
                           a_l * n_l.to(torch.float32)
                           + a_r * n_r.to(torch.float32), inf)  # (F, B-1)
        k = cost.argmin(1)                  # first minimum, as jnp.argmin
        ck = cost.gather(1, k[:, None])[:, 0]
        improve = ck < best_cost
        best_cost = torch.where(improve, ck, best_cost)
        best_axis = torch.where(improve, axis, best_axis)
        best_k = torch.where(improve, k, best_k)
        best_valid = best_valid | (improve & torch.isfinite(ck))
        nleft_of = torch.where(improve, n_l.gather(1, k[:, None])[:, 0],
                               nleft_of)

    # the median split where binning degenerates (the builder's fallback)
    use_median = active & ~best_valid
    do_split = active.to(torch.int64)

    # node slots and new (right) segment ids; past capacity a segment
    # freezes and phase B finishes it
    split_idx = do_split.cumsum(0) - do_split
    new_node = s["node_alloc"] + split_idx
    new_seg = s["seg_alloc"] + split_idx
    can = active & (new_seg < F) & (new_node < s["node_child"].shape[0])
    n_splits = can.sum()

    # per-prim left/right decision
    prim_active = can[seg]
    axis_p = best_axis[seg]
    bin_on_axis = bins.gather(1, axis_p[:, None])[:, 0]
    go_left_sah = bin_on_axis <= best_k[seg]
    pos_in_seg = arange_n - seg_start[seg]
    go_left_median = pos_in_seg < (seg_count[seg] // 2)
    go_left = torch.where(use_median[seg], go_left_median, go_left_sah)
    nleft = torch.where(use_median, seg_count // 2, nleft_of)

    # stable in-segment partition via segmented exclusive cumsums
    flags = go_left.to(torch.int64)
    cum_all = flags.cumsum(0)
    seg_base = cum_all[seg_start] - flags[seg_start]
    excl_left = (cum_all - flags) - seg_base[seg]
    flags_r = 1 - flags
    cum_all_r = flags_r.cumsum(0)
    seg_base_r = cum_all_r[seg_start] - flags_r[seg_start]
    excl_right = (cum_all_r - flags_r) - seg_base_r[seg]
    new_pos = seg_start[seg] + torch.where(go_left, excl_left,
                                           nleft[seg] + excl_right)
    new_pos = torch.where(prim_active, new_pos, arange_n)

    def permute(arr):          # new_pos is a permutation
        out = torch.empty_like(arr)
        out[new_pos] = arr
        return out

    # parent slots: the parent's child (side) <- the new node; its bounds
    # <- the segment's (pre-split) bounds, exact from here on
    slo = _seg_min(lo, seg, F)
    sup = _seg_max(up, seg, F)
    Tn = s["node_child"].shape[0]
    parent = torch.where(can, s["seg_parent"], Tn)
    side = s["seg_side"]

    # segment records: the left half keeps its id, the right takes new_seg
    tgt = torch.where(can, new_seg, F)
    left_i = torch.where(can, torch.arange(F, device=dev), F)
    seg_count_new = _set_drop(s["seg_count"], tgt, seg_count - nleft)
    seg_parent_new = _set_drop(s["seg_parent"], tgt, new_node)
    seg_side_new = _set_drop(s["seg_side"], tgt, torch.ones_like(tgt))
    # prims moving right take the new segment id
    seg_of_prim = torch.where(prim_active & ~go_left, new_seg[seg], seg)
    return dict(
        seg_of_prim=permute(seg_of_prim),
        seg_start=_set_drop(s["seg_start"], tgt, seg_start + nleft),
        seg_count=_set_drop(seg_count_new, left_i, nleft),
        seg_parent=_set_drop(seg_parent_new, left_i, new_node),
        seg_side=_set_drop(seg_side_new, left_i, torch.zeros_like(tgt)),
        seg_alive=_set_drop(s["seg_alive"], tgt, torch.ones_like(can)),
        seg_alloc=s["seg_alloc"] + n_splits,
        node_alloc=s["node_alloc"] + n_splits,
        node_child=_set_drop(s["node_child"], (parent, side), new_node),
        node_lower=_set_drop(s["node_lower"], (parent, side), slo),
        node_upper=_set_drop(s["node_upper"], (parent, side), sup),
        lo=permute(lo), up=permute(up), codes=permute(s["codes"]),
        prim_order=permute(s["prim_order"]), last_splits=n_splits)


# =============================================================================
# phase B: segmented Karras radix pass + blocked-leaf collapse
# =============================================================================

def _segmented_karras(codes, seg_of_prim, seg_start, seg_count, seg_alive,
                      base, leaf_size):
    """Build all bottom subtrees at once. Returns:
      kchild: (n-1, 2) child refs (global node ids / leaf refs / INVALID)
      kreal: (n-1,) whether the Karras node exists
      kroot_of_seg: (F,) global id of each segment's subtree root (or
        INVALID)
      leafref_of_seg: (F,) the leaf ref of a segment that fits one leaf
        (else INVALID)
    """
    n = codes.shape[0]
    dev = codes.device

    def delta(i, j):
        ok = (j >= 0) & (j <= n - 1)
        jj = j.clamp(0, n - 1)
        ci, cj = codes[i], codes[jj]
        d = torch.where(ci == cj, 32 + _clz32(i ^ jj), _clz32(ci ^ cj))
        d = torch.where(seg_of_prim[i] == seg_of_prim[jj], d,
                        torch.full_like(d, -1))
        return torch.where(ok, d, torch.full_like(d, -1))

    i = torch.arange(n - 1, device=dev)
    kvalid = seg_of_prim[i] == seg_of_prim[torch.clamp(i + 1, max=n - 1)]
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, torch.ones_like(d), d)
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
        take = (t >= 1) & (delta(i, i + (ln + t) * d) > delta_min)
        ln = torch.where(take, ln + t, ln)
        t = t // 2
    j = i + ln * d
    first = torch.minimum(i, j)
    last = torch.maximum(i, j)
    delta_node = delta(i, j)
    ss = torch.zeros(n - 1, dtype=torch.int64, device=dev)
    t = (ln + 1) // 2
    for _ in range(32):
        take = (t >= 1) & (delta(i, i + (ss + t) * d) > delta_node)
        ss = torch.where(take, ss + t, ss)
        t = torch.where(t > 1, (t + 1) // 2, torch.zeros_like(t))
    gamma = i + ss * d + torch.clamp(d, max=0)

    # child refs with blocked-leaf collapse: a child covering <= leaf_size
    # prims becomes a leaf ref over its contiguous range
    lsize = gamma - first + 1
    rsize = last - gamma
    left = torch.where(lsize <= leaf_size, encode_leaf(first, lsize),
                       base + gamma)
    right = torch.where(rsize <= leaf_size, encode_leaf(gamma + 1, rsize),
                        base + gamma + 1)
    # a Karras node is real only if its own range holds > leaf_size prims
    kreal = kvalid & (last - first + 1 > leaf_size)
    kchild = torch.where(kreal[:, None], torch.stack([left, right], 1),
                         torch.full_like(left[:, None], _INV))

    root_id = base + seg_start.clamp(0, n - 2)
    kroot_of_seg = torch.where(seg_alive & (seg_count > leaf_size), root_id,
                               torch.full_like(root_id, _INV))
    leafref_of_seg = torch.where(
        seg_alive & (seg_count <= leaf_size) & (seg_count > 0),
        encode_leaf(seg_start, seg_count), torch.full_like(root_id, _INV))
    return kchild, kreal, kroot_of_seg, leafref_of_seg


def _refit_karras(top_lower, top_upper, kchild, lo, up, T, leaf_size):
    """Bottom-up bounds for the Karras portion; the top bounds are already
    exact. Passes repeat until nothing changes, at most 64."""
    n = lo.shape[0]
    nk = kchild.shape[0]
    inf = float("inf")

    def leaf_block_bounds(start, count):
        blo = torch.full((start.shape[0], 3), inf, device=lo.device)
        bup = torch.full((start.shape[0], 3), -inf, device=lo.device)
        for k in range(leaf_size):
            m = (k < count)[:, None]
            si = (start + k).clamp(0, n - 1)
            blo = torch.where(m, fmin(blo, lo[si]), blo)
            bup = torch.where(m, fmax(bup, up[si]), bup)
        return blo, bup

    def child_bounds(ref, agg_lo, agg_up):
        leaf = (ref < 0) & (ref != _INV)
        packed = torch.where(leaf, -(ref + 1), torch.zeros_like(ref))
        l_lo, l_up = leaf_block_bounds(packed >> 4, packed & 0xF)
        node_i = torch.where(ref >= 0, ref - T,
                             torch.zeros_like(ref)).clamp(0, nk - 1)
        blo = torch.where(leaf[:, None], l_lo, agg_lo[node_i])
        bup = torch.where(leaf[:, None], l_up, agg_up[node_i])
        empty = (ref == _INV)[:, None]
        return (torch.where(empty, inf, blo), torch.where(empty, -inf, bup))

    klo = torch.zeros((nk, 2, 3), dtype=torch.float32, device=lo.device)
    kup = torch.zeros((nk, 2, 3), dtype=torch.float32, device=lo.device)
    for _ in range(_KEY_BITS + 2):
        agg_lo = amin(klo, 1)
        agg_up = amax(kup, 1)
        l_lo, l_up = child_bounds(kchild[:, 0], agg_lo, agg_up)
        r_lo, r_up = child_bounds(kchild[:, 1], agg_lo, agg_up)
        new_lo = torch.stack([l_lo, r_lo], 1)
        new_up = torch.stack([l_up, r_up], 1)
        changed = bool(((new_lo != klo).any() | (new_up != kup).any()).item())
        klo, kup = new_lo, new_up
        if not changed:
            break
    return torch.cat([top_lower, klo]), torch.cat([top_upper, kup])
