"""Pack a BVH8 + the merged primitive table into the records the traversal
kernel reads.

Port of embree_tpu/accel/pack.py:59-311. The record contents are the JAX
package's, bit for bit; only their arrangement differs. The TPU keeps
records along the 128 lanes of one unified tile table, because its kernel
gathers one record per lane per step. A Hopper thread instead reads its own
record with 16-byte loads, so each record is contiguous, and nodes and
leaves live in two arrays:

Node record (int32 x 32 = 128 B):
  word 0..7    : child refs (>=0: node record id; <0: leaf ref
                 = -(leaf id)-1; INVALID_REC: empty slot)
  word 8+8d+c  : dim d (x,y,z) of child c: lo as the LOW 16 bits (bf16
                 pattern, decode = bits<<16), hi as the HIGH 16 bits
                 (decode = bits & 0xFFFF0000); lo rounded toward -inf, hi
                 toward +inf (boxes only grow).

Leaf record (int32 words), in the Pallas kernel's chunk order
(traverse_pallas.py:123-127), each chunk 8 words (one per slot):
  fields A (8*nf) : word 8*k+s is field k of slot s as float32 bits; nf = 9
                  generic fields, or 16 when the scene holds native flat
                  curves (JAX accel/pack.py:63-70, scene.py:1253-1256):
                  triangle / quad half : v0(3) e1(3) e2(3)
                  sphere / disc        : center(3) radius
                  oriented disc        : center(3) radius normal(3)
                  round / flat line    : p0(3) r0 p1(3) r1 begin-flag
                  flat curve           : Bezier CP j at fields 4j..4j+3 =
                                         x, y, z, r (16 fields)
                  Fields a kind does not use are zero.
  fields B (8*nf) : the same fields at the second time step (motion scenes)
  mask (8)      : geometry mask of each slot (scenes with a non-default mask)
  kind (8)      : kind tag of each slot (scenes with another class than
                  triangles; quads are two triangle slots tagged 0)
  t0, t1 (8+8)  : each slot's time window (time-sliced motion scenes);
                  padding slots get [0, 1]
Padding slots are zero with tag 0: Möller's det == 0 there, so they never
hit (and a curve-only scene has no class 0, so its padding is never
tested). Slot identity is implicit (8*leaf+slot), mapped back to the merged
prim table through ``pid_map`` (-1 for padding).

Record 0 of ``nodes`` is the root.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bvh import INVALID_NODE, decode_leaf, is_leaf

INVALID_REC = np.int32(0x40000000)  # empty child slot in packed records
NODE_WORDS = 32
LEAF_WIDTH = 8               # primitive slots per leaf record (== node width)
N_FIELDS = 9                 # generic fields per slot
CURVE_FIELDS = 16            # per slot when native flat curves are present


@dataclasses.dataclass
class PackedScene:
    """Device-resident packed traversable for the traversal kernel."""
    nodes: torch.Tensor      # (n_nodes, 32) int32
    leaves: torch.Tensor     # (n_leaves, leaf_words) int32
    pid_map: torch.Tensor    # (n_leaves * 8,) int64: slot -> merged prim
    has_mask: bool = False   # leaf records carry per-slot geometry masks
    tri_attrs: bool = True   # pure-triangle scene: the kernel emits u/v/Ng
    has_kinds: bool = False  # leaf records carry per-slot kind tags
    kind_classes: tuple = (0,)   # the kind tags that occur
    has_motion: bool = False  # leaf records carry the B-step fields
    has_win: bool = False    # leaf records carry per-slot [t0, t1] windows
    nf: int = N_FIELDS       # fields per slot: 9, or 16 with flat curves
    curve_rate: int = 4      # ribbon segments per curve in the kernel

    @property
    def leaf_words(self) -> int:
        return leaf_words(self.has_mask, self.has_kinds, self.has_motion,
                          self.has_win, self.nf)

    def chunk_at(self, chunk: str) -> int:
        """First word of a leaf chunk: "mask", "kind" or "t0" (t1 follows
        it), in the chunk order of the module docstring."""
        at = self.nf * LEAF_WIDTH * (2 if self.has_motion else 1)
        for name, present in (("mask", self.has_mask),
                              ("kind", self.has_kinds)):
            if name == chunk:
                return at
            at += LEAF_WIDTH * int(present)
        return at


def leaf_words(has_mask: bool, has_kinds: bool, has_motion: bool = False,
               has_win: bool = False, nf: int = N_FIELDS) -> int:
    """Words of one leaf record: the fields, then the optional chunks."""
    return LEAF_WIDTH * (nf * (2 if has_motion else 1) + int(has_mask)
                         + int(has_kinds) + 2 * int(has_win))


def _dfs_positions(child, n_wide):
    """Preorder (DFS) position of every wide node — vectorized, no Python
    recursion: O(depth) numpy passes (levels -> subtree sizes bottom-up ->
    preorder offsets top-down). DFS order makes subtrees contiguous, so rays
    descending a common subtree read neighbouring records (the role of the
    reference's layoutLargeNodes, kernels/bvh/bvh.h:108)."""
    internal = (child >= 0) & (child < n_wide)
    ch = np.where(internal, child, 0)
    depth = np.full(n_wide, -1, np.int64)
    depth[0] = 0
    levels = [np.array([0])]
    while True:
        lev = levels[-1]
        kids = ch[lev][internal[lev]]
        kids = kids[depth[kids] < 0]       # guard against corrupt cycles
        if kids.size == 0:
            break
        depth[kids] = len(levels)
        levels.append(kids)
    size = np.ones(n_wide, np.int64)
    for lev in levels[::-1]:
        m = internal[lev]
        size[lev] += np.where(m, size[ch[lev]], 0).sum(axis=1)
    pos = np.zeros(n_wide, np.int64)
    nxt = int(size[0])                     # first position after the tree
    for lev in levels:
        m = internal[lev]
        sub = np.where(m, size[ch[lev]], 0)
        prefix = np.cumsum(sub, axis=1) - sub
        childpos = pos[lev][:, None] + 1 + prefix
        pos[ch[lev][m]] = childpos[m]
    unreached = depth < 0
    if unreached.any():                    # padding/detached nodes -> tail
        pos[unreached] = nxt + np.arange(int(unreached.sum()))
    return pos


def _bf16_bits_dir(x, toward_pos: bool):
    """Top-16 float bits of x rounded toward +inf (toward_pos) or -inf.

    Truncating the low 16 mantissa bits rounds toward zero; when that moves
    the value the wrong way, bump the magnitude by one bf16 ulp (int bits
    + 0x10000 — exponent carries work out in ieee bit order)."""
    b = np.asarray(x, np.float32).view(np.int32)
    frac = (b & 0xFFFF) != 0
    t = b & ~np.int32(0xFFFF)
    neg = b < 0
    bump = frac & (neg != toward_pos)
    t = np.where(bump, t + np.int32(0x10000), t)
    return (t >> 16) & 0xFFFF


def pack_arrays(node_child, node_lower, node_upper, prim_order, n_wide,
                slot_fields, slot_mask, slot_pid, has_mask, slot_kind=None,
                slot_factor=1, slot_fields_b=None, slot_t01=None):
    """Host numpy packing. Returns (nodes (n_wide, 32) int32, leaves
    (n_leaf, leaf_words) int32, pid_map (n_leaf*8,) int32).

    slot_* arrays index slots: merged prim p owns slots p*slot_factor ..
    p*slot_factor+slot_factor-1 (factor 2 when quads are present, each quad
    being two triangle slots); slot_pid < 0 marks an unused slot.
    slot_fields (S, nf) float32 (nf = 9 or 16), slot_mask (S,) uint32,
    slot_pid (S,) int32, slot_kind (S,) int32 or None (no kind chunk),
    slot_fields_b (S, nf) or None (no B-step chunk), slot_t01 (S, 2) or None
    (no window chunks).
    """
    W = 8
    leaf_prims = LEAF_WIDTH // slot_factor
    child = np.asarray(node_child[:n_wide])               # (n_wide, 8)
    lo = np.asarray(node_lower[:n_wide])                  # (n_wide, 8, 3)
    up = np.asarray(node_upper[:n_wide])

    # DFS-relayout wide nodes; internal child refs are remapped, leaf refs
    # are renumbered implicitly below from the permuted flat order
    if n_wide > 1:
        pos = _dfs_positions(child, n_wide)
        internal2 = (child >= 0) & (child < n_wide)
        child = np.where(internal2, pos[np.where(internal2, child, 0)], child)
        child2 = np.empty_like(child)
        lo2 = np.empty_like(lo)
        up2 = np.empty_like(up)
        child2[pos] = child
        lo2[pos] = lo
        up2[pos] = up
        child, lo, up = child2, lo2, up2

    # leaf records ordered by (node, slot): sibling leaves stay adjacent
    leaf_mask2 = np.asarray(is_leaf(child))                      # (n_wide, 8)
    leaf_mask = leaf_mask2.reshape(-1)
    n_leaf = int(leaf_mask.sum())
    leaf_ids_flat = np.cumsum(leaf_mask) - leaf_mask

    flat_child = child.reshape(-1)
    packed_ref = np.where(
        flat_child == int(INVALID_NODE), INVALID_REC,
        np.where(leaf_mask, -leaf_ids_flat - 1, flat_child)).astype(np.int32)

    nodes = np.zeros((n_wide, NODE_WORDS), np.int32)
    nodes[:, 0:8] = packed_ref.reshape(n_wide, W)
    for d in range(3):
        lo16 = _bf16_bits_dir(lo[..., d], toward_pos=False)   # (n_wide, 8)
        hi16 = _bf16_bits_dir(up[..., d], toward_pos=True)
        nodes[:, 8 + 8 * d:16 + 8 * d] = lo16 | (hi16 << 16)

    starts, counts = decode_leaf(child)
    starts = np.asarray(starts).reshape(-1)[leaf_mask]
    counts = np.asarray(counts).reshape(-1)[leaf_mask]
    n_prims = np.asarray(prim_order).shape[0]
    pslot = starts[:, None] + np.arange(leaf_prims)[None, :]    # (n_leaf, P)
    pvalid = np.arange(leaf_prims)[None, :] < counts[:, None]
    pslot = np.clip(pslot, 0, n_prims - 1)
    prim = np.asarray(prim_order)[pslot]                         # merged ids
    # expand prims to slots: (n_leaf, P, factor) -> (n_leaf, 8)
    slots = (prim[:, :, None] * slot_factor
             + np.arange(slot_factor)[None, None, :]).reshape(-1, LEAF_WIDTH)
    valid = np.repeat(pvalid, slot_factor, axis=1)
    slot_fields = np.asarray(slot_fields, np.float32)
    nf = slot_fields.shape[1]
    slots = np.clip(slots, 0, slot_fields.shape[0] - 1)
    pid = np.asarray(slot_pid)[slots]
    valid = valid & (pid >= 0)

    def field_words(sf):
        f = np.where(valid[..., None], np.asarray(sf, np.float32)[slots], 0.0)
        return (f.transpose(0, 2, 1).reshape(-1, nf * LEAF_WIDTH)
                .astype(np.float32).view(np.int32))

    cols = [field_words(slot_fields)]
    if slot_fields_b is not None:
        cols.append(field_words(slot_fields_b))
    if has_mask:
        cols.append(np.where(valid, np.asarray(slot_mask, np.int64)[slots],
                             0).astype(np.uint32).view(np.int32))
    if slot_kind is not None:
        cols.append(np.where(valid, np.asarray(slot_kind, np.int32)[slots],
                             0).astype(np.int32))
    if slot_t01 is not None:
        t01 = np.asarray(slot_t01, np.float32)[slots]           # (n_leaf,8,2)
        for j, pad in ((0, 0.0), (1, 1.0)):
            cols.append(np.where(valid, t01[..., j], pad)
                        .astype(np.float32).view(np.int32))
    leaves = np.concatenate(cols, axis=1)
    if n_leaf == 0:
        leaves = np.zeros((1, leaves.shape[1]), np.int32)
        valid = np.zeros((1, LEAF_WIDTH), bool)
        pid = np.zeros((1, LEAF_WIDTH), np.int32)
    pid_map = np.where(valid, pid.astype(np.int32), -1).reshape(-1)
    return (np.ascontiguousarray(nodes), np.ascontiguousarray(leaves),
            pid_map.astype(np.int32))


def from_table(table, pid_map, gn, has_mask, tri_attrs, device,
               has_kinds=False, kind_classes=(0,), has_motion=False,
               has_win=False, nf=N_FIELDS, curve_rate=4) -> PackedScene:
    """Re-lay the JAX package's unified tile table (GN+GL, rows, 128) int32
    into the port's records: record r of tile g is column r of that tile.
    Node tiles come first (their first 32 rows), then leaf tiles, whose
    rows already follow the port's chunk order."""
    table = np.asarray(table, np.int32)
    rows = table.shape[1]
    recs = table.transpose(0, 2, 1).reshape(-1, rows)
    nodes = np.ascontiguousarray(recs[:gn * 128, :NODE_WORDS])
    leaves = np.ascontiguousarray(
        recs[gn * 128:, :leaf_words(has_mask, has_kinds, has_motion,
                                    has_win, nf)])
    pid = np.asarray(pid_map, np.int64)
    return PackedScene(nodes=torch.from_numpy(nodes).to(device),
                       leaves=torch.from_numpy(leaves).to(device),
                       pid_map=torch.from_numpy(pid).to(device),
                       has_mask=bool(has_mask), tri_attrs=bool(tri_attrs),
                       has_kinds=bool(has_kinds),
                       kind_classes=tuple(int(k) for k in kind_classes),
                       has_motion=bool(has_motion), has_win=bool(has_win),
                       nf=int(nf), curve_rate=int(curve_rate))


def to_table(packed: PackedScene):
    """The JAX package's unified tile table of the port's records, the
    inverse of ``from_table``: (table (GN+GL, rows, 128) int32, pid_map
    (GL*128*8,) int32, GN, GL), padded as embree_tpu/accel/pack.py:246-311
    pads it (empty node records hold INVALID_REC child refs, empty leaf
    records zeros, empty slots -1)."""
    nodes = packed.nodes.cpu().numpy()
    leaves = packed.leaves.cpu().numpy()
    rows = packed.leaf_words
    gn = max(1, -(-nodes.shape[0] // 128))
    gl = max(1, -(-leaves.shape[0] // 128))
    node_recs = np.zeros((gn * 128, rows), np.int32)
    node_recs[:, 0:8] = INVALID_REC
    node_recs[:nodes.shape[0], :NODE_WORDS] = nodes
    leaf_recs = np.zeros((gl * 128, rows), np.int32)
    leaf_recs[:leaves.shape[0]] = leaves
    recs = np.concatenate([node_recs, leaf_recs], axis=0)
    table = np.ascontiguousarray(
        recs.reshape(gn + gl, 128, rows).transpose(0, 2, 1))
    pid_map = np.full(gl * 128 * LEAF_WIDTH, -1, np.int32)
    pid = packed.pid_map.cpu().numpy()
    pid_map[:pid.shape[0]] = pid
    return table, pid_map, gn, gl
