"""The ablation kernels' record tables, carried across from the port's
packed scene.

Both harnesses read node records of 32 int32 words (the port's, and the
first 32 rows of a node tile of the JAX package's unified table) and
float32 leaf records:

- v7 (perf/ablate_v7.py): the 72-word triangle leaf record, 9 fields x 8
  slots, field k of slot s at word 8k+s: the port's leaf record (and the
  first 72 rows of a JAX leaf tile) as float32 bits.
- v5 (perf/kernel_ablate.py:195-201): a 48-word record of 4 slots, which
  no packer of the JAX package writes any more: word 0 the slot count,
  words 1-4 the merged prim ids, words 8+4k+s field k (v0, e1, e2) of slot
  s, words 44-47 the slots' geometry masks (int32 bits); words 5-7 zero.
  ``pack_v5`` builds it from a BVH8 with leaves of at most 4 triangles.

Records are padded to whole 128-record tiles as the TPU harnesses' tables
are (zero records; node records with empty child refs), so that a record
id maps to the same record in both layouts, out-of-range ids included:
tile ``clip(id // 128, 0, G - 1)``, lane ``id % 128``. Everything here is numpy (``AblateTables.to`` makes
tensors), so the tests hand the same arrays to the JAX harnesses
(``AblateTables.tiles``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import scene as scene_mod
from ..accel import pack as pack_mod
from ..native import build_bvh8_native

LANE = 128
NODE_WORDS = pack_mod.NODE_WORDS
V7_LEAF_WORDS = 9 * pack_mod.LEAF_WIDTH
V5_LEAF_WORDS = 48
V5_SLOTS = 4


@dataclasses.dataclass
class AblateTables:
    """Node records (GN*128, 32) int32, leaf records (GL*128, L) float32
    (L = 72 for v7, 48 for v5), numpy arrays or tensors of one device;
    ``pid_map``: slot id (8 * leaf record + slot) -> merged prim, -1 for an
    empty slot (v7; the v5 records carry their prim ids)."""
    nodes: object
    leaves: object
    pid_map: Optional[object] = None

    @property
    def n_node_tiles(self) -> int:
        return self.nodes.shape[0] // LANE

    @property
    def n_leaf_tiles(self) -> int:
        return self.leaves.shape[0] // LANE

    @property
    def table_bytes(self) -> int:
        return 4 * (self.nodes.shape[0] * self.nodes.shape[1]
                    + self.leaves.shape[0] * self.leaves.shape[1])

    def to(self, device) -> "AblateTables":
        """The same tables as tensors on ``device`` (no copy where they
        already are)."""
        def t(x):
            return (None if x is None else
                    torch.as_tensor(x).to(device).contiguous())
        return AblateTables(t(self.nodes), t(self.leaves), t(self.pid_map))

    def tiles(self):
        """The TPU harnesses' layout: (node table (GN, 32, 128) int32, leaf
        table (GL, L, 128) float32), record r of tile g in lane r."""
        nodes, leaves = (np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                                    else x) for x in (self.nodes, self.leaves))
        return (np.ascontiguousarray(
                    nodes.reshape(-1, LANE, NODE_WORDS).transpose(0, 2, 1)),
                np.ascontiguousarray(
                    leaves.reshape(-1, LANE, leaves.shape[1])
                    .transpose(0, 2, 1)))


def _pad_tiles(recs: np.ndarray, nodes: bool = False) -> np.ndarray:
    """Records padded to whole tiles: zero records, with empty child refs
    in node records (the JAX packer's inert padding, pack.py:245)."""
    n = -(-recs.shape[0] // LANE) * LANE
    out = np.zeros((n, recs.shape[1]), recs.dtype)
    if nodes:
        out[:, :8] = pack_mod.INVALID_REC
    out[:recs.shape[0]] = recs
    return out


def v7_tables(table, gn: Optional[int] = None,
              gl: Optional[int] = None) -> AblateTables:
    """v7's tables from a triangle scene's packed records.

    ``table``: the port's ``PackedScene`` (its contiguous records), or the
    JAX package's unified tile table as numpy, (GN+GL, rows, 128) int32,
    with its node tile count ``gn`` (and leaf tile count ``gl``, default
    the rest)."""
    if isinstance(table, pack_mod.PackedScene):
        if table.nf != pack_mod.N_FIELDS or tuple(table.kind_classes) != (0,) \
                or table.has_motion:
            raise ValueError("v7 reads static triangle records")
        nodes = table.nodes.cpu().numpy()
        leaves = table.leaves.cpu().numpy()[:, :V7_LEAF_WORDS]
        pid = table.pid_map.cpu().numpy().astype(np.int64)
    else:
        table = np.asarray(table, np.int32)
        if gn is None:
            raise ValueError("a tile table needs its node tile count gn")
        gl = table.shape[0] - gn if gl is None else gl
        recs = table.transpose(0, 2, 1).reshape(-1, table.shape[1])
        nodes = recs[:gn * LANE, :NODE_WORDS]
        leaves = recs[gn * LANE:(gn + gl) * LANE, :V7_LEAF_WORDS]
        pid = None
    leaves = _pad_tiles(np.ascontiguousarray(leaves)).view(np.float32)
    if pid is not None:
        pid = np.concatenate([pid, np.full(leaves.shape[0] * 8 - pid.size, -1,
                                           np.int64)])
    return AblateTables(
        _pad_tiles(np.ascontiguousarray(nodes, np.int32), nodes=True),
        leaves, pid)


def pack_v5(scene, threads: int = 0) -> AblateTables:
    """v5's tables for a committed static triangle scene of the port.

    Builds a BVH8 with leaves of at most 4 triangles through the port's
    native builder, packs its node records with the port's packer (DFS
    order, outward-rounded bf16 bounds) and writes each leaf as a 48-word
    v5 record at the index its parent's child reference -(id)-1 names.
    ``threads``: the builder's OpenMP team (1 numbers the nodes the same
    way in every run)."""
    kind = scene.prim_kind.cpu().numpy()
    if scene.has_motion or not np.all(kind == scene_mod.KIND_TRIANGLE):
        raise ValueError("v5 reads static triangle records")
    data = scene.prim_data.cpu().numpy()
    tab = {k: getattr(scene, k).cpu().numpy()
           for k in ("tri_v0", "tri_v1", "tri_v2", "tri_v0b", "tri_v1b",
                     "tri_v2b")}
    rows = np.stack([kind.astype(np.int64), scene.prim_geom.cpu().numpy(),
                     scene.prim_local.cpu().numpy(), data,
                     scene.prim_mask.cpu().numpy()], axis=1)
    lo, up = scene_mod._bounds(kind, data, tab, np.float32(1.0))
    nl, nu, nc, order, n_wide = build_bvh8_native(lo, up, leaf_size=V5_SLOTS,
                                                  threads=threads)
    fields, _, _, spid = scene_mod._slot_encoding(rows, tab, 1)
    smask = rows[:, 4].astype(np.uint32)
    nodes, leaves8, pid_map = pack_mod.pack_arrays(
        nc, nl, nu, order, n_wide, fields, smask, spid, has_mask=True)
    n_leaf = leaves8.shape[0]
    pid = pid_map.reshape(n_leaf, 8)
    if np.any(pid[:, V5_SLOTS:] >= 0):
        raise RuntimeError("a leaf holds more than 4 triangles")
    pid = pid[:, :V5_SLOTS]
    valid = pid >= 0
    rec = np.zeros((n_leaf, V5_LEAF_WORDS), np.int32)
    rec[:, 0] = valid.sum(1)
    rec[:, 1:1 + V5_SLOTS] = pid
    f = leaves8[:, :V7_LEAF_WORDS].reshape(n_leaf, 9, 8)[:, :, :V5_SLOTS]
    rec[:, 8:44] = f.reshape(n_leaf, 9 * V5_SLOTS)
    mask_at = 9 * pack_mod.LEAF_WIDTH
    rec[:, 44:48] = leaves8[:, mask_at:mask_at + V5_SLOTS]
    return AblateTables(_pad_tiles(nodes, nodes=True),
                        _pad_tiles(rec).view(np.float32))
