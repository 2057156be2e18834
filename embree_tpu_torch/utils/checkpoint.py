"""Committed-scene checkpoints: the JAX package's archive, without JAX.

Port of embree_tpu/utils/checkpoint.py. An archive is an ``.npz`` of the
scene's pytree leaves as the JAX package writes them: ``leaf_0`` ..
``leaf_{n-1}`` in the order of its CommittedScene fields (query.py's
ARRAY_FIELDS), the BVH as its four arrays, the packed table as its two
(the unified tile table and the slot map; none when the scene has no
packed table), with the JAX package's dtypes, and a ``__meta__`` JSON
string (format version, static fields, the packed table's static fields).
An archive saved by either package loads in the other. Scenes with
filters or user geometry cannot be saved (their callbacks are not data);
re-attach them after a load.
"""
from __future__ import annotations

import json

import numpy as np

from ..accel import pack as pack_mod
from ..query import ARRAY_FIELDS
from ..scene import CommittedScene, from_arrays

# must equal embree_tpu/utils/checkpoint.py's FORMAT_VERSION
FORMAT_VERSION = 8

_BVH = ("node_lower", "node_upper", "node_child", "prim_order")
# the JAX package's dtypes of the fields that are not float32
_DTYPES = {"bvh.node_child": np.int32, "bvh.prim_order": np.int32,
           "prim_kind": np.int32, "prim_geom": np.uint32,
           "prim_local": np.uint32, "prim_inst": np.uint32,
           "prim_data": np.int32, "prim_mask": np.uint32,
           "prim_filter": np.int32, "curve_prate": np.int32,
           "packed.table": np.int32, "packed.pid_map": np.int32}
# CommittedScene's static fields, in the JAX package's order
_STATICS = ("kinds_present", "has_motion", "has_windows", "filters",
            "user_fns", "robust", "min_width_factor", "max_radius_scale",
            "curve_rate", "curve_rates_present", "compact")


def _leaves(scene: CommittedScene, table):
    """(name, numpy array) of every archive leaf, in order; ``table`` is
    ``pack_mod.to_table`` of the scene's packed records (None without)."""
    out = []
    for f in ARRAY_FIELDS:
        v = getattr(scene, f)
        if f == "bvh":
            out += [("bvh." + k, getattr(v, k).cpu().numpy()) for k in _BVH]
        elif f == "packed":
            if v is not None:
                out += [("packed.table", table[0]),
                        ("packed.pid_map", table[1])]
        else:
            out.append((f, v.cpu().numpy()))
    return [(k, a.astype(_DTYPES.get(k, np.float32))) for k, a in out]


def save_scene(path: str, scene: CommittedScene):
    """Write a CommittedScene to an .npz archive the JAX package reads."""
    if scene.filters or scene.user_fns:
        raise ValueError(
            "scenes with filter/user callbacks cannot be serialized; "
            "re-commit without callbacks or re-attach them after load")
    pk = scene.packed
    table = None if pk is None else pack_mod.to_table(pk)
    leaves = _leaves(scene, table)
    statics = {}
    for f in _STATICS:
        v = getattr(scene, f)
        statics[f] = [int(x) for x in v] if isinstance(v, tuple) else v
    statics["filters"], statics["user_fns"] = [], []
    packed_aux = None
    if pk is not None:
        packed_aux = [table[2], table[3], pk.has_mask, pk.has_motion,
                      pk.has_kinds, [int(k) for k in pk.kind_classes],
                      pk.tri_attrs, pk.has_win, pk.nf, pk.curve_rate]
    meta = dict(version=FORMAT_VERSION, statics=statics,
                n_leaves=len(leaves), has_packed=pk is not None,
                packed_aux=packed_aux)
    np.savez_compressed(path, __meta__=json.dumps(meta),
                        **{f"leaf_{i}": a for i, (_, a) in enumerate(leaves)})


def load_scene(path: str, device=None) -> CommittedScene:
    """Read an archive of either package into a CommittedScene on
    ``device`` (CUDA unless the caller passes device='cpu')."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        ver = meta.get("version", 0)
        if ver != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path!r} has format version {ver}, this build "
                f"reads version {FORMAT_VERSION}; re-commit the scene and "
                "save again (archives are not migrated across layout "
                "changes)")
        names = []
        for f in ARRAY_FIELDS:
            if f == "bvh":
                names += ["bvh." + k for k in _BVH]
            elif f == "packed":
                if meta["has_packed"]:
                    names += ["packed.table", "packed.pid_map"]
            else:
                names.append(f)
        if len(names) != meta["n_leaves"]:
            raise ValueError(f"checkpoint {path!r} has {meta['n_leaves']} "
                             f"leaves, its layout {len(names)}")
        arrays = {k: data[f"leaf_{i}"] for i, k in enumerate(names)}
    st = meta["statics"]
    flags = {k: st[k] for k in _STATICS if k not in ("filters", "user_fns")}
    flags["filters"] = len(st["filters"])
    flags["user_fns"] = len(st["user_fns"])
    if meta["has_packed"]:
        (flags["gn"], _, flags["has_mask"], _, flags["has_kinds"],
         flags["kind_classes"], flags["tri_attrs"], _, flags["nf"],
         _) = meta["packed_aux"]
    return from_arrays(arrays, flags, device)
