"""Closest hits: each call is ``pt.intersect(scene, rays, **kwargs)``.

The numbers, over one call's sample:

- ``hit_flips``: share of rays that one side hits and the other misses;
- ``prim_flips``: share of the rays both hit on which the primitive ids
  differ;
- ``id_errors``: records whose geometry or instance ids are wrong, or
  misses with a finite t or a primitive id (exact: limit 0);
- ``t_gap``: largest |t - t_ref| / t_ref over the rays both hit on the same
  primitive;
- ``uv_gap``: largest |u - u_ref| or |v - v_ref| over those rays;
- ``ng_gap``: largest |Ng - Ng_ref| / |Ng_ref| over those rays.

A value that is not finite reads as an infinite gap. The scenes attach one
geometry, so a hit's geometry id is 0 and its instance ids are invalid.
"""
from __future__ import annotations

import torch

from rtbench.compare import INVALID_ID, largest

FIELDS = ("t", "u", "v", "ng", "prim_id", "geom_id", "inst_id")
NUMBERS = ("hit_flips", "prim_flips", "id_errors", "t_gap", "uv_gap",
           "ng_gap")


def call(pt, kwargs: dict):
    return lambda cs, rays: pt.intersect(cs, rays, **kwargs)


def fields(out) -> dict:
    return {k: getattr(out, k) for k in FIELDS}


def reference(ref, prep, rays, idx, dtype) -> dict:
    return ref.closest(prep, rays.org[idx], rays.dir[idx], rays.tnear[idx],
                       rays.tfar[idx], dtype)


def as_answers(expected: dict) -> dict:
    valid = expected["valid"]
    inv = torch.full_like(expected["prim"], INVALID_ID)
    return {"t": expected["t"].float(), "u": expected["u"].float(),
            "v": expected["v"].float(), "ng": expected["ng"].float(),
            "prim_id": torch.where(valid, expected["prim"], inv),
            "geom_id": torch.where(valid, torch.zeros_like(inv), inv),
            "inst_id": torch.stack([inv, inv], -1)}


def numbers(got: dict, expected: dict) -> dict:
    valid = got["geom_id"] != INVALID_ID
    rv = expected["valid"]
    both = valid & rv
    n_both = int(both.sum())
    same = both & (got["prim_id"] == expected["prim"])
    wrong_ids = (valid & ((got["geom_id"] != 0)
                          | (got["inst_id"] != INVALID_ID).any(-1)))
    bad_miss = (~valid & (~torch.isinf(got["t"])
                          | (got["prim_id"] != INVALID_ID)
                          | (got["inst_id"] != INVALID_ID).any(-1)))
    d = lambda k: got[k][same].double()  # noqa: E731
    r = {k: expected[k][same].double() for k in ("t", "u", "v", "ng")}
    ng_ref = torch.linalg.vector_norm(r["ng"], dim=-1)
    return {
        "hit_flips": float((valid != rv).double().mean()),
        "prim_flips": (float((both & ~same).sum()) / n_both
                       if n_both else 0.0),
        "id_errors": float(int((wrong_ids | bad_miss).sum())),
        "t_gap": largest((d("t") - r["t"]).abs() / r["t"].abs()),
        "uv_gap": largest(torch.maximum((d("u") - r["u"]).abs(),
                                        (d("v") - r["v"]).abs())),
        "ng_gap": largest(torch.linalg.vector_norm(d("ng") - r["ng"],
                                                   dim=-1) / ng_ref),
    }
