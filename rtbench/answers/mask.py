"""Any hits: each call is ``pt.occluded(scene, rays, **kwargs)``, a bool
a ray. The number: ``hit_flips``, the share of rays on which the program's
answer differs from the reference's."""
from __future__ import annotations

NUMBERS = ("hit_flips",)


def call(pt, kwargs: dict):
    return lambda cs, rays: pt.occluded(cs, rays, **kwargs)


def fields(out) -> dict:
    return {"mask": out}


def reference(ref, prep, rays, idx, dtype) -> dict:
    return {"mask": ref.any_hit(prep, rays.org[idx], rays.dir[idx],
                                rays.tnear[idx], rays.tfar[idx], dtype)}


def as_answers(expected: dict) -> dict:
    return expected


def numbers(got: dict, expected: dict) -> dict:
    return {"hit_flips": float((got["mask"] != expected["mask"]).double()
                               .mean())}
