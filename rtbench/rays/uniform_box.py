"""Incoherent rays as Embree's verify.cpp IncoherentRaysBenchmark draws
them (``render_block``): each coordinate of the origin and of the
direction uniform in [-1, 1), independently, t in [0, inf) (``makeRay``);
here over ``org_lo``..``org_hi`` and ``dir_lo``..``dir_hi``."""
from __future__ import annotations

import torch


def count(spec: dict) -> int:
    return spec["count"]


def _uniform(n, lo, hi, g, device):
    return torch.rand((n, 3), generator=g, device=device) * (hi - lo) + lo


def make(spec: dict, g, device, pt):
    n = spec["count"]
    org = _uniform(n, spec["org_lo"], spec["org_hi"], g, device)
    d = _uniform(n, spec["dir_lo"], spec["dir_hi"], g, device)
    return pt.make_rays(org, d)
