"""The comparison that decides ``correct``: each call's answers on its
batch's sampled rays against the plain reference's on the same rays, by
the numbers of the mix's answer kind (``answers/<kind>.py``), each held to
the cell's limit (``limits/<cell>.json``)."""
from __future__ import annotations

import torch

INVALID_ID = 0xFFFFFFFF


def largest(x) -> float:
    """The largest value, a value that is not finite read as infinite; 0
    over nothing."""
    if x.numel() == 0:
        return 0.0
    x = torch.where(torch.isfinite(x), x, torch.full_like(x, float("inf")))
    return float(x.max())


def judge(per_call: list, limits: dict):
    """(numbers, failed): each number the worst over the calls, and how
    many calls read over a limit."""
    names = list(limits)
    worst = {k: max((c[k] for c in per_call), default=0.0) for k in names}
    failed = sum(any(not c[k] <= limits[k] for k in names)
                 for c in per_call)
    return worst, failed
