"""Brute force over every primitive, with a conservative cull and the
closest-hit reduction the kinds share.

The cull keeps each (ray, primitive) pair whose half-line from the origin
passes within a primitive's bounding sphere. It runs in float32 on the
expanded form |w|^2 - (w.d)^2 (w = center - origin, d unit), two matrix
products and a few elementwise ops a pair; its rounding stays under
5e-5 in the squared distance for |center| + |origin| <= 5, so a margin of
2e-4 on it (and 1e-4 on the radius) keeps every pair the exact test can
accept. The exact tests run in the caller's dtype on the kept pairs only.
"""
from __future__ import annotations

import contextlib

import torch

PAIR_BUDGET = 1 << 28     # (prims x rays) elements of one cull block
TEST_BLOCK = 1 << 21      # pairs of one exact-test block
RADIUS_MARGIN = 1e-4
DIST2_MARGIN = 2e-4


@contextlib.contextmanager
def exact_matmul():
    """float32 products in float32, not TF32, while the block runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


def candidates(centers, radii, org, dir, tnear):
    """(ray index, prim index) of every pair the cull keeps, int64."""
    c = centers.to(torch.float32)
    lim2 = (radii.to(torch.float32) + RADIUS_MARGIN) ** 2 + DIST2_MARGIN
    lim1 = -(radii.to(torch.float32) + RADIUS_MARGIN)
    o = org.to(torch.float32)
    d = dir.to(torch.float32)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True).clamp(
        min=1e-30)
    cc = (c * c).sum(1)
    step = max(1, PAIR_BUDGET // max(1, c.shape[0]))
    rays, prims = [], []
    with exact_matmul():
        for a in range(0, o.shape[0], step):
            oc, dc = o[a:a + step], d[a:a + step]
            wd = c @ dc.T - (oc * dc).sum(1)[None]
            ww = cc[:, None] - 2 * (c @ oc.T) + (oc * oc).sum(1)[None]
            keep = ww - wd * wd <= lim2[:, None]
            keep &= (wd >= lim1[:, None]) | (tnear[a:a + step] < 0)[None]
            p, r = keep.nonzero(as_tuple=True)
            rays.append(r + a)
            prims.append(p)
            del wd, ww, keep
    return torch.cat(rays), torch.cat(prims)


def blocks(n: int):
    for a in range(0, n, TEST_BLOCK):
        yield slice(a, min(n, a + TEST_BLOCK))


def nearest(n_rays: int, ray, order, t, attrs: dict, dtype):
    """The closest accepted pair of each ray: the least t, then the least
    ``order`` (primitive, then segment). ``ray``, ``order``, ``t`` and each
    attribute are over the accepted pairs. Returns (valid, t, the winner's
    attributes)."""
    dev = t.device
    inf = torch.tensor(float("inf"), dtype=t.dtype, device=dev)
    best_t = torch.full((n_rays,), float("inf"), dtype=t.dtype, device=dev)
    best_t.scatter_reduce_(0, ray, t, "amin")
    at_best = t == best_t[ray]
    big = torch.iinfo(torch.int64).max
    best_o = torch.full((n_rays,), big, dtype=torch.int64, device=dev)
    best_o.scatter_reduce_(0, ray[at_best], order[at_best], "amin")
    win = at_best & (order == best_o[ray])
    idx = torch.full((n_rays,), -1, dtype=torch.int64, device=dev)
    idx[ray[win]] = torch.nonzero(win)[:, 0]
    valid = idx >= 0
    pick = idx.clamp(min=0)
    out = {}
    for k, x in attrs.items():
        v = x[pick] if x.numel() else torch.zeros(
            (n_rays,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
        fill = torch.zeros((), dtype=v.dtype, device=dev)
        mask = valid.reshape((-1,) + (1,) * (v.dim() - 1))
        out[k] = torch.where(mask, v, fill)
    return valid, torch.where(valid, best_t, inf.to(best_t.dtype)), out
