"""The ray-reorder (sort) tax and candidate replacements, on the card.

Port of perf/sort_tax.py. The triangle wrapper (``accel/traverse.py::
traverse_packed``) sorts the rays by their coherence key, gathers every
field in that order, and scatters the results back (the unsort). This
times the alternatives at 1,048,576 rows of a random 30-bit key and ten
float32 operands:

  a) the wrapper's own route: a sort of (key, index), then a gather per
     operand (PyTorch has no multi-operand sort, so this stands for the
     JAX script's 12-operand ``lax.sort``; it returns the sorted key, the
     ten operands and the index, as that sort does)
  b) 2-op sort (key, index) + one gather per operand
  c) 2-op sort + ONE row gather of the stacked (R, 10) matrix
  d) argsort + row gather
  e) 16-bucket cumsum-rank permutation + row gather
  f) as a), with the key cut to its top 8 bits (does key width matter?)
  g) 2-op sort + row scatter (the unsort's direction)

Every sort is stable, so b-d and g follow the stable full-key order, e the
ranks within 16 buckets and f the stable 8-bit order: each variant gives
the rows of its JAX namesake. Times are the median of 5 windows of 5
calls between CUDA events (``perf/device.py::time_call``); on the CPU the
host clock (not a device figure).

Usage: python -m embree_tpu_torch.perf.sort_tax [--rays N] [--cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

N_OPS = 10
LABELS = {"a": "a) wrapper route (sort+11 gathers)",
          "b": "b) 2-op sort + 10 takes:",
          "c": "c) 2-op sort + row-gather:",
          "d": "d) argsort + row-gather:",
          "e": "e) 16-bucket rank + gath:",
          "f": "f) as a), 8b key:",
          "g": "g) 2-op sort + row-scat:"}


def inputs(n: int, device, seed: int = 0):
    """(key (n,) int32 in [0, 2^30), ten (n,) float32 operands), drawn as
    the JAX script draws them."""
    rng = np.random.default_rng(seed)
    key = torch.from_numpy(rng.integers(0, 1 << 30, n, dtype=np.int32))
    ops = [torch.from_numpy(rng.normal(size=n).astype(np.float32))
           for _ in range(N_OPS)]
    return key.to(device), [o.to(device) for o in ops]


def _sorted(key):
    return torch.sort(key, stable=True)


def full_sort(key, ops):
    k2, perm = _sorted(key)
    return [k2] + [o[perm] for o in ops] + [perm.to(torch.int32)]


def sort2_take(key, ops):
    perm = _sorted(key).indices
    return [o[perm] for o in ops]


def sort2_rowgather(key, ops):
    perm = _sorted(key).indices
    return torch.stack(ops, dim=-1)[perm]


def argsort_rowgather(key, ops):
    perm = torch.argsort(key, stable=True)
    return torch.stack(ops, dim=-1)[perm]


def bucket_perm(key, ops):
    n = key.shape[0]
    b = key >> 26                                           # 16 buckets
    onehot = (b[:, None] == torch.arange(16, device=key.device)[None, :]) \
        .to(torch.int32)
    within = torch.cumsum(onehot, 0, dtype=torch.int32) - onehot
    counts = onehot.sum(0, dtype=torch.int32)
    start = torch.cat([torch.zeros(1, dtype=torch.int32, device=key.device),
                       torch.cumsum(counts, 0, dtype=torch.int32)[:-1]])
    pos = (onehot * (start[None, :] + within)).sum(1)
    # the inverse permutation by a scatter, then a row gather
    idx0 = torch.arange(n, dtype=torch.int32, device=key.device)
    inv = torch.zeros(n, dtype=torch.int32, device=key.device)
    inv[pos.long()] = idx0
    return torch.stack(ops, dim=-1)[inv.long()]


def full_sort8(key, ops):
    return full_sort(key >> 22, ops)


def sort2_scatter(key, ops):
    perm = _sorted(key).indices
    m = torch.stack(ops, dim=-1)
    out = torch.zeros_like(m)
    out[perm] = m
    return out


VARIANTS = {"a": full_sort, "b": sort2_take, "c": sort2_rowgather,
            "d": argsort_rowgather, "e": bucket_perm, "f": full_sort8,
            "g": sort2_scatter}


def main(argv=None):
    """Returns {variant: (ms, rows)}, rows on the host."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from .device import time_call
    device = "cpu" if args.cpu else "cuda"
    key, ops = inputs(args.rays, device)
    out = {}
    for name, fn in VARIANTS.items():
        ms, rows = time_call(lambda: fn(key, ops), cuda=device == "cuda")
        rows = ([r.cpu() for r in rows] if isinstance(rows, list)
                else rows.cpu())
        out[name] = (ms, rows)
        print(f"{LABELS[name]:34s}{ms:8.3f} ms", flush=True)
    return out


if __name__ == "__main__":
    main()
