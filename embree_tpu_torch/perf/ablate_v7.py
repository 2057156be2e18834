"""Ablate the v7 traversal phase by phase, pinned at a step count: the
counterpart of perf/ablate_v7.py on an NVIDIA H100.

The harness toggles node fetch, leaf fetch, node math (slab test and
keys), leaf math (Moeller), the child sort and the stack, plus
``one_trip`` (one tile fetch round per step). Every variant runs
``max_steps`` = 24 steps, so ns per step compares across variants; an
ablated variant's hits are garbage, only its time matters, but the kernel
and its plain version still agree on them bit for bit.

- ``traverse`` runs the hand-written CUDA kernel (``csrc/ablate_v7.cu``) on
  CUDA rays and the plain PyTorch version on CPU rays; it returns t, slot
  ids (8 * leaf record + slot) and steps in the harness's (B, 16, 128)
  shapes, and each ray's node and leaf steps.
- ``traverse_plain`` is the plain version: the same per-program lockstep,
  with the fetch trips the harness counts (steps rows 1-2), which the
  kernel leaves 0.
- ``traverse_twin`` runs the kernel's per-ray code compiled for the host
  (tests only).
- ``main()`` runs the harness's 12 variants (ablate_v7.py:386-401) on the
  16,384-triangle sphere and 1,048,576 sorted rays and prints ms, steps,
  ns per program step and ns per ray step, timed with CUDA events around
  5 calls queued behind a spin kernel (median of 5 windows after a
  warm-up: ``device.time_call``).

Usage: python -m embree_tpu_torch.perf.ablate_v7 [--rays N] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..accel.traverse import _jmax, _leaf_moeller
from . import harness
from .device import LAUNCHES, time_call
from .harness import INF_BITS, AblateResult
from .scenes import HARNESS_RAYS, harness_rays, sphere_scene
from .tables import V7_LEAF_WORDS, AblateTables, v7_tables

UGRP = 16
PROG = UGRP * harness.LANE
MAX_STEPS = 24
FLAGS = ("f_node", "f_leaf", "m_node", "m_leaf", "sort", "stack", "one_trip")
DEFAULTS = dict(f_node=True, f_leaf=True, m_node=True, m_leaf=True,
                sort=True, stack=True, one_trip=False)
# ablate_v7.py:386-401
VARIANTS = (
    ("full", dict()),
    ("one_trip", dict(one_trip=True)),
    ("no node fetch", dict(f_node=False)),
    ("no leaf fetch", dict(f_leaf=False)),
    ("no fetch", dict(f_node=False, f_leaf=False)),
    ("no node math", dict(m_node=False)),
    ("no leaf math", dict(m_leaf=False)),
    ("no sort", dict(sort=False)),
    ("no stack", dict(stack=False)),
    ("fetch only", dict(m_node=False, m_leaf=False, sort=False,
                        stack=False)),
    ("compute only", dict(f_node=False, f_leaf=False)),
    ("bare", dict(f_node=False, f_leaf=False, m_node=False, m_leaf=False,
                  sort=False, stack=False)),
)


def _flags(kw) -> dict:
    bad = set(kw) - set(FLAGS)
    if bad:
        raise TypeError(f"unknown v7 flags {sorted(bad)}")
    return dict(DEFAULTS, **kw)


def flag_bits(**kw) -> int:
    """The kernel's flags word (csrc/ablate.cuh: kFNode ... kOneTrip)."""
    f = _flags(kw)
    return sum(1 << k for k, name in enumerate(FLAGS) if f[name])


def variant_name(**kw) -> str:
    """The name launches are counted under: v7_full, v7_one_trip, or
    v7_no_ and the phases switched off ("no fetch" and "compute only" are
    one kernel)."""
    f = _flags(kw)
    off = [n for n in FLAGS[:6] if not f[n]]
    name = "v7" + ("_one_trip" if f["one_trip"] else "")
    return name + ("_no_" + "_".join(off) if off else
                   "" if f["one_trip"] else "_full")


def _leaf(rec, org, dir, tnear, tf, mask, lid):
    """ablate_v7.py:181-197, :256-262 over the rays at a leaf."""
    f = rec.view(-1, 9, 8)
    valid, tt, _ = _leaf_moeller(
        tuple(f[:, k] for k in range(9)),
        (org[:, 0:1], org[:, 1:2], org[:, 2:3]),
        (dir[:, 0:1], dir[:, 1:2], dir[:, 2:3]), tnear[:, None], tf[:, None])
    slot = torch.arange(8, dtype=torch.int32, device=rec.device)
    tb = _jmax(tt, torch.zeros((), device=rec.device)).view(torch.int32)
    lmin = torch.where(valid, (tb & ~7) | slot, INF_BITS | slot).amin(1)
    ws = (lmin & 7).long()
    t_new = tb.gather(1, ws[:, None]).squeeze(1).view(torch.float32)
    found = (lmin < INF_BITS) & (t_new < tf)
    return found, t_new, lid * 8 + ws.to(torch.int32)


def _prepare(tables, org, dir, tnear, tfar, mask):
    B, rays = harness.pad_rays(org, dir, tnear, tfar, mask, PROG)
    tables = tables.to(org.device)
    harness.check_tables(tables, V7_LEAF_WORDS, org.device)
    return B, tables, rays


def traverse_plain(tables: AblateTables, org, dir, tnear, tfar, mask, *,
                   max_steps: int = MAX_STEPS, **kw) -> AblateResult:
    """The plain PyTorch version of ``traverse`` (any device)."""
    f = _flags(kw)
    B, tables, rays = _prepare(tables, org, dir, tnear, tfar, mask)
    tf, best, visits, ntrips, ltrips = harness.walk_plain(
        tables, rays, PROG, fetch_node=f["f_node"], fetch_leaf=f["f_leaf"],
        node_math="slab" if f["m_node"] else "refs",
        leaf_fn=_leaf if f["m_leaf"] else None, sort=f["sort"],
        stack_on=f["stack"], one_trip=f["one_trip"], max_steps=max_steps,
        trips="subgroup")
    it_final = torch.full((B,), max_steps, dtype=torch.int32,
                          device=org.device)
    return AblateResult(tf.view(B, UGRP, -1), best.view(B, UGRP, -1),
                        harness.steps_rows(it_final, ntrips, ltrips, UGRP),
                        visits)


def _native(tables, org, dir, tnear, tfar, mask, max_steps, kw):
    B, tables, rays = _prepare(tables, org, dir, tnear, tfar, mask)
    tf, best, visits, _, sched = harness.run_native(
        "v7", tables, rays, PROG, max_steps, flag_bits(**kw))
    zeros = torch.zeros(B, dtype=torch.int32, device=org.device)
    # the harness's step count is its pinned limit; the kernel leaves the
    # fetch trips (rows 1-2) at 0
    return AblateResult(tf.view(B, UGRP, -1), best.view(B, UGRP, -1),
                        harness.steps_rows(zeros + max_steps, zeros, zeros,
                                           UGRP), visits, sched)


def traverse_kernel(tables: AblateTables, org, dir, tnear, tfar, mask, *,
                    max_steps: int = MAX_STEPS, **kw) -> AblateResult:
    """Launch the CUDA kernel (CUDA rays only)."""
    if org.device.type != "cuda":
        raise ValueError("traverse_kernel takes CUDA tensors only")
    res = _native(tables, org, dir, tnear, tfar, mask, max_steps, kw)
    LAUNCHES[variant_name(**kw)] += 1
    return res


def traverse_twin(tables: AblateTables, org, dir, tnear, tfar, mask, *,
                  max_steps: int = MAX_STEPS, **kw) -> AblateResult:
    """The kernel's per-ray code compiled for the host (CPU rays, tests)."""
    if org.device.type != "cpu":
        raise ValueError("traverse_twin takes CPU tensors only")
    return _native(tables, org, dir, tnear, tfar, mask, max_steps, kw)


def traverse(tables: AblateTables, org, dir, tnear, tfar, mask, *,
             max_steps: int = MAX_STEPS, **kw) -> AblateResult:
    """The v7 ablation of R rays (org, dir (R, 3); tnear, tfar, mask (R,))
    against ``tables`` (``tables.v7_tables``): the kernel for CUDA rays,
    the plain version for CPU rays. Flags as the harness's make_kernel
    (all on, one_trip off)."""
    if org.device.type == "cuda":
        return traverse_kernel(tables, org, dir, tnear, tfar, mask,
                               max_steps=max_steps, **kw)
    if org.device.type == "cpu":
        return traverse_plain(tables, org, dir, tnear, tfar, mask,
                              max_steps=max_steps, **kw)
    raise ValueError(f"no v7 ablation for device {org.device}")


def run_variants(tables: AblateTables, rays, variants=VARIANTS, reps: int = 5,
                 max_steps: int = MAX_STEPS):
    """Time each variant through ``traverse`` (``device.time_call``: the
    median of ``reps`` windows after a warm-up) and print its line; returns
    the records."""
    out = []
    for name, kw in variants:
        ms, res = time_call(
            lambda: traverse(tables, *rays, max_steps=max_steps, **kw), reps,
            rays[0].is_cuda)
        rec = harness.report(name, ms, res, UGRP)
        rec.update(kernel=variant_name(**kw), flags=_flags(kw),
                   flag_bits=flag_bits(**kw), max_steps=max_steps,
                   node_visits=int(res.visits[0].sum(dtype=torch.int64)),
                   leaf_visits=int(res.visits[1].sum(dtype=torch.int64)))
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=HARNESS_RAYS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu for the plain version",
              file=sys.stderr)
        return 2
    cs = sphere_scene(device=dev)
    tables = v7_tables(cs.packed).to(dev)
    rays = harness_rays(args.rays, device=dev)
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0))
    else:
        print("CPU: the plain version, host clock")
    run_variants(tables, rays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
