"""Ablate the v5 traversal: which phase costs what. The counterpart of
perf/kernel_ablate.py on an NVIDIA H100.

The harness toggles fetch (node and leaf records), the child sort, the
stack, the leaf test (Moeller over 4 slots with per-slot masks) and the
node test, over programs of UGRP x 128 rays (UGRP 16, 8 or 4). A program
runs in lockstep until none of its rays is active, or for ``max_steps``
steps. Its leaf records are 4-slot v5 records, which the port writes
itself (``tables.pack_v5``).

- ``traverse`` runs the hand-written CUDA kernel (``csrc/ablate_v5.cu``) on
  CUDA rays and the plain PyTorch version on CPU rays; it returns t, prim
  ids and steps in the harness's (B, UGRP, 128) shapes, and each ray's node
  and leaf steps.
- ``traverse_plain`` is the plain version, with the fetch trips (steps
  rows 1-2) the kernel leaves 0; ``traverse_twin`` the kernel's per-ray
  code compiled for the host (tests only).
- ``main()`` runs the harness's 9 variants (kernel_ablate.py:374-385) on
  the 16,384-triangle sphere and 1,048,576 sorted rays and prints ms,
  steps, ns per program step and ns per ray step (CUDA events around 5
  calls queued behind a spin kernel, median of 5 windows after a warm-up:
  ``device.time_call``).

Usage: python -m embree_tpu_torch.perf.kernel_ablate [--rays N]
       [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from ..accel.traverse import _leaf_moeller
from . import harness
from .device import LAUNCHES, time_call
from .harness import MAX_STEPS, AblateResult
from .scenes import HARNESS_RAYS, harness_rays, sphere_scene
from .tables import V5_LEAF_WORDS, V5_SLOTS, AblateTables, pack_v5

FLAGS = ("do_fetch", "do_sort", "do_stack", "do_leaf", "do_node")
DEFAULTS = dict(do_fetch=True, do_sort=True, do_stack=True, do_leaf=True,
                do_node=True)
# kernel_ablate.py:374-385
VARIANTS = (
    ("full U16", dict(UGRP=16)),
    ("full U8", dict(UGRP=8)),
    ("full U4", dict(UGRP=4)),
    ("nofetch U16", dict(UGRP=16, do_fetch=False, max_steps=40)),
    ("nonode U16", dict(UGRP=16, do_node=False, max_steps=40)),
    ("noleaf U16", dict(UGRP=16, do_leaf=False, max_steps=40)),
    ("nostack U16", dict(UGRP=16, do_stack=False, max_steps=40)),
    ("nosort U16", dict(UGRP=16, do_sort=False)),
    ("fetchonly U16", dict(UGRP=16, do_node=False, do_leaf=False,
                           do_stack=False, max_steps=40)),
)


def _flags(kw) -> dict:
    bad = set(kw) - set(FLAGS)
    if bad:
        raise TypeError(f"unknown v5 flags {sorted(bad)}")
    return dict(DEFAULTS, **kw)


def flag_bits(**kw) -> int:
    """The kernel's flags word (csrc/ablate.cuh: kFetch ... kV5Node)."""
    f = _flags(kw)
    return sum(1 << k for k, name in enumerate(FLAGS) if f[name])


def variant_name(UGRP: int, **kw) -> str:
    """The name launches are counted under: v5_full_U16, or v5_no_ and the
    phases switched off, then the group count."""
    f = _flags(kw)
    off = [n[3:] for n in FLAGS if not f[n]]
    return "v5_" + ("no_" + "_".join(off) if off else "full") + f"_U{UGRP}"


def _leaf(rec, org, dir, tnear, tf, mask, lid):
    """kernel_ablate.py:194-233 over the rays at a leaf."""
    bits = rec.view(torch.int32)
    f = tuple(rec[:, 8 + 4 * k:12 + 4 * k] for k in range(9))
    valid, tt, _ = _leaf_moeller(
        f, (org[:, 0:1], org[:, 1:2], org[:, 2:3]),
        (dir[:, 0:1], dir[:, 1:2], dir[:, 2:3]), tnear[:, None], tf[:, None])
    slot = torch.arange(V5_SLOTS, device=rec.device)
    valid = (valid & (slot < bits[:, 0:1])
             & ((bits[:, 44:48] & mask[:, None]) != 0))
    tl = torch.where(valid, tt, float("inf"))
    tmin = tl.amin(1)
    first = torch.where(valid & (tl == tmin[:, None]), slot, V5_SLOTS).amin(1)
    pid = torch.where(first < V5_SLOTS, bits[:, 1:5].gather(
        1, first.clamp(max=V5_SLOTS - 1)[:, None]).squeeze(1), 0)
    return tmin < tf, tmin, pid


def _tables_on(tables: AblateTables, device) -> AblateTables:
    tables = tables.to(device)
    harness.check_tables(tables, V5_LEAF_WORDS, device)
    return tables


def _limit(max_steps: Optional[int]) -> int:
    return MAX_STEPS if max_steps is None else max_steps


def _it_final(prog_max, max_steps: Optional[int]):
    """The program's lockstep count: the pinned steps, or the most steps a
    ray took, at least 1 (the harness's loop starts with one step) and at
    most the runaway guard."""
    if max_steps is not None:
        return torch.full_like(prog_max, max_steps)
    return prog_max.clamp(1, MAX_STEPS)


def traverse_plain(tables: AblateTables, org, dir, tnear, tfar, mask, UGRP,
                   *, max_steps: Optional[int] = None,
                   **kw) -> AblateResult:
    """The plain PyTorch version of ``traverse`` (any device)."""
    f = _flags(kw)
    prog = UGRP * harness.LANE
    B, rays = harness.pad_rays(org, dir, tnear, tfar, mask, prog)
    tables = _tables_on(tables, org.device)
    tf, best, visits, ntrips, ltrips = harness.walk_plain(
        tables, rays, prog, fetch_node=f["do_fetch"],
        fetch_leaf=f["do_fetch"],
        node_math="slab" if f["do_node"] else "none",
        leaf_fn=_leaf if f["do_leaf"] else None, sort=f["do_sort"],
        stack_on=f["do_stack"], one_trip=False, max_steps=_limit(max_steps),
        trips="program")
    prog_max = visits.sum(0).view(B, prog).amax(1)
    return AblateResult(tf.view(B, UGRP, -1), best.view(B, UGRP, -1),
                        harness.steps_rows(_it_final(prog_max, max_steps),
                                           ntrips, ltrips, UGRP), visits)


def _native(tables, org, dir, tnear, tfar, mask, UGRP, max_steps, kw):
    prog = UGRP * harness.LANE
    B, rays = harness.pad_rays(org, dir, tnear, tfar, mask, prog)
    tf, best, visits, prog_max, sched = harness.run_native(
        "v5", _tables_on(tables, org.device), rays, prog, _limit(max_steps),
        flag_bits(**kw))
    zeros = torch.zeros(B, dtype=torch.int32, device=org.device)
    return AblateResult(tf.view(B, UGRP, -1), best.view(B, UGRP, -1),
                        harness.steps_rows(_it_final(prog_max, max_steps),
                                           zeros, zeros, UGRP), visits, sched)


def traverse_kernel(tables: AblateTables, org, dir, tnear, tfar, mask, UGRP,
                    *, max_steps: Optional[int] = None,
                    **kw) -> AblateResult:
    """Launch the CUDA kernel (CUDA rays only)."""
    if org.device.type != "cuda":
        raise ValueError("traverse_kernel takes CUDA tensors only")
    res = _native(tables, org, dir, tnear, tfar, mask, UGRP, max_steps, kw)
    LAUNCHES[variant_name(UGRP, **kw)] += 1
    return res


def traverse_twin(tables: AblateTables, org, dir, tnear, tfar, mask, UGRP,
                  *, max_steps: Optional[int] = None,
                  **kw) -> AblateResult:
    """The kernel's per-ray code compiled for the host (CPU rays, tests)."""
    if org.device.type != "cpu":
        raise ValueError("traverse_twin takes CPU tensors only")
    return _native(tables, org, dir, tnear, tfar, mask, UGRP, max_steps, kw)


def traverse(tables: AblateTables, org, dir, tnear, tfar, mask, UGRP,
             *, max_steps: Optional[int] = None, **kw) -> AblateResult:
    """The v5 ablation of R rays against ``tables`` (``tables.pack_v5``)
    in programs of UGRP x 128 rays: the kernel for CUDA rays, the plain
    version for CPU rays. Flags as the harness's make_kernel (all on),
    ``max_steps`` None: to completion."""
    if org.device.type == "cuda":
        return traverse_kernel(tables, org, dir, tnear, tfar, mask, UGRP,
                               max_steps=max_steps, **kw)
    if org.device.type == "cpu":
        return traverse_plain(tables, org, dir, tnear, tfar, mask, UGRP,
                              max_steps=max_steps, **kw)
    raise ValueError(f"no v5 ablation for device {org.device}")


def run_variants(tables: AblateTables, rays, variants=VARIANTS,
                 reps: int = 5):
    """Time each variant through ``traverse`` (``device.time_call``: the
    median of ``reps`` windows after a warm-up) and print its line; returns
    the records."""
    out = []
    for name, kw in variants:
        kw = dict(kw)
        ugrp = kw.pop("UGRP")
        ms, res = time_call(
            lambda: traverse(tables, *rays, ugrp, **kw), reps,
            rays[0].is_cuda)
        rec = harness.report(name, ms, res, ugrp)
        flags = {k: v for k, v in kw.items() if k != "max_steps"}
        rec.update(kernel=variant_name(ugrp, **flags), flags=_flags(flags),
                   flag_bits=flag_bits(**flags),
                   max_steps=kw.get("max_steps"),
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
    tables = pack_v5(cs).to(dev)
    rays = harness_rays(args.rays, device=dev)
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0))
    else:
        print("CPU: the plain version, host clock")
    run_variants(tables, rays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
