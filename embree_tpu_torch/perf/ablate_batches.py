"""The two ablation kernels of this tree, timed to set against another
tree's: every variant of each harness on the phase-18 cell (the 16K-tri
sphere, 1,048,576 sorted rays) and the main cell (``sphere_mesh(1024,
1024)``, 16,777,216 sorted rays), beside B1 closest on the same rays.

Each variant is timed twice: through the harness's entry point as
``run_variants`` times it (``device.time_call``: CUDA events around 5 calls
queued behind a spin kernel, median of 5 windows), which includes what the
host spends per call when that outlasts the kernel, and by the kernel's own
device time under ``torch.profiler`` (the mean over 5 launches of every
device kernel whose name holds the kernel's, "not measured" when the
profiler sees no device time).

Run it from each tree's root in one call, A, B, B, A, to compare trees
(unpack the other tree with ``git archive`` into ``_checkout/`` and copy
this file into its ``embree_tpu_torch/perf/``):

    python -m embree_tpu_torch.perf.ablate_batches [--cells check,main]
        [--units v7,v5] [--out FILE]

The JSON goes to ``--out`` (default: ``ablate_batches.json`` in
``device.OUT_DIR``).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..accel import traverse as tr
from . import ablate_v7 as v7
from . import kernel_ablate as v5
from . import scenes, tables
from .device import card_line, default_out, time_call

CELLS = {"check": (scenes.HARNESS_MESH, scenes.HARNESS_RAYS),
         "main": ((1024, 1024), 1 << 24)}
REPS = 5


def device_ms(fn, name: str, reps: int = REPS):
    """Mean device ms of the kernels whose name holds ``name`` over
    ``reps`` calls of ``fn`` under torch.profiler, or None when the
    profiler records no device time for them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if name in e.key:
            total += getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0))
    return total / reps / 1e3 if total > 0 else None


def run_cell(cell: str, units):
    mesh, n = CELLS[cell]
    cs = scenes.sphere_scene(*mesh, device="cuda")
    rays = scenes.harness_rays(n, device="cuda")
    out = []

    def b1():
        return tr.traverse_kernel(cs.packed, *rays)
    ms, _ = time_call(b1)
    out.append(dict(cell=cell, kernel="B1 closest", ms=ms,
                    device_ms=device_ms(b1, "persistent_kernel")))
    tabs = {}
    if "v7" in units:
        tabs["v7"] = tables.v7_tables(cs.packed).to("cuda")
    if "v5" in units:
        tabs["v5"] = tables.pack_v5(cs).to("cuda")
    for unit in units:
        mod = v7 if unit == "v7" else v5
        for name, kw in mod.VARIANTS:
            kw = dict(kw)
            args = (kw.pop("UGRP"),) if unit == "v5" else ()

            def call():
                return mod.traverse_kernel(tabs[unit], *rays, *args, **kw)
            ms, _ = time_call(call)
            out.append(dict(cell=cell, kernel=f"{unit} {name}", ms=ms,
                            device_ms=device_ms(call, f"{unit}_kernel")))
    for rec in out:
        dev = rec["device_ms"]
        print(f"{cell:5s} {rec['kernel']:18s} {rec['ms']:9.3f} ms  device "
              + ("not measured" if dev is None else f"{dev:9.3f} ms"),
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="check,main")
    ap.add_argument("--units", default="v7,v5")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_batches: needs a CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    units = args.units.split(",")
    recs = []
    for cell in args.cells.split(","):
        recs += run_cell(cell, units)
    with open(args.out or default_out("ablate_batches.json"), "w") as f:
        json.dump({"card": card, "records": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
