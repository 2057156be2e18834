"""The loop-probe kernels of this tree, timed to set against another
tree's: every probe of the three harnesses (``micro_ops``,
``micro_expand``, ``micro_v8``) at the harness's ITERS on the harness's x,
through its entry point as phase 19 of ``chip_smoke.py`` times it
(``device.time_call``: CUDA events around 5 calls queued behind a spin
kernel, median of 5 windows), beside the bound this tree's ``Cost`` gives
at the card's highest SM clock; a unit's other forms (``FORMS``:
micro_expand's row-min masked min) are timed after its probes.

Run it from each tree's root in one call, A, B, B, A, to compare trees
(unpack the other tree with ``git archive`` into ``_checkout/`` and copy
this file into its ``embree_tpu_torch/perf/``):

    python -m embree_tpu_torch.perf.micro_batches [--units micro_ops,...]
        [--out FILE]

The JSON goes to ``--out`` (default: ``micro_batches.json`` in
``device.OUT_DIR``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from . import micro, micro_expand, micro_ops, micro_v8
from .device import card_line, default_out, time_call

MODULES = {"micro_ops": micro_ops, "micro_expand": micro_expand,
           "micro_v8": micro_v8}


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def time_unit(mod, clock: float):
    h = mod.HARNESS
    x = micro.harness_x(h, "cuda")
    out = []
    for p in mod.PROBES + getattr(mod, "FORMS", ()):
        ms, _ = time_call(lambda: mod.run(p.name, x, h.iters))
        bound, by = micro.bound_ms(micro.cost_of(p, x, h.iters), h.iters,
                                   clock)
        out.append(dict(unit=h.unit, probe=p.name, kid=p.kid, ms=ms,
                        ns_per_iter=ms * 1e6 / h.iters, bound_ms=bound,
                        bound_by=by, share=bound / ms))
        print(f"{h.unit:12s} {p.kid:2d} {p.name:58s} {ms:9.4f} ms  bound "
              f"{bound:8.4f} ({by}) {100 * bound / ms:5.1f}%", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--units", default=",".join(MODULES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("micro_batches: needs a CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    clock = sm_clock_hz()
    print(f"{card}, SM clock (max) {clock / 1e6:.0f} MHz", flush=True)
    recs = []
    for unit in args.units.split(","):
        recs += time_unit(MODULES[unit], clock)
    with open(args.out or default_out("micro_batches.json"), "w") as f:
        json.dump({"card": card, "sm_clock_mhz": clock / 1e6,
                   "records": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
