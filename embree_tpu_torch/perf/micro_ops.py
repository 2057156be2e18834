"""The Mosaic primitive probes of perf/micro_ops.py on an NVIDIA H100.

Each probe carries an (8,128) int32 tile through ``ITERS`` = 20,000
iterations of its body over x, (512,128): lane gathers of (8, 32, 48 and
256,128) operands, sublane gathers, a roll, a scalar extract with a
dynamic-slice load, scalar and row min reductions, a select, a 10x f32
mul-add chain and an inner while loop. ``PROBES`` lists them in the
harness's order under its printed names, each with its plain PyTorch body
(``micro_ops.py:56-135`` op for op), its id in the CUDA kernel
(``csrc/micro_ops.cu``) and its least work per iteration (``micro.Cost``).

- ``run(name, x, iters, device)``: the carried tile, by the kernel for a
  CUDA x and by the plain version for a CPU x;
- ``main()`` prints the harness's lines: name and ns per iteration
  (``device.time_call``: CUDA events, the median of 5 windows of 5
  calls).

Usage: python -m embree_tpu_torch.perf.micro_ops [--device cpu]
       [--iters N]
"""
from __future__ import annotations

import sys

import torch

from . import micro
from .micro import (ROW_MIN_BYTES, Cost, Harness, Probe, add,
                    bcast_row, f2i, lane_gather, row_gather)

ITERS = 20000
HARNESS = Harness("micro_ops", rows_in=512, rows_acc=8, mask=127,
                  iters=ITERS, width=55)


def _idx_row0(acc, rows):
    """broadcast_to(acc[0:1] & 127, (rows, 128))."""
    return bcast_row(acc[0:1] & 127, rows)


def lane8(acc, it, x):
    return add(acc, lane_gather(x[0:8], acc & 127))


def lane32(acc, it, x):
    g = lane_gather(x[0:32], _idx_row0(acc, 32))
    return add(add(add(add(acc, g[0:8]), g[8:16]), g[16:24]), g[24:32])


def lane48(acc, it, x):
    g = lane_gather(x[0:48], _idx_row0(acc, 48))
    return add(add(acc, g[0:8]), g[40:48])


def lane256(acc, it, x):
    g = lane_gather(x[0:256], _idx_row0(acc, 256))
    return add(add(acc, g[0:8]), g[248:256])


def sub8(acc, it, x):
    return add(acc, row_gather(x[0:8], acc & 7))


def sub32(acc, it, x):
    return add(acc, row_gather(x[0:32], acc & 31)[0:8])


def roll(acc, it, x):
    return add(acc, torch.roll(acc, 1, 0))


def dynslice(acc, it, x):
    g = int(acc[0, 0]) & 15
    return add(acc, x[g * 32:g * 32 + 32][0:8])


def scalar_min(acc, it, x):
    return add(acc, acc.min())


def row_min(acc, it, x):
    return add(acc, acc.amin(1, keepdim=True))


def select(acc, it, x):
    return torch.where(acc > it, add(acc, 1), acc)


def fma10(acc, it, x):
    a = acc.to(torch.float32)
    c1 = torch.tensor(1.000001, dtype=torch.float32, device=acc.device)
    c05 = torch.tensor(0.5, dtype=torch.float32, device=acc.device)
    for _ in range(10):
        a = (a * c1) + c05           # separate mul and add: no FMA
    return add(acc, f2i(a))


def inner_while(acc, it, x):
    a = acc
    for _ in range(4):
        a = add(a, lane_gather(x[0:8], a & 127))
    return a


# micro_ops.py:56-135; least work per iteration (micro.Cost): 1024
# elements, thread l holds lane l's 8 rows, 4 bytes a gathered word
E = 8 * 128
PROBES = (
    Probe("loop overhead (add only)", lambda acc, it, x: add(acc, 1), 0,
          Cost(E)),
    Probe("lane gather (8,128) take_along_axis ax1", lane8, 1,
          Cost(2 * E, alu_ops=E, smem_bytes=4 * E)),
    # the sum of the gathered rows is one gather of a table of x's rows
    # summed once before the loop (the same for the next two)
    Probe("lane gather (32,128)", lane32, 2, Cost(E, smem_bytes=4 * E)),
    Probe("lane gather (48,128)", lane48, 3, Cost(E, smem_bytes=4 * E)),
    Probe("lane gather (256,128)", lane256, 4, Cost(E, smem_bytes=4 * E)),
    Probe("sublane gather (8,128) ax0", sub8, 5,
          Cost(2 * E, alu_ops=E, smem_bytes=4 * E)),
    Probe("sublane gather (32,128) ax0 (8 idx rows)", sub32, 6,
          Cost(2 * E, alu_ops=E, smem_bytes=4 * E)),
    Probe("pltpu.roll sublane", roll, 7, Cost(E)),
    # acc[0, 0] evolves on its own: each thread carries a copy (its start,
    # its add) and reads its word of x; the slice's rows staged in shared
    # memory
    Probe("scalar-extract + dyn-slice (32,128) load", dynslice, 8,
          Cost(E + 2 * 128, alu_ops=128, smem_bytes=4 * E + 4 * 128)),
    # 7 mins a lane over its 8 rows, a warp reduction (not counted), 3
    # mins over the four warps' minima, an add an element
    Probe("scalar min-reduction (8,128)", scalar_min, 9,
          Cost(7 * 128 + 3 + E, alu_ops=7 * 128 + 3,
               smem_bytes=ROW_MIN_BYTES)),
    # a row in one warp: 3 mins over each thread's 4 lanes (96 a row), a
    # warp reduction, an add an element; nothing crosses warps
    Probe("row min-reduction (8,128)->(8,1)", row_min, 10,
          Cost(E + 8 * 96, alu_ops=8 * 96)),
    # the compare and an add under it
    Probe("select (8,128)", select, 11, Cost(2 * E, alu_ops=E)),
    # 10 x (mul, add) in fp32; the conversions are not counted
    Probe("10x f32 FMA (8,128)", fma10, 12, Cost(E, fp_ops=20 * E)),
    Probe("inner while 4x (cond+gather body)", inner_while, 13,
          Cost(8 * E, alu_ops=4 * E, smem_bytes=16 * E)),
)


def run(name, x=None, iters=None, device=None) -> torch.Tensor:
    """The (8,128) tile after ``iters`` (default ITERS) iterations of probe
    ``name`` on x (default: the harness's x on ``device``)."""
    return micro.run(HARNESS, PROBES, name, x, iters, device)


def main(argv=None) -> int:
    return micro.main(HARNESS, PROBES, argv, __doc__)


if __name__ == "__main__":
    sys.exit(main())
