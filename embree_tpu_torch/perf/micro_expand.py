"""The compact-vs-broadcast state probes of perf/micro_expand.py on an
NVIDIA H100.

Each probe carries an (8,128) int32 tile through ``ITERS`` = 3,000
iterations; each iteration makes a fresh operand ``x + it`` of x,
(128,128), as its (16,128) rows (``u``) or all (128,128) (``r``), and adds
rows 0-7 of an op on it: reshape-broadcast and ``pltpu.repeat`` expands
(which differ: the repeat tiles the rows), a strided extract, a masked min
along the lanes, selects, a 10x add that is multiplied by 0, a block sum
and one or sixteen 72-row group gathers. ``PROBES`` lists them in the
harness's order under its printed names, each with its plain PyTorch body
(``micro_expand.py:52-95`` op for op), its id in the CUDA kernel
(``csrc/micro_expand.cu``) and its least work per iteration
(``micro.Cost``). The harness keeps the best of 3 timed calls; the port
times as for its other probes (``device.time_call``).

- ``run(name, x, iters, device)``: the carried tile, by the kernel for a
  CUDA x and by the plain version for a CPU x;
- ``main()`` prints the harness's lines: name and ns per iteration.

Usage: python -m embree_tpu_torch.perf.micro_expand [--device cpu]
       [--iters N]
"""
from __future__ import annotations

import sys

import torch

from . import micro
from .micro import (LANE, ROW_MIN_BYTES, Cost, Harness, Probe, add,
                    bcast_row, lane_gather, mul, sum_wrap, tile_rows)

U = 16
ROWS = U * 8
ITERS = 3000
HARNESS = Harness("micro_expand", rows_in=ROWS, rows_acc=8, mask=63,
                  iters=ITERS, width=52)
E = 8 * 128


def mk_u(x, it):
    """x[0:U] + it: a fresh (16,128) operand each iteration."""
    return add(x[0:U], it)


def mk_r(x, it):
    """x[0:ROWS] + it: a fresh (128,128) operand."""
    return add(x[0:ROWS], it)


def expand_r(xu):
    """(U,128) -> (ROWS,128), row r = xu[r >> 3] (micro_expand.py:48)."""
    return xu[:, None, :].expand(U, 8, LANE).reshape(ROWS, LANE)


def masked_min(v):
    return torch.where(v > 0, v, torch.full_like(v, 999)).amin(
        1, keepdim=True)


def sel(v):
    return torch.where(v > 32, v, add(v, 1))


def add10(acc, it, x):
    s = sum_wrap(add(mk_r(x, it), k) for k in range(10))
    return add(add(add(acc, mul(s[0:8], 0)), mul(acc, 0)), 1)


def block_sum(acc, it, x):
    s = sum_wrap(mk_r(x, it).view(U, 8, LANE).unbind(1))
    return add(acc, s[0:8])


def gather72(acc, it, x):
    idx = bcast_row(mk_u(x, it)[0:1] & 127, 72)
    return add(acc, lane_gather(mk_r(x, it)[0:72], idx)[0:8])


def gather72x16(acc, it, x):
    r72 = mk_r(x, it)[0:72]
    u = mk_u(x, it)
    parts = (lane_gather(r72, bcast_row(u[k:k + 1] & 127, 72))[0:8]
             for k in range(16))
    return add(acc, sum_wrap(parts))


# micro_expand.py:52-95; least work per iteration (micro.Cost) on the
# rows 0-7 the probes keep: 1024 elements, thread l holds lane l's 8 rows
PROBES = (
    Probe("baseline (acc+1 only)", lambda acc, it, x: add(acc, 1), 0,
          Cost(E)),
    Probe("expand reshape-bcast (16,128)->(128,128)",
          lambda acc, it, x: add(acc, expand_r(mk_u(x, it))[0:8]), 1,
          Cost(E)),
    Probe("expand pltpu.repeat (16,128)->(128,128)",
          lambda acc, it, x: add(acc, tile_rows(mk_u(x, it), 8)[0:8]), 2,
          Cost(E)),
    Probe("strided extract (128,128)->(16,128) [::8]",
          lambda acc, it, x: add(acc, mk_r(x, it).view(U, 8, LANE)[:, 0, :]
                                 [0:8]), 3, Cost(E)),
    # per element: + it, the compare and the select, the final add
    Probe("masked-min axis=1 (128,128)",
          lambda acc, it, x: add(acc, masked_min(mk_r(x, it))[0:8]), 4,
          Cost(4 * E + 8 * 3, alu_ops=2 * E + 8 * 3,
               smem_bytes=8 * ROW_MIN_BYTES)),
    Probe("masked-min axis=1 (16,128)",
          lambda acc, it, x: add(acc, masked_min(mk_u(x, it))[0:8]), 5,
          Cost(4 * E + 8 * 3, alu_ops=2 * E + 8 * 3,
               smem_bytes=8 * ROW_MIN_BYTES)),
    # per element: + it, the compare, acc + v + (v <= 32) as two adds
    # under it
    Probe("select (128,128)",
          lambda acc, it, x: add(acc, sel(mk_r(x, it))[0:8]), 6,
          Cost(4 * E, alu_ops=E)),
    Probe("select (16,128)",
          lambda acc, it, x: add(acc, sel(mk_u(x, it))[0:8]), 7,
          Cost(4 * E, alu_ops=E)),
    # the sum is multiplied by 0: acc + 1
    Probe("10x add (128,128)", add10, 8, Cost(E)),
    # the block's sum of x is the same every iteration: acc + s + 8 it
    Probe("block-sum (128,128)->(16,128)", block_sum, 9, Cost(E)),
    # the index (+ it, & 127) once a lane
    Probe("take_along_axis 72 rows ax1 (one group gather)", gather72, 10,
          Cost(E + 2 * 128, alu_ops=128, smem_bytes=4 * E)),
    # 16 indices a lane; acc, 16 gathered words and 16 it: 9 three-input
    # adds an element
    Probe("16x take_along_axis 72 rows ax1", gather72x16, 11,
          Cost(9 * E + 32 * 128, alu_ops=16 * 128, smem_bytes=64 * E)),
)


def run(name, x=None, iters=None, device=None) -> torch.Tensor:
    """The (8,128) tile after ``iters`` (default ITERS) iterations of probe
    ``name`` on x (default: the harness's x on ``device``)."""
    return micro.run(HARNESS, PROBES, name, x, iters, device)


def main(argv=None) -> int:
    return micro.main(HARNESS, PROBES, argv, __doc__)


if __name__ == "__main__":
    sys.exit(main())
