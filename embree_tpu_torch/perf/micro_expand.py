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

- ``ROW_MIN_FORM`` (in ``FORMS``): the masked min run as a lane reduction
  every iteration, timed beside the probes;
- ``CROSSINGS``: the probes whose kernels run in stretches between the
  iterations at which a word's ``x + it`` crosses a threshold, and
  ``edge_x(t, n)``, an x whose words cross within n iterations;
- ``run(name, x, iters, device)``: the carried tile, by the kernel for a
  CUDA x and by the plain version for a CPU x;
- ``main()`` prints the harness's lines: name and ns per iteration.

Usage: python -m embree_tpu_torch.perf.micro_expand [--device cpu]
       [--iters N]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import micro
from .micro import (LANE, Cost, Harness, Probe, add, bcast_row, lane_gather,
                    mul, sum_wrap, tile_rows)

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
# rows 0-7 the probes keep: 1024 elements, x (or a table of x) held from
# before the loop
PROBES = (
    Probe("baseline (acc+1 only)", lambda acc, it, x: add(acc, 1), 0,
          Cost(E)),
    # acc + x[row] + it: one three-input add an element
    Probe("expand reshape-bcast (16,128)->(128,128)",
          lambda acc, it, x: add(acc, expand_r(mk_u(x, it))[0:8]), 1,
          Cost(E)),
    Probe("expand pltpu.repeat (16,128)->(128,128)",
          lambda acc, it, x: add(acc, tile_rows(mk_u(x, it), 8)[0:8]), 2,
          Cost(E)),
    Probe("strided extract (128,128)->(16,128) [::8]",
          lambda acc, it, x: add(acc, mk_r(x, it).view(U, 8, LANE)[:, 0, :]
                                 [0:8]), 3, Cost(E)),
    # x + it > 0 exactly for x in [1 - it, INT_MAX - it] (for every int32
    # x and it < 2**31, x + it wrapping), which a word enters or leaves
    # only at iterations 1 - x and 2**31 - x mod 2**32, at most twice in
    # 2**31 iterations (csrc/micro_expand.cu, next_crossing). Between them
    # a row's masked minimum is min(lo + it, cap), lo its least word in the
    # window and cap 999 where a word lies outside, both of x alone: per
    # row a compare against the next crossing, the add and the min, and an
    # add an element. lo and cap are taken again at most 2,048 times in any
    # number of iterations, at the crossings of the tile's words (once on
    # the harness's x, never on distinct_x in 3,000): not counted. No lane
    # reduction runs in the loop, so this does not price one on an operand
    # that changes every iteration: ROW_MIN_FORM does
    Probe("masked-min axis=1 (128,128)",
          lambda acc, it, x: add(acc, masked_min(mk_r(x, it))[0:8]), 4,
          Cost(E + 8 * 3, alu_ops=8 * 2)),
    Probe("masked-min axis=1 (16,128)",
          lambda acc, it, x: add(acc, masked_min(mk_u(x, it))[0:8]), 5,
          Cost(E + 8 * 3, alu_ops=8 * 2)),
    # v = x + it: acc + (v > 32 ? v : v + 1) = acc + (x + c - 1) + (it +
    # 1), c = [x + it <= 32], which changes only at iterations 33 - x and
    # 2**31 - x mod 2**32, as the masked min's window does (at most twice a
    # word in 2**31 iterations; c taken again then, 33 times on the
    # harness's x, not counted): one three-input add an element, and per
    # lane column a compare against the iteration at which one of its
    # words next crosses
    Probe("select (128,128)",
          lambda acc, it, x: add(acc, sel(mk_r(x, it))[0:8]), 6,
          Cost(E + 128, alu_ops=128)),
    Probe("select (16,128)",
          lambda acc, it, x: add(acc, sel(mk_u(x, it))[0:8]), 7,
          Cost(E + 128, alu_ops=128)),
    # the sum is multiplied by 0: acc + 1
    Probe("10x add (128,128)", add10, 8, Cost(E)),
    # the block's sum of x is the same every iteration: acc + s + 8 it
    Probe("block-sum (128,128)->(16,128)", block_sum, 9, Cost(E)),
    # the index (+ it, & 127) once a lane; acc + the gathered word + it
    Probe("take_along_axis 72 rows ax1 (one group gather)", gather72, 10,
          Cost(E + 2 * 128, alu_ops=128, smem_bytes=4 * E)),
    # 16 indices a lane; acc, 16 gathered words and 16 it: 9 three-input
    # adds an element
    Probe("16x take_along_axis 72 rows ax1", gather72x16, 11,
          Cost(9 * E + 32 * 128, alu_ops=16 * 128, smem_bytes=64 * E)),
)

# Beside the probes, timed with them but not among the harness's: the
# masked min (128,128) as a lane reduction every iteration, in micro_ops'
# row-min layout (csrc/micro_expand.cu, id 12; 8 compare-selects, 6 mins
# and 2 warp reductions a thread), the price of a masked lane minimum
# whose operand is new every iteration. The same function as probe 4, so
# the same least work.
ROW_MIN_FORM = Probe("masked-min axis=1 (128,128), row-min form",
                     PROBES[4].body, 12, PROBES[4].cost)
FORMS = (ROW_MIN_FORM,)

# the probes whose operand moves only where a word's x + it crosses a
# threshold T (csrc/micro_expand.cu, Crossings): T by name
CROSSINGS = {PROBES[4].name: 0, PROBES[5].name: 0, PROBES[6].name: 32,
             PROBES[7].name: 32}

# the two probes that gather x's rows 0-7 at a lane index
# (csrc/micro_expand.cu): x[0:8] staged transposed, 12 words an index, two
# 16-byte reads a gathered index
GATHERS = ("take_along_axis 72 rows ax1 (one group gather)",
           "16x take_along_axis 72 rows ax1")


def gather_wavefronts(name, x, iters: int):
    """Shared-memory wavefronts per iteration of gather probe ``name``'s
    kernel on x, averaged over ``iters`` iterations, and the count if no
    read met a bank conflict: (wavefronts, conflict_free). Index g of lane
    l at iteration it is (x[g, l] + it) & 127 (g < 1, or 16); the kernel
    reads x[0:8] at index i as two 16-byte chunks, 3 i and 3 i + 1 of its
    transposed copy (12 words an index), a quarter warp at a time: one
    wavefront per distinct 16 bytes in the busiest of 8 bank quads. Chunk
    c lies in quad c % 8, so the two reads spread alike."""
    if iters == 0:
        return 0.0, 0.0
    g = 1 if name == GATHERS[0] else 16
    idx = (x[0:g].cpu().numpy().astype(np.int64)[None]
           + np.arange(iters)[:, None, None]) & (LANE - 1)
    wf = micro.busiest(idx.reshape(-1, LANE), 8, (3 * np.arange(LANE)) % 8)
    return 2 * wf / iters, 2.0 * 16 * g


def edge_x(t: int, n: int, seed: int = 0, device="cpu") -> torch.Tensor:
    """An x whose rows 0-7 take the words' x + it > t through its cases
    within n iterations: words crossing t + 1 upward, words wrapping past
    INT_MAX, words near INT_MIN, rows where x + it > t holds for none, one
    word crossing among INT_MIN, the values around t and 999, and a mix;
    rows 8-127 uniform int32 from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    lo, hi = micro.INT_MIN, micro.INT_MAX
    x = rng.integers(lo, hi + 1, size=(ROWS, LANE), dtype=np.int64)

    def pick(vals):
        return rng.choice(np.asarray(vals, np.int64), size=LANE)

    x[0] = pick(np.arange(t - n, t + n))
    x[1] = pick(np.arange(hi - n, hi + 1))
    x[2] = pick(np.r_[np.arange(lo, lo + n), np.arange(t - n, t + 3)])
    x[3] = pick(np.arange(t - 3 * n, t - n))
    x[4] = lo
    x[4, rng.integers(LANE)] = t - n // 2
    x[5] = pick(np.r_[np.arange(hi - n, hi + 1), np.arange(t - n, t + 1)])
    x[6] = pick([lo, hi, 0, 1, -1, t - 1, t, t + 1, 998, 999, 1000, -998])
    x[7] = pick(np.r_[np.arange(t - n, t + n, 7),
                      np.arange(hi - n, hi + 1, 5), [lo]])
    return torch.from_numpy(x.astype(np.int32)).to(device)


def run(name, x=None, iters=None, device=None) -> torch.Tensor:
    """The (8,128) tile after ``iters`` (default ITERS) iterations of probe
    ``name`` (or of a form in FORMS) on x (default: the harness's x on
    ``device``)."""
    return micro.run(HARNESS, PROBES + FORMS, name, x, iters, device)


def main(argv=None) -> int:
    return micro.main(HARNESS, PROBES, argv, __doc__)


if __name__ == "__main__":
    sys.exit(main())
