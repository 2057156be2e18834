"""The v8 building-block probes of perf/micro_v8.py on an NVIDIA H100.

Each probe carries a (128,128) int32 tile through ``ITERS`` = 20,000
iterations of its body over x, (512,128): an elementwise chain, a select,
static XOR and dynamic block-local sublane gathers, the roll-form block XOR
and block-sum butterfly, a (16,128) -> (128,128) expand and a block
reduce, 72-row and 9 x 8-row lane gathers with and without dynamic slices,
a gather + select merge, a compact chain, and four 6-stage bitonic networks
(gather form, roll form, key + ref, per group). ``PROBES`` lists them in
the harness's order under its printed names, each with its plain PyTorch
body (``micro_v8.py:52-204`` op for op), its id in the CUDA kernel
(``csrc/micro_v8.cu``) and its least work per iteration (``micro.Cost``).

The key + ref networks keep the harness's one-sided tie rule: a pair
swaps where ``(partner < key) == keepmin``, so on equal keys the row that
keeps the maximum takes its partner's ref and the other keeps its own
(``bitonic_pairs``). In the probes the ref is ``key ^ 12345``, which
travels with its key, so there the rule cannot show.

- ``run(name, x, iters, device)``: the carried tile, by the kernel for a
  CUDA x and by the plain version for a CPU x;
- ``main()`` prints the harness's lines: name and ns per iteration.

Usage: python -m embree_tpu_torch.perf.micro_v8 [--device cpu] [--iters N]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import micro
from .micro import (LANE, Cost, Harness, Probe, add, bcast_row, lane_gather,
                    mul, row_gather, row_iota, sub, sum_wrap)

ROWS = 128
ITERS = 20000
HARNESS = Harness("micro_v8", rows_in=512, rows_acc=ROWS, mask=127,
                  iters=ITERS, width=58)
E = ROWS * 128
STAGES = ((2, 1), (4, 2), (4, 1), (8, 4), (8, 2), (8, 1))


def chain(acc, it, x):
    p = add(mul(acc, 3), 1) ^ (acc >> 2)
    return add(acc, mul(p, add(acc | 1, it)))


def select(acc, it, x):
    return torch.where(acc > it, add(acc, 1), sub(acc, 1))


def xor4_gather(acc, it, x):
    return add(acc, row_gather(acc, row_iota(ROWS, acc.device) ^ 4))


def dyn_block_gather(acc, it, x):
    rowall = row_iota(ROWS, acc.device)
    idx = (rowall & ~7) | ((rowall ^ (acc & 7)) & 7)
    return add(acc, row_gather(acc, idx))


def _roll_pair(a, s, rc):
    """where((rc & s) == 0, roll(a, ROWS - s), roll(a, s)): row r + s or
    r - s."""
    up = torch.roll(a, ROWS - s, 0)
    dn = torch.roll(a, s, 0)
    return torch.where((rc & s) == 0, up, dn)


def xor4_roll(acc, it, x):
    rc = row_iota(ROWS, acc.device) & 7
    return add(acc, _roll_pair(acc, 4, rc))


def butterfly(acc, it, x):
    rc = row_iota(ROWS, acc.device) & 7
    a = acc
    for s in (1, 2, 4):
        a = add(a, _roll_pair(a, s, rc))
    return add(acc, a)


def _expand16(c):
    """(16,128) -> (128,128), row r = c[r >> 3]."""
    return c[:, None, :].expand(16, 8, LANE).reshape(ROWS, LANE)


def expand16(acc, it, x):
    return add(acc, _expand16(acc[0:16]))


def reduce_rows(acc, it, x):
    r = sum_wrap(acc.view(16, 8, LANE).unbind(1))
    return add(acc, _expand16(r))


def _cat72(g):
    """concatenate([g, g[0:56]]): 72 rows to 128."""
    return torch.cat([g, g[0:56]], 0)


def gather72(acc, it, x):
    g = lane_gather(x[0:72], bcast_row(acc[0:1] & 127, 72))
    return add(acc, _cat72(g))


def dynslice72(acc, it, x):
    g = int(acc[0, 0]) & 3
    tile = x[g * 72:g * 72 + 72]
    got = lane_gather(tile, bcast_row(acc[0:1] & 127, 72))
    return add(acc, _cat72(got))


def dynslice32(acc, it, x):
    g = int(acc[0, 0]) & 7
    tile = x[g * 32:g * 32 + 32]
    got = lane_gather(tile, bcast_row(acc[0:1] & 127, 32))
    return add(acc, torch.cat([got] * 4, 0))


def merge72(acc, it, x):
    g = lane_gather(x[0:72], bcast_row(acc[0:1] & 127, 72))
    m = bcast_row((acc[0:1] & 1) > 0, 72)
    return add(acc, _cat72(torch.where(m, g, x[72:144])))


def gather8x9(acc, it, x):
    li = acc[0:8] & 127
    g = torch.cat([lane_gather(x[8 * k:8 * k + 8], li) for k in range(9)], 0)
    return add(acc, _cat72(g))


def compact(acc, it, x):
    c = acc[0:16]
    c = add(mul(torch.where(c > it, add(c, 1), sub(c, 1)), 3), c >> 1)
    return add(acc, torch.cat([c] * 8, 0))


def _stage(key, ref, key_p, ref_p, rc, k, j):
    keepmin = ((rc & k) == 0) == ((rc & j) == 0)
    swap = (key_p < key) == keepmin
    key_n = torch.where(swap, key_p, key)
    ref_n = None if ref is None else torch.where(swap, ref_p, ref)
    return key_n, ref_n


def bitonic_gather(acc, it, x):
    rowall = row_iota(ROWS, acc.device)
    rc = rowall & 7
    key = acc
    for k, j in STAGES:
        key, _ = _stage(key, None, row_gather(key, rowall ^ j), None, rc,
                        k, j)
    return add(key, 1)


def bitonic_roll(acc, it, x):
    rc = row_iota(ROWS, acc.device) & 7
    key = acc
    for k, j in STAGES:
        key, _ = _stage(key, None, _roll_pair(key, j, rc), None, rc, k, j)
    return add(key, 1)


def bitonic_pairs(key, ref):
    """The six stages on (key, ref) tiles of whole 8-row blocks, with the
    harness's one-sided tie rule."""
    rowall = row_iota(key.shape[0], key.device)
    rc = rowall & 7
    for k, j in STAGES:
        perm = rowall ^ j
        key, ref = _stage(key, ref, row_gather(key, perm),
                          row_gather(ref, perm), rc, k, j)
    return key, ref


def bitonic_ref(acc, it, x):
    key, ref = bitonic_pairs(acc, acc ^ 12345)
    return add(key, ref)


def bitonic_group(acc, it, x):
    row8 = row_iota(8, acc.device)
    out = []
    for u in range(16):
        key = acc[8 * u:8 * u + 8]
        ref = key ^ 12345
        for k, j in STAGES:
            perm = row8 ^ j
            key, ref = _stage(key, ref, row_gather(key, perm),
                              row_gather(ref, perm), row8, k, j)
        out.append(add(key, ref))
    return torch.cat(out, 0)


def merge72_cost(x, iters: int) -> Cost:
    """merge72's least work per iteration, averaged over ``iters``
    iterations on x. The merge's mask ``acc[0] & 1`` is one bit a lane, the
    same for all the rows a thread holds, so one branch a thread picks the
    gathered rows or ``x[72:144]`` (registers): the 72-row gather (72 words,
    rows r and r + 72 of the tile add one word) is needed only where the
    lane's bit is set. Row 0 evolves on its own (``acc[0] + (g[0] if m else
    x[72])``), so its loop alone counts those lanes."""
    x = x.cpu()
    a = x[0].clone()
    lanes = 0
    for _ in range(iters):
        m = (a & 1) > 0
        lanes += int(m.sum())
        a = add(a, torch.where(m, x[0].gather(0, (a & 127).long()), x[72]))
    # the index and the bit once a thread (128 threads, a lane's 128 rows
    # each), an add an element
    return Cost(E + 2 * LANE, alu_ops=2 * LANE,
                smem_bytes=lanes / max(iters, 1) * 4 * 72)


# micro_v8.py:52-204; least work per iteration (micro.Cost): 16,384
# elements. Where rows 0-15 of a lane feed its other rows (the expand, the
# 72-row gathers' index row, the compact state), one thread holds the
# lane's 128 rows, so nothing is exchanged; a 72-row gather reads 72 words
# a lane (tile rows r and r + 72 add the same word), its index (and a
# dynamic slice's start) once a thread. acc[0, 0], a dynamic slice's start,
# evolves on its own: each of the 128 threads carries it (its start, its
# index, its add) and reads its word of x (4 bytes).
_GATHER72 = 4 * 72 * LANE
_SLICE0 = 4 * LANE
# a sort of 8 keys: 19 compare-exchanges at the least (the six bitonic
# stages take 24), a min and a max each
_SORT8 = 19 * 2 * E // 8
PROBES = (
    Probe("base (add only) (128,128)", lambda acc, it, x: add(acc, 1), 0,
          Cost(E)),
    # IMAD (3v + 1), shift, xor, or, + it, IMAD (p q + acc)
    Probe("elementwise 10 op chain (128,128)", chain, 1,
          Cost(6 * E, alu_ops=3 * E)),
    # the compare, then acc + 1 or acc - 1 as two adds under it
    Probe("select (128,128)", select, 2, Cost(3 * E, alu_ops=E)),
    # rows r and r ^ 4 get the same sum: one add for the pair
    Probe("static XOR-4 take_along_axis ax0 (128,128)", xor4_gather, 3,
          Cost(E // 2)),
    # the index (one logic op), the tile written to shared memory and read
    # back at the dynamic row (bank = lane: no conflict; cheaper than the
    # kernel's select network, 7 selects an element), the add
    Probe("dynamic block-local sublane gather (128,128)", dyn_block_gather,
          4, Cost(2 * E, alu_ops=E, smem_bytes=8 * E)),
    Probe("block-XOR-4 via 2 rolls + select (128,128)", xor4_roll, 5,
          Cost(E // 2)),
    # a block's sum in 3 three-input adds (two partial sums left), then
    # acc plus both: 11 adds per 8 elements
    Probe("block-sum butterfly 3x(2roll+sel+add) (128,128)", butterfly, 6,
          Cost(11 * E // 8)),
    # rows 0-15 are the lane's thread's own: an add an element
    Probe("expand (16,128)->(128,128) block-broadcast", expand16, 7,
          Cost(E)),
    Probe("block-reduce (128,128)->(16,128) + re-expand", reduce_rows, 8,
          Cost(11 * E // 8)),
    # the index once a thread, an add an element
    Probe("lane gather (72,128) broadcast idx", gather72, 9,
          Cost(E + LANE, alu_ops=LANE, smem_bytes=_GATHER72)),
    # the slice's 72 (32) rows gathered; acc[0, 0]'s copy: its start
    # (& 3 or & 7), its index, its add
    Probe("dynslice (72,128) + lane gather", dynslice72, 10,
          Cost(E + 4 * LANE, alu_ops=3 * LANE,
               smem_bytes=_GATHER72 + _SLICE0)),
    Probe("dynslice (32,128) + lane gather", dynslice32, 11,
          Cost(E + 4 * LANE, alu_ops=3 * LANE,
               smem_bytes=4 * 32 * LANE + _SLICE0)),
    Probe("gather72 + select72 merge", merge72, 12, merge72_cost),
    # rows 0-7 are the thread's own: 8 indices a thread, 72 words gathered
    # a lane
    Probe("9x lane gather (8,128) [v7 style]", gather8x9, 13,
          Cost(E + 8 * LANE, alu_ops=8 * LANE, smem_bytes=_GATHER72)),
    # the (16,128) state on the thread's own rows 0-15: compare, select of
    # +3 or -3, IMAD (3c +- 3), shift (2,048 elements); then each tile row
    # plus both, one three-input add an element
    Probe("compact (16,128) 5-op chain + concat x8", compact, 14,
          Cost(4 * 2048 + E, alu_ops=3 * 2048)),
    # each 8-row block sorted ascending (any sorting network does), the add
    Probe("tile-parallel bitonic6 gather-form key-only (128,128)",
          bitonic_gather, 15, Cost(_SORT8 + E, alu_ops=_SORT8)),
    Probe("tile-parallel bitonic6 roll-form key-only (128,128)",
          bitonic_roll, 16, Cost(_SORT8 + E, alu_ops=_SORT8)),
    # ref is key ^ 12345 before and after every stage (a swap moves both),
    # so the output is the sorted keys plus their xor: the sort, the xor,
    # the add
    Probe("tile-parallel bitonic6 gather-form key+ref (128,128)",
          bitonic_ref, 17, Cost(_SORT8 + 2 * E, alu_ops=_SORT8 + E)),
    Probe("per-group bitonic6 x16 key+ref (8,128) [v7 style]",
          bitonic_group, 18, Cost(_SORT8 + 2 * E, alu_ops=_SORT8 + E)),
)


# the five probes that gather x's rows in shared memory at a lane index
# (csrc/micro_v8.cu): row-major x, one 4-byte read a row, except the
# merge's transposed x[0:144] (76 words an index, 16-byte reads)
GATHERS = ("lane gather (72,128) broadcast idx",
           "dynslice (72,128) + lane gather",
           "dynslice (32,128) + lane gather",
           "gather72 + select72 merge",
           "9x lane gather (8,128) [v7 style]")


def gather_wavefronts(name, x, iters: int):
    """Shared-memory wavefronts per iteration of gather probe ``name``'s
    kernel on x, averaged over ``iters`` iterations, and the count if no
    read met a bank conflict: (wavefronts, conflict_free). The indices come
    from the rows the probe's reads depend on (rows 0-7 of the tile, which
    evolve on their own). A warp's 4-byte read takes one wavefront per
    distinct word in its busiest of 32 banks (words at one address are
    broadcast); the merge's 16-byte reads (72 rows at a lane's index in
    x[0:72] where its bit is set, its own lane of x[72:144] elsewhere, both
    staged transposed, 76 words a lane) are taken a quarter warp at a time,
    one wavefront per distinct 16 bytes in the busiest of 8 bank quads. The
    dynamic slices' copy of acc[0, 0] adds one broadcast read a warp."""
    xs = x.cpu().numpy().astype(np.int64)
    a = xs[0:8].copy()
    lane = np.arange(LANE)
    rows = []
    for _ in range(iters):
        idx = a & 127
        if name == GATHERS[3]:
            m = (a[0] & 1) > 0
            rows.append(np.where(m, idx[0], LANE + lane))
            a[0] = a[0] + np.where(m, xs[0, idx[0]], xs[72])
        elif name == GATHERS[4]:
            rows.append(idx)
            a = a + xs[np.arange(8)[:, None], idx]
        else:
            span, mask = {GATHERS[0]: (72, 0), GATHERS[1]: (72, 3),
                          GATHERS[2]: (32, 7)}[name]
            start = span * (int(a[0, 0]) & mask)
            rows.append(idx[0])
            a[0] = a[0] + xs[start, idx[0]]
        a = (a + 2 ** 31) % 2 ** 32 - 2 ** 31
    if iters == 0:
        return 0.0, 0.0
    if name == GATHERS[3]:
        # 16-byte chunk 19 i + q of row block q (i < 256): quad (19 i + q)
        # % 8, the same spread for every q; 18 reads, 16 quarter warps
        wf = micro.busiest(np.stack(rows), 8,
                           (19 * np.arange(2 * LANE)) % 8)
        return 18 * wf / iters, 18.0 * 16
    per_read, z_reads = {GATHERS[0]: (72, 0), GATHERS[1]: (72, 4),
                         GATHERS[2]: (32, 4), GATHERS[4]: (9, 0)}[name]
    wf = micro.busiest(np.stack(rows).reshape(-1, LANE), 32,
                       np.arange(LANE) % 32)
    free = per_read * 4 * (8 if name == GATHERS[4] else 1) + z_reads
    return (per_read * wf + z_reads * iters) / iters, float(free)


def run(name, x=None, iters=None, device=None) -> torch.Tensor:
    """The (128,128) tile after ``iters`` (default ITERS) iterations of
    probe ``name`` on x (default: the harness's x on ``device``)."""
    return micro.run(HARNESS, PROBES, name, x, iters, device)


def main(argv=None) -> int:
    return micro.main(HARNESS, PROBES, argv, __doc__)


if __name__ == "__main__":
    sys.exit(main())
