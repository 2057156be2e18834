"""What the three loop probes share (``micro_ops``, ``micro_expand``,
``micro_v8``): their inputs, int32 arithmetic as XLA does it, the plain
loop, the kernels' launcher, the per-SM bound and the harnesses' print
format (their loader, launch counts and timing: ``device``).

Each TPU harness runs one Pallas program that carries an int32 tile
through ``ITERS`` iterations of a probe body, ``acc = body(acc, it, x)``
with ``acc`` starting as the first rows of ``x``, and prints the probe's
name and ns per iteration. The port runs the same loop as one CUDA block
(``csrc/micro_*.cu``, one template instantiation per probe) on the card,
and as torch ops on the tile (the plain version) anywhere.

The harnesses' own ``x`` is the lane index (``arange & 127``, or ``& 63``
in ``micro_expand``): every row of it is the same. A port that reads the
wrong row would agree with the harness on it, so the tests and the smoke
run also feed both sides ``distinct_x``, random int32 rows from a seed.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .device import LAUNCHES, load, time_call

LANE = 128
I32 = torch.int32
INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
DISTINCT_SEED = 7


class Cost(NamedTuple):
    """The least work of one iteration of a probe on the whole tile: the
    least over the implementations that give the probe's output for every
    x, not the count of the one its kernel chose. The tile is held as the
    kernels hold it (lane columns of whole 8-row blocks, one block on one
    SM); any algebra that holds for all int32 data may be used: work on x
    alone (which never changes) is done once before the loop, equal
    results are computed once, a product by 0 is dropped, a wrapping sum is
    taken in any order and a sorting network may be any that sorts.

    Counted: int32 instructions (a three-input add or logic op counts
    once), of which ``alu_ops`` only the integer ALU executes (logic,
    shifts, compares, selects, min and max; adds and multiplies can also
    issue on the FMA pipe); fp32 operations; and bytes through the SM's
    shared memory / L1: a gather's words, each word of a value another
    thread holds (4 bytes written by its holder, 4 read by each thread that
    needs it), and a word of x read at an address that changes with the
    iteration (a word of x, or of a table of x, at a fixed address stays in
    a register). A dynamic register index is the cheaper of a select
    network and a shared-memory round trip. Block barriers, warp
    reductions, address arithmetic, the loop counter and its branch are
    not counted. Where the work depends on the data, the probe's cost is a
    function of x and the iteration count (the average per iteration)."""
    int_ops: float
    alu_ops: float = 0
    fp_ops: float = 0
    smem_bytes: float = 0


# shared-memory bytes of the lane minimum of one row to every thread of a
# block of 128, one a lane: the 4 warps' minima written (16 bytes), one
# thread reads the other 3 (12) and writes their minimum (4), the other 127
# read it (508), with 3 mins
ROW_MIN_BYTES = 540


class Probe(NamedTuple):
    name: str            # as the harness prints it
    body: Callable       # the plain version: body(acc, it, x) -> acc
    kid: int             # the kernel's probe id (the enum in csrc/micro_*.cu)
    cost: Union[Cost, Callable[[torch.Tensor, int], Cost]]  # or of (x, iters)


class Harness(NamedTuple):
    unit: str            # the module: "micro_ops", "micro_expand", "micro_v8"
    rows_in: int         # rows of x
    rows_acc: int        # rows of the carried tile
    mask: int            # the harness's x: arange & mask
    iters: int           # the harness's ITERS
    width: int           # the name's field width in the printed line


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def harness_x(h: Harness, device="cpu") -> torch.Tensor:
    """The harness's own x: ``arange(rows * 128).reshape(rows, 128) &
    mask``, which is the lane index in every row."""
    x = torch.arange(h.rows_in * LANE, dtype=I32, device=device)
    return (x.view(h.rows_in, LANE) & h.mask).contiguous()


def distinct_x(h: Harness, device="cpu") -> torch.Tensor:
    """x of the harness's shape with distinct rows: uniform int32 from
    ``numpy.random.default_rng(7)``."""
    rng = np.random.default_rng(DISTINCT_SEED)
    x = rng.integers(INT_MIN, INT_MAX + 1, size=(h.rows_in, LANE),
                     dtype=np.int32)
    return torch.from_numpy(x).to(device)


# ---------------------------------------------------------------------------
# int32 as XLA computes it
# ---------------------------------------------------------------------------

def wrap(v: torch.Tensor) -> torch.Tensor:
    """int64 values modulo 2**32, as int32."""
    v = v & 0xFFFFFFFF
    return (v - ((v >> 31) << 32)).to(I32)


def add(a, b) -> torch.Tensor:
    """a + b with int32 wrap-around (sums taken in int64)."""
    a = a.long() if torch.is_tensor(a) else a
    b = b.long() if torch.is_tensor(b) else b
    return wrap(a + b)


def sub(a, b) -> torch.Tensor:
    a = a.long() if torch.is_tensor(a) else a
    b = b.long() if torch.is_tensor(b) else b
    return wrap(a - b)


def mul(a, b) -> torch.Tensor:
    """a * b with int32 wrap-around: the int64 product of two int32 values
    is exact, and its low 32 bits are the int32 product's."""
    a = a.long() if torch.is_tensor(a) else a
    b = b.long() if torch.is_tensor(b) else b
    return wrap(a * b)


def sum_wrap(parts) -> torch.Tensor:
    """The wrapped sum of int32 tensors (exact in any order)."""
    s = 0
    for p in parts:
        s = s + p.long()
    return wrap(s)


def f2i(f: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: toward zero, saturated (values at
    or above 2**31 give INT_MAX, below -2**31 INT_MIN) and NaN -> 0."""
    d = torch.trunc(f.double()).clamp(INT_MIN, INT_MAX)
    return torch.where(torch.isnan(d), torch.zeros_like(d), d).to(I32)


def row_iota(rows: int, device) -> torch.Tensor:
    """broadcasted_iota(int32, (rows, 128), 0)."""
    return torch.arange(rows, dtype=I32, device=device)[:, None].expand(
        rows, LANE)


def lane_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis(src, idx, axis=1), idx in [0, 128)."""
    return torch.gather(src, 1, idx.long())


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis(src, idx, axis=0): out[r, l] = src[idx[r, l], l]."""
    return torch.gather(src, 0, idx.long())


def bcast_row(row: torch.Tensor, rows: int) -> torch.Tensor:
    """A (1, 128) row broadcast to (rows, 128)."""
    return row.expand(rows, LANE)


def tile_rows(t: torch.Tensor, reps: int) -> torch.Tensor:
    """``pltpu.repeat(t, reps, 0)``: the rows of t, ``reps`` times over
    (tiled, not each row repeated)."""
    return t.repeat(reps, 1)


# ---------------------------------------------------------------------------
# the plain loop
# ---------------------------------------------------------------------------

def run_plain(body: Callable, x: torch.Tensor, iters: int,
              rows_acc: int) -> torch.Tensor:
    """``fori_loop(0, iters, body, x[0:rows_acc] * 1)`` in torch ops."""
    acc = x[0:rows_acc].clone()
    for it in range(iters):
        acc = body(acc, it, x)
    return acc


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_ARGS = (ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p)


def check_input(h: Harness, x: torch.Tensor) -> None:
    """Raise unless x is the harness's (rows_in, 128) int32 tile,
    contiguous, on a CUDA device."""
    if x.dtype != I32:
        raise ValueError(f"{h.unit}: x must be int32, got {x.dtype}")
    if tuple(x.shape) != (h.rows_in, LANE):
        raise ValueError(f"{h.unit}: x must be ({h.rows_in}, {LANE}), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{h.unit}: x must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"{h.unit}: the kernel takes CUDA tensors only, "
                         f"got one on {x.device}")


def launch(h: Harness, p: Probe, x: torch.Tensor, iters: int) -> torch.Tensor:
    """Run probe ``p``'s kernel for ``iters`` iterations on x (one block on
    the current stream); returns the carried tile (rows_acc, 128)."""
    check_input(h, x)
    if iters < 0:
        raise ValueError("iters must be >= 0")
    out = torch.empty((h.rows_acc, LANE), dtype=I32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    entry = load("micro_cuda", h.unit, _ARGS)
    err = entry(p.kid, ctypes.c_void_p(x.data_ptr()), h.rows_in,
                ctypes.c_void_p(out.data_ptr()), iters,
                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{h.unit} kernel {p.kid} ({p.name}) launch "
                           f"failed: CUDA error {err}")
    LAUNCHES[f"{h.unit}:{p.name}"] += 1
    return out


def twin(h: Harness, p: Probe, x: torch.Tensor, iters: int,
         aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run probe ``p``'s kernel code compiled for the host (the g++ twin,
    ``csrc/micro_cpu.cpp``) for ``iters`` iterations on a CPU x; returns
    the carried tile. ``aux``, an int32 CPU tensor of one word a thread of
    the probe's block, receives each thread's copy of acc[0, 0] (the
    dynamic slices)."""
    if x.dtype != I32 or tuple(x.shape) != (h.rows_in, LANE):
        raise ValueError(f"{h.unit}: x must be ({h.rows_in}, {LANE}) int32")
    if x.device.type != "cpu":
        raise ValueError(f"{h.unit}: the twin takes CPU tensors only")
    x = x.contiguous()
    out = torch.empty((h.rows_acc, LANE), dtype=I32)
    entry = load("micro_twin", f"{h.unit}_twin", _ARGS[:5] + (
        ctypes.c_void_p,))
    err = entry(p.kid, ctypes.c_void_p(x.data_ptr()), h.rows_in,
                ctypes.c_void_p(out.data_ptr()), iters,
                ctypes.c_void_p(None if aux is None else aux.data_ptr()))
    if err != 0:
        raise RuntimeError(f"{h.unit} twin {p.kid} ({p.name}) refused")
    return out


def run(h: Harness, probes, name: str, x: Optional[torch.Tensor] = None,
        iters: Optional[int] = None, device=None) -> torch.Tensor:
    """The carried tile after ``iters`` (default: the harness's ITERS)
    iterations of probe ``name`` on x (default: the harness's x on
    ``device``, default the card): the kernel for a CUDA x, the plain
    version for a CPU x."""
    p = find(probes, name)
    iters = h.iters if iters is None else iters
    if x is None:
        x = harness_x(h, "cuda" if device is None else device)
    elif device is not None:
        x = x.to(device)
    if x.device.type == "cuda":
        return launch(h, p, x, iters)
    if x.device.type == "cpu":
        return run_plain(p.body, x, iters, h.rows_acc)
    raise ValueError(f"{h.unit}: no probe runs on {x.device}")


def find(probes, name: str) -> Probe:
    for p in probes:
        if p.name == name:
            return p
    raise KeyError(f"no probe named {name!r}")


# ---------------------------------------------------------------------------
# timing, bound, output
# ---------------------------------------------------------------------------

def cost_of(p: Probe, x: torch.Tensor, iters: int) -> Cost:
    """Probe ``p``'s cost per iteration on this x over ``iters``
    iterations."""
    return p.cost if isinstance(p.cost, Cost) else p.cost(x, iters)


def busiest(ids, group: int, bank):
    """Wavefronts of reads at ids (reads, 128 lanes; an id names one
    word, or 16 bytes, with bank ``bank[id]``, as many ids in each bank),
    taken ``group`` lanes at a time: per read and group, the most distinct
    ids in one bank, summed."""
    by_bank = np.argsort(bank, kind="stable")
    banks = int(bank.max()) + 1
    groups = np.broadcast_to(np.arange(LANE) // group, (4096, LANE))
    total = 0
    for c in range(0, ids.shape[0], 4096):
        chunk = ids[c:c + 4096]
        n = chunk.shape[0]
        seen = np.zeros((n, LANE // group, len(bank)), dtype=np.uint8)
        seen[np.arange(n)[:, None], groups[:n], chunk] = 1
        per_bank = seen[:, :, by_bank].reshape(n, LANE // group, banks, -1)
        total += int(per_bank.sum(3, dtype=np.int32).max(2).sum())
    return total


# per SM and clock on an H100 (sm_90): 64 results of the integer ALU, 128
# int32 results of the ALU and the FMA pipe together (IMAD), 128 fp32
# results, 128 bytes of shared memory / L1
ALU_PER_CLK = 64
INT_PER_CLK = 128
FP32_PER_CLK = 128
SMEM_BYTES_PER_CLK = 128


def measured_sm_clock_hz(cycles: int = 200_000_000) -> float:
    """The SM clock as the card runs it, in Hz: ``cycles`` clock64() cycles
    of one spinning thread over the global timer's ns, the timer CUDA
    events read (``micro_sm_clock`` in ``csrc/micro_ops.cu``)."""
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    entry = load("micro_cuda", "micro_sm_clock",
                 (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p))
    err = entry(ctypes.c_void_p(out.data_ptr()), cycles, ctypes.c_void_p(
        torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"micro_sm_clock launch failed: CUDA error {err}")
    counted, ns = out.tolist()
    return counted / ns * 1e9


def bound_ms(cost: Cost, iters: int, sm_clock_hz: float) -> Tuple[float, str]:
    """Least time of ``iters`` iterations on the one SM that runs the
    block: iters x the largest of ALU-only instructions / 64, int32
    instructions / 128, fp32 operations / 128 and shared-memory bytes / 128
    per clock, over the SM clock. Returns (ms, "operations" or "bytes")."""
    ops_clk = max(cost.alu_ops / ALU_PER_CLK, cost.int_ops / INT_PER_CLK,
                  cost.fp_ops / FP32_PER_CLK)
    smem_clk = cost.smem_bytes / SMEM_BYTES_PER_CLK
    ms = iters * max(ops_clk, smem_clk) / sm_clock_hz * 1e3
    return ms, ("bytes" if smem_clk > ops_clk else "operations")


def main(h: Harness, probes, argv=None, doc: str = "") -> int:
    """Run every probe at ``--iters`` on the harness's x and print the
    harness's line: its name, then ns per iteration (``--device cpu``: the
    plain versions, host clock)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0] if doc
                                 else h.unit)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=h.iters)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu for the plain versions",
              file=sys.stderr)
        return 2
    x = harness_x(h, dev)
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0))
    else:
        print("CPU: the plain versions, host clock")
    for p in probes:
        ms, _ = time_call(lambda: run(h, probes, p.name, x, args.iters),
                          cuda=dev.type == "cuda")
        ns = ms * 1e6 / max(args.iters, 1)
        print(f"{p.name:{h.width}s} {ns:8.1f} ns/iter", flush=True)
    return 0
