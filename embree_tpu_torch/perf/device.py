"""What the harnesses of this package share on the card: the loader of the
built kernel libraries, one count of kernel launches, CUDA-event timing,
and the card's name and power limit.

Every wrapper that launches a kernel of ``perf/`` adds one to its entry of
``LAUNCHES`` where it launches it and nowhere else; the ablations count by
variant name, the loop probes by ``<harness>:<probe name>``.
"""
from __future__ import annotations

import collections
import ctypes
import statistics
import subprocess
import threading
import time
from typing import Callable, Dict, Sequence

import torch

from .. import _build

REPS = 5                 # timed windows after a warm-up, median
BATCH = 5                # calls in a timed window on the card
SPIN_CYCLES = 2_000_000  # the spin kernel ahead of a window (~1 ms)

# Kernel launches by name, counted where a kernel is launched and nowhere
# else.
LAUNCHES: Dict[str, int] = collections.defaultdict(int)

_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (the first card)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def load(target: str, fn: str, argtypes: Sequence):
    """Function ``fn`` of the built library ``target`` (``_build.ensure``
    builds it when it is missing or stale), returning a C int."""
    with _libs_lock:
        if target not in _libs:
            _libs[target] = ctypes.CDLL(_build.ensure(target))
        f = getattr(_libs[target], fn)
        f.restype = ctypes.c_int
        f.argtypes = list(argtypes)
        return f


def time_call(fn: Callable, reps: int = REPS, cuda: bool = True,
              batch: int = BATCH):
    """Median ms of a call over ``reps`` timed windows after one warm-up;
    returns (ms, the last call's result). On the card a window is CUDA
    events around ``batch`` calls queued behind a spin kernel
    (``torch.cuda._sleep``), so the host's launch work never idles the card
    inside it; on the CPU one call on the host clock (a CPU time, not a
    device metric)."""
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            for _ in range(batch):
                out = fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / batch)
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out
