"""The traced window: ``torch.profiler`` events turned into device ops,
host spans and the ``breakdown`` of a ``--trace 1`` line.

**Which device ops are PyTorch's own.** A device op (a kernel, a memcpy or
a memset) belongs to PyTorch when its name is of one of PyTorch's own
families: ATen's kernels (``at::``, ``at_cuda_detail::``), the CUB and
Thrust kernels ATen calls (``cub::``, ``thrust::``), c10's, and the
``Memcpy``/``Memset`` copies. Every other device op is one of the port's
hand-written kernels. The rule names no kernel of the port, so a kernel
that a later change renames or adds counts with the port's. The copies
that the harness makes of the sampled answers are not device ops of the
query: ``from_profiler`` leaves them out, so that their time reads as
idle.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import List, Optional, Tuple

TORCH_FAMILIES = ("at::", "at_cuda_detail::", "cub::", "thrust::", "c10::")
COPIES = ("Memcpy", "Memset", "memcpy", "memset")
SPAN = "rtbench."
WINDOW = SPAN + "window"
SAMPLE = SPAN + "sample"
TOP = 10


def is_torch_op(name: str) -> bool:
    return name.startswith(COPIES) or any(f in name for f in TORCH_FAMILIES)


def _on(e, device: str) -> bool:
    return str(e.device_type()).endswith(device)


def _device_op(e) -> bool:
    """A kernel, copy or set on the card: not the harness's spans, which
    the profiler mirrors onto the card's timeline."""
    return (_on(e, "CUDA") and not e.name().startswith(SPAN)
            and not getattr(e, "is_user_annotation", lambda: False)())


@dataclasses.dataclass
class Trace:
    """Times in ns of one clock. ``device``: (name, start, end) of every
    device op in the window; ``host``: (name, start, end) of the events on
    the harness's thread; ``window``: (start, end)."""
    device: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int]]
    window: Tuple[int, int]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def _inside(t: int, spans: List[Tuple[int, int]]) -> bool:
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def from_profiler(prof) -> Optional[Trace]:
    """The window's events; None where the trace has no window span. The
    device ops that the harness itself launches, inside its ``SAMPLE``
    spans (the copies of the sampled answers), are left out: they are
    found by the correlation id of the CUDA runtime call that launched
    them."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW and _on(e, "CPU")]
    if not win:
        return None
    w = win[0]
    w0, w1 = w.start_ns(), w.start_ns() + w.duration_ns()
    tid = w.start_thread_id()
    mine = [e for e in events
            if _on(e, "CPU") and e.start_thread_id() == tid]
    samples = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in mine if e.name() == SAMPLE)
    harness_ops = {e.correlation_id() for e in mine
                   if e.name().startswith("cuda") and e.correlation_id()
                   and _inside(e.start_ns(), samples)}
    device, host = [], []
    for e in events:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if b < w0 or a > w1:
            continue
        if _device_op(e):
            if e.correlation_id() not in harness_ops:
                device.append((e.name(), a, b))
        elif _on(e, "CPU") and e.start_thread_id() == tid:
            host.append((e.name(), a, b))
    device.sort(key=lambda x: x[1])
    host.sort(key=lambda x: (x[1], -x[2]))
    return Trace(device, host, (w0, w1))


def busy_intervals(tr: Trace) -> List[Tuple[int, int]]:
    """The union of the device ops' intervals, clipped to the window."""
    out: List[List[int]] = []
    w0, w1 = tr.window
    for _, a, b in tr.device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr)) / 1e9


def idle_gaps(tr: Trace) -> List[Tuple[int, int]]:
    gaps, t = [], tr.window[0]
    for a, b in busy_intervals(tr):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if tr.window[1] > t:
        gaps.append((t, tr.window[1]))
    return gaps


def host_at(tr: Trace, times: List[int]) -> List[str]:
    """For each time (ascending), what the host was doing: the harness span
    around it and the innermost host event, "span / event"."""
    out, stack, i = [], [], 0
    for q in times:
        while i < len(tr.host) and tr.host[i][1] <= q:
            ev = tr.host[i]
            while stack and stack[-1][2] <= ev[1]:
                stack.pop()
            stack.append(ev)
            i += 1
        while stack and stack[-1][2] <= q:
            stack.pop()
        names = [e[0] for e in stack]
        span = next((n for n in reversed(names) if n.startswith(SPAN)
                     and n != WINDOW), "rtbench.loop")
        inner = names[-1] if names else span
        out.append(span if inner == span else f"{span} / {inner}")
    return out


def breakdown(tr: Trace) -> dict:
    """The device ops that took the most time, by name, and the idle time
    by what the host was doing, at most ``TOP`` each, seconds."""
    ops = collections.Counter()
    for name, a, b in tr.device:
        ops[name] += (b - a) / 1e9
    gaps = idle_gaps(tr)
    labels = host_at(tr, [(a + b) // 2 for a, b in gaps])
    idle = collections.Counter()
    for (a, b), lab in zip(gaps, labels):
        idle[lab] += (b - a) / 1e9
    return {"device_ops": [[n[:160], s] for n, s in ops.most_common(TOP)],
            "idle_gaps": [[n[:160], s] for n, s in idle.most_common(TOP)]}


def device_s(tr: Trace, torch_ops: bool) -> float:
    """Device seconds of PyTorch's own ops (or of every other op)."""
    return sum(b - a for n, a, b in tr.device
               if is_torch_op(n) == torch_ops) / 1e9

