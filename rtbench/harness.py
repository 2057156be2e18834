"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

The window is a closed loop with one caller, as a renderer that calls
``rtcIntersect`` and waits: each call takes the next batch of the pool and
is synchronized before the next one starts; the window closes with the
first call that ends ``seconds`` after it opened. Each call's answers on
its batch's sampled rays are copied aside after its synchronize, and
synchronized again, outside its call time (``rtbench.sample``), and
compared once the window has closed, the peak memory has been read and the
program's scene has been freed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

import torch

from rtbench import compare, least_bytes, traffic
from rtbench import trace as trace_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "embree_tpu")
WARM_CALLS = 2
SPAN = trace_mod.SPAN


@dataclasses.dataclass
class Reading:
    """What the metric readers read (``metrics/<name>.py``)."""
    setup_s: float
    commit_s: float
    calls: int
    rays_per_call: int
    window_s: float
    call_s: List[float]
    least_bytes: int
    device_kind: str
    trace: Optional[trace_mod.Trace]


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(workload: str, rehearsal: bool = False) -> dict:
    """The cell's entry, its configuration, mix, limits and the modules
    they name, by name. ``rehearsal``: the configuration's and the mix's
    small sizes, for a run on the CPU."""
    bench = load_json(ROOT, "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = load_json(ROOT, entry["file"])
    mix = traffic.load(w["traffic"])
    if rehearsal:
        mix = dict(mix, rays={**mix["rays"], **mix["rehearsal"]})
    return {"bench": bench, "workload": w, "config": cfg, "mix": mix,
            "limits": load_json(HERE, "limits", f"{workload}.json"),
            "sizes": cfg["rehearsal"] if rehearsal else cfg["sizes"],
            "scene": importlib.import_module(
                f"rtbench.scenes.{cfg['scene']}"),
            "reference": importlib.import_module(
                f"rtbench.reference.{cfg['reference']}"),
            "answer": traffic.answer_kind(mix)}


def metric_entries(bench: dict, workload: str, traced: bool):
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def entry_for(pt, mix: dict):
    """The call each request makes, by the mix's answer kind."""
    return traffic.answer_kind(mix).call(pt, mix.get("kwargs", {}))


class Copies:
    """Each call's answers on its batch's sampled rays, copied with
    ``index_select(out=...)`` into rows of buffers allocated ``ROWS`` calls
    at a time, in a memory pool of their own on the card: the window
    allocates once in ``ROWS`` calls, and the buffers hold no block that
    the program's next call would reuse."""

    ROWS = 256

    def __init__(self, ans, idx, like):
        self.ans, self.idx, self.chunks, self.calls = ans, idx, [], []
        self.like = ans.fields(like)
        cuda = next(iter(self.like.values())).is_cuda
        self.pool = torch.cuda.MemPool() if cuda else None

    def _chunk(self):
        s = self.idx[0].shape[0]
        with (torch.cuda.use_mem_pool(self.pool) if self.pool is not None
              else contextlib.nullcontext()):
            return {k: torch.empty((self.ROWS, s) + tuple(x.shape[1:]),
                                   dtype=x.dtype, device=x.device)
                    for k, x in self.like.items()}

    def take(self, out, b: int):
        k = len(self.calls)
        if k == len(self.chunks) * self.ROWS:
            self.chunks.append(self._chunk())
        rows = self.chunks[k // self.ROWS]
        for n, x in self.ans.fields(out).items():
            torch.index_select(x, 0, self.idx[b], out=rows[n][k % self.ROWS])
        self.calls.append(b)

    def taken(self):
        """(batch, answers) of every call."""
        for k, b in enumerate(self.calls):
            rows = self.chunks[k // self.ROWS]
            yield b, {n: x[k % self.ROWS] for n, x in rows.items()}


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return r.stdout.strip().replace("\n", "; ")


def ptxas_lines(logs: dict) -> List[str]:
    out = []
    for name, log in sorted(logs.items()):
        out += [f"{name}: {ln.strip()}" for ln in log.splitlines()
                if "registers" in ln
                or ("spill" in ln and " 0 bytes spill stores" not in ln)]
    return out[:40]


def reference_answers(ans, ref_mod, arrays, pool, idx, device, dtype):
    """The plain reference's answers on every batch's sampled rays."""
    prep = ref_mod.prepare(arrays, device)
    return [ans.reference(ref_mod, prep, rays, i, dtype)
            for rays, i in zip(pool, idx)]


def judge_calls(ans, taken, refs, limits: dict):
    """``taken``: (batch, answers) of every call."""
    return compare.judge([ans.numbers(got, refs[b]) for b, got in taken],
                         limits)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(workload: str, seed: int, seconds: float, traced: bool, t0: float,
        device: str = "cuda", rehearsal: bool = False, out=None,
        err=None) -> int:
    """Runs the cell once and prints its line; returns the exit code.
    ``rehearsal``: the configuration's and the mix's small sizes, for a run
    on the CPU."""
    out = out or sys.stdout
    err = err or sys.stderr
    spec = cell(workload, rehearsal)
    mix, lim, ans = spec["mix"], spec["limits"], spec["answer"]
    ref_mod, scene_mod = spec["reference"], spec["scene"]
    chips = spec["workload"]["chips"]
    import embree_tpu_torch as pt
    from embree_tpu_torch import _build
    from embree_tpu_torch.accel import traverse as tr

    arrays = scene_mod.generate(spec["sizes"], seed)
    scene = scene_mod.attach(pt, arrays)
    sync(device)
    c0 = time.perf_counter()
    cs = scene.commit(device=device)
    sync(device)
    commit_s = time.perf_counter() - c0
    del scene
    pool = traffic.make_pool(mix, seed, device, pt)
    n = traffic.n_rays(mix)
    idx = traffic.sample(n, lim["sample_per_batch"], len(pool), seed, device)
    call = entry_for(pt, mix)
    for k in range(WARM_CALLS):
        warm = call(cs, pool[k % len(pool)])
        sync(device)
    q_bytes = least_bytes.query_bytes(pool[0], warm, arrays)
    # the first rows and the copy's kernels load here, not in the window
    copies = Copies(ans, idx, warm)
    copies.take(warm, 0)
    copies.calls.clear()
    sync(device)
    del warm
    tr.reset_launch_counts()
    gc.collect()
    setup_s = time.perf_counter() - t0

    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    span = (torch.profiler.record_function if traced
            else lambda name: contextlib.nullcontext())
    call_s = []
    with prof if prof is not None else contextlib.nullcontext():
        with span(trace_mod.WINDOW):
            w0 = time.perf_counter()
            k = 0
            while True:
                with span(SPAN + "pick"):
                    b = k % len(pool)
                    rays = pool[b]
                a = time.perf_counter()
                with span(SPAN + "call"):
                    res = call(cs, rays)
                with span(SPAN + "sync"):
                    sync(device)
                e = time.perf_counter()
                call_s.append(e - a)
                with span(trace_mod.SAMPLE):
                    copies.take(res, b)
                    sync(device)
                del res
                k += 1
                if e - w0 >= seconds:
                    break
    window_s = e - w0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    launches = dict(tr.LAUNCHES)
    bad = forbidden_modules()
    if bad:
        print(f"rtbench: modules loaded in the run: {', '.join(bad)}",
              file=err)
        return 3
    tr_data = trace_mod.from_profiler(prof) if prof is not None else None
    del cs, call, prof
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    r0 = time.perf_counter()
    refs = reference_answers(ans, ref_mod, arrays, pool, idx, device,
                             torch.float64)
    sync(device)
    ref_s = time.perf_counter() - r0
    numbers, failed = judge_calls(ans, copies.taken(), refs,
                                  lim["limits"])
    correct = failed == 0 and all(numbers[k] <= v
                                  for k, v in lim["limits"].items())

    kind = (torch.cuda.get_device_name(0) if device == "cuda"
            else "cpu rehearsal")
    reading = Reading(setup_s, commit_s, len(call_s), n, window_s, call_s,
                      q_bytes, kind, tr_data)
    metrics = {}
    for m in metric_entries(spec["bench"], workload, traced):
        mod = importlib.import_module(f"rtbench.metrics.{m['name']}")
        v = mod.read(reading)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": chips, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": len(call_s), "failed": failed,
            "metrics": metrics, "device": dev}
    if tr_data is not None and tr_data.device:
        dev["busy_s"] = trace_mod.busy_s(tr_data)
        dev["window_s"] = tr_data.window_s
        line["breakdown"] = trace_mod.breakdown(tr_data)
    line["checks"] = {k: {"value": numbers[k], "limit": v}
                      for k, v in lim["limits"].items()}

    print(f"# rtbench {workload} seed {seed}: {kind}; "
          f"{power_limit() if device == 'cuda' else 'no card'}; "
          f"torch {torch.__version__}", file=out)
    print(f"# launches in the window: {json.dumps(launches)}", file=out)
    for ln in ptxas_lines(_build.BUILD_LOGS):
        print(f"# ptxas {ln}", file=out)
    print(f"# setup {setup_s:.3f} s (commit {commit_s:.3f} s), window "
          f"{window_s:.3f} s, {len(call_s)} calls of {n} rays, least bytes "
          f"{q_bytes} a call; reference {ref_s:.3f} s", file=out)
    for k, v in lim["limits"].items():
        print(f"check {k} {numbers[k]!r} limit {v!r}", file=err)
    print(json.dumps(line), file=out, flush=True)
    return 0
