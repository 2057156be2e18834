"""Per-machine benchmark score database with regression detection.

Port of embree_tpu/tools/benchdb.py, same JSON format and rules (the
reference's verify-tool database, tutorials/verify/verify.cpp:453-517):
every run is compared against the best score this machine has produced;
a run below best * (1 - tolerance) is a REGRESSION. Scores persist in a
JSON file keyed by (hostname, device name, benchmark name), so machines
and cards never share a baseline. The file is ``EMBREE_TPU_BENCH_DB``
(read at each call) or ``.benchscores.json`` at the repository root.

Usage:
    from embree_tpu_torch.tools.benchdb import record
    verdict = record("incoherent_rays", 12.3, unit="Mrays/s")
    # verdict: {"best": ..., "regression": bool, "improved": bool}

    python -m embree_tpu_torch.tools.benchdb            # list scores
    python -m embree_tpu_torch.tools.benchdb --reset    # clear this machine
"""
from __future__ import annotations

import json
import os
import platform
import time
from typing import Optional

from ..perf.device import ROOT

DEFAULT_PATH = os.path.join(ROOT, ".benchscores.json")
TOLERANCE = 0.10      # >10% below the best score => regression


def db_path() -> str:
    return os.environ.get("EMBREE_TPU_BENCH_DB", DEFAULT_PATH)


def _machine_key() -> str:
    """``host::card`` (the CUDA device's name, spaces as underscores), or
    ``host::cpu`` without a card."""
    import torch
    dev = "cpu"
    if torch.cuda.is_available():
        dev = torch.cuda.get_device_name(0).replace(" ", "_")
    return f"{platform.node()}::{dev}"


def _load(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def record(name: str, value: float, unit: str = "",
           higher_is_better: bool = True, path: Optional[str] = None,
           tolerance: float = TOLERANCE) -> dict:
    """Record a benchmark result; returns the verdict against the stored
    best. The best only moves in the improving direction (verify.cpp keeps
    per-machine maxima); a regression run is kept in ``last`` but does not
    lower the bar."""
    path = path or db_path()
    db = _load(path)
    machine = db.setdefault(_machine_key(), {})
    entry = machine.setdefault(name, {})
    best = entry.get("best")
    better = (best is None or
              (value > best if higher_is_better else value < best))
    worse_frac = 0.0
    if best:
        worse_frac = ((best - value) / best if higher_is_better
                      else (value - best) / best)
    regression = best is not None and worse_frac > tolerance
    if better:
        entry["best"] = value
    entry["last"] = value
    entry["unit"] = unit
    entry["higher_is_better"] = higher_is_better
    entry["timestamp"] = time.time()
    entry["runs"] = entry.get("runs", 0) + 1
    try:
        with open(path, "w") as f:
            json.dump(db, f, indent=1, sort_keys=True)
    except OSError:
        pass
    return {"best": entry["best"], "regression": bool(regression),
            "improved": bool(better and best is not None)}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default=None,
                    help="the score file (default: EMBREE_TPU_BENCH_DB or "
                         ".benchscores.json at the repository root)")
    ap.add_argument("--reset", action="store_true",
                    help="clear this machine's scores")
    args = ap.parse_args(argv)
    path = args.path or db_path()
    db = _load(path)
    if args.reset:
        db.pop(_machine_key(), None)
        with open(path, "w") as f:
            json.dump(db, f, indent=1, sort_keys=True)
        print(f"cleared {_machine_key()}")
        return
    for mk, scores in db.items():
        print(mk)
        for name, e in sorted(scores.items()):
            print(f"  {name:30s} best {e.get('best'):>10.3f} "
                  f"last {e.get('last'):>10.3f} {e.get('unit','')} "
                  f"({e.get('runs', 0)} runs)")


if __name__ == "__main__":
    main()
