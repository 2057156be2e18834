"""The comparison fails what it must: the control (the plain reference in
bfloat16 in the program's place), and a run whose timed path is broken
underneath, once for each fault a cell can have (one chip: no exchange
between chips to leave out)."""
import io
import json
import time

import pytest
import torch

from rtbench import control, harness

from test_rtbench_runs import CELLS, SEED


def broken(fault):
    real = harness.entry_for

    def entry_for(pt, mix):
        call = real(pt, mix)
        first = {}
        mask = mix["answer"] == "mask"

        def stale(cs, rays):
            """The first answer, returned again for every later call."""
            if "r" not in first:
                first["r"] = call(cs, rays)
            return first["r"]

        def half(cs, rays):
            """The second half of the batch left out: answered as
            misses."""
            n = rays.shape[0]
            k = n // 2
            part = type(rays)(*(getattr(rays, f)[:k] for f in
                                ("org", "dir", "tnear", "tfar", "time",
                                 "mask")))
            got = call(cs, part)
            if mask:
                return torch.cat([got, torch.zeros(n - k, dtype=torch.bool)])
            miss = pt.make_miss_hits((n - k,), device="cpu")
            return type(got)(*(torch.cat([getattr(got, f),
                                          getattr(miss, f)])
                               for f in ("t", "u", "v", "ng", "prim_id",
                                         "geom_id", "inst_id")))

        def altered(cs, rays):
            """Answers altered where they are produced: every 16th hit's
            primitive id off by one; every 16th any-hit answer flipped."""
            got = call(cs, rays)
            if mask:
                got = got.clone()
                got[::16] = ~got[::16]
                return got
            hits = torch.nonzero(got.geom_id != 0xFFFFFFFF)[::16, 0]
            got.prim_id[hits] += 1
            return got
        return {"stale": stale, "half": half, "altered": altered}[fault]
    return entry_for


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    monkeypatch.setattr(harness, "entry_for", broken(fault))
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, SEED, 0.3, False, time.perf_counter(),
                     device="cpu", rehearsal=True, out=out, err=err)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert rc == 0
    assert line["correct"] is False and line["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """bfloat16 in the program's place fails one of the cell's numbers on
    each of three seeds."""
    lim = harness.cell(workload)["limits"]["limits"]
    for seed in (SEED, 11, 12):
        r = control.control_numbers(workload, seed, device="cpu",
                                    rehearsal=True)
        assert r["failed_batches"] >= 1
        assert any(r["numbers"][k] > v for k, v in lim.items())


@pytest.mark.parametrize("workload", CELLS)
def test_reference_in_float32_is_correct(workload):
    """The reference is not the control's only failure: the same reference
    in the configuration's own float32 passes."""
    lim = harness.cell(workload)["limits"]["limits"]
    r = control.control_numbers(workload, SEED, device="cpu",
                                rehearsal=True, dtype=torch.float32)
    assert r["failed_batches"] == 0
    assert all(r["numbers"][k] <= v for k, v in lim.items())
