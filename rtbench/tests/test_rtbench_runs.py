"""The whole harness at the configurations' and mixes' small sizes on the
CPU, with the kernels' plain versions; and the command's refusals."""
import contextlib
import glob
import io
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from rtbench import harness, traffic

ROOT = harness.ROOT
BENCH = harness.load_json(ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 977          # more than 32 signed bits hold


def run_cell(workload, traced=False, seed=SEED, seconds=0.3):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, seed, seconds, traced, time.perf_counter(),
                     device="cpu", rehearsal=True, out=out, err=err)
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_rehearsal_prints_the_line(workload, traced):
    rc, out, err = run_cell(workload, traced)
    assert rc == 0
    line = json.loads(out[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    # a CPU run names its device: no device metric comes from it
    assert line["device"]["platform"] == "cpu"
    assert "busy_s" not in line["device"]
    want = [m["name"] for m in harness.metric_entries(BENCH, workload,
                                                      traced)]
    if traced:       # no device trace here: the host's commit_s alone
        assert set(line["metrics"]) == {"commit_s"}
    else:
        assert set(line["metrics"]) == set(want)
    for m in line["metrics"].values():
        assert m["value"] > 0
    # every compared number beside its limit, last on standard error
    checks = line["checks"]
    assert err[-len(checks):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}"
        for k, v in checks.items()]


def test_every_config_and_mix_file_generates():
    """Each configuration and mix file found by name makes its scene and
    its pool at the small sizes, the same for the same seed."""
    import importlib
    import embree_tpu_torch as pt
    for f in sorted(glob.glob(os.path.join(harness.HERE, "configs",
                                           "*.json"))):
        cfg = harness.load_json(f)
        mod = importlib.import_module(f"rtbench.scenes.{cfg['scene']}")
        importlib.import_module(f"rtbench.reference.{cfg['reference']}")
        a, b = (mod.generate(cfg["rehearsal"], SEED) for _ in range(2))
        assert all(
            (a[k] == b[k]).all() for k in ("vertices", "indices"))
        assert isinstance(cfg["reduced"], list) and cfg["chips"] in (1, 4)
    for f in sorted(glob.glob(os.path.join(harness.HERE, "traffic",
                                           "*.json"))):
        mix = harness.load_json(f)
        mix = dict(mix, rays={**mix["rays"], **mix["rehearsal"]})
        p, q = (traffic.make_pool(mix, SEED, "cpu", pt) for _ in range(2))
        assert len(p) == mix["batches"]
        n = traffic.n_rays(mix)
        for x, y in zip(p, q):
            assert x.shape == (n,)
            assert torch.equal(x.org, y.org) and torch.equal(x.dir, y.dir)
        assert not torch.equal(p[0].dir, p[1].dir)
        assert callable(traffic.answer_kind(mix).call(pt, mix["kwargs"]))


def test_seeds_change_values_not_sizes():
    import embree_tpu_torch as pt
    mix = traffic.load("incoherent_intersect")
    mix = dict(mix, rays={**mix["rays"], **mix["rehearsal"]})
    a = traffic.make_pool(mix, 1, "cpu", pt)[0]
    b = traffic.make_pool(mix, 2, "cpu", pt)[0]
    assert a.shape == b.shape and not torch.equal(a.org, b.org)
    assert float(a.org.min()) >= -1 and float(a.org.max()) < 1


def test_run_refuses_without_the_cards():
    """The command prints no result and exits non-zero without a card."""
    r = subprocess.run([sys.executable, "rtbench/run.py", "--workload",
                        CELLS[0], "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and rtbench/ is no run."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "rtbench/run.py", "--workload",
                        CELLS[0], "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_refuses_where_jax_was_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["os"])
    rc, out, err = run_cell(CELLS[0])
    assert rc != 0 and out == []
    assert "jax" in err[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload):
    """One short window of the cell at its own sizes, correct."""
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, SEED, 2.0, False, time.perf_counter(),
                     out=out, err=err)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu"
