"""BENCHMARK.json keeps to the form its checker takes, and every name in it
finds its files."""
import json
import os
import re

import pytest

from rtbench import harness

ROOT = harness.ROOT
PATH = os.path.join(ROOT, "BENCHMARK.json")
BENCH = harness.load_json(PATH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert os.path.getsize(PATH) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert os.path.isdir(os.path.join(ROOT, p)) and ".." not in p
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    for w in cmd:
        assert not w.startswith("/") and ".." not in w
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w.startswith(p + "/") for p in BENCH["paths"])


def test_run_seconds_fit_the_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert list(c) == ["name", "source", "file", "reduced", "why"]
        assert NAME.match(c["name"]) and c["name"] in used
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = harness.load_json(ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in ("scene", "reference"):
            assert os.path.exists(os.path.join(
                harness.HERE, {"scene": "scenes"}.get(k, k),
                f"{cfg[k]}.py"))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def test_workloads():
    ws = BENCH["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert list(w) == ["name", "config", "traffic", "chips", "why"]
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        spec = harness.cell(w["name"])
        assert spec["mix"]["name"] == w["traffic"]
        assert set(spec["limits"]["limits"]) <= set(spec["answer"].NUMBERS)


def test_metrics():
    e2e, layers = BENCH["end_to_end"], BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    names = [m["name"] for m in e2e + layers]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in [m["name"] for m in e2e]
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert m["moves"] in [x["name"] for x in e2e]
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(w):
    e2e = [m["name"] for m in harness.metric_entries(BENCH, w, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metric_entries(BENCH, w, True)
