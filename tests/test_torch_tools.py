"""The port's tools against the JAX package's (tools/benchdb.py,
tools/buildbench.py, tools/info.py, tools/viewer.py's command line), on
the CPU and in-process: the JAX tools run on JAX's CPU backend.

- benchdb: the same sequence of ``record`` calls on both packages, into
  two files, gives the same verdicts and the same JSON but for the
  timestamps; the listing prints the same lines; ``--reset`` clears this
  machine in both.
- buildbench: ``make_mesh`` bit-equal; ``bench_scene`` at 2,000 tris
  returns the three modes; ``main`` records its 9 figures of one size.
- info: ``--cpu`` prints the same ten property lines as the JAX tool.
- viewer: ``main`` with ``--cpu --golden`` passes on cube/eyelight at the
  golden's size, writes its outputs, and fails a threshold below the
  wrong-pixel count.
"""
import json
import os

import numpy as np
import pytest

from embree_tpu_torch.tools import benchdb, buildbench, info, viewer
from test_torch_round import one_thread  # noqa: F401 (module-wide autouse)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

# (name, value, keyword arguments): new entries, a better score, a
# regression, scores where lower is better, a tolerance of its own
RECORDS = [("rays", 10.0, dict(unit="Mrays/s")),
           ("rays", 12.0, dict(unit="Mrays/s")),
           ("rays", 10.5, dict(unit="Mrays/s")),
           ("rays", 11.5, dict(unit="Mrays/s")),
           ("build", 5.0, dict(unit="s", higher_is_better=False)),
           ("build", 4.0, dict(unit="s", higher_is_better=False)),
           ("build", 6.0, dict(unit="s", higher_is_better=False)),
           ("rays", 11.0, dict(unit="Mrays/s", tolerance=0.05))]


def _no_timestamps(path):
    db = json.loads(open(path).read())
    for machine in db.values():
        for entry in machine.values():
            assert entry.pop("timestamp") > 0
    return db


def test_benchdb_matches_jax(tmp_path, capsys):
    from embree_tpu.tools import benchdb as jdb
    mine, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    got = [benchdb.record(n, v, path=mine, **kw) for n, v, kw in RECORDS]
    want = [jdb.record(n, v, path=theirs, **kw) for n, v, kw in RECORDS]
    assert got == want
    assert [v["regression"] for v in got] == [False, False, True, False,
                                              False, False, True, True]
    assert benchdb._machine_key() == jdb._machine_key()
    assert _no_timestamps(mine) == _no_timestamps(theirs)
    # the files themselves, timestamps aside, byte for byte
    a = json.loads(open(mine).read())
    b = json.loads(open(theirs).read())
    for db in (a, b):
        for m in db.values():
            for e in m.values():
                e["timestamp"] = 0
    assert json.dumps(a, indent=1, sort_keys=True) \
        == json.dumps(b, indent=1, sort_keys=True)

    capsys.readouterr()
    benchdb.main(["--path", mine])
    listing = capsys.readouterr().out
    jdb.main(["--path", theirs])
    assert listing == capsys.readouterr().out
    assert "rays" in listing and "(5 runs)" in listing

    benchdb.main(["--path", mine, "--reset"])
    jdb.main(["--path", theirs, "--reset"])
    assert json.loads(open(mine).read()) == json.loads(open(theirs).read()) \
        == {}


def test_benchdb_env_path(tmp_path, monkeypatch):
    path = tmp_path / "env.json"
    monkeypatch.setenv("EMBREE_TPU_BENCH_DB", str(path))
    assert benchdb.record("x", 1.0)["best"] == 1.0
    assert "x" in json.loads(path.read_text())[benchdb._machine_key()]


@pytest.mark.parametrize("n", [1, 2, 7, 2000, 10001])
def test_make_mesh_bit_equal(n):
    from embree_tpu.tools.buildbench import make_mesh
    for a, b in zip(buildbench.make_mesh(n), make_mesh(n)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_bench_scene_modes():
    from embree_tpu_torch.scene import BuildQuality
    r = buildbench.bench_scene(2000, BuildQuality.MEDIUM, 1, device="cpu")
    assert set(r) == {"create", "update", "refit"}
    assert all(np.isfinite(v) and v > 0 for v in r.values())


def test_buildbench_main_records(tmp_path, monkeypatch, capsys):
    path = tmp_path / "scores.json"
    monkeypatch.setenv("EMBREE_TPU_BENCH_DB", str(path))
    out = buildbench.main(["--cpu", "--sizes", "2000", "--iters", "1"])
    assert sorted(out) == [(2000, "high"), (2000, "low"), (2000, "medium")]
    scores = json.loads(path.read_text())[benchdb._machine_key()]
    assert sorted(scores) == sorted(
        f"build_{m}_{q}_2000" for m in ("create", "update", "refit")
        for q in ("low", "medium", "high"))
    assert all(e["unit"] == "Mprims/s" for e in scores.values())
    assert "(Mprims/s)" in capsys.readouterr().out


def _properties(text):
    lines = text.splitlines()
    at = lines.index("properties (rtcGetDeviceProperty analog)")
    return lines[at + 1:]


def test_info_properties_match_jax(capsys):
    from embree_tpu.tools import info as jinfo
    info.main(["--cpu"])
    mine = capsys.readouterr().out
    jinfo.main(["--cpu"])
    theirs = capsys.readouterr().out
    assert len(_properties(mine)) == 10
    assert _properties(mine) == _properties(theirs)
    assert "stack capacity      : 64 refs/ray" in mine
    assert "native C++ builder  : available" in mine


def test_info_launch_shape():
    block, min_blocks, b6 = info.launch_shape()
    assert block % 32 == 0 and min_blocks >= 1 and b6 >= 1


@pytest.mark.parametrize("shader", ["eyelight", "primID"])
def test_viewer_main_golden(shader, tmp_path, capsys):
    from embree_tpu_torch.utils.image import load_pfm
    golden = os.path.join(GOLDEN, f"cube_{shader}.pfm")
    size = load_pfm(golden).shape[0]
    args = ["--cpu", "--scene", "cube", "--shader", shader, "--size",
            str(size), "--golden", golden]
    assert viewer.main(args + ["--out", str(tmp_path / "a.png"),
                               "--save-golden",
                               str(tmp_path / "g.pfm")]) == 0
    out = capsys.readouterr().out
    assert "COMPARE PASS" in out
    assert (tmp_path / "a.png").exists()
    assert load_pfm(str(tmp_path / "g.pfm")).shape == (size, size, 3)
    # the image the viewer saved passes against itself, and a threshold
    # below a wrong image's count fails
    assert viewer.main(["--cpu", "--scene", "sphere", "--shader", shader,
                        "--size", str(size), "--golden", golden,
                        "--compare-threshold", "0", "--benchmark",
                        "1"]) == 1
    out = capsys.readouterr().out
    assert "COMPARE FAIL" in out and "BENCHMARK sphere/" in out


def test_viewer_main_unknown_scene():
    with pytest.raises(SystemExit):
        viewer.main(["--cpu", "--scene", "teapot"])
