"""The port's examples against the JAX package's (examples/*.py).

The JAX examples parse ``sys.argv`` when imported, so they run only in
reference subprocesses (``torch_jaxref.run``), two started together:
"renders" runs the triangle demo at 32^2 and the path-tracer demo at 16^2,
2 spp, through ``runpy`` with their own command lines, keeps their printed
lines and images, records the arrays of the path tracer's scene as the
JAX example builds them (its ``render_pathtracer`` call is wrapped to keep
its arguments), and records the draws of its render by repeating the
render's key splits from its default key, as tests/test_torch_pathtracer.py
does; "demos" runs the feature demos of JAX_DEMOS and keeps their printed
lines. Each writes its CPU seconds (``resource``) beside its outputs.

- Triangle demo: the port's PGM within 1 grey level of the JAX one on
  every pixel, and the same printed scene, hit and shadow lines.
- Path-tracer demo: the port's scene is held geometry for geometry
  against the JAX example's (committed tables and tree bit-equal,
  materials, lights and camera equal). Its render, with the JAX run's
  draws replayed (``ReplayDraws``), is held against the JAX example's PFM
  per pixel within test_torch_pathtracer's RTOL/ATOL, at most MAX_FLIPS
  pixels moved by a branch that flips on a last-bit difference; its PNG is
  the JAX example's tonemap of its PFM, bit for bit.
- Feature demos: the port runs all 13 (each asserts its outcome) and
  prints, for each demo the JAX side ran, the JAX run's line. JAX_DEMOS
  leaves out the five whose JAX references cost most CPU (collide,
  gradients, subdivision, curves, quaternion motion: 29 of the 13 demos'
  48 CPU-s); those rely on the port's asserts.
"""
import contextlib
import json
import os
import resource
import runpy
import sys

import numpy as np
import pytest
from PIL import Image

import embree_tpu_torch as pt
from embree_tpu_torch.examples import (feature_demos,
                                       render_pathtracer_demo,
                                       render_triangle_demo)
from embree_tpu_torch.utils.image import load_pfm
from test_torch_pathtracer import (MAX_FLIPS, _jax_render_draws,
                                   _save_draws, mismatched, replay)
from test_torch_round import one_thread  # noqa: F401 (module-wide autouse)
import torch_jaxref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
TRI_SIZE = 32
PT_SIZE, PT_SPP = 16, 2
PT_DEPTH = 4        # examples/render_pathtracer_demo.py's max_depth
JAX_DEMOS = ("intersection_filter", "user_geometry", "closest_point",
             "instancing", "motion_blur_time_range", "interpolation",
             "grid_geometry", "instance_array")
SCENE_FIELDS = ("tri_v0", "tri_v1", "tri_v2", "pnt_c", "pnt_r",
                "prim_kind", "prim_geom", "prim_local", "prim_data")
TREE_FIELDS = ("node_lower", "node_upper", "node_child", "prim_order")


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _cpu_seconds():
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def _run_example(name, args, out_txt):
    sys.argv = [name] + args
    with open(out_txt, "w") as f, contextlib.redirect_stdout(f):
        runpy.run_path(os.path.join(EXAMPLES, name), run_name="__main__")


def _jax_reference(out_dir, part):
    import jax
    jax.config.update("jax_platforms", "cpu")
    t0 = _cpu_seconds()
    if part == "renders":
        _run_example("render_triangle_demo.py",
                     ["--cpu", "--size", str(TRI_SIZE), "--out",
                      os.path.join(out_dir, "tri.pgm")],
                     os.path.join(out_dir, "tri.txt"))
        # keep what the example builds: the committed scene, materials,
        # lights and the camera (render_pathtracer runs under jit, where
        # only the camera is not traced)
        import embree_tpu.models.lights as jl
        import embree_tpu.models.materials as jm
        import embree_tpu.models.pathtracer as jpt
        import embree_tpu.scene as js
        kept = {}

        def keeping(owner, name, key, pick=lambda r, a: r):
            orig = getattr(owner, name)

            def fn(*a, **kw):
                r = orig(*a, **kw)
                kept.setdefault(key, pick(r, a))
                return r
            setattr(owner, name, fn)
        keeping(js.Scene, "commit", "cs")
        keeping(jm, "make_materials", "mats")
        keeping(jl.LightSetBuilder, "build", "lights")
        keeping(jpt, "render_pathtracer", "cam", lambda r, a: a[3])
        _run_example("render_pathtracer_demo.py",
                     ["--cpu", "--size", str(PT_SIZE), "--spp", str(PT_SPP),
                      "--out", os.path.join(out_dir, "pt")],
                     os.path.join(out_dir, "pt.txt"))
        cs, mats, lights, cam = (kept[k] for k in ("cs", "mats", "lights",
                                                   "cam"))
        arrays = {f: np.asarray(getattr(cs, f)) for f in SCENE_FIELDS}
        arrays.update({f"bvh.{f}": np.asarray(getattr(cs.bvh, f))
                       for f in TREE_FIELDS})
        arrays.update({f"mats.{f}": np.asarray(getattr(mats, f))
                       for f in ("type", "albedo", "roughness", "ior")})
        arrays.update({f"lights.{f}": np.asarray(getattr(lights, f))
                       for f in ("type", "position", "direction", "radiance",
                                 "u_edge", "v_edge", "cos_angle",
                                 "ambient")})
        arrays.update({f"cam.{f}": np.asarray(getattr(cam, f))
                       for f in ("from_point", "to_point", "up", "fov_deg")})
        np.savez(os.path.join(out_dir, "cornell.npz"), **arrays)
        draws = {}
        _save_draws(draws, "render", _jax_render_draws(
            jax, jax.random.PRNGKey(0), PT_SIZE, PT_SIZE, PT_SPP, PT_DEPTH,
            lights.count))
        np.savez(os.path.join(out_dir, "pt_draws.npz"), **draws)
    else:
        g = runpy.run_path(os.path.join(EXAMPLES, "feature_demos.py"),
                           run_name="jax_feature_demos")
        with open(os.path.join(out_dir, "demos.txt"), "w") as f, \
                contextlib.redirect_stdout(f):
            for name in JAX_DEMOS:
                g[f"demo_{name}"]()
    with open(os.path.join(out_dir, f"{part}_cpu.json"), "w") as f:
        json.dump({"cpu_s": _cpu_seconds() - t0}, f)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = torch_jaxref.shared_dir(tmp_path_factory)
    out = tmp_path_factory.mktemp("jax_examples")
    torch_jaxref.run([torch_jaxref.script(__file__, out, part)
                      for part in ("renders", "demos")], d,
                     torch_jaxref.env())
    return out


def read_pgm(path):
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P5"
        w, h = map(int, f.readline().split())
        assert f.readline().strip() == b"255"
        return np.frombuffer(f.read(), np.uint8).reshape(h, w)


def lines(text, prefixes):
    return [ln for ln in text.splitlines() if ln.startswith(prefixes)]


# ---------------------------------------------------------------------------
# the triangle demo
# ---------------------------------------------------------------------------

def test_triangle_demo_matches_jax(jax_ref, tmp_path, capsys):
    got = render_triangle_demo.main(["--cpu", "--size", str(TRI_SIZE),
                                     "--out", str(tmp_path / "tri.pgm")])
    out = capsys.readouterr().out
    mine = read_pgm(tmp_path / "tri.pgm").astype(np.int32)
    theirs = read_pgm(jax_ref / "tri.pgm").astype(np.int32)
    assert mine.shape == theirs.shape == (TRI_SIZE, TRI_SIZE)
    assert np.abs(mine - theirs).max() <= 1
    np.testing.assert_array_equal(got["image"], mine)
    keys = ("committed:", "hit fraction:")
    assert lines(out, keys) == lines((jax_ref / "tri.txt").read_text(), keys)
    assert 0 < got["shadows"] < got["hits"] < TRI_SIZE * TRI_SIZE


# ---------------------------------------------------------------------------
# the path-tracer demo
# ---------------------------------------------------------------------------

def _port_cornell_arrays(parts):
    cs, mats, lights, cam = parts
    out = {f: getattr(cs, f).numpy() for f in SCENE_FIELDS}
    out.update({f"bvh.{f}": getattr(cs.bvh, f).numpy()
                for f in TREE_FIELDS})
    out.update({f"mats.{f}": getattr(mats, f).numpy()
                for f in ("type", "albedo", "roughness", "ior")})
    out.update({f"lights.{f}": getattr(lights, f).numpy()
                for f in ("type", "position", "direction", "radiance",
                          "u_edge", "v_edge", "cos_angle", "ambient")})
    out.update({f"cam.{f}": np.asarray(getattr(cam, f))
                for f in ("from_point", "to_point", "up", "fov_deg")})
    return out


def test_cornell_scene_matches_jax(jax_ref):
    """Geometry for geometry: the committed tables and tree bit-equal (ids
    by value: the port keeps them int64), the materials, lights and camera
    equal, to the scene the JAX example renders."""
    want = np.load(jax_ref / "cornell.npz")
    got = _port_cornell_arrays(render_pathtracer_demo.setup(pt, "cpu"))
    assert sorted(got) == sorted(want.files)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if w.dtype.kind == "f":
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_pathtracer_demo_matches_jax(jax_ref, tmp_path, capsys):
    """The demo's command line writes its render as PFM and as the JAX
    example's tonemapped PNG; its render from the JAX run's draws matches
    the JAX example's image per pixel."""
    out = str(tmp_path / "pt")
    got = render_pathtracer_demo.main(["--cpu", "--size", str(PT_SIZE),
                                       "--spp", str(PT_SPP), "--out", out])
    assert "pathtracer: 16x16x2spp" in capsys.readouterr().out
    img = got["image"]
    assert img.shape == (PT_SIZE, PT_SIZE, 3) and np.isfinite(img).all()
    np.testing.assert_array_equal(load_pfm(out + ".pfm"), img)
    # examples/render_pathtracer_demo.py's tonemap, then save_png's bytes
    tone = np.clip(img / (1 + img), 0, 1) ** (1 / 2.2)
    want = (np.clip(tone, 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(out + ".png")), want)

    dr = replay(dict(np.load(jax_ref / "pt_draws.npz")), "render")
    mine = render_pathtracer_demo.render(
        render_pathtracer_demo.setup(pt, "cpu"), PT_SIZE, PT_SPP,
        dr).numpy()
    assert dr.remaining == 0
    theirs = load_pfm(str(jax_ref / "pt.pfm"))
    assert mine.shape == theirs.shape and np.abs(theirs).max() > 0
    bad = mismatched(mine, theirs)
    assert bad.sum() <= MAX_FLIPS, np.flatnonzero(bad)


# ---------------------------------------------------------------------------
# the feature demos
# ---------------------------------------------------------------------------

def test_feature_demos_match_jax(jax_ref, capsys):
    ran = feature_demos.main(["--cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(ran) == 13 and out[-1] == "all feature demos OK"
    theirs = (jax_ref / "demos.txt").read_text().splitlines()
    assert len(theirs) == len(JAX_DEMOS)
    mine = {ln.split(":")[0]: ln for ln in out[:-1]}
    assert len(mine) == 13
    for ln in theirs:
        assert mine[ln.split(":")[0]] == ln


if __name__ == "__main__":
    _jax_reference(*sys.argv[1:3])
