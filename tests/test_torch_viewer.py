"""Port viewer vs the golden images and vs the JAX package's renders.

Cube and sphere x eyelight/primID/uv at 96x96 through the default
differentiable path (traversal selects, re-intersection fills the hit), held
within 10 wrong pixels of tests/golden/*.pfm (the bar of
tests/test_golden_images.py:48) and against the JAX package's render of the
same scene.
"""
import os

import jax
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as pt
from embree_tpu.models import camera as jcam
from embree_tpu.models import viewer as jviewer
from embree_tpu.tools.viewer import build_scene as jbuild
from embree_tpu_torch.models import viewer as pviewer
from embree_tpu_torch.models.camera import Camera
from embree_tpu_torch.tools.viewer import build_scene as pbuild
from embree_tpu_torch.utils.image import compare_images, load_pfm
from test_torch_round import one_thread  # noqa: F401 (module-wide autouse)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
CASES = [(sc, sh) for sc in ("cube", "sphere")
         for sh in ("eyelight", "primID", "uv")]
_cache = {}


def _scenes(sc):
    if sc not in _cache:
        sj, eye = jbuild(sc, et)
        sp, eye_p = pbuild(sc, pt)
        assert eye == eye_p
        cam = dict(from_point=np.asarray(eye, np.float32),
                   to_point=np.zeros(3, np.float32),
                   up=np.array([0, 1, 0], np.float32))
        _cache[sc] = (sj.commit(), sp.commit(device="cpu"), cam)
    return _cache[sc]


@pytest.mark.parametrize("sc,sh", CASES)
def test_golden_and_jax(sc, sh):
    cj, cp, cam = _scenes(sc)
    img = pviewer.render(cp, Camera(**cam), 96, 96, shader=sh).numpy()
    assert img.shape == (96, 96, 3) and np.isfinite(img).all()
    ref = load_pfm(os.path.join(GOLDEN_DIR, f"{sc}_{sh}.pfm"))
    wrong = compare_images(img, ref)
    assert wrong <= 10, f"{sc}/{sh}: {wrong} wrong pixels vs golden"
    jimg = np.asarray(jax.jit(lambda c: jviewer.render(
        c, jcam.Camera(**cam), 96, 96, shader=sh))(cj))
    assert compare_images(img, jimg) == 0
    # apart from tie-broken pixels, the two renders agree to float noise
    close = np.abs(img - jimg).max(-1) < 1e-4
    assert close.mean() > 0.99


@pytest.mark.parametrize("sh", sorted(pviewer.SHADERS))
def test_all_shaders_match_jax(sh):
    """All 7 shaders, through the reference debug camera (render_debug)."""
    cj, cp, cam = _scenes("cube")
    dbg = dict(from_=cam["from_point"], to=cam["to_point"], up=cam["up"],
               fov=60.0)
    img = pviewer.render_debug(cp, dbg, sh, width=48, height=40).numpy()
    jimg = np.asarray(jviewer.render_debug(cj, dbg, sh, width=48, height=40))
    assert img.shape == jimg.shape == (40, 48, 3)
    assert compare_images(img, jimg) <= 2


def test_camera_rays_match_jax():
    cam = dict(from_point=np.array([3.0, 2.5, 3.5], np.float32),
               to_point=np.zeros(3, np.float32),
               up=np.array([0, 1, 0], np.float32))
    rj = jcam.Camera(**cam).rays(12, 16)
    rp = Camera(**cam).rays(12, 16, device="cpu")
    np.testing.assert_allclose(rp.dir.numpy(), np.asarray(rj.dir),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(rp.org.numpy(), np.asarray(rj.org))
    rj = jviewer.ispc_camera_rays(cam["from_point"], cam["to_point"],
                                  cam["up"], 60.0, 16, 12, time=0.5)
    rp = pviewer.ispc_camera_rays(cam["from_point"], cam["to_point"],
                                  cam["up"], 60.0, 16, 12, time=0.5,
                                  device="cpu")
    np.testing.assert_allclose(rp.dir.numpy(), np.asarray(rj.dir),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(rp.time.numpy(), np.asarray(rj.time))


def test_random_color_matches_jax():
    ids = np.arange(-5, 300, dtype=np.int32)
    np.testing.assert_array_equal(
        pviewer.random_color(torch.from_numpy(ids)).numpy(),
        np.asarray(jviewer.random_color(jax.numpy.asarray(ids))))


# a square pyramid over a ground quad, two objects and the face forms
# v, v/vt, v//vn and negative indices
PYRAMID_OBJ = """mtllib scene.mtl
o pyramid
v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
v 0 1.5 0
usemtl red
f 1 2 5
f 2/1 3/2 5/3
f 3//1 4//1 5//1
f -2 -5 -1
o ground
v -3 -0.5 -3
v 3 -0.5 -3
v 3 -0.5 3
v -3 -0.5 3
usemtl grey
f -4 -3 -2 -1
"""
PYRAMID_MTL = """newmtl red
Kd 0.8 0.1 0.1
newmtl grey
Kd 0.5 0.5 0.5
"""


def test_obj_scene_matches_jax(tmp_path):
    """An .obj path as the viewer's scene (tools/viewer.py:22-28): the
    port's build_scene loads it as the JAX package's does, and renders it
    the same."""
    (tmp_path / "scene.obj").write_text(PYRAMID_OBJ)
    (tmp_path / "scene.mtl").write_text(PYRAMID_MTL)
    path = str(tmp_path / "scene.obj")
    sj, eye = jbuild(path, et)
    sp, eye_p = pbuild(path, pt)
    assert eye == eye_p
    cam = dict(from_point=np.asarray(eye, np.float32),
               to_point=np.zeros(3, np.float32),
               up=np.array([0, 1, 0], np.float32))
    cp = sp.commit(device="cpu")
    assert cp.num_prims == sj.commit().num_prims
    for sh in ("eyelight", "primID"):
        img = pviewer.render(cp, Camera(**cam), 64, 64, shader=sh).numpy()
        jimg = np.asarray(jax.jit(lambda c: jviewer.render(
            c, jcam.Camera(**cam), 64, 64, shader=sh))(sj.commit()))
        assert img.max() > 0
        assert compare_images(img, jimg) == 0
        assert (np.abs(img - jimg).max(-1) < 1e-4).mean() > 0.99


def test_unknown_scene_raises():
    with pytest.raises(ValueError):
        pbuild("no_such_scene", pt)
