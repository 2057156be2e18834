"""Viewer: the image-regression renderer.

Port of embree_tpu/models/viewer.py (behavior parity with the reference
viewer's debug shaders, tutorials/viewer/viewer_device_debug.cpp:213-316).
Each shader reproduces the reference's pixel formula so renders compare
against the golden images with the reference's error metric
(utils/image.compare_images).
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from ..core.math import cross, dot, normalize
from ..core.ray import RayBatch, make_rays, resolve_device
from ..scene import CommittedScene, intersect, occluded
from .camera import Camera


def random_color(ids):
    """The reference's randomColor(ID) (viewer_device_debug.cpp:204-211)."""
    i = ids.to(torch.int32)
    r = (((i + 13) * (17 * 23)) & 255).to(torch.float32) / 255.0
    g = (((i + 15) * (11 * 13)) & 255).to(torch.float32) / 255.0
    b = (((i + 17) * (7 * 19)) & 255).to(torch.float32) / 255.0
    return torch.stack([r, g, b], dim=-1)


def _masked(hits, col):
    return torch.where(hits.valid[..., None], col, 0.0)


def shade_eyelight(scene: CommittedScene, rays: RayBatch, hits):
    """Miss -> black; front-facing (dot(dir,Ng) < 0) -> |dot(dir,n)| in G,
    back-facing -> in R (viewer_device_debug.cpp:250-256)."""
    d = rays.dir
    ng = hits.ng
    c = dot(normalize(ng), d).abs()
    front = dot(ng, d) < 0.0
    z = torch.zeros_like(c)
    col = torch.where(front[..., None], torch.stack([z, c, z], -1),
                      torch.stack([c, z, z], -1))
    return _masked(hits, col)


def shade_uv(scene, rays, hits):
    """(u, v, 1-u-v); miss -> black (viewer_device_debug.cpp:264-266)."""
    return _masked(hits, torch.stack([hits.u, hits.v,
                                      1.0 - hits.u - hits.v], dim=-1))


def shade_ng(scene, rays, hits):
    """abs(normalize(Ng)); miss -> black (viewer_device_debug.cpp:292-294)."""
    return _masked(hits, normalize(hits.ng).abs())


def shade_prim_id(scene, rays, hits):
    """randomColor(geomID ^ primID) * |dot(dir, n)|
    (SHADER_GEOMID_PRIMID, viewer_device_debug.cpp:303-305)."""
    c = dot(normalize(hits.ng), rays.dir).abs()
    ids = hits.geom_id.to(torch.int32) ^ hits.prim_id.to(torch.int32)
    return _masked(hits, random_color(ids) * c[..., None])


def shade_geom_id(scene, rays, hits):
    """randomColor(geomID) (SHADER_GEOMID, viewer_device_debug.cpp:298-300)."""
    return _masked(hits, random_color(hits.geom_id.to(torch.int32)))


def shade_occlusion(scene: CommittedScene, rays: RayBatch, hits):
    """PRIMARY-ray occlusion: occluded -> white, free -> black
    (SHADER_OCCLUSION, viewer_device_debug.cpp:258-262)."""
    occ = occluded(scene, rays)
    return torch.where(occ[..., None], 1.0, 0.0).expand(
        occ.shape + (3,)).contiguous()


def shade_ao(scene: CommittedScene, rays: RayBatch, hits):
    """Ambient-occlusion-ish secondary shader (renderPixelAOShader analog,
    single cosine sample instead of 64 — a separate mode, not a parity
    target). Pixels whose primary ray missed trace no secondary ray (their
    colour is masked anyway): from an infinite origin with a zero
    direction, its every slab test enters at +inf, and the kernel's walk
    (the JAX package's, followed bit for bit) then takes an empty slot for
    a hit on trees whose empty slot lies between valid ones, as the SAH
    builder's root does, and runs to its step limit (ROADMAP C)."""
    p = rays.org + rays.dir * hits.t[..., None]
    ng = normalize(hits.ng)
    d = normalize(rays.dir)
    ng = torch.where(dot(ng, d)[..., None] > 0, -ng, ng)
    srays = make_rays(p + ng * 1e-3, ng, tnear=1e-3,
                      tfar=torch.where(hits.valid, math.inf, -math.inf))
    occ = occluded(scene, srays)
    col = torch.where(occ, 0.2, 1.0)
    return _masked(hits, col[..., None].expand(col.shape + (3,)))


SHADERS: Dict[str, Callable] = {
    "eyelight": shade_eyelight,
    "uv": shade_uv,
    "Ng": shade_ng,
    "primID": shade_prim_id,
    "geomID": shade_geom_id,
    "occlusion": shade_occlusion,
    "ao": shade_ao,
}


def ispc_camera_rays(from_, to, up, fov, width, height, time=0.0,
                     device=None) -> RayBatch:
    """Reference camera model (tutorials/common/tutorial/camera.h:57-81,
    right-handed): per-pixel dir = normalize(x*vx + y*vy + vz) at integer
    pixel coordinates. Returns a RayBatch of shape (H, W)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    from_, to, up = f32(from_), f32(to), f32(up)
    Z = normalize(to - from_)
    U = normalize(cross(up, Z))
    V = normalize(cross(Z, U))
    lvx = -U                                   # RIGHT_HANDED flips vx
    lvy, lvz = V, Z
    fov_scale = 1.0 / math.tan(math.radians(0.5 * fov))
    vx = lvx
    vy = -lvy
    vz = (-0.5 * width * lvx + 0.5 * height * lvy
          + 0.5 * height * fov_scale * lvz)
    x = torch.arange(width, dtype=torch.float32, device=dev)[None, :, None]
    y = torch.arange(height, dtype=torch.float32, device=dev)[:, None, None]
    d = normalize(x * vx + y * vy + vz)
    org = torch.broadcast_to(from_, d.shape).contiguous()
    return make_rays(org, d, time=time)


def render(scene: CommittedScene, camera: Camera, height: int, width: int,
           shader: str = "eyelight") -> torch.Tensor:
    """Render one frame: (H, W, 3) float32 on the scene's device."""
    rays = camera.rays(height, width, device=scene.device)
    hits = intersect(scene, rays)
    return SHADERS[shader](scene, rays, hits)


def render_debug(scene: CommittedScene, cam: dict, shader: str,
                 width: int = 512, height: int = 512,
                 time: float = 0.0) -> torch.Tensor:
    """Render with the reference debug-camera model + a parity shader.

    cam: dict(from_, to, up, fov). Matches embree_viewer --shader <s>
    --time <t> output (before 8-bit framebuffer quantization)."""
    rays = ispc_camera_rays(cam["from_"], cam["to"], cam["up"], cam["fov"],
                            width, height, time=time, device=scene.device)
    hits = intersect(scene, rays)
    return SHADERS[shader](scene, rays, hits)
