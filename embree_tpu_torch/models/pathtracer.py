"""Monte-Carlo path tracer, the flagship renderer.

Port of embree_tpu/models/pathtracer.py (behavior parity with the reference
path tracer, tutorials/pathtracer/pathtracer_device.cpp renderPixelFunction
:1474-1604: a path loop with per-vertex light sampling and occlusion rays,
BRDF sampling, throughput Lw, and the spp loop :1619), restructured as a
wavefront:

- The whole image's rays advance together: one loop iteration is one path
  depth for every pixel (the JAX package's ``lax.scan`` step).
- Terminated paths carry zero throughput and get ``tfar = -1``; lanes stay
  dense, and the traversal wrapper sorts dead rays to the tail.
- Per bounce: emission, next-event estimation (one light sample and a
  shadow ray through ``occluded``) and BRDF sampling.
- Differentiable with respect to geometry, materials and lights through the
  re-intersection (``intersect(differentiable=True)``: the kernel only
  selects the winning primitive, torch ops recompute the hit). The forward
  pass records an autograd graph only when an input requires grad; that
  graph keeps every bounce's hit tensors.

Random numbers come from a ``Draws`` source consumed in a fixed order
(per bounce: the light pick, the light sample, the hemisphere, the metal
perturbation, the dielectric pick; per sample before its paths: the pixel
jitter). ``ReplayDraws`` hands out recorded draws instead, so a render can
be repeated exactly on another device or held against the JAX package's
draws.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.math import dot, normalize
from ..core.ray import RayBatch, make_rays
from ..scene import intersect, occluded
from .camera import Camera
from .lights import LightSet, sample_one
from .materials import MaterialSet, emission, eval_brdf, sample_brdf


class Draws:
    """The path tracer's random numbers from a ``torch.Generator``.

    ``record``: a list that receives a CPU copy of every draw, in order
    (for a ``ReplayDraws`` on another device)."""

    def __init__(self, generator: torch.Generator,
                 record: Optional[List[np.ndarray]] = None):
        self.generator = generator
        self.record = record

    @classmethod
    def seeded(cls, seed: int, device, record=None) -> "Draws":
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        return cls(g, record)

    def _keep(self, x):
        if self.record is not None:
            self.record.append(x.cpu().numpy())
        return x

    def uniform(self, shape) -> torch.Tensor:
        """float32 uniforms in [0, 1) of ``shape``."""
        return self._keep(torch.rand(tuple(shape), generator=self.generator,
                                     device=self.generator.device))

    def randint(self, high: int, shape) -> torch.Tensor:
        """int64 integers in [0, high) of ``shape``."""
        return self._keep(torch.randint(0, high, tuple(shape),
                                        generator=self.generator,
                                        device=self.generator.device))


class ReplayDraws:
    """Recorded draws handed out in order, each checked against the shape
    the consumer asks for."""

    def __init__(self, draws, device):
        self._draws = list(draws)
        self._next = 0
        self.device = torch.device(device)

    def _take(self, shape, dtype):
        if self._next >= len(self._draws):
            raise IndexError(f"replay ran out after {self._next} draws")
        a = np.asarray(self._draws[self._next])
        self._next += 1
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"draw {self._next - 1} has shape {a.shape}, "
                             f"the consumer asks for {tuple(shape)}")
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def uniform(self, shape) -> torch.Tensor:
        return self._take(shape, torch.float32)

    def randint(self, high: int, shape) -> torch.Tensor:
        return self._take(shape, torch.int64)

    @property
    def remaining(self) -> int:
        return len(self._draws) - self._next


def trace_paths(scene, mats: MaterialSet, lights: LightSet, rays: RayBatch,
                draws, max_depth: int = 4, backend=None) -> torch.Tensor:
    """Trace one path per input ray; returns (..., 3) radiance."""
    shape = rays.shape
    dev = rays.device
    L = torch.zeros(shape + (3,), device=dev)
    Lw = torch.ones(shape + (3,), device=dev)
    cur = RayBatch(org=rays.org, dir=rays.dir, tnear=rays.tnear,
                   tfar=torch.clamp(rays.tfar, max=1e30), time=rays.time,
                   mask=rays.mask)
    alive = torch.ones(shape, dtype=torch.bool, device=dev)
    for _ in range(max_depth):
        hits = intersect(scene, cur, backend=backend)
        valid = hits.valid & alive

        # ambient/miss contribution
        L = L + torch.where((alive & ~hits.valid)[..., None],
                            Lw * lights.ambient, 0.0)

        # sanitize miss lanes (t = inf): an inf hit point would poison the
        # backward pass, since the unselected branch's inf still reaches
        # its cotangent (0 * inf = nan)
        t_safe = torch.where(valid, hits.t, 0.0)
        p = cur.org + cur.dir * t_safe[..., None]
        ng = normalize(torch.where(valid[..., None], hits.ng, 1.0))
        wo = -normalize(cur.dir)
        entering = dot(ng, wo) > 0             # outside -> inside
        n = torch.where(entering[..., None], ng, -ng)   # face forward

        # emission at the hit (area lights as emissive geometry)
        L = L + torch.where(valid[..., None],
                            Lw * emission(mats, hits.geom_id), 0.0)

        # next-event estimation: one light sample and a shadow ray; lanes
        # without a hit trace no shadow ray (their term is masked anyway)
        wi_l, dist_l, contrib = sample_one(lights, p, draws)
        f = eval_brdf(mats, hits.geom_id, n, wo, wi_l, u=hits.u, v=hits.v)
        s_far = torch.where(torch.isinf(dist_l), 1e30, dist_l - 1e-3)
        srays = make_rays(p + n * 1e-3, wi_l, tnear=1e-4,
                          tfar=torch.where(valid, s_far, -1.0),
                          time=cur.time)
        shadowed = occluded(scene, srays, backend=backend)
        ndotl_ok = dot(n, wi_l) > 0
        L = L + torch.where((valid & ~shadowed & ndotl_ok)[..., None],
                            Lw * f * contrib, 0.0)

        # BRDF sampling -> next ray (dielectrics may refract below the
        # surface: offset along the side wi leaves through)
        wi, w = sample_brdf(mats, hits.geom_id, n, wo, draws,
                            entering=entering, u=hits.u, v=hits.v)
        Lw = Lw * torch.where(valid[..., None], w, 0.0)
        alive = valid & (Lw.amax(dim=-1) > 1e-4)
        side = torch.where(dot(wi, n) >= 0, 1.0, -1.0)[..., None]
        nxt = make_rays(p + side * n * 1e-3, wi, tnear=1e-4, time=cur.time)
        # dead rays stay inert (tfar < tnear); live ones carry a finite
        # tfar (1e30): an inf in the carried rays turns a zero cotangent
        # into NaN
        cur = RayBatch(org=nxt.org, dir=nxt.dir, tnear=nxt.tnear,
                       tfar=torch.where(alive, 1e30, -1.0), time=nxt.time,
                       mask=cur.mask)
    return L


def render_pathtracer(scene, mats: MaterialSet, lights: LightSet,
                      camera: Camera, height: int, width: int, spp: int = 4,
                      max_depth: int = 4, draws=None,
                      backend=None) -> torch.Tensor:
    """Render an (H, W, 3) image with spp jittered samples per pixel on the
    scene's device. ``draws``: the random source (by default a generator
    on that device seeded with 0)."""
    dev = scene.device
    if draws is None:
        draws = Draws.seeded(0, dev)
    img = torch.zeros((height, width, 3), device=dev)
    for _ in range(spp):
        jitter = draws.uniform((height, width, 2))
        rays = camera.rays(height, width, jitter=jitter, device=dev)
        img = img + trace_paths(scene, mats, lights, rays, draws,
                                max_depth=max_depth, backend=backend)
    return img / spp
