"""Light types with sample/eval pairs.

Port of embree_tpu/models/lights.py (behavior parity with the reference
light library, tutorials/common/lights/: ambient, point, directional, spot,
quad) as a dataclass of tensors plus a pure sample function. A LightSet
packs all lights of all types; ``sample_one`` picks a light uniformly per
shading point and compensates the pick with its pdf.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.math import cross, dot, normalize, sqrt_rn
from ..core.ray import resolve_device

TYPE_POINT = 0
TYPE_DIRECTIONAL = 1
TYPE_SPOT = 2
TYPE_QUAD = 3


@dataclasses.dataclass
class LightSet:
    """SoA over lights. position/direction/u/v meanings depend on type."""
    type: torch.Tensor        # (L,) int32
    position: torch.Tensor    # (L, 3)
    direction: torch.Tensor   # (L, 3) (directional/spot dir; quad normal)
    radiance: torch.Tensor    # (L, 3) intensity / radiance
    u_edge: torch.Tensor      # (L, 3) quad edge 1
    v_edge: torch.Tensor      # (L, 3) quad edge 2
    cos_angle: torch.Tensor   # (L,) spot cosAngleMax
    ambient: torch.Tensor     # (3,) ambient radiance

    @property
    def count(self):
        return self.type.shape[0]

    @property
    def device(self):
        return self.type.device


class LightSetBuilder:
    def __init__(self):
        self._rows = []
        self._ambient = np.zeros(3, np.float32)

    def ambient(self, radiance):
        self._ambient = self._ambient + np.asarray(radiance, np.float32)
        return self

    def point(self, position, intensity):
        self._rows.append((TYPE_POINT, position, (0, 0, 1), intensity,
                           (0, 0, 0), (0, 0, 0), 0.0))
        return self

    def directional(self, direction, radiance):
        self._rows.append((TYPE_DIRECTIONAL, (0, 0, 0), direction, radiance,
                           (0, 0, 0), (0, 0, 0), 0.0))
        return self

    def spot(self, position, direction, intensity, cos_angle=0.5):
        self._rows.append((TYPE_SPOT, position, direction, intensity,
                           (0, 0, 0), (0, 0, 0), cos_angle))
        return self

    def quad(self, corner, edge_u, edge_v, radiance):
        n = np.cross(np.asarray(edge_u, np.float32),
                     np.asarray(edge_v, np.float32))
        n = n / max(np.linalg.norm(n), 1e-20)
        self._rows.append((TYPE_QUAD, corner, n, radiance, edge_u, edge_v,
                           0.0))
        return self

    def build(self, device=None) -> LightSet:
        """The set on ``device`` (CUDA unless the caller asks for the CPU).
        An empty set holds one black point light, so a pick always lands."""
        dev = resolve_device(device)
        if not self._rows:
            self._rows.append((TYPE_POINT, (0, 0, 0), (0, 0, 1), (0, 0, 0),
                               (0, 0, 0), (0, 0, 0), 0.0))
        r = self._rows

        def f32(col):
            return torch.as_tensor(np.asarray([x[col] for x in r],
                                              np.float32), device=dev)

        return LightSet(
            type=torch.as_tensor([x[0] for x in r], dtype=torch.int32,
                                 device=dev),
            position=f32(1),
            direction=normalize(f32(2)),
            radiance=f32(3),
            u_edge=f32(4),
            v_edge=f32(5),
            cos_angle=f32(6),
            ambient=torch.as_tensor(self._ambient, device=dev),
        )


def sample_one(lights: LightSet, p, draws):
    """Sample one light uniformly per shading point.

    Draws, in order: the light pick (``randint``) and a (..., 2) uniform
    point on it. Returns (wi, dist, radiance_over_pdf): direction to the
    light, distance (inf for directional), and radiance already divided by
    the selection and area pdfs (Light*::sample parity).
    """
    L = lights.count
    shape = tuple(p.shape[:-1])
    li = draws.randint(L, shape)
    uv = draws.uniform(shape + (2,))

    ltype = lights.type[li]
    pos = lights.position[li]
    ldir = lights.direction[li]
    rad = lights.radiance[li]

    # point / spot
    to_l = pos - p
    d2 = torch.clamp(dot(to_l, to_l), min=1e-12)
    dist_pt = sqrt_rn(d2)
    wi_pt = to_l / dist_pt[..., None]
    contrib_pt = rad / d2[..., None]
    cos_spot = dot(-wi_pt, ldir)
    cos_max = lights.cos_angle[li]
    spot_fall = torch.clamp((cos_spot - cos_max)
                            / torch.clamp(1 - cos_max, min=1e-6), 0.0, 1.0)
    contrib_spot = contrib_pt * spot_fall[..., None]

    # directional
    wi_dir = -ldir
    contrib_dir = rad

    # quad area light: a uniform point on the quad
    q = (pos + uv[..., 0:1] * lights.u_edge[li]
         + uv[..., 1:2] * lights.v_edge[li])
    to_q = q - p
    dq2 = torch.clamp(dot(to_q, to_q), min=1e-12)
    dist_q = sqrt_rn(dq2)
    wi_q = to_q / dist_q[..., None]
    e = cross(lights.u_edge[li], lights.v_edge[li])
    area = sqrt_rn(dot(e, e))
    cos_l = torch.clamp(dot(-wi_q, ldir), min=0.0)
    contrib_q = rad * (area * cos_l / dq2)[..., None]

    is_pt = (ltype == TYPE_POINT)[..., None]
    is_dir = (ltype == TYPE_DIRECTIONAL)[..., None]
    is_spot = (ltype == TYPE_SPOT)[..., None]
    wi = torch.where(is_dir, wi_dir, torch.where(is_pt | is_spot, wi_pt, wi_q))
    dist = torch.where(is_dir[..., 0], math.inf,
                       torch.where((is_pt | is_spot)[..., 0], dist_pt, dist_q))
    contrib = torch.where(is_pt, contrib_pt,
                          torch.where(is_spot, contrib_spot,
                                      torch.where(is_dir, contrib_dir,
                                                  contrib_q)))
    return wi, dist, contrib * L  # * L compensates the uniform pick pdf
