"""Material models (BRDFs) for the path tracer.

Port of embree_tpu/models/materials.py (behavior parity with the reference
path tracer's material set, tutorials/pathtracer/pathtracer_device.cpp
Material_{sample,eval}: matte, mirror, rough metal, emissive, dielectric
with exact Fresnel and Snell refraction, and a base-color texture with
bilinear sampling). Materials are a per-geometry table of tensors;
sample/eval are plain functions dispatched by type id.

A miss lane's geometry id is INVALID_ID. The JAX package casts it to int32
(-1) and clips it to material 0; the port does the same (``_gid``), so the
textures and BRDFs a miss lane reads, masked afterwards, stay finite and
their gradients stay free of NaN.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..core.math import dot, normalize, reflect, sqrt_rn
from ..core.ray import resolve_device

MATTE = 0
MIRROR = 1
METAL = 2
EMISSIVE = 3
DIELECTRIC = 4


@dataclasses.dataclass
class MaterialSet:
    """Per-geometry material table (indexed by geom_id)."""
    type: torch.Tensor       # (G,) int32
    albedo: torch.Tensor     # (G, 3) reflectance, emission or tint
    roughness: torch.Tensor  # (G,)
    ior: Optional[torch.Tensor] = None       # (G,) index of refraction
    tex: Optional[torch.Tensor] = None       # (G, TH, TW, 3) texture atlas
    textured: Optional[torch.Tensor] = None  # (G,) bool: albedo * tex

    @property
    def device(self):
        return self.type.device


def make_materials(n_geoms: int, assignments: Dict[int, tuple],
                   textures: Optional[Dict[int, np.ndarray]] = None,
                   tex_size: int = 64, device=None) -> MaterialSet:
    """assignments: geom_id -> (type, albedo, roughness[, ior]).
    textures: geom_id -> (th, tw, 3) base-color image, resampled onto the
    shared (tex_size, tex_size) atlas layer with nearest filtering. The
    table lives on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    t = np.zeros(n_geoms, np.int32)
    a = np.full((n_geoms, 3), 0.8, np.float32)
    r = np.zeros(n_geoms, np.float32)
    ior = np.full(n_geoms, 1.5, np.float32)
    for gid, spec in assignments.items():
        t[gid] = spec[0]
        a[gid] = spec[1]
        r[gid] = spec[2]
        if len(spec) > 3:
            ior[gid] = spec[3]
    tex = textured = None
    if textures:
        tex = np.ones((n_geoms, tex_size, tex_size, 3), np.float32)
        textured = np.zeros(n_geoms, bool)
        for gid, img in textures.items():
            img = np.asarray(img, np.float32)
            ys = (np.arange(tex_size) * img.shape[0] // tex_size)
            xs = (np.arange(tex_size) * img.shape[1] // tex_size)
            tex[gid] = img[ys][:, xs]
            textured[gid] = True
        tex = torch.as_tensor(tex, device=dev)
        textured = torch.as_tensor(textured, device=dev)

    def on(x):
        return torch.as_tensor(x, device=dev)

    return MaterialSet(on(t), on(a), on(r), on(ior), tex, textured)


def _gid(mats: MaterialSet, geom_id):
    """The table row of each lane: the id as int32 (INVALID_ID becomes -1),
    clipped into the table, as the JAX package indexes it."""
    return torch.clamp(geom_id.to(torch.int32), 0,
                       mats.type.shape[0] - 1).long()


def texture_lookup(tex, gid, u, v):
    """Bilinear texture fetch from the (G, TH, TW, 3) atlas with wrap
    addressing (texture.cpp getTexel1f bilinear analog)."""
    G, TH, TW, _ = tex.shape
    x = u * TW - 0.5
    y = v * TH - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def at(ix, iy):
        ix = ix.to(torch.int32) % TW
        iy = iy.to(torch.int32) % TH
        return tex[gid, iy.long(), ix.long()]

    return (at(x0, y0) * (1 - fx) * (1 - fy) + at(x0 + 1, y0) * fx * (1 - fy)
            + at(x0, y0 + 1) * (1 - fx) * fy + at(x0 + 1, y0 + 1) * fx * fy)


def base_color(mats: MaterialSet, geom_id, u=None, v=None):
    """Albedo, modulated by the geometry's base-color texture when present."""
    gid = _gid(mats, geom_id)
    alb = mats.albedo[gid]
    if mats.tex is not None and u is not None:
        tx = texture_lookup(mats.tex, gid, u, v)
        alb = torch.where(mats.textured[gid][..., None], alb * tx, alb)
    return alb


def _onb(n):
    """Orthonormal basis around normal n (branchless Frisvad)."""
    s = torch.where(n[..., 2] >= 0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]],
                     -1)
    t2 = torch.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t1, t2


def cosine_sample_hemisphere(n, draws):
    """A cosine-weighted direction around n from one (..., 2) uniform."""
    u = draws.uniform(tuple(n.shape[:-1]) + (2,))
    r = sqrt_rn(u[..., 0])
    phi = 2 * math.pi * u[..., 1]
    t1, t2 = _onb(n)
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = sqrt_rn(torch.clamp(1.0 - u[..., 0], min=0.0))
    return normalize(x[..., None] * t1 + y[..., None] * t2 + z[..., None] * n)


def fresnel_dielectric(cos_i, eta):
    """Exact unpolarized dielectric Fresnel reflectance.

    eta = n_incident / n_transmitted; returns (F, cos_t, tir_mask)
    (fresnel.h FresnelDielectric analog)."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    # the floor keeps the root's derivative finite at (and beyond) total
    # internal reflection: a zero cotangent through sqrt(0) is 0 * inf, NaN,
    # which would poison every gradient through the bounce loop
    cos_t = sqrt_rn(torch.clamp(1.0 - sin2_t, min=1e-12))
    cos_t = torch.where(tir, 0.0, cos_t)
    rs = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-12)
    rp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-12)
    F = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    return F, cos_t, tir


def eval_brdf(mats: MaterialSet, geom_id, n, wo, wi, u=None, v=None):
    """BRDF value * cos(theta_i) for light sampling (Material_eval parity).

    Specular materials (mirror, dielectric) return 0: no next-event
    contribution through delta lobes.
    """
    gid = _gid(mats, geom_id)
    mtype = mats.type[gid]
    albedo = base_color(mats, geom_id, u, v)
    cos_i = torch.clamp(dot(n, wi), min=0.0)
    matte = albedo / math.pi * cos_i[..., None]
    zero = torch.zeros_like(matte)
    is_matte = (mtype == MATTE)[..., None]
    # metal: a Phong-like lobe around the mirror direction
    refl = reflect(wo, n)
    gid_r = torch.clamp(mats.roughness[gid], min=1e-3)
    shin = 2.0 / (gid_r * gid_r)
    phong = albedo * ((shin + 2) / (2 * math.pi)
                      * torch.pow(torch.clamp(dot(refl, wi), min=0.0), shin)
                      * cos_i)[..., None]
    is_metal = (mtype == METAL)[..., None]
    return torch.where(is_matte, matte, torch.where(is_metal, phong, zero))


def sample_brdf(mats: MaterialSet, geom_id, n, wo, draws, entering=None,
                u=None, v=None):
    """Sample an outgoing direction; returns (wi, weight) with weight =
    brdf * cos / pdf (Material_sample parity).

    Draws, in order: a (..., 2) uniform for the hemisphere, a (..., 2)
    uniform for the metal perturbation, and one uniform for the dielectric
    pick. n is the face-forward shading normal; entering (bool) says
    whether the ray arrives from outside the surface (the dielectric's eta
    orientation; True everywhere by default)."""
    gid = _gid(mats, geom_id)
    mtype = mats.type[gid]
    albedo = base_color(mats, geom_id, u, v)

    wi_diff = cosine_sample_hemisphere(n, draws)
    w_diff = albedo  # lambert: brdf*cos/pdf = albedo

    refl = normalize(reflect(wo, n))
    # metal: perturb the mirror direction within the roughness cone
    perturb = cosine_sample_hemisphere(refl, draws)
    rough = mats.roughness[gid][..., None]
    wi_metal = normalize(refl * (1 - rough) + perturb * rough)
    w_metal = albedo

    # dielectric: exact Fresnel split between reflection and refraction
    if entering is None:
        entering = torch.ones(mtype.shape, dtype=torch.bool,
                              device=mtype.device)
    ior = mats.ior[gid] if mats.ior is not None \
        else torch.full(mtype.shape, 1.5, device=mtype.device)
    eta = torch.where(entering, 1.0 / ior, ior)
    cos_i = torch.clamp(dot(n, wo), 0.0, 1.0)
    F, cos_t, tir = fresnel_dielectric(cos_i, eta)
    wi_refr = normalize(-eta[..., None] * wo
                        + (eta * cos_i - cos_t)[..., None] * n)
    pick_refl = (draws.uniform(tuple(mtype.shape)) < F) | tir
    wi_diel = torch.where(pick_refl[..., None], refl, wi_refr)
    # weight 1 on reflection; transmission carries the tint
    w_diel = torch.where(pick_refl[..., None], torch.ones_like(albedo),
                         albedo)

    is_mirror = (mtype == MIRROR)[..., None]
    is_metal = (mtype == METAL)[..., None]
    is_diel = (mtype == DIELECTRIC)[..., None]
    wi = torch.where(is_mirror, refl,
                     torch.where(is_metal, wi_metal,
                                 torch.where(is_diel, wi_diel, wi_diff)))
    w = torch.where(is_mirror | is_metal, w_metal,
                    torch.where(is_diel, w_diel, w_diff))
    # emissive surfaces terminate (no scattering weight)
    w = torch.where((mtype == EMISSIVE)[..., None], 0.0, w)
    return wi, w


def emission(mats: MaterialSet, geom_id):
    gid = _gid(mats, geom_id)
    return torch.where((mats.type[gid] == EMISSIVE)[..., None],
                       mats.albedo[gid], 0.0)
