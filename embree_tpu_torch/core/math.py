"""Vector math, the subset the triangle path uses.

Port of embree_tpu/core/math.py (:32-63, :290-303). Every "vector" is a
trailing-dim-3 tensor. Dot and cross products are written out component by
component, so they sum in one fixed order on every device.
"""
from __future__ import annotations

import torch


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def sqrt_rn(x):
    """float32 square root, correctly rounded on every device: CUDA's (and
    XLA's) is, PyTorch's CPU kernel can be 1 ulp off, so on the CPU the
    float64 root is rounded once. Differentiable."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)


def normalize(a, eps=1e-20):
    return a * torch.rsqrt(torch.clamp(dot(a, a), min=eps))[..., None]


def rcp_safe(x, eps=1e-18):
    """Reciprocal that avoids inf for near-zero input by clamping magnitude
    (cf. Embree rcp_safe, node_intersector1.h:33)."""
    e = torch.tensor(eps, dtype=x.dtype, device=x.device)
    return 1.0 / torch.where(x.abs() < e, torch.where(x >= 0, e, -e), x)


def _expand_bits_10(v):
    """Spread the lower 10 bits of v to every 3rd bit. int64 arithmetic with
    the same masks as the JAX package's uint32 version: the masks keep the low
    32 bits, so wrap-around never shows."""
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_code(p_norm):
    """30-bit Morton code (int64) from points normalized to [0,1)^3."""
    q = torch.clamp(p_norm * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits_10(q[..., 0]) << 2)
            | (_expand_bits_10(q[..., 1]) << 1)
            | _expand_bits_10(q[..., 2]))
