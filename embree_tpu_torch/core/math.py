"""Vector math, the subset the triangle path uses.

Port of embree_tpu/core/math.py (:32-63, :88-91, :290-303). Every "vector" is a
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


def _total_key(x):
    """int32 keys of float32 values in XLA's order for min and max, where
    -0.0 lies below +0.0 (PyTorch's min and max return either zero). The
    map is its own inverse on the bits."""
    b = x.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _from_key(k):
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def fmin(a, b):
    """Elementwise float32 minimum as XLA takes it (-0.0 < +0.0)."""
    return _from_key(torch.minimum(_total_key(a), _total_key(b)))


def fmax(a, b):
    """Elementwise float32 maximum as XLA takes it (-0.0 < +0.0)."""
    return _from_key(torch.maximum(_total_key(a), _total_key(b)))


def amin(x, dim):
    """float32 minimum along ``dim`` as XLA reduces (-0.0 < +0.0)."""
    return _from_key(_total_key(x).amin(dim))


def amax(x, dim):
    """float32 maximum along ``dim`` as XLA reduces (-0.0 < +0.0)."""
    return _from_key(_total_key(x).amax(dim))


def cummin(x, dim):
    """Running float32 minimum along ``dim`` (-0.0 < +0.0)."""
    return _from_key(_total_key(x).cummin(dim).values)


def cummax(x, dim):
    """Running float32 maximum along ``dim`` (-0.0 < +0.0)."""
    return _from_key(_total_key(x).cummax(dim).values)


def segment_reduce(x, seg, num, op):
    """``jax.ops.segment_min`` (op "amin") or ``segment_max`` ("amax") of
    the rows of float32 x by segment id: +inf or -inf for an empty
    segment, -0.0 below +0.0."""
    fill = float("inf") if op == "amin" else float("-inf")
    out = torch.full((num,) + x.shape[1:], fill, dtype=x.dtype,
                     device=x.device)
    idx = seg.reshape((-1,) + (1,) * (x.ndim - 1)).expand_as(x)
    return _from_key(_total_key(out).scatter_reduce(
        0, idx, _total_key(x), op, include_self=False))


def aabb_half_area(lo, up):
    """Half surface area of (lower, upper) boxes (the SAH metric; cf.
    halfArea in common/math/bbox.h), summed in the JAX package's order.
    Negative extents count as +0.0, as XLA's max(x, 0.0) gives."""
    d = up - lo
    d = torch.where(d <= 0, torch.zeros_like(d), d)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


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
