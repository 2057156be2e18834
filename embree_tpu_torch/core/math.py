"""Vector math.

Port of embree_tpu/core/math.py. Every "vector" is a trailing-dim-3 tensor.
Dot and cross products are written out component by component, so they
sum in one fixed order on every device. The affines and quaternions that
instance transforms use (resolved at commit on the host) are float32 numpy
arrays: (3, 4) affines [linear | translation] and (4,) quaternions (w, x,
y, z), each product written out and rounded term by term, without FMA. The
JAX package's other vector, box and affine helpers (:28-186) are torch
functions on tensors with the jnp originals' shapes and results.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def vec3(x, y, z, dtype=torch.float32):
    """Stack three components (tensors or numbers) along a new last dim."""
    return torch.stack([torch.as_tensor(x, dtype=dtype),
                        torch.as_tensor(y, dtype=dtype),
                        torch.as_tensor(z, dtype=dtype)], dim=-1)


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


def length(a):
    return sqrt_rn(dot(a, a))


def sqr_length(a):
    return dot(a, a)


def normalize(a, eps=1e-20):
    return a * torch.rsqrt(torch.clamp(dot(a, a), min=eps))[..., None]


def reflect(v, n):
    """Reflect direction v about normal n (both pointing away from the
    surface)."""
    return 2.0 * dot(v, n)[..., None] * n - v


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


def aabb_empty(shape=(), dtype=torch.float32, device=None):
    """(lower, upper) of empty boxes: +inf and -inf, shape + (3,)."""
    shape = tuple(shape) + (3,)
    return (torch.full(shape, float("inf"), dtype=dtype, device=device),
            torch.full(shape, float("-inf"), dtype=dtype, device=device))


def aabb_union(lo_a, up_a, lo_b, up_b):
    return fmin(lo_a, lo_b), fmax(up_a, up_b)


def aabb_extend_point(lo, up, p):
    return fmin(lo, p), fmax(up, p)


def aabb_center(lo, up):
    return 0.5 * (lo + up)


def aabb_contains_point(lo, up, p):
    return ((p >= lo) & (p <= up)).all(dim=-1)


def aabb_lerp(lo0, up0, lo1, up1, t):
    """Linear bounds interpolation (LBBox, reference common/math/lbbox.h)."""
    t = torch.as_tensor(t, dtype=lo0.dtype, device=lo0.device)[..., None]
    return lo0 * (1 - t) + lo1 * t, up0 * (1 - t) + up1 * t


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


# ---------------------------------------------------------------------------
# affines as torch tensors (..., 3, 4) [R | t] (embree_tpu/core/math.py
# :113-186; reference common/math/affinespace.h)
# ---------------------------------------------------------------------------

def _mv(m, v):
    """m (..., 3, 3) times v (..., 3), each row summed left to right."""
    return (m[..., 0] * v[..., None, 0] + m[..., 1] * v[..., None, 1]) \
        + m[..., 2] * v[..., None, 2]


def affine_from_cols(vx, vy, vz, p):
    """Build from column vectors (linear part columns + translation)."""
    return torch.stack([vx, vy, vz, p], dim=-1)


def affine_translate(t):
    t = torch.as_tensor(t)
    eye = torch.eye(3, dtype=t.dtype, device=t.device).expand(
        t.shape[:-1] + (3, 3))
    return torch.cat([eye, t[..., None]], dim=-1)


def affine_scale(s):
    s = torch.as_tensor(s)
    if s.ndim == 0:
        s = torch.stack([s, s, s])
    return torch.cat([torch.diag(s), torch.zeros((3, 1), dtype=s.dtype,
                                                  device=s.device)], dim=-1)


def affine_rotate(axis, angle):
    """Rotation about ``axis`` by ``angle`` radians."""
    axis = normalize(torch.as_tensor(axis, dtype=torch.float32))
    angle = torch.as_tensor(angle, dtype=torch.float32, device=axis.device)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c, s = torch.cos(angle), torch.sin(angle)
    C = 1 - c
    R = torch.stack([
        torch.stack([x * x * C + c, x * y * C - z * s, x * z * C + y * s], -1),
        torch.stack([y * x * C + z * s, y * y * C + c, y * z * C - x * s], -1),
        torch.stack([z * x * C - y * s, z * y * C + x * s, z * z * C + c], -1),
    ], dim=-2)
    return torch.cat([R, torch.zeros(R.shape[:-1] + (1,), dtype=R.dtype,
                                     device=R.device)], dim=-1)


def affine_mul(a, b):
    """Compose: (a @ b)(x) = a(b(x))."""
    Ra, ta = a[..., :3], a[..., 3]
    Rb, tb = b[..., :3], b[..., 3]
    R = torch.stack([_mv(Ra, Rb[..., :, j]) for j in range(3)], dim=-1)
    return torch.cat([R, (_mv(Ra, tb) + ta)[..., None]], dim=-1)


def affine_inverse(a):
    Rinv = torch.linalg.inv(a[..., :3])
    return torch.cat([Rinv, -_mv(Rinv, a[..., 3])[..., None]], dim=-1)


def xfm_point(a, p):
    return _mv(a[..., :3], p) + a[..., 3]


def xfm_vector(a, v):
    return _mv(a[..., :3], v)


def xfm_normal(a, n):
    """Transform a normal: the inverse transpose of the linear part."""
    return _mv(torch.linalg.inv(a[..., :3]).transpose(-1, -2), n)


def xfm_aabb(a, lo, up):
    """The AABB of an AABB's eight transformed corners."""
    corners = torch.stack([
        vec3(x[..., 0], y[..., 1], z[..., 2])
        for z in (lo, up) for y in (lo, up) for x in (lo, up)], dim=-2)
    tc = xfm_point(a[..., None, :, :], corners)
    return amin(tc, -2), amax(tc, -2)


# ---------------------------------------------------------------------------
# affines and quaternions, host numpy (embree_tpu/core/math.py:109-110,
# :196-288; reference common/math/quaternion.h, rtcore_quaternion.h)
# ---------------------------------------------------------------------------

_F = np.float32


def affine_identity():
    """The (3, 4) identity affine."""
    return np.concatenate([np.eye(3, dtype=_F), np.zeros((3, 1), _F)], -1)


def _dot4(a, b):
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1])
            + a[..., 2] * b[..., 2]) + a[..., 3] * b[..., 3]


def quat_identity():
    return np.array([1.0, 0.0, 0.0, 0.0], _F)


def quat_from_axis_angle(axis, angle):
    """The rotation by ``angle`` radians about ``axis`` (normalized here)."""
    axis = np.asarray(axis, _F)
    d = (axis[..., 0] * axis[..., 0] + axis[..., 1] * axis[..., 1]) \
        + axis[..., 2] * axis[..., 2]
    axis = axis * (_F(1) / np.sqrt(np.maximum(d, _F(1e-20))))[..., None]
    half = _F(0.5) * np.asarray(angle, _F)
    return np.concatenate([np.cos(half)[..., None],
                           axis * np.sin(half)[..., None]], -1).astype(_F)


def quat_mul(a, b):
    a, b = np.asarray(a, _F), np.asarray(b, _F)
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        ((aw * bw - ax * bx) - ay * by) - az * bz,
        ((aw * bx + ax * bw) + ay * bz) - az * by,
        ((aw * by - ax * bz) + ay * bw) + az * bx,
        ((aw * bz + ax * by) - ay * bx) + az * bw], -1)


def quat_normalize(q):
    q = np.asarray(q, _F)
    n = np.maximum(_dot4(q, q), _F(1e-20))
    return q * (_F(1) / np.sqrt(n))[..., None]


def quat_slerp(q0, q1, t):
    """Spherical lerp, nlerp where the two are nearly parallel."""
    q0, q1 = np.asarray(q0, _F), np.asarray(q1, _F)
    t = np.asarray(t, _F)
    cosom = _dot4(q0, q1)
    q1 = np.where(cosom[..., None] < 0, -q1, q1)
    cosom = np.abs(cosom)
    om = np.arccos(np.clip(cosom, _F(-1), _F(1)))
    sinom = np.sin(om)
    near = sinom < _F(1e-4)
    safe = np.where(near, _F(1), sinom)
    w0 = np.where(near, _F(1) - t, np.sin((_F(1) - t) * om) / safe)
    w1 = np.where(near, t, np.sin(t * om) / safe)
    return quat_normalize(w0[..., None] * q0 + w1[..., None] * q1)


def quat_to_matrix(q):
    q = np.asarray(q, _F)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    one, two = _F(1), _F(2)
    return np.stack([
        np.stack([one - two * (y * y + z * z), two * (x * y - w * z),
                  two * (x * z + w * y)], -1),
        np.stack([two * (x * y + w * z), one - two * (x * x + z * z),
                  two * (y * z - w * x)], -1),
        np.stack([two * (x * z - w * y), two * (y * z + w * x),
                  one - two * (x * x + y * y)], -1)], -2)


def _matvec3(m, v):
    """m (..., 3, 3) times v (..., 3), each row summed left to right."""
    return ((m[..., 0] * v[..., None, 0] + m[..., 1] * v[..., None, 1])
            + m[..., 2] * v[..., None, 2])


@dataclasses.dataclass
class QuaternionDecomposition:
    """A transform T * R(q) * S, interpolated component by component for
    quaternion motion blur (RTCQuaternionDecomposition)."""
    scale: np.ndarray        # (3, 4) upper-triangular scale/shear + shift
    quat: np.ndarray         # (4,) (w, x, y, z)
    translation: np.ndarray  # (3,)

    def to_affine(self):
        r = quat_to_matrix(quat_normalize(self.quat))
        s = np.asarray(self.scale, _F)
        # r @ s[:, :3], column by column
        lin = np.stack([_matvec3(r, s[..., :, j]) for j in range(3)], -1)
        t = _matvec3(r, s[..., :, 3]) + np.asarray(self.translation, _F)
        return np.concatenate([lin, t[..., None]], -1).astype(_F)


def qd_identity():
    return QuaternionDecomposition(affine_identity(), quat_identity(),
                                   np.zeros(3, _F))


def qd_interpolate(qd0, qd1, t):
    """Lerp scale and translation, slerp the rotation."""
    t = _F(t)
    a, b = np.asarray(qd0.scale, _F), np.asarray(qd1.scale, _F)
    ta = np.asarray(qd0.translation, _F)
    tb = np.asarray(qd1.translation, _F)
    return QuaternionDecomposition(
        scale=a * (_F(1) - t) + b * t,
        quat=quat_slerp(qd0.quat, qd1.quat, t),
        translation=ta * (_F(1) - t) + tb * t)
