"""BVH8 traversal over the packed records: the host wrapper, the Hopper kernel
launcher and the kernel's plain PyTorch version.

Port of embree_tpu/accel/traverse_pallas.py:1268-1555. ``traverse_packed``
keeps the JAX wrapper's contract (coherence sort, launch, ``pid_map`` and
id-table gathers, unsort) and returns the same values. Beneath it:

- ``traverse_kernel`` launches ``csrc/traverse.cu`` (flat curves:
  ``csrc/traverse_curves.cu``, round curves: ``csrc/traverse_round.cu``,
  linked into it) on CUDA tensors. It is the
  port of ``_kernel`` (traverse_pallas.py:108): the triangle
  specialization (B1), robust mode (B2), per-slot kind tags (B3), points
  (B4), lines (B5), motion blur (B6: fields lerped by the ray time,
  per-slot time windows), flat curves (B7: the ribbon test on 16-field
  Bezier slots) and round curves (B8: cone candidates and a Newton polish
  on the same slots); ``LAUNCHES`` counts its launches per variant. Every
  variant runs persistent warps that refill finished lanes from a ray
  counter the wrapper zeroes; their work counts come back in
  ``TraceResult.sched`` (and, for curve scenes and static B1-B5,
  ``leaf_sched``).
- ``traverse_packed_reference`` computes the same function in plain PyTorch
  ops: a loop over steps, vectorized over the rays still active, with the
  kernel's keys, stack discipline and strict ``<``. The tests run the port on
  the CPU through it, and the smoke run holds the kernel against it on the
  card.
- ``traverse_twin`` runs the kernel's per-ray logic and its scheduler over
  32 emulated lanes, compiled for the host
  (``csrc/traverse_cpu.cpp``). Test-only: never on the main path.

``trace`` picks by device: CPU tensors take the plain version, CUDA tensors
the kernel, and there is no fallback from one to the other.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..core.math import morton_code, rcp_safe
from ..geometry import KIND_CURVE_FLAT, KIND_CURVE_ROUND
from .pack import INVALID_REC, LEAF_WIDTH, NODE_WORDS, PackedScene

STACK = 64               # entries per ray (STACK_BLOCKS * 8, :65)
MAX_STEPS = 200_000      # runaway guard (:77)
INF_BITS = 0x7F800000
SORT_MIN_RAYS = 128      # the JAX wrapper sorts only batches above one lane row

# kind classes the mixed kernel serves (traverse_pallas.py:525-1046); quads
# ride as triangle slots (class 0), class 8 is the flat curve, 9 the round
KERNEL_CLASSES = (0, 2, 3, 4, 5, 6, KIND_CURVE_FLAT, KIND_CURVE_ROUND)
CURVE_CLASSES = (KIND_CURVE_FLAT, KIND_CURVE_ROUND)
N_TAGS = 16              # bins of the slot-test counts by kind tag
# float32 constants of the leaf and slab tests, as the Pallas kernel
# rounds them
ROBUST_DOWN = float(np.float32(1.0 - 3.0 * 1.19209290e-07))
ROBUST_UP = float(np.float32(1.0 + 3.0 * 1.19209290e-07))
ULP1 = float(np.float32(1.19209290e-07))
BIG = float(np.float32(3e38))
RIBBON_EPS = float(np.float32(4.0 * 1.19209290e-07))   # :759
SWEEP_ERR = float(np.float32(16.0 * 1.19209290e-07))   # :955, :998, :1020
ROUND_MIN_RATE = 8       # the round curve's cone segments: max(rate, 8)
ROUND_NEWTON = 5         # Newton steps per candidate (:962)

# Kernel launches by variant, counted where the kernel is launched and
# nowhere else (the smoke run zeroes them before a path and reads them
# after). Keys come from ``variant_name``.
LAUNCHES: Dict[str, int] = collections.defaultdict(int)


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def variant_name(occlusion: bool, want_attrs: bool, robust: bool = False,
                 kinds: bool = False, masked: bool = False,
                 motion: bool = False, windows: bool = False,
                 curves: bool = False, round_curves: bool = False) -> str:
    """closest | closest_attrs | occluded, then _robust (B2), _kinds (the
    mixed-class kernel, B3-B5) or _curves (the mixed-class kernel with
    16-field slots and the ribbon, B7) or _curves_round (the same
    instantiation on a scene with round slots, B8), _motion (B6, fields
    lerped by ray time) or _motion_win (B6 with per-slot time windows, a
    uniform branch of the same instantiation), and _masked (per-slot mask
    chunk)."""
    name = ("occluded" if occlusion else
            "closest_attrs" if want_attrs else "closest")
    return (name + ("_robust" if robust else "")
            + ("_curves_round" if round_curves else "_curves" if curves
               else "_kinds" if kinds else "")
            + ("_motion_win" if windows else "_motion" if motion else "")
            + ("_masked" if masked else ""))


def has_curves(packed: PackedScene) -> bool:
    """Whether the scene's slots are the 16-field curve slots."""
    return any(k in packed.kind_classes for k in CURVE_CLASSES)


def packed_variant(packed: PackedScene, occlusion: bool, want_attrs: bool,
                   robust: bool) -> str:
    """The variant name of a launch on ``packed``."""
    return variant_name(occlusion, want_attrs, robust, packed.has_kinds,
                        packed.has_mask, packed.has_motion, packed.has_win,
                        has_curves(packed),
                        KIND_CURVE_ROUND in packed.kind_classes)


def ribbon_weights(rate: int) -> np.ndarray:
    """(rate + 1, 7) float32: at knot k, the cubic Bernstein weights of
    t = k / rate and the quadratic ones of its derivative, computed in
    float64 as the Pallas kernel's Python does (``bezw``, ``bez2w``,
    :730-737) and rounded to float32 where they meet the float32 planes."""
    rows = []
    for k in range(rate + 1):
        t = k / rate
        sm = 1.0 - t
        rows.append((sm * sm * sm, 3 * sm * sm * t, 3 * sm * t * t,
                     t * t * t, sm * sm, 2 * sm * t, t * t))
    return np.asarray(rows, np.float64).astype(np.float32)


def round_segments(rate: int) -> int:
    """The round curve's cone segments at the scene's rate (:865)."""
    return max(int(rate), ROUND_MIN_RATE)


def curve_weights(rate: int) -> np.ndarray:
    """The kernel's knot table of a curve scene at ``rate``, flat: the
    ribbon's ``ribbon_weights(rate)`` rows, then at each of the round
    curve's R + 1 knots (R = ``round_segments(rate)``) the cubic Bernstein
    weights of k / R (``bezw``, :870), float64 rounded to float32."""
    n = round_segments(rate)
    cubic = ribbon_weights(n)[:, :4]
    return np.concatenate([ribbon_weights(rate).reshape(-1),
                           cubic.reshape(-1)])


_weights_cache: Dict[Tuple[int, str], torch.Tensor] = {}


def _curve_weights_on(packed: PackedScene, device) -> Optional[torch.Tensor]:
    """The knot table of the scene's rate on ``device`` (None without
    curves), made once per rate and device."""
    if not has_curves(packed):
        return None
    key = (int(packed.curve_rate), str(device))
    if key not in _weights_cache:
        _weights_cache[key] = torch.from_numpy(
            curve_weights(packed.curve_rate)).to(device)
    return _weights_cache[key]


@dataclasses.dataclass
class TraceResult:
    """Per-ray traversal output, in the order the rays were given."""
    t: torch.Tensor               # (R,) float32: best hit t, else tfar
    best: torch.Tensor            # (R,) int32: 8*leaf+slot, -1 = miss
    visits: torch.Tensor          # (2, R) int32: node, leaf records visited
    attrs: Optional[torch.Tensor]  # (5, R) float32 u, v, Ng (want_attrs)
    overflow: torch.Tensor        # () int32: rays whose stack overflowed
    # (N_TAGS,) int64 slot tests by kind tag over all leaf visits, tags of
    # the scene's classes only, of the slots that the mask chunk and the
    # windows let through (the plain version counts them; the operation
    # count of a bound needs them)
    class_slots: Optional[torch.Tensor] = None
    # () int64 round-curve candidates of those slots over all leaf visits
    # (the plain version counts them: the kernel polishes these only)
    round_candidates: Optional[torch.Tensor] = None
    # (4,) int64 of the persistent warps (kernel and twin; None from the
    # plain version): lane slots (warp passes x 32), lane steps that did
    # work, rays finished, warps resident per SM (the twin: 1)
    sched: Optional[torch.Tensor] = None
    # (3,) int64, the persistent warps of curve scenes and static B1-B5:
    # lane slots of leaf passes (leaf passes x 32), lane steps of leaf
    # passes, and item rounds x 32 (each round deals up to 32 of the pass's
    # (ray, slot) items across the warp; 0 where each lane runs its own
    # leaf); zeros in moving scenes without curves
    leaf_sched: Optional[torch.Tensor] = None


def _coherence_key(org, dir, tnear=None, tfar=None):
    """Sort key grouping rays by direction octant then origin locality
    (traverse_pallas.py:1268). 31-bit: dead(1) | octant(3) | morton(27).
    Dead rays (tnear > tfar) sort to the tail."""
    lo = org.amin(dim=0)
    up = org.amax(dim=0)
    q = (org - lo) / torch.clamp(up - lo, min=1e-20)
    m27 = morton_code(q) >> 3
    octant = ((dir[:, 0] < 0).long()
              | ((dir[:, 1] < 0).long() << 1)
              | ((dir[:, 2] < 0).long() << 2))
    key = (octant << 27) | m27
    if tnear is not None:
        key = key | ((tnear > tfar).long() << 30)
    return key


# ---------------------------------------------------------------------------
# input checks shared by the kernel, its twin and the plain version
# ---------------------------------------------------------------------------

def _time(packed: PackedScene, org, time):
    """The rays' times for a moving scene (zeros when not given, as in the
    JAX wrapper), None for a static one, whose kernel never reads them."""
    if not packed.has_motion:
        return None
    if time is None:
        return torch.zeros(org.shape[0], dtype=torch.float32,
                           device=org.device)
    return time


def _check(packed: PackedScene, org, dir, tnear, tfar, mask, time=None):
    R = org.shape[0]
    dev = org.device
    if packed.has_win and not packed.has_motion:
        raise ValueError("time windows need the B-step fields (has_motion)")
    for name, x, dtype, shape in (
            ("org", org, torch.float32, (R, 3)),
            ("dir", dir, torch.float32, (R, 3)),
            ("tnear", tnear, torch.float32, (R,)),
            ("tfar", tfar, torch.float32, (R,)),
            ("mask", mask, torch.int32, (R,)),
            ("time", time, torch.float32, (R,)),
            ("nodes", packed.nodes, torch.int32, None),
            ("leaves", packed.leaves, torch.int32, None)):
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays are on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lw = packed.leaf_words
    if packed.nodes.ndim != 2 or packed.nodes.shape[1] != NODE_WORDS:
        raise ValueError(f"nodes must be (n, {NODE_WORDS})")
    if packed.leaves.ndim != 2 or packed.leaves.shape[1] != lw:
        raise ValueError(f"leaves must be (n, {lw}) for has_mask="
                         f"{packed.has_mask}, has_kinds={packed.has_kinds}, "
                         f"has_motion={packed.has_motion}, has_win="
                         f"{packed.has_win}")
    if packed.has_kinds:
        if not set(packed.kind_classes) <= set(KERNEL_CLASSES):
            raise ValueError(f"kind classes {packed.kind_classes} are not "
                             f"all in {KERNEL_CLASSES}")
    elif tuple(packed.kind_classes) != (0,):
        raise ValueError("a scene without kind tags holds triangles only")
    if packed.nf != (16 if has_curves(packed) else 9):
        raise ValueError(f"{packed.nf} fields per slot: curve scenes take "
                         "16, others 9")
    if has_curves(packed) and not packed.has_kinds:
        raise ValueError("curve scenes carry kind tags")
    if has_curves(packed) and packed.curve_rate < 1:
        raise ValueError(f"ribbon rate {packed.curve_rate} is below 1")
    if packed.nodes.shape[0] < 1 or packed.leaves.shape[0] < 1:
        raise ValueError("packed scene has no records")


def kernel_instantiation(packed: PackedScene, occlusion: bool,
                         want_attrs: bool, robust: bool):
    """The kernel a launch on ``packed`` runs, as ``csrc/launch.cuh``'s
    dispatch picks it: (entry, its template flags), for its ptxas line:
    ``persistent_kernel<OCCLUSION, WANT_ATTRS, HAS_MASK, ROBUST, KINDS,
    MOTION, CURVES, ROUND>``, the persistent warps every variant runs."""
    flags = (occlusion, want_attrs and not occlusion, packed.has_mask,
             robust, packed.has_kinds, packed.has_motion, has_curves(packed),
             KIND_CURVE_ROUND in packed.kind_classes)
    return "persistent_kernel", tuple(int(f) for f in flags)


# the twin's outputs start as values no traversal writes (a NaN payload, a
# prim id below -1), so a ray it never finished shows in any comparison
_UNWRITTEN_F32 = 0x7FC0DEAD
_UNWRITTEN_I32 = -2


def _outputs(R, dev, want_attrs, unwritten=False):
    """t, best, visits, attrs, overflow count; then the scheduler's ray
    counter and its seven counts (``_result``), both zero."""
    def i32(*shape, fill=_UNWRITTEN_I32):
        if unwritten:
            return torch.full(shape, fill, dtype=torch.int32, device=dev)
        return torch.empty(shape, dtype=torch.int32, device=dev)

    def f32(*shape):
        return i32(*shape, fill=_UNWRITTEN_F32).view(torch.float32)

    def zeros(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return (f32(R), i32(R), i32(2, R), f32(5, R) if want_attrs else None,
            zeros(dtype=torch.int32), zeros(1, dtype=torch.int32),
            zeros(7, dtype=torch.int64))


def _result(outs) -> "TraceResult":
    """The TraceResult of ``_outputs`` after a launch."""
    counts = outs[6]
    return TraceResult(*outs[:5], sched=counts[:4], leaf_sched=counts[4:])


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr() if x is not None else 0)


_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
          ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int]
         + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()


def _load(target: str, fn: str, extra_args=()):
    with _libs_lock:
        if target not in _libs:
            lib = ctypes.CDLL(_build.ensure(target))
            f = getattr(lib, fn)
            f.restype = ctypes.c_int
            f.argtypes = _ARGS + list(extra_args)
            _libs[target] = lib
        return getattr(_libs[target], fn)


def _call_args(packed, org, dir, tnear, tfar, mask, time, outs, occlusion,
               want_attrs, robust):
    out_t, out_best, out_visits, out_attr, out_ovf = outs[:5]
    return [_ptr(packed.nodes), packed.nodes.shape[0],
            _ptr(packed.leaves), packed.leaves.shape[0],
            packed.leaves.shape[1],
            _ptr(org), _ptr(dir), _ptr(tnear), _ptr(tfar), _ptr(mask),
            _ptr(time), org.shape[0],
            _ptr(out_t), _ptr(out_best), _ptr(out_visits), _ptr(out_attr),
            _ptr(out_ovf), int(occlusion), int(want_attrs),
            int(packed.has_mask), int(robust), int(packed.has_kinds),
            sum(1 << k for k in packed.kind_classes),
            int(packed.has_motion), int(packed.has_win), int(packed.nf),
            int(packed.curve_rate), _ptr(_curve_weights_on(packed,
                                                           org.device))]


# ---------------------------------------------------------------------------
# the Hopper kernel
# ---------------------------------------------------------------------------

def _want_attrs(packed: PackedScene, occlusion: bool, want_attrs: bool):
    if want_attrs and not occlusion and not packed.tri_attrs:
        raise ValueError("the kernel emits u/v/Ng for pure-triangle scenes "
                         "only (tri_attrs)")
    return want_attrs and not occlusion


def traverse_kernel(packed: PackedScene, org, dir, tnear, tfar, mask,
                    occlusion: bool = False, want_attrs: bool = False,
                    robust: bool = False, time=None) -> TraceResult:
    """Launch the traversal kernel on CUDA tensors (raises for others).
    ``time``: (R,) float32 ray times, read by moving scenes only."""
    if org.device.type != "cuda":
        raise ValueError("traverse_kernel takes CUDA tensors only")
    want_attrs = _want_attrs(packed, occlusion, want_attrs)
    time = _time(packed, org, time)
    _check(packed, org, dir, tnear, tfar, mask, time)
    for name, x in (("nodes", packed.nodes), ("leaves", packed.leaves)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    launch = _load("traverse_cuda", "traverse_launch",
                   [ctypes.c_void_p] * 3)
    outs = _outputs(org.shape[0], org.device, want_attrs)
    stream = torch.cuda.current_stream(org.device).cuda_stream
    err = launch(*_call_args(packed, org, dir, tnear, tfar, mask, time, outs,
                             occlusion, want_attrs, robust),
                 _ptr(outs[5]), _ptr(outs[6]), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"traverse kernel launch failed: CUDA error {err}")
    LAUNCHES[packed_variant(packed, occlusion, want_attrs, robust)] += 1
    return _result(outs)


def traverse_twin(packed: PackedScene, org, dir, tnear, tfar, mask,
                  occlusion: bool = False, want_attrs: bool = False,
                  robust: bool = False, time=None) -> TraceResult:
    """The kernel's per-ray logic compiled for the host (test-only)."""
    if org.device.type != "cpu":
        raise ValueError("traverse_twin takes CPU tensors only")
    want_attrs = _want_attrs(packed, occlusion, want_attrs)
    time = _time(packed, org, time)
    _check(packed, org, dir, tnear, tfar, mask, time)
    run = _load("traverse_twin", "traverse_twin", [ctypes.c_void_p])
    outs = _outputs(org.shape[0], org.device, want_attrs, unwritten=True)
    if run(*_call_args(packed, org, dir, tnear, tfar, mask, time, outs,
                       occlusion, want_attrs, robust), _ptr(outs[6])) != 0:
        raise ValueError("the twin has no such variant")
    return _result(outs)


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def _bits(x):
    return x.contiguous().view(torch.int32)


def _as_tensors(a, b):
    # a Python scalar becomes a filled tensor on the other's device (a
    # fill, not a host-to-device copy, which would wait for the device)
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.broadcast_tensors(a, b)


def _jmin(a, b):
    """jnp.minimum: NaN propagates, and -0 < +0 (torch.minimum has no
    order between the zeros)."""
    a, b = _as_tensors(a, b)
    eq = (_bits(a) | _bits(b)).view(torch.float32)
    r = torch.where(a < b, a, torch.where(b < a, b, eq))
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b, r)


def _jmax(a, b):
    """jnp.maximum: NaN propagates, and +0 > -0."""
    a, b = _as_tensors(a, b)
    eq = (_bits(a) & _bits(b)).view(torch.float32)
    r = torch.where(a > b, a, torch.where(b > a, b, eq))
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b, r)


def _sqrt(x):
    """Correctly rounded float32 square root. PyTorch's CPU kernel is not
    (it can be 1 ulp off); the Pallas kernel's, CUDA's sqrtf and the twin's
    are. The float64 root rounded once to float32 is exact."""
    return torch.sqrt(x.double()).to(torch.float32)


def _where(c, a, b):
    """jnp.where with float32 scalars allowed on either side."""
    a, b = _as_tensors(a, b)
    return torch.where(c, a, b)


# ---- leaf tests per kind class, over (n, 8) slots, in the Pallas kernel's
# association order (traverse_pallas.py:525-857). o, d: 3-tuples of (n, 1)
# ray components; tn, tf: (n, 1); f: the slot fields, each (n, 8) (the
# first 9 for every class but the curve's 16).

def _leaf_moeller(f, o, d, tn, tf):
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = f
    ox, oy, oz = o
    dx, dy, dz = d
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = det.abs() > 1e-24
    inv_det = _where(det_ok, torch.reciprocal(det), 0.0)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    valid = (det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
             & (tt >= tn) & (tt <= tf))
    return valid, tt, (uu, vv)


def _leaf_pluecker(f, o, d, tn, tf):
    """B2: the watertight Plücker test (:529-556)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = f
    ox, oy, oz = o
    dx, dy, dz = d
    ax = v0x - ox
    ay = v0y - oy
    az = v0z - oz
    bx = ax + e1x
    by = ay + e1y
    bz = az + e1z
    cx = ax + e2x
    cy = ay + e2y
    cz = az + e2z
    up = (dx * (cy * bz - cz * by) + dy * (cz * bx - cx * bz)
          + dz * (cx * by - cy * bx))
    vp = (dx * (ay * cz - az * cy) + dy * (az * cx - ax * cz)
          + dz * (ax * cy - ay * cx))
    wp = (dx * (by * az - bz * ay) + dy * (bz * ax - bx * az)
          + dz * (bx * ay - by * ax))
    min_uvw = _jmin(_jmin(up, vp), wp)
    max_uvw = _jmax(_jmax(up, vp), wp)
    ngx = e1y * e2z - e1z * e2y
    ngy = e1z * e2x - e1x * e2z
    ngz = e1x * e2y - e1y * e2x
    den = ngx * dx + ngy * dy + ngz * dz
    den_ok = den.abs() > 1e-30
    inv_den = _where(den_ok, torch.reciprocal(den), 0.0)
    tt = (ngx * ax + ngy * ay + ngz * az) * inv_den
    valid = (((min_uvw >= 0.0) | (max_uvw <= 0.0)) & den_ok
             & (tt >= tn) & (tt <= tf))
    s = up + vp + wp
    rcp_s = _where(s.abs() > 1e-30, torch.reciprocal(s), 0.0)
    return valid, tt, (up * rcp_s, vp * rcp_s)


def _leaf_sphere(f, o, d, tn, tf, ddot):
    """B4: sphere point (:585-598)."""
    ocx = o[0] - f[0]
    ocy = o[1] - f[1]
    ocz = o[2] - f[2]
    r = f[3]
    dx, dy, dz = d
    bq = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    cq = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = bq * bq - 4.0 * ddot * cq
    sq = _sqrt(_jmax(disc, 0.0))
    inv2a = 1.0 / _jmax(2.0 * ddot, 1e-30)
    st0 = (-bq - sq) * inv2a
    st1 = (-bq + sq) * inv2a
    ok = disc >= 0.0
    v0 = ok & (st0 >= tn) & (st0 <= tf)
    v1 = ok & (st1 >= tn) & (st1 <= tf)
    return v0 | v1, torch.where(v0, st0, st1)


def _disc_hit(f, o, d, tn, tf, td, cmo):
    dx, dy, dz = d
    px = td * dx - cmo[0]
    py = td * dy - cmo[1]
    pz = td * dz - cmo[2]
    r2 = px * px + py * py + pz * pz
    r = f[3]
    return (td >= tn) & (td <= tf) & (r2 <= r * r)


def _leaf_disc(f, o, d, tn, tf):
    """B4: ray-facing disc (:600-608)."""
    cmo = (f[0] - o[0], f[1] - o[1], f[2] - o[2])
    dx, dy, dz = d
    d2 = _jmax(dx * dx + dy * dy + dz * dz, 1e-30)
    td = (cmo[0] * dx + cmo[1] * dy + cmo[2] * dz) / d2
    return _disc_hit(f, o, d, tn, tf, td, cmo), td


def _leaf_oriented_disc(f, o, d, tn, tf):
    """B4: oriented disc (:610-620)."""
    cmo = (f[0] - o[0], f[1] - o[1], f[2] - o[2])
    nx, ny, nz = f[4], f[5], f[6]
    dx, dy, dz = d
    dn = dx * nx + dy * ny + dz * nz
    ok = dn.abs() > 1e-12
    td = (cmo[0] * nx + cmo[1] * ny + cmo[2] * nz) / _where(ok, dn, 1.0)
    return ok & _disc_hit(f, o, d, tn, tf, td, cmo), td


def _leaf_round_line(f, o, d, tn, tf, ddot):
    """B5: tangent cone + end spheres, begin-cap flag in field 8
    (:622-691)."""
    p0x, p0y, p0z, r0, p1x, p1y, p1z, r1, flag = f
    ox, oy, oz = o
    dx, dy, dz = d
    rcpdd = 1.0 / _jmax(ddot, 1e-30)
    ccx = 0.5 * (p0x + p1x)
    ccy = 0.5 * (p0y + p1y)
    ccz = 0.5 * (p0z + p1z)
    dtl = ((ccx - ox) * dx + (ccy - oy) * dy + (ccz - oz) * dz) * rcpdd
    o2x = ox + dtl * dx
    o2y = oy + dtl * dy
    o2z = oz + dtl * dz
    dpx = p1x - p0x
    dpy = p1y - p0y
    dpz = p1z - p0z
    dpdp = dpx * dpx + dpy * dpy + dpz * dpz
    drr = r1 - r0
    r0dr = r0 * drr
    gco = dpdp - drr * drr
    oxx = o2x - p0x
    oyy = o2y - p0y
    ozz = o2z - p0z
    odp = oxx * dpx + oyy * dpy + ozz * dpz
    dodp = dx * dpx + dy * dpy + dz * dpz
    ypc = odp + r0dr
    oo = oxx * oxx + oyy * oyy + ozz * ozz
    odo = dx * oxx + dy * oyy + dz * ozz
    ac = gco * ddot - dodp * dodp
    bc = 2.0 * (gco * odo - dodp * ypc)
    cc = gco * oo - odp * odp - r0 * r0 * dpdp - 2.0 * r0dr * odp
    dc = bc * bc - 4.0 * ac * cc
    cone_ok = (dc >= 0.0) & (gco > 0.0) & (ac.abs() > 1e-18)
    qc = _sqrt(_jmax(dc, 0.0))
    rc2a = 1.0 / _where(cone_ok, 2.0 * ac, 1.0)
    tcf = (-bc - qc) * rc2a
    tcb = (-bc + qc) * rc2a
    ycf = ypc + tcf * dodp
    ycb = ypc + tcb * dodp
    cf_ok = cone_ok & (ycf > -ULP1) & (ycf <= gco)
    cb_ok = cone_ok & (ycb > -ULP1) & (ycb <= gco)

    def lsph(cx, cy, cz, cr):
        o1x = o2x - cx
        o1y = o2y - cy
        o1z = o2z - cz
        o1do = o1x * dx + o1y * dy + o1z * dz
        h2 = o1do * o1do - ddot * (o1x * o1x + o1y * o1y + o1z * o1z
                                   - cr * cr)
        rt = _sqrt(_jmax(h2, 0.0))
        return h2 >= 0.0, (-o1do - rt) * rcpdd, (-o1do + rt) * rcpdd

    s0ok, ts0f, ts0b = lsph(p0x, p0y, p0z, r0)
    s1ok, ts1f, ts1b = lsph(p1x, p1y, p1z, r1)
    s0ok = s0ok & (flag < 0.5)
    s0f = s0ok & (ypc + ts0f * dodp < 0.0)
    s0b = s0ok & (ypc + ts0b * dodp < 0.0)
    s1f = s1ok & (ypc + ts1f * dodp > gco)
    s1b = s1ok & (ypc + ts1b * dodp > gco)
    t_lo = _jmin(_where(cf_ok, tcf, BIG),
                 _jmin(_where(s0f, ts0f, BIG), _where(s1f, ts1f, BIG)))
    t_up = _jmax(_where(cb_ok, tcb, -BIG),
                 _jmax(_where(s0b, ts0b, -BIG), _where(s1b, ts1b, -BIG)))
    lo_ok = (tn <= dtl + t_lo) & (dtl + t_lo <= tf) & (t_lo < BIG)
    up_ok = (tn <= dtl + t_up) & (dtl + t_up <= tf) & (t_up > -BIG)
    return lo_ok | up_ok, dtl + torch.where(lo_ok, t_lo, t_up)


def _leaf_flat_line(f, o, d, tn, tf):
    """B5: ray-facing flat segment (:693-717). The Pallas kernel's
    ``rsqrt`` is taken as 1/sqrt, correctly rounded in every port
    version."""
    p0x, p0y, p0z, r0, p1x, p1y, p1z, r1 = f[:8]
    ox, oy, oz = o
    dx, dy, dz = d
    vx = p1x - p0x
    vy = p1y - p0y
    vz = p1z - p0z
    wx = p0x - ox
    wy = p0y - oy
    wz = p0z - oz
    dd = _jmax(dx * dx + dy * dy + dz * dz, 1e-30)
    invdd = 1.0 / dd
    wd = wx * dx + wy * dy + wz * dz
    vd = vx * dx + vy * dy + vz * dz
    wv = (wx * vx + wy * vy + wz * vz) - wd * vd * invdd
    vv2 = (vx * vx + vy * vy + vz * vz) - vd * vd * invdd
    okf = vv2 > 1e-20
    sf = _jmin(1.0, _jmax(0.0, _where(okf, -wv / _where(okf, vv2, 1.0),
                                      0.0)))
    mx = wx + sf * vx
    my = wy + sf * vy
    mz = wz + sf * vz
    md = mx * dx + my * dy + mz * dz
    tl = md * invdd
    d2f = mx * mx + my * my + mz * mz - md * md * invdd
    rr = r0 + sf * (r1 - r0)
    ok = ((d2f <= rr * rr) & (tl >= tn) & (tl <= tf)
          & (tl > 2.0 * rr * (1.0 / _sqrt(dd)))
          & ((vx != 0.0) | (vy != 0.0) | (vz != 0.0)))
    return ok, tl


def curve_frame(d):
    """B7: the per-ray curve frame of the unnormalized direction
    (:197-221): rows vx, vy (3-tuples), vz * ds (3-tuple) and ds = 1 /
    |d|, with 1 / sqrt, not rsqrt."""
    dx, dy, dz = d
    ds = 1.0 / _sqrt(_jmax(dx * dx + dy * dy + dz * dz, 1e-36))
    nx, ny, nz = dx * ds, dy * ds, dz * ds
    pick = (nz * nz + ny * ny) > (nz * nz + nx * nx)
    fx0 = _where(pick, 0.0, -nz)
    fx1 = _where(pick, nz, 0.0)
    fx2 = _where(pick, -ny, nx)
    fl = 1.0 / _sqrt(_jmax(fx0 * fx0 + fx1 * fx1 + fx2 * fx2, 1e-36))
    fx0, fx1, fx2 = fx0 * fl, fx1 * fl, fx2 * fl
    fy0 = ny * fx2 - nz * fx1
    fy1 = nz * fx0 - nx * fx2
    fy2 = nx * fx1 - ny * fx0
    fyl = 1.0 / _sqrt(_jmax(fy0 * fy0 + fy1 * fy1 + fy2 * fy2, 1e-36))
    return ((fx0, fx1, fx2), (fy0 * fyl, fy1 * fyl, fy2 * fyl),
            (nx * ds, ny * ds, nz * ds), ds)


def _leaf_ribbon(f, o, tn, tf, frame, weights):
    """B7: the ribbon (:739-856) on 16-field Bezier slots (CP j at fields
    4j..4j+3): CPs into the ray frame, ``len(weights) - 1`` ruled quads
    between the +-r offset curves, backface-culled 2D quad tests, the
    nearest accepted t of the slot; its hit is the OR of every accepted
    segment. ``weights``: ``ribbon_weights`` rows as Python floats."""
    (vx, vy, vz, ds) = frame
    ox, oy, oz = o
    c2x, c2y, c2z, cpr = [], [], [], []
    for j in range(4):
        rx = f[4 * j] - ox
        ry = f[4 * j + 1] - oy
        rz = f[4 * j + 2] - oz
        c2x.append(rx * vx[0] + ry * vx[1] + rz * vx[2])
        c2y.append(rx * vy[0] + ry * vy[1] + rz * vy[2])
        c2z.append(rx * vz[0] + ry * vz[1] + rz * vz[2])
        cpr.append(f[4 * j + 3])
    amax = torch.zeros_like(c2x[0])
    for j in range(4):
        for c in (c2x[j], c2y[j], c2z[j], cpr[j]):
            amax = _jmax(amax, c.abs())
    eps = RIBBON_EPS * amax

    def knot(k):
        w0, w1, w2, w3, q0, q1, q2 = weights[k]

        def pos(c):
            return w0 * c[0] + w1 * c[1] + w2 * c[2] + w3 * c[3]

        def der(c):
            return 3.0 * (q0 * (c[1] - c[0]) + q1 * (c[2] - c[1])
                          + q2 * (c[3] - c[2]))
        dkx, dky, dkz = der(c2x), der(c2y), der(c2z)
        small = _jmax(_jmax(dkx.abs(), dky.abs()), dkz.abs()) < eps
        return pos(c2x), pos(c2y), pos(c2z), pos(cpr), dkx, dky, small

    rib_t = torch.full_like(eps, float("inf"))
    rib_hit = torch.zeros_like(eps, dtype=torch.bool)
    px0, py0, pz0, pr0, dx0, dy0, sm0 = knot(0)
    for i in range(len(weights) - 1):
        px1, py1, pz1, pr1, dx1, dy1, sm1 = knot(i + 1)
        sdx = px1 - px0
        sdy = py1 - py0
        d0x = torch.where(sm0, sdx, dx0)
        d0y = torch.where(sm0, sdy, dy0)
        d1x = torch.where(sm1, sdx, dx1)
        d1y = torch.where(sm1, sdy, dy1)
        # cylinder culling against the 2D origin (ribbon.h:66-71)
        num = sdx * py0 - sdy * px0
        den2 = sdx * sdx + sdy * sdy
        rmax = _jmax(pr0, pr1)
        vseg = num * num <= rmax * rmax * den2
        n0l = 1.0 / _sqrt(_jmax(d0y * d0y + d0x * d0x, 1e-36))
        n1l = 1.0 / _sqrt(_jmax(d1y * d1y + d1x * d1x, 1e-36))
        n0x, n0y = d0y * n0l, -d0x * n0l
        n1x, n1y = d1y * n1l, -d1x * n1l
        # quad (lp0, lp1, up1, up0), backface-culled 2D variant
        # (quad_intersector.h:15-74); z rides along for t
        va = (px0 + pr0 * n0x, py0 + pr0 * n0y, pz0)
        vb = (px1 + pr1 * n1x, py1 + pr1 * n1y, pz1)
        vc = (px1 - pr1 * n1x, py1 - pr1 * n1y, pz1)
        vd = (px0 - pr0 * n0x, py0 - pr0 * n0y, pz0)
        edbx = vb[0] - vd[0]
        edby = vb[1] - vd[1]
        sel = vd[0] * edby - vd[1] * edbx <= 0.0
        v0 = [torch.where(sel, a, c) for a, c in zip(va, vc)]
        v1 = [torch.where(sel, b, d) for b, d in zip(vb, vd)]
        v2 = [torch.where(sel, d, b) for b, d in zip(vb, vd)]
        e0 = [b - a for a, b in zip(v0, v2)]
        e1 = [a - b for a, b in zip(v0, v1)]
        uq = v0[0] * e0[1] - v0[1] * e0[0]
        vq = v1[0] * e1[1] - v1[1] * e1[0]
        vseg = vseg & (_jmax(uq, vq) <= 0.0)
        ngx = e1[1] * e0[2] - e1[2] * e0[1]
        ngy = e1[2] * e0[0] - e1[0] * e0[2]
        ngz = e1[0] * e0[1] - e1[1] * e0[0]
        rden = _where(ngz != 0.0, 1.0 / _where(ngz == 0.0, 1.0, ngz), 0.0)
        tq = rden * (v0[0] * ngx + v0[1] * ngy + v0[2] * ngz)
        vseg = vseg & (tn <= tq) & (tq <= tf) & (ngz != 0.0)
        uq = uq * rden
        uq = torch.where(sel, uq, 1.0 - uq)
        r_at = pr0 * (1.0 - uq) + pr1 * uq
        # self-intersection avoidance (ribbon.h:117-120)
        vseg = vseg & (tq > 2.0 * r_at * ds)
        rib_t = torch.where(vseg & (tq < rib_t), tq, rib_t)
        rib_hit = rib_hit | vseg
        px0, py0, pz0, pr0, dx0, dy0, sm0 = px1, py1, pz1, pr1, dx1, dy1, sm1
    return rib_hit, rib_t


def _leaf_round_curve(f, o, d, tn, tf, weights):
    """B8: the round curve's swept circle (:858-1046) on 16-field Bezier
    slots. Each of R cone segments between knots k / R gives a candidate
    (the round line's tangent cone, no end spheres); every candidate seeds
    a 5-step Jacobian-Newton polish of the exact sweep equations in the
    frame recentred on the curve; the nearest root confirmed on a candidate
    segment wins. ``weights``: (R + 1, 4) float32 tensor, the
    ``curve_weights`` cubic rows of the round knots.

    The R segments ride a trailing axis: each element's arithmetic is the
    Pallas kernel's for its segment (the min over segments is exact), with
    R times fewer operations launched."""
    ox, oy, oz = (x[..., None] for x in o)
    dx, dy, dz = (x[..., None] for x in d)
    tn = tn[..., None]
    tf = tf[..., None]
    cpx = [f[4 * j][..., None] for j in range(4)]
    cpy = [f[4 * j + 1][..., None] for j in range(4)]
    cpz = [f[4 * j + 2][..., None] for j in range(4)]
    cpr = [f[4 * j + 3][..., None] for j in range(4)]
    n_seg = weights.shape[0] - 1
    w = [weights[:, j] for j in range(4)]
    ddot = dx * dx + dy * dy + dz * dz
    rcpdd = 1.0 / _jmax(ddot, 1e-30)

    def bez(w, c):
        return w[0] * c[0] + w[1] * c[1] + w[2] * c[2] + w[3] * c[3]

    qx, qy, qz, qr = (bez(w, c) for c in (cpx, cpy, cpz, cpr))
    p0x, p0y, p0z, r0 = (q[..., :-1] for q in (qx, qy, qz, qr))
    p1x, p1y, p1z, r1 = (q[..., 1:] for q in (qx, qy, qz, qr))
    ccx = 0.5 * (p0x + p1x)
    ccy = 0.5 * (p0y + p1y)
    ccz = 0.5 * (p0z + p1z)
    dtl = ((ccx - ox) * dx + (ccy - oy) * dy + (ccz - oz) * dz) * rcpdd
    o2x = ox + dtl * dx
    o2y = oy + dtl * dy
    o2z = oz + dtl * dz
    dpx = p1x - p0x
    dpy = p1y - p0y
    dpz = p1z - p0z
    dpdp = dpx * dpx + dpy * dpy + dpz * dpz
    drr = r1 - r0
    r0dr = r0 * drr
    gco = dpdp - drr * drr
    oxx = o2x - p0x
    oyy = o2y - p0y
    ozz = o2z - p0z
    odp = oxx * dpx + oyy * dpy + ozz * dpz
    dodp = dx * dpx + dy * dpy + dz * dpz
    ypc = odp + r0dr
    oo = oxx * oxx + oyy * oyy + ozz * ozz
    odo = dx * oxx + dy * oyy + dz * ozz
    ac = gco * ddot - dodp * dodp
    bc = 2.0 * (gco * odo - dodp * ypc)
    cc = gco * oo - odp * odp - r0 * r0 * dpdp - 2.0 * r0dr * odp
    dc = bc * bc - 4.0 * ac * cc
    cone_ok = (dc >= 0.0) & (gco > 0.0) & (ac.abs() > 1e-18)
    qc = _sqrt(_jmax(dc, 0.0))
    rc2a = 1.0 / _where(cone_ok, 2.0 * ac, 1.0)
    tcf = (-bc - qc) * rc2a
    tcb = (-bc + qc) * rc2a
    ycf = ypc + tcf * dodp
    ycb = ypc + tcb * dodp
    cf_ok = cone_ok & (ycf > 0.0) & (ycf <= gco)
    cb_ok = cone_ok & (ycb > 0.0) & (ycb <= gco)
    tlo = _where(cf_ok, tcf, BIG)
    tup = _where(cb_ok, tcb, -BIG)
    lo_ok = (tn <= dtl + tlo) & (dtl + tlo <= tf) & (tlo < BIG)
    up_ok = (tn <= dtl + tup) & (dtl + tup <= tf) & (tup > -BIG)
    t_i = dtl + torch.where(lo_ok, tlo, tup)
    y_i = torch.where(lo_ok, ycf, ycb)
    hit_i = lo_ok | up_ok
    seg = torch.arange(n_seg, dtype=torch.float32, device=t_i.device)
    # divided by a device tensor: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, inexact for R = 12
    u_i = ((seg + _jmin(_jmax(y_i / _jmax(gco, 1e-30), 0.0), 1.0))
           / torch.full((), float(n_seg), device=t_i.device))

    # the Newton frame: the ray recentred at the curve's CP centroid
    cenx = 0.25 * (cpx[0] + cpx[1] + cpx[2] + cpx[3])
    ceny = 0.25 * (cpy[0] + cpy[1] + cpy[2] + cpy[3])
    cenz = 0.25 * (cpz[0] + cpz[1] + cpz[2] + cpz[3])
    dtc = ((cenx - ox) * dx + (ceny - oy) * dy + (cenz - oz) * dz) * rcpdd
    relx = [c - (ox + dtc * dx) for c in cpx]
    rely = [c - (oy + dtc * dy) for c in cpy]
    relz = [c - (oz + dtc * dz) for c in cpz]
    bmax = torch.zeros_like(relx[0])
    for j in range(4):
        for c in (relx[j], rely[j], relz[j], cpr[j]):
            bmax = _jmax(bmax, c.abs())
    p_err = SWEEP_ERR * bmax
    len_dir = _sqrt(_jmax(ddot, 1e-36))

    def d1(c, b0, b1, b2):
        return 3.0 * (b0 * (c[1] - c[0]) + b1 * (c[2] - c[1])
                      + b2 * (c[3] - c[2]))

    def d2(c, un):
        return 6.0 * ((1.0 - un) * (c[2] - 2 * c[1] + c[0])
                      + un * (c[3] - 2 * c[2] + c[1]))

    # a segment without a candidate seeds at the curve centre (finite
    # arithmetic; its result is masked out)
    un = u_i
    t0w = torch.where(hit_i, t_i, dtc)
    tn_ = t0w - dtc
    ok = torch.zeros_like(hit_i)
    t_p = t0w
    for _ in range(ROUND_NEWTON):
        sm = 1.0 - un
        wn = (sm * sm * sm, 3.0 * sm * sm * un, 3.0 * sm * un * un,
              un * un * un)
        px, py, pz, pr = (bez(wn, c) for c in (relx, rely, relz, cpr))
        b0 = sm * sm
        b1 = 2.0 * sm * un
        b2 = un * un
        dpx, dpy, dpz, dpr = (d1(c, b0, b1, b2)
                              for c in (relx, rely, relz, cpr))
        ddx, ddy, ddz = (d2(c, un) for c in (relx, rely, relz))
        rx = tn_ * dx - px
        ry = tn_ * dy - py
        rz = tn_ * dz - pz
        len_r = _sqrt(_jmax(rx * rx + ry * ry + rz * rz, 0.0))
        q_err = SWEEP_ERR * len_dir * tn_
        r_err = _jmax(q_err, p_err)
        dp2 = dpx * dpx + dpy * dpy + dpz * dpz
        rl = 1.0 / _sqrt(_jmax(dp2, 1e-36))
        tx, ty, tz = dpx * rl, dpy * rl, dpz * rl
        dd = dpx * ddx + dpy * ddy + dpz * ddz
        rl3 = rl * rl * rl
        dtx = (ddx * dp2 - dpx * dd) * rl3
        dty = (ddy * dp2 - dpy * dd) * rl3
        dtz = (ddz * dp2 - dpz * dd) * rl3
        cos_err = p_err * rl
        fv = rx * tx + ry * ty + rz * tz
        f_err = len_r * p_err + r_err + cos_err * (1.0 + len_r)
        dfdu = (-dpx * tx - dpy * ty - dpz * tz
                + rx * dtx + ry * dty + rz * dtz)
        dfdt = dx * tx + dy * ty + dz * tz
        k = _jmax(rx * rx + ry * ry + rz * rz - fv * fv, 0.0)
        dkdu = (-rx * dpx - ry * dpy - rz * dpz) - fv * dfdu
        dkdt = (rx * dx + ry * dy + rz * dz) - fv * dfdt
        rsk = 1.0 / _sqrt(_jmax(k, 1e-36))
        gv = _sqrt(k) - pr
        g_err = r_err + f_err + SWEEP_ERR * bmax
        dgdu = dkdu * rsk - dpr
        dgdt = dkdt * rsk
        det = dfdu * dgdt - dfdt * dgdu
        rdet = _where(det.abs() > 1e-30, 1.0 / det, 0.0)
        du = (dgdt * fv - dfdt * gv) * rdet
        dt_ = (-dgdu * fv + dfdu * gv) * rdet
        conv = (fv.abs() < f_err) & (gv.abs() < g_err)
        tw = tn_ + dtc
        okn = conv & (tn <= tw) & (tw <= tf) & (un >= 0.0) & (un <= 1.0)
        t_p = torch.where(okn & ~ok, tw, t_p)
        ok = ok | okn
        un = torch.where(ok, un, un - du)
        tn_ = torch.where(ok, tn_, tn_ - dt_)
    okh = ok & hit_i
    newt_t = _where(okh, t_p, float("inf")).amin(-1)
    return hit_i.any(-1) & okh.any(-1), newt_t, hit_i.sum(-1)


def _fields(rec, at, nf):
    """The nf fields of a record's field block at word ``at``, each
    (n, 8)."""
    fw = rec[:, at:at + nf * LEAF_WIDTH].contiguous().view(torch.float32)
    return fw.reshape(-1, nf, LEAF_WIDTH).unbind(1)


def _chunk(rec, at):
    return rec[:, at:at + LEAF_WIDTH]


def _leaf_classes(packed: PackedScene, rec, o, d, tn, tf, robust: bool,
                  time=None):
    """Per-slot (valid, t, u/v of class 0, kind tag, fields, round-curve
    candidates per slot or None, window test or None) of one leaf record
    per ray, selected by the kind tag where the record carries one
    (:1048-1057). Moving scenes first lerp every field A -> B as
    a + w * (b - a), with w the ray time or, in windowed scenes, the
    clipped window-local time; a slot whose window misses the ray time
    fails the window test, which the caller applies (:502-520,
    :1059-1060)."""
    nf = packed.nf
    f = _fields(rec, 0, nf)
    win_ok = None
    if packed.has_motion:
        w = time
        if packed.has_win:
            at = packed.chunk_at("t0")
            t0 = _chunk(rec, at).contiguous().view(torch.float32)
            t1 = _chunk(rec, at + LEAF_WIDTH).contiguous().view(torch.float32)
            w = _jmin(_jmax((time - t0) / _jmax(t1 - t0, 1e-9), 0.0), 1.0)
            win_ok = (time >= t0) & (time <= t1)
        f = tuple(a + w * (b - a) for a, b in
                  zip(f, _fields(rec, nf * LEAF_WIDTH, nf)))
    dx, dy, dz = d
    ddot = dx * dx + dy * dy + dz * dz
    results = []
    uv = None
    cands = None
    f9 = f[:9]
    for k in packed.kind_classes:
        if k == 0:
            v, t, uv = (_leaf_pluecker if robust else _leaf_moeller)(
                f9, o, d, tn, tf)
        elif k == 2:
            v, t = _leaf_sphere(f9, o, d, tn, tf, ddot)
        elif k == 3:
            v, t = _leaf_disc(f9, o, d, tn, tf)
        elif k == 4:
            v, t = _leaf_oriented_disc(f9, o, d, tn, tf)
        elif k == 5:
            v, t = _leaf_round_line(f9, o, d, tn, tf, ddot)
        elif k == 6:
            v, t = _leaf_flat_line(f9, o, d, tn, tf)
        elif k == KIND_CURVE_FLAT:
            weights = ribbon_weights(packed.curve_rate).tolist()
            v, t = _leaf_ribbon(f, o, tn, tf, curve_frame(d), weights)
        else:
            n_seg = round_segments(packed.curve_rate)
            weights = torch.from_numpy(ribbon_weights(n_seg)[:, :4]).to(
                tn.device)
            v, t, cands = _leaf_round_curve(f, o, d, tn, tf, weights)
        results.append((k, v, t))
    if not packed.has_kinds:
        _, valid, tt = results[0]
        tag = torch.zeros_like(rec[:, :LEAF_WIDTH])
    else:
        tag = _chunk(rec, packed.chunk_at("kind"))
        valid = torch.zeros_like(tag, dtype=torch.bool)
        tt = torch.zeros_like(f[0])
        for k, v, t in results:
            sel = tag == k
            valid = valid | (sel & v)
            tt = torch.where(sel, t, tt)
    if cands is not None:
        cands = torch.where(tag == KIND_CURVE_ROUND, cands, 0)
    return valid, tt, uv, tag, f, cands, win_ok


def _bf16_pairs(words):
    """Decode (n, 3, 8) int32 lo|hi words into float32 lo and hi."""
    w = words.long()
    lo = ((w & 0xFFFF) << 16).to(torch.int32).view(torch.float32)
    hi = (w & 0xFFFF0000).to(torch.int32).view(torch.float32)
    return lo, hi


def traverse_packed_reference(packed: PackedScene, org, dir, tnear, tfar,
                              mask, occlusion: bool = False,
                              want_attrs: bool = False,
                              robust: bool = False, time=None) -> TraceResult:
    """Plain PyTorch version of the traversal kernel: same inputs, same
    outputs, bit for bit.

    A loop over steps, vectorized over the rays still active. Each step
    splits them into rays at a node and rays at a leaf and compacts the
    active set: three waits for the device per step. Everything else is
    masked updates, so the steps of a long tail (a few rays that walk many
    overlapping boxes, as in motion blur) cost kernel launches only."""
    want_attrs = _want_attrs(packed, occlusion, want_attrs)
    time = _time(packed, org, time)
    _check(packed, org, dir, tnear, tfar, mask, time)
    dev = org.device
    R = org.shape[0]
    nodes, leaves = packed.nodes, packed.leaves
    n_nodes, n_leaves = nodes.shape[0], leaves.shape[0]
    rd = rcp_safe(dir)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    slot = torch.arange(8, dtype=torch.int32, device=dev)
    push_j = torch.arange(1, 8, device=dev)
    tf = tfar.clone()
    best = torch.full((R,), -1, dtype=torch.int32, device=dev)
    visits = torch.zeros((2, R), dtype=torch.int32, device=dev)
    attrs = (torch.zeros((5, R), dtype=torch.float32, device=dev)
             if want_attrs else None)
    # column STACK takes the pushes that fall off the stack (never read)
    stack = torch.zeros((R, STACK + 1), dtype=torch.int32, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    cur = torch.zeros(R, dtype=torch.int32, device=dev)
    overflow = torch.zeros(R, dtype=torch.bool, device=dev)
    class_slots = torch.zeros(N_TAGS, dtype=torch.int64, device=dev)
    round_cands = torch.zeros((), dtype=torch.int64, device=dev)
    live = tnear <= tfar
    if not packed.has_mask:
        # mask-free scenes fold the ray mask into activation (:1231-1235)
        live = live & (mask != 0)
    act = live.nonzero().squeeze(1)
    steps = 0
    while act.numel() > 0 and steps < MAX_STEPS:
        steps += 1
        c = cur[act]
        at_node = c >= 0
        node_i = at_node.nonzero().squeeze(1)     # positions within act
        leaf_i = (~at_node).nonzero().squeeze(1)
        pop = torch.zeros_like(at_node)

        # ---- nodes: 8-wide slab test on bf16 bounds (:453-494) ----
        na = act[node_i]
        if na.numel():
            visits[0, na] += 1
            rec = nodes[c[node_i].long().clamp(0, n_nodes - 1)]
            refs = rec[:, :8]
            lo, hi = _bf16_pairs(rec[:, 8:].reshape(-1, 3, 8))
            o = org[na].unsqueeze(2)                           # (n, 3, 1)
            r = rd[na].unsqueeze(2)
            t0 = (lo - o) * r                                  # (n, 3, 8)
            t1 = (hi - o) * r
            tmin = _jmin(t0, t1)
            tmax = _jmax(t0, t1)
            if robust:
                # +-3-ulp widened slabs (:469-479); tnear, tf unscaled
                tmin = tmin * ROBUST_DOWN
                tmax = tmax * ROBUST_UP
            tent = _jmax(_jmax(tmin[:, 0], tmin[:, 1]),
                         _jmax(tmin[:, 2], tnear[na, None]))
            tex = _jmin(_jmin(tmax[:, 0], tmax[:, 1]),
                        _jmin(tmax[:, 2], tf[na, None]))
            hit = (tent <= tex) & (refs != int(INVALID_REC))
            kd = _bits(_jmax(tent, zero))
            key = torch.where(hit, (kd & ~7) | slot, INF_BITS | slot)
            h = hit.sum(1)
            skey = torch.sort(key, dim=1).values
            srefs = refs.gather(1, (skey & 7).long())
            spn = sp[na]
            # push sorted[h-1] .. sorted[1] (farthest first) (:1150-1178)
            pos = spn[:, None] + h[:, None] - 1 - push_j       # (n, 7)
            ok = (push_j < h[:, None]) & (pos < STACK)
            stack[na[:, None], torch.where(ok, pos, STACK)] = srefs[:, 1:]
            new_sp = spn + torch.clamp(h - 1, min=0)
            overflow[na] |= new_sp > STACK
            sp[na] = new_sp
            has = h > 0
            cur[na] = torch.where(has, srefs[:, 0], cur[na])
            pop[node_i] = ~has

        # ---- leaves: per-kind tests over 8 slots, best slot key
        # (:496-579, :1048-1068) ----
        la = act[leaf_i]
        if la.numel():
            visits[1, la] += 1
            lid = (-c[leaf_i] - 1).long()
            rec = leaves[lid.clamp(0, n_leaves - 1)]
            o = org[la]
            d = dir[la]
            valid, tt, uv, tag, f, cands, let = _leaf_classes(
                packed, rec, (o[:, 0:1], o[:, 1:2], o[:, 2:3]),
                (d[:, 0:1], d[:, 1:2], d[:, 2:3]), tnear[la, None],
                tf[la, None], robust,
                None if time is None else time[la, None])
            if packed.has_mask:
                smask = _chunk(rec, packed.chunk_at("mask"))
                ok = (smask & mask[la, None]) != 0
                let = ok if let is None else let & ok
            if let is not None:
                valid = valid & let
            # the counters take the slots that the mask chunk and the
            # windows let through (let): the others need no test
            tags = tag if let is None else tag[let]
            class_slots.index_add_(0, tags.reshape(-1).long()
                                   .clamp(0, N_TAGS - 1),
                                   torch.ones_like(tags.reshape(-1),
                                                   dtype=torch.int64))
            if cands is not None:
                round_cands += (cands if let is None else cands[let]).sum()
            tb = _bits(_jmax(tt, zero))
            lkey = torch.where(valid, (tb & ~7) | slot, INF_BITS | slot)
            lmin = lkey.amin(dim=1)
            ws = (lmin & 7).long().unsqueeze(1)
            # exact (clamped) t of the winning slot, strictly nearer (:1184)
            t_new = tb.gather(1, ws).squeeze(1).view(torch.float32)
            found = (lmin < INF_BITS) & (t_new < tf[la])
            tf[la] = torch.where(found, t_new, tf[la])
            best[la] = torch.where(found, (lid * 8 + ws[:, 0]).to(torch.int32),
                                   best[la])
            if want_attrs:
                e1x, e1y, e1z, e2x, e2y, e2z = f[3:9]
                ngx = e1y * e2z - e1z * e2y
                ngy = e1z * e2x - e1x * e2z
                ngz = e1x * e2y - e1y * e2x
                for k, a in enumerate(uv + (ngx, ngy, ngz)):
                    attrs[k, la] = torch.where(
                        found, a.gather(1, ws).squeeze(1), attrs[k, la])
            pop[leaf_i] = True

        # ---- advance: pop the stack or retire (:1196-1215) ----
        spa = sp[act]
        can = pop & (spa > 0)
        top = (spa - 1).clamp(min=0)
        popped = torch.where(top < STACK,
                             stack[act, top.clamp(max=STACK - 1)], 0)
        cur[act] = torch.where(can, popped, cur[act])
        sp[act] = torch.where(can, top, spa)
        live[act] = live[act] & ~(pop & ~can)
        if occlusion:
            live &= best < 0
        act = act[live[act]]

    in_classes = torch.zeros(N_TAGS, dtype=torch.bool, device=dev)
    in_classes[list(packed.kind_classes)] = True
    return TraceResult(t=tf, best=best, visits=visits, attrs=attrs,
                       overflow=overflow.sum().to(torch.int32),
                       class_slots=torch.where(in_classes, class_slots, 0),
                       round_candidates=round_cands)


def trace(packed: PackedScene, org, dir, tnear, tfar, mask,
          occlusion: bool = False, want_attrs: bool = False,
          robust: bool = False, time=None) -> TraceResult:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if org.device.type == "cuda":
        return traverse_kernel(packed, org, dir, tnear, tfar, mask,
                               occlusion, want_attrs, robust, time)
    if org.device.type == "cpu":
        return traverse_packed_reference(packed, org, dir, tnear, tfar, mask,
                                          occlusion, want_attrs, robust, time)
    raise ValueError(f"no traversal for device {org.device}")


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def sort_rays_by_coherence(org, dir, tnear, tfar, mask, time=None):
    """Reorder rays by the coherence key. Returns (perm, sorted fields), the
    fields org, dir, tnear, tfar, mask and, when given, time;
    ``perm[i]`` is the original index of sorted ray i."""
    key = _coherence_key(org, dir, tnear, tfar)
    perm = torch.sort(key, stable=True).indices
    fields = (org, dir, tnear, tfar, mask) + (() if time is None else (time,))
    return perm, tuple(x[perm].contiguous() for x in fields)


def traverse_packed(packed: PackedScene, org, dir, tnear, tfar, ray_mask,
                    occlusion: bool = False, sort_rays: bool = True,
                    want_attrs: bool = False,
                    id_tables: Tuple[torch.Tensor, ...] = (),
                    robust: bool = False, time=None):
    """Trace R rays against a packed scene. Returns (t, best_prim) with
    best_prim = merged prim index, -1 for miss. Inputs are flat (R,3)/(R,);
    ray_mask holds uint32 values (any integer dtype).

    sort_rays: reorder rays by a coherence key so neighbouring threads walk
    neighbouring records; results come back in the original order and do not
    depend on it.

    want_attrs: for pure-triangle scenes the kernel also emits the winning
    hit's exact u/v/Ng, and this returns (t, best_prim, attrs) with attrs =
    dict(u, v, ng (R,3), ids tuple); id_tables are per-merged-prim tensors
    gathered by best_prim (misses gather entry 0 — mask by best_prim >= 0).
    For other scenes attrs is None.

    robust: the scene's robust mode (widened slabs, Plücker leaf, B2).

    time: (R,) ray times, read by moving scenes (zeros when not given).
    """
    R = org.shape[0]
    org = org.to(torch.float32).contiguous()
    dir = dir.to(torch.float32).contiguous()
    tnear = tnear.to(torch.float32).contiguous()
    tfar = tfar.to(torch.float32).contiguous()
    mask = ray_mask.to(torch.int32).contiguous()   # uint32 value -> bits
    time = _time(packed, org, time)
    if time is not None:
        time = time.to(torch.float32).contiguous()
    perm = None
    if sort_rays and R > SORT_MIN_RAYS:
        # the ray times travel with the rays they belong to
        perm, fields = sort_rays_by_coherence(org, dir, tnear, tfar, mask,
                                              time)
        (org, dir, tnear, tfar, mask), time = fields[:5], (
            fields[5] if time is not None else None)
    emit_attrs = want_attrs and packed.tri_attrs
    res = trace(packed, org, dir, tnear, tfar, mask, occlusion, emit_attrs,
                robust, time)
    prim = torch.where(res.best >= 0,
                       packed.pid_map[res.best.clamp(min=0).long()], -1)

    def unsort(x):
        if perm is None:
            return x
        out = torch.empty_like(x)
        out[perm] = x
        return out

    t, prim_u = unsort(res.t), unsort(prim)
    if not want_attrs:
        return t, prim_u
    if not emit_attrs:
        return t, prim_u, None
    pclamp = prim.clamp(min=0)
    ids = tuple(unsort(tab[pclamp]) for tab in id_tables)
    a = [unsort(res.attrs[k]) for k in range(5)]
    return t, prim_u, {"u": a[0], "v": a[1],
                       "ng": torch.stack(a[2:5], dim=-1), "ids": ids}
