"""Two-level scenes: a TLAS over instances above shared child BLASes.

Port of embree_tpu/tlas.py (role parity with the reference's two-level
acceleration, kernels/bvh/bvh_builder_twolevel.h:25, and its instance
leaves, kernels/geometry/instance_intersector.cpp:25-60). Each distinct
child scene commits once into a BLAS (a CommittedScene); the TLAS is a
BVH8 over the instances' world bounds, built by the port's binned-SAH
builder and collapse (``build_sah(leaf_size=4)``, ``collapse(width=8)``)
on the commit's device. BLAS memory is shared between instances, a
transform update rebuilds the TLAS and no BLAS, and non-uniform scales are
exact for round prims (flattening scales radii by a uniform factor).

A query runs in waves. The collect walk (``_collect_loop``, torch ops in
lockstep over the rays, one host wait per step, finished rays compacted
out) gathers per ray the C lexicographically nearest (entry t, instance)
candidates above a watermark that can still beat the best hit, and flags
rays with more. The BLAS pass then transforms each candidate ray into its
instance's object space (the direction is not renormalized, so t carries
over) and runs the port's own ``intersect`` once per distinct child over
that child's candidate rays, so the BLASes ride the traversal kernels;
hits merge by t. Rays whose list overflowed walk again above the new
watermark until the watermark passes their best hit, so a bounded C loses
no hit.

The walk and the ray transforms are torch code, as they are jnp code in
the JAX package: no kernel of their own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .accel.bvh import BVH, INVALID_NODE
from .accel.collapse import collapse
from .accel.sah import build_sah
from .core.ray import INVALID_ID, HitBatch, RayBatch, resolve_device
from .geometry import (InstanceArrayGeometry, InstanceGeometry,
                       instance_transform_steps)
from .scene import CommittedScene, Scene, intersect

MAX_CANDIDATES = 8   # per-ray instance candidates of a wave
STACK = 32           # the collect walk's stack entries per ray
TLAS_LEAF_SIZE = 4


class TopologyChanged(AssertionError):
    """``update_transforms`` on a scene whose instances or children
    changed: a full rebuild is needed."""


@dataclasses.dataclass
class TwoLevelScene:
    """TLAS over instances + shared child BLASes, tensors on one device.

    inst_l2w holds S motion steps per instance (S = 1 static; a shorter
    stack is padded with its last step), lerped at the ray's time in the
    BLAS pass (scene_instance.cpp getWorld2Local's interpolation)."""
    children: Tuple[CommittedScene, ...]   # the distinct BLASes
    tlas: BVH                              # BVH8 over instance world bounds
    inst_l2w: torch.Tensor                 # (N, S, 3, 4) local -> world
    inst_w2l: torch.Tensor                 # (N, 3, 4) world -> local, step 0
    inst_lo: torch.Tensor                  # (N, 3) world bounds, all steps
    inst_up: torch.Tensor
    inst_gid: torch.Tensor                 # (N,) int64 instance geometry id
    inst_mask: torch.Tensor                # (N,) int64 (uint32 value)
    inst_child_arr: torch.Tensor           # (N,) int64 child index
    inst_child: Tuple[int, ...] = ()
    has_motion: bool = False

    @property
    def num_instances(self):
        return self.inst_gid.shape[0]

    @property
    def n_children(self):
        return len(self.children)

    @property
    def device(self):
        return self.inst_gid.device


def _invert_affine(xf):
    """The inverse of a (3, 4) affine (tlas.py:88-93, numpy)."""
    inv = np.linalg.inv(xf[:, :3])
    out = np.zeros((3, 4), np.float32)
    out[:, :3] = inv
    out[:, 3] = -inv @ xf[:, 3]
    return out


def _scene_bounds(cs: CommittedScene):
    """A committed scene's bounds from its BVH root (tlas.py:96-101)."""
    child = cs.bvh.node_child[0].cpu().numpy()
    valid = child != int(INVALID_NODE)
    lo = cs.bvh.node_lower[0].cpu().numpy()[valid].min(0)
    up = cs.bvh.node_upper[0].cpu().numpy()[valid].max(0)
    return lo, up


def build_two_level(scene: Scene, device=None,
                    reuse_blas: Optional[TwoLevelScene] = None
                    ) -> TwoLevelScene:
    """Commit a scene of instances into a two-level structure on
    ``device`` (CUDA unless the caller passes device='cpu'). Child scenes
    that are one Scene object share one BLAS; the scene's other geometries
    go into an implicit identity instance (gid INVALID_ID) of a scene of
    their own. reuse_blas: a TwoLevelScene of the same topology whose
    BLASes are kept, so that only the transforms and the TLAS are built
    (tlas.py:104-199)."""
    dev = resolve_device(device)
    blas_cache = {}
    children = []

    def blas_of(child_scene) -> int:
        key = id(child_scene)
        if key not in blas_cache:
            idx = len(children)
            if reuse_blas is not None:
                if idx >= reuse_blas.n_children:
                    raise TopologyChanged("a child scene was added")
                cs = reuse_blas.children[idx]
            else:
                cs = (child_scene if isinstance(child_scene, CommittedScene)
                      else child_scene.commit(device=dev))
            blas_cache[key] = idx
            children.append(cs)
        return blas_cache[key]

    inst_xf, inst_child, inst_gid, inst_mask = [], [], [], []
    plain = Scene()
    has_plain = False
    for gid, g in sorted(scene._geoms.items()):
        if not getattr(g, "enabled", True):
            continue
        if isinstance(g, InstanceGeometry):
            xfs = instance_transform_steps(g)
            inst_xf.append(xfs if xfs.ndim == 3 else xfs[None])
            inst_child.append(blas_of(g.scene))
            inst_gid.append(gid)
            inst_mask.append(g.mask)
        elif isinstance(g, InstanceArrayGeometry):
            c = blas_of(g.scene)
            for xf in np.asarray(g.transforms, np.float32):
                inst_xf.append(xf[None])
                inst_child.append(c)
                inst_gid.append(gid)
                inst_mask.append(g.mask)
        else:
            plain.attach(g)
            has_plain = True
    if has_plain:
        c = blas_of(plain)
        inst_xf.append(np.hstack([np.eye(3), np.zeros((3, 1))])
                       .astype(np.float32)[None])
        inst_child.append(c)
        inst_gid.append(INVALID_ID)
        inst_mask.append(0xFFFFFFFF)

    N = len(inst_xf)
    if N == 0:
        raise ValueError("two-level commit on a scene without geometry")
    S = max(x.shape[0] for x in inst_xf)
    l2w = np.stack([
        np.concatenate([x, np.repeat(x[-1:], S - x.shape[0], axis=0)])
        if x.shape[0] < S else x for x in inst_xf])           # (N, S, 3, 4)
    w2l = np.stack([_invert_affine(x[0]) for x in l2w])
    # world bounds: the 8 corners of the child's bounds under every motion
    # step, all instances at once (the JAX package's numpy expression)
    corners = np.array([[i & 1, (i >> 1) & 1, (i >> 2) & 1]
                        for i in range(8)], np.float32)
    cb = np.stack([np.concatenate(_scene_bounds(c)) for c in children])
    child_arr = np.asarray(inst_child, np.int32)
    blo, bup = cb[child_arr, :3], cb[child_arr, 3:]
    pts = blo[:, None, :] + corners[None] * (bup - blo)[:, None, :]
    w = np.einsum("nsij,nkj->nski", l2w[:, :, :, :3], pts) \
        + l2w[:, :, None, :, 3]                               # (N, S, 8, 3)
    lo = w.min((1, 2)).astype(np.float32)
    up = w.max((1, 2)).astype(np.float32)
    tlas, _ = collapse(build_sah(torch.from_numpy(lo).to(dev),
                                 torch.from_numpy(up).to(dev),
                                 leaf_size=TLAS_LEAF_SIZE), width=8)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)
    return TwoLevelScene(
        children=tuple(children), tlas=tlas,
        inst_l2w=put(l2w, torch.float32), inst_w2l=put(w2l, torch.float32),
        inst_lo=put(lo, torch.float32), inst_up=put(up, torch.float32),
        inst_gid=put(np.asarray(inst_gid, np.int64), torch.int64),
        inst_mask=put(np.asarray(inst_mask, np.int64) & 0xFFFFFFFF,
                      torch.int64),
        inst_child_arr=put(child_arr, torch.int64),
        inst_child=tuple(inst_child), has_motion=S > 1)


def update_transforms(tl: TwoLevelScene, scene: Scene) -> TwoLevelScene:
    """New transforms and TLAS over the same BLASes: no BLAS is touched
    (tlas.py:205-211). Raises TopologyChanged when the instances' children
    differ from ``tl``'s."""
    new = build_two_level(scene, device=tl.device, reuse_blas=tl)
    if new.inst_child != tl.inst_child:
        raise TopologyChanged("topology changed; full rebuild")
    return new


def two_level_from_arrays(arrays, flags, device) -> TwoLevelScene:
    """The port's TwoLevelScene from a JAX TwoLevelScene's arrays (converted
    to numpy by the caller), so that the port's collect walk and BLAS pass
    can be held against the JAX package's on the same TLAS.

    arrays: ``children`` (each child's arrays for ``scene.from_arrays``),
    ``tlas.node_lower`` .. ``tlas.prim_order``, ``inst_l2w``, ``inst_w2l``,
    ``inst_lo``, ``inst_up``, ``inst_gid``, ``inst_mask`` and
    ``inst_child_arr``. flags: ``children`` (each child's flags) and
    ``has_motion``."""
    from .scene import from_arrays
    dev = resolve_device(device)
    children = tuple(from_arrays(a, f, dev) for a, f in
                     zip(arrays["children"], flags["children"]))

    def put(k, dtype):
        return torch.as_tensor(np.ascontiguousarray(arrays[k]),
                               device=dev).to(dtype)
    tlas = BVH(node_lower=put("tlas.node_lower", torch.float32),
               node_upper=put("tlas.node_upper", torch.float32),
               node_child=put("tlas.node_child", torch.int32),
               prim_order=put("tlas.prim_order", torch.int32))
    child_arr = np.asarray(arrays["inst_child_arr"]).astype(np.int64)
    return TwoLevelScene(
        children=children, tlas=tlas,
        inst_l2w=put("inst_l2w", torch.float32),
        inst_w2l=put("inst_w2l", torch.float32),
        inst_lo=put("inst_lo", torch.float32),
        inst_up=put("inst_up", torch.float32),
        inst_gid=put("inst_gid", torch.int64),
        inst_mask=put("inst_mask", torch.int64),
        inst_child_arr=put("inst_child_arr", torch.int64),
        inst_child=tuple(int(c) for c in child_arr),
        has_motion=bool(flags["has_motion"]))


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------

def _lex_gt(t1, i1, t2, i2):
    """The lexicographic (entry t, instance) order, a total order that keeps
    the wave watermark exact where instance bounds tie (tlas.py:214-217)."""
    return (t1 > t2) | ((t1 == t2) & (i1 > i2))


def _slab(lo, up, org, rdir, tnear, tfar):
    """accel/traverse.py::slab_test of the JAX package: (R, K, 3) boxes
    against (R, 3) rays; (hit, entry t), each (R, K)."""
    t0 = (lo - org[:, None, :]) * rdir[:, None, :]
    t1 = (up - org[:, None, :]) * rdir[:, None, :]
    t_entry = torch.maximum(torch.minimum(t0, t1).amax(-1), tnear[:, None])
    t_exit = torch.minimum(torch.maximum(t0, t1).amin(-1), tfar[:, None])
    return t_entry <= t_exit, t_entry


def _collect_step(tl, st, ray, arange_c):
    """One lockstep step of the collect walk over the rays in ``st``
    (tlas.py:258-325)."""
    bvh = tl.tlas
    active, cur, stack, sp, ct, cid, ovf = st
    org, rdir, tnear, tfar, mask, wm_t, wm_i, best_t = ray
    is_node = active & (cur >= 0)
    is_leaf = active & (cur < 0) & (cur != int(INVALID_NODE))

    node = torch.where(is_node, cur, 0).long()
    child = bvh.node_child[node]
    hit, t_entry = _slab(bvh.node_lower[node], bvh.node_upper[node], org,
                         rdir, tnear, tfar)
    hit = hit & (child != int(INVALID_NODE)) & is_node[:, None]
    dist = torch.where(hit, t_entry, math.inf)
    order = torch.sort(dist, dim=-1, stable=True).indices
    child_sorted = child.gather(1, order)
    hit_sorted = hit.gather(1, order)
    nhits = hit.sum(-1)
    # push the hit children but the nearest, farthest first, while the
    # stack has room; the pushes land in consecutive entries, the refused
    # ones in the stack's last column, which is never read
    want = is_node[:, None] & hit_sorted[:, 1:].flip(1)
    n_want = want.to(sp.dtype)
    pos = sp[:, None] + torch.cumsum(n_want, 1) - n_want
    do_push = want & (pos < STACK)
    stack.scatter_(1, torch.where(do_push, pos, STACK).long(),
                   child_sorted[:, 1:].flip(1))
    sp = sp + do_push.sum(1, dtype=sp.dtype)
    node_next = torch.where(nhits > 0, child_sorted[:, 0],
                            int(INVALID_NODE))

    # leaf: each instance into the bounded list, which keeps the C
    # lexicographically smallest qualifying (entry t, instance) pairs; the
    # slots' tests at once, their insertions in slot order
    packed = torch.where(is_leaf, -(cur + 1), 0)
    start, count = packed >> 4, packed & 0xF
    ks = torch.arange(TLAS_LEAF_SIZE, device=cur.device)
    slot = torch.clamp(start[:, None] + ks, 0,
                       bvh.prim_order.shape[0] - 1).long()
    inst = bvh.prim_order[slot].long()                    # (R, 4)
    ih, te = _slab(tl.inst_lo[inst], tl.inst_up[inst], org, rdir, tnear,
                   tfar)
    ok = (is_leaf[:, None] & (ks < count[:, None]) & ih
          & ((mask[:, None] & tl.inst_mask[inst]) != 0)
          & _lex_gt(te, inst, wm_t[:, None], wm_i[:, None])
          & (te <= best_t[:, None]))
    for k in range(TLAS_LEAF_SIZE):
        # the lexicographically worst kept entry (empty ones are (inf,
        # -1)), the first of equal ones, as the JAX package's scan over
        # the slots with a strict > finds it
        w_t = ct.amax(1)
        top = ct == w_t[:, None]
        w_i = torch.where(top, cid, -1 << 62).amax(1)
        w_k = (top & (cid == w_i[:, None])).int().argmax(1)
        do = ok[:, k] & _lex_gt(w_t, w_i, te[:, k], inst[:, k])
        # a qualifying candidate refused, or a real one evicted: the next
        # wave walks again
        ovf = ovf | (ok[:, k] & ~do) | (do & torch.isfinite(w_t))
        selc = do[:, None] & (arange_c[None, :] == w_k[:, None])
        ct = torch.where(selc, te[:, k, None], ct)
        cid = torch.where(selc, inst[:, k, None], cid)

    need_pop = is_leaf | (is_node & (nhits == 0))
    has = sp > 0
    pop_sp = torch.where(has, sp - 1, sp)
    popped = stack.gather(1, torch.clamp(pop_sp, min=0).long()[:, None])
    pop_cur = torch.where(has, popped[:, 0], int(INVALID_NODE))
    cur = torch.where(need_pop, pop_cur, torch.where(is_node, node_next, cur))
    sp = torch.where(need_pop, pop_sp, sp)
    active = torch.where(need_pop, active & has, active)
    return active, cur, stack, sp, ct, cid, ovf


def _collect_loop(tl: TwoLevelScene, flat: RayBatch, C: int, wm_t=None,
                  wm_i=None, best_t=None, stats=None):
    """The lockstep TLAS walk (tlas.py:220-328): per ray the C
    lexicographically smallest (entry t, instance) candidates strictly
    above the watermark (wm_t, wm_i) whose entry t can still beat best_t.
    Returns (cand ids (R, C), their entry t (R, C), overflow (R,)): the
    overflow marks rays with qualifying candidates left over. One host
    wait per step; once half the rays in flight are done they are compacted
    out (their outputs no longer change). ``stats``: a dict that gets the
    step count."""
    dev = flat.device
    R = flat.shape[0]
    d = flat.dir
    rdir = 1.0 / torch.where(d.abs() < 1e-20,
                             torch.where(d >= 0, 1e-20, -1e-20), d)
    if wm_t is None:
        wm_t = torch.full((R,), -math.inf, device=dev)
    if wm_i is None:
        wm_i = torch.full((R,), -1, dtype=torch.int64, device=dev)
    if best_t is None:
        best_t = torch.full((R,), math.inf, device=dev)
    ct_out = torch.full((R, C), math.inf, device=dev)
    cid_out = torch.full((R, C), -1, dtype=torch.int64, device=dev)
    ovf_out = torch.zeros(R, dtype=torch.bool, device=dev)
    arange_c = torch.arange(C, device=dev)
    ids = torch.arange(R, device=dev)
    st = (torch.ones(R, dtype=torch.bool, device=dev),
          torch.zeros(R, dtype=torch.int32, device=dev),
          # STACK entries and a column that takes refused pushes
          torch.zeros((R, STACK + 1), dtype=torch.int32, device=dev),
          torch.zeros(R, dtype=torch.int32, device=dev),
          ct_out.clone(), cid_out.clone(), ovf_out.clone())
    ray = (flat.org, rdir, flat.tnear, flat.tfar, flat.mask, wm_t, wm_i,
           best_t)
    steps = 0
    while True:
        n_live = int(st[0].sum())          # the step's one host wait
        if n_live == 0:
            break
        if 2 * n_live <= ids.shape[0]:
            keep = st[0]
            done = ~keep
            ct_out[ids[done]] = st[4][done]
            cid_out[ids[done]] = st[5][done]
            ovf_out[ids[done]] = st[6][done]
            ids = ids[keep]
            st = tuple(x[keep] for x in st)
            ray = tuple(x[keep] for x in ray)
        st = _collect_step(tl, st, ray, arange_c)
        steps += 1
    ct_out[ids] = st[4]
    cid_out[ids] = st[5]
    ovf_out[ids] = st[6]
    if stats is not None:
        stats["collect_steps"] = steps
    return cid_out, ct_out, ovf_out


def _matvec(m, v):
    """(n, 3, 3) times (n, 3): three products summed left to right, each
    rounded (no FMA)."""
    return ((m[:, :, 0] * v[:, None, 0] + m[:, :, 1] * v[:, None, 1])
            + m[:, :, 2] * v[:, None, 2])


def _xf_rays(w2l, org, dir):
    """Rays into object space (tlas.py:331-334); the direction keeps its
    length, so t carries over."""
    return _matvec(w2l[:, :, :3], org) + w2l[:, :, 3], \
        _matvec(w2l[:, :, :3], dir)


def _affine_inv(m):
    """Batched (n, 3, 4) affine inverse on the device (tlas.py:337-343)."""
    inv = torch.linalg.inv(m[:, :, :3])
    return torch.cat([inv, -_matvec(inv, m[:, :, 3])[:, :, None]], -1)


def _l2w_at(tl: TwoLevelScene, inst, time):
    """Each candidate's local -> world at its ray's time, lerped between
    the two motion steps around it (tlas.py:346-358)."""
    steps = tl.inst_l2w[inst]                      # (n, S, 3, 4)
    S = tl.inst_l2w.shape[1]
    if S == 1:
        return steps[:, 0]
    x = torch.clamp(time, 0.0, 1.0) * (S - 1)
    k = torch.clamp(x.to(torch.int64), 0, S - 2)
    w = (x - k.to(torch.float32))[:, None, None]
    rows = torch.arange(inst.shape[0], device=inst.device)
    return (1.0 - w) * steps[rows, k] + w * steps[rows, k + 1]


def child_rays(tl: TwoLevelScene, flat: RayBatch, cand, c: int):
    """The object-space rays of child ``c``'s candidates: (flat lane ids
    r * C + j of the candidates that are live and belong to child c, their
    RayBatch). The JAX package runs every lane of every ray through each
    child with the others' tfar at -inf (tlas.py:377-385); a lane's hit
    does not depend on the other rays of the batch, so the port passes
    only the live ones."""
    C = cand.shape[1]
    candc = torch.clamp(cand, 0, tl.num_instances - 1)
    sel = (tl.inst_child_arr[candc] == c) & (cand >= 0)
    lanes = torch.nonzero(sel.reshape(-1)).squeeze(1)
    r = lanes // C
    inst = candc.reshape(-1)[lanes]
    time = flat.time[r]
    if tl.has_motion:
        w2l = _affine_inv(_l2w_at(tl, inst, time))
    else:
        w2l = tl.inst_w2l[inst]
    o, d = _xf_rays(w2l, flat.org[r], flat.dir[r])
    return lanes, RayBatch(org=o, dir=d, tnear=flat.tnear[r],
                           tfar=flat.tfar[r], time=time, mask=flat.mask[r])


def _blas_pass(tl: TwoLevelScene, flat: RayBatch, cand, best, stats=None):
    """Every live candidate lane against its BLAS, merged by t into best =
    (t, u, v, ng, prim, geom, instance gid, valid) (tlas.py:361-410).
    ``stats``: a dict that gets each child's lane count."""
    R, C = cand.shape
    dev = flat.device
    candc = torch.clamp(cand, 0, tl.num_instances - 1)
    (best_t, best_u, best_v, best_ng, best_prim, best_geom, best_inst,
     best_valid) = best
    for c, child in enumerate(tl.children):
        lanes, rr = child_rays(tl, flat, cand, c)
        if stats is not None:
            stats.setdefault("child_lanes", []).append(int(lanes.shape[0]))
        if lanes.shape[0] == 0:
            continue
        h = intersect(child, rr)
        tv = torch.full((R * C,), math.inf, device=dev)
        tv[lanes] = torch.where(h.valid, h.t, math.inf)
        tv = tv.reshape(R, C)
        lane = tv.argmin(1)
        tmin = tv.gather(1, lane[:, None])[:, 0]
        upd = tmin < best_t
        # where each ray's winning lane sits in the child's batch
        pos = torch.zeros(R * C, dtype=torch.int64, device=dev)
        pos[lanes] = torch.arange(lanes.shape[0], device=dev)
        at = pos[torch.arange(R, device=dev) * C + lane]
        inst_lane = candc.gather(1, lane[:, None])[:, 0]
        l2w_lane = _l2w_at(tl, inst_lane, flat.time)
        ng_w = _matvec(l2w_lane[:, :, :3], h.ng[at])
        best_u = torch.where(upd, h.u[at], best_u)
        best_v = torch.where(upd, h.v[at], best_v)
        best_ng = torch.where(upd[:, None], ng_w, best_ng)
        best_prim = torch.where(upd, h.prim_id[at], best_prim)
        best_geom = torch.where(upd, h.geom_id[at], best_geom)
        best_inst = torch.where(upd, tl.inst_gid[inst_lane], best_inst)
        best_valid = best_valid | upd
        best_t = torch.where(upd, tmin, best_t)
    return (best_t, best_u, best_v, best_ng, best_prim, best_geom,
            best_inst, best_valid)


def _watermark(cand, ct, wm_t, wm_i):
    """The lexicographic max over the collected (finite) candidates."""
    new_t, new_i = wm_t, wm_i
    for c in range(cand.shape[1]):
        fin = torch.isfinite(ct[:, c]) & (cand[:, c] >= 0)
        gt = fin & _lex_gt(ct[:, c], cand[:, c], new_t, new_i)
        new_t = torch.where(gt, ct[:, c], new_t)
        new_i = torch.where(gt, cand[:, c], new_i)
    return new_t, new_i


def _sub(flat: RayBatch, idx) -> RayBatch:
    return RayBatch(*(getattr(flat, f.name)[idx]
                      for f in dataclasses.fields(RayBatch)))


def intersect_two_level(tl: TwoLevelScene, rays: RayBatch,
                        C: int = MAX_CANDIDATES, stats=None) -> HitBatch:
    """Closest hit through the two-level structure (tlas.py:413-478).

    The first wave runs every ray; then, while some ray overflowed and its
    watermark has not passed its best hit, another wave runs those rays
    (the JAX package's while loop runs all rays again, and the others
    collect nothing: whatever still qualifies for them was collected). A
    ray's t is the object-space t (the transform keeps the direction's
    length). ``stats``: a list that gets one dict per wave (rays, collect
    steps, overflowed rays, each child's lanes, and on CUDA the collect and
    BLAS-pass ms from CUDA events)."""
    if rays.device != tl.device:
        raise ValueError(f"rays are on {rays.device}, the scene on "
                         f"{tl.device}")
    shape = rays.shape
    flat = rays.reshape(int(np.prod(shape)) if shape else 1)
    R = flat.shape[0]
    dev = flat.device
    best = [torch.full((R,), math.inf, device=dev),
            torch.zeros(R, device=dev), torch.zeros(R, device=dev),
            torch.zeros((R, 3), device=dev),
            torch.zeros(R, dtype=torch.int64, device=dev),
            torch.zeros(R, dtype=torch.int64, device=dev),
            torch.zeros(R, dtype=torch.int64, device=dev),
            torch.zeros(R, dtype=torch.bool, device=dev)]
    wm_t = torch.full((R,), -math.inf, device=dev)
    wm_i = torch.full((R,), -1, dtype=torch.int64, device=dev)
    idx = torch.arange(R, device=dev)
    while idx.shape[0]:
        sub = _sub(flat, idx)
        w = {"rays": int(idx.shape[0])} if stats is not None else None
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
              if w is not None and dev.type == "cuda" else None)
        if ev:
            ev[0].record()
        cand, ct, ovf = _collect_loop(tl, sub, C, wm_t[idx], wm_i[idx],
                                      best[0][idx], stats=w)
        if ev:
            ev[1].record()
        b = _blas_pass(tl, sub, cand, [x[idx] for x in best], stats=w)
        if ev:
            ev[2].record()
        for x, y in zip(best, b):
            x[idx] = y
        nt, ni = _watermark(cand, ct, wm_t[idx], wm_i[idx])
        wm_t[idx], wm_i[idx] = nt, ni
        if w is not None:
            w["overflow"] = int(ovf.sum())
            if ev:
                torch.cuda.synchronize(dev)
                w["collect_ms"] = ev[0].elapsed_time(ev[1])
                w["blas_ms"] = ev[1].elapsed_time(ev[2])
            stats.append(w)
        if tl.num_instances <= C:
            break
        idx = idx[ovf & (nt <= best[0][idx])]
    best_t, best_u, best_v, best_ng, best_prim, best_geom, best_inst, \
        valid = best
    inv = torch.tensor(INVALID_ID, dtype=torch.int64, device=dev)
    inst = torch.stack([best_inst, torch.full_like(best_inst, INVALID_ID)],
                       -1)
    hits = HitBatch(
        t=torch.where(valid, best_t, math.inf), u=best_u, v=best_v,
        ng=best_ng, prim_id=torch.where(valid, best_prim, inv),
        geom_id=torch.where(valid, best_geom, inv),
        inst_id=torch.where(valid[:, None], inst, inv))
    return hits.reshape(*shape)


def occluded_two_level(tl: TwoLevelScene, rays: RayBatch,
                       C: int = MAX_CANDIDATES) -> torch.Tensor:
    """Any hit: the closest hit's mask, as in the JAX package
    (tlas.py:477-480)."""
    return intersect_two_level(tl, rays, C=C).valid
