"""The static triangles (B1), robust triangles (B2) and mixed classes
(B3-B5) on persistent warps, through the kernel's g++ twin.

On the card these 20 instantiations run persistent warps (``run_warp`` in
``csrc/traverse.cuh``): lanes refilled from a global ray counter as their
rays finish, leaves postponed until enough lanes wait at one, and a leaf
pass of their own (``static_pass``) that deals the waiting lanes' (ray,
slot) items across the warp. The twin runs the same code over 32 emulated
lanes. Its outputs start as values no traversal writes, so each case below
shows that every ray was written (t, best, both visit rows and u/v/Ng
equal the plain version's bit for bit) and written once (the
rays-finished count equals the batch), and that the lane steps the
scheduler counted are the rays' steps:

- batches of 1, 31, 32, 33 and 4,097 rays in each of the 20
  instantiations: mixed classes {closest, occluded} x {mask chunk or not}
  x {robust or not} on the kind check scene of test_torch_kinds.py,
  triangles {closest + attrs, closest, occluded} x {mask chunk or not} on
  its sphere, robust (B2) and in normal mode (B1; a Moeller leaf), with a
  second, smaller sphere with mask 0x2 when masked;
- batches of dead rays only;
- a scene of small prims of every class scattered through one box, so
  that its leaves mix classes and one round of items runs several class
  tests;
- the scheduler's other constants (a leaf pass for one waiting lane, a
  refill at 1, 8 and 32 idle lanes, leaf passes at 8 and 32 waiting
  lanes): a twin copy built with them gives the same bits.

The plain references are computed once per scene and variant, on the
largest batch; a smaller batch is its first rays. No Pallas reference runs
here: test_torch_kinds.py holds the plain version against it. The card
runs the same check in its card-only test at the end, on batches larger
than its resident lanes, so that its warps refill:
``python -m pytest --noconftest tests/test_torch_static_sched.py -m cuda``.
"""
import ctypes
import os
import re
import shutil

import numpy as np
import pytest
import torch

import embree_tpu_torch as pt
from embree_tpu_torch import _build
from embree_tpu_torch.accel import traverse as tr
from test_torch_kinds import mixed_geoms, robust_geoms, sphere_mesh
from test_torch_motion_sched import bits

F32 = np.float32
SIZES = (1, 31, 32, 33, 4097)
BIG = SIZES[-1]
FLAGS = [(m, r) for m in (False, True) for r in (False, True)]
TRI_VARIANTS = ((False, True), (False, False), (True, False))  # (occ, attrs)
# the 20 instantiations: (family, masked, robust, occ, attrs)
INSTANTIATIONS = ([("kinds", m, r, occ, False) for m, r in FLAGS
                   for occ in (False, True)]
                  + [("robust", m, True, occ, attrs) for m in (False, True)
                     for occ, attrs in TRI_VARIANTS]
                  + [("tri", m, False, occ, attrs) for m in (False, True)
                     for occ, attrs in TRI_VARIANTS])


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the file shares its worker with others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kinds_scene(masked=False, robust=False, device="cpu"):
    """The kind check scene (tests/test_pallas_kernel.py:69-93): triangles,
    a quad, two of each point kind, two round and two flat segments;
    ``masked``: every second geometry has mask 0x2."""
    s = pt.Scene(robust=robust)
    for g in mixed_geoms(pt, masked=masked):
        s.attach(g)
    return s.commit(device=device)


def sphere_scene(masked=False, robust=True, device="cpu"):
    """sphere_mesh(16, 24), robust or in normal mode; ``masked``: a second,
    smaller sphere inside it with mask 0x2."""
    s = pt.Scene(robust=robust)
    for g in robust_geoms(pt):
        s.attach(g)
    if masked:
        v, idx = sphere_mesh(8, 12)
        s.attach(pt.TriangleGeometry(v * F32(0.5), idx, mask=0x2))
    return s.commit(device=device)


def scattered_scene(device="cpu"):
    """48 small prims of each class (triangles, spheres, discs, oriented
    discs, round and flat segments) at random in [-1, 1]^3 (numpy seed
    12), so that the BVH's leaves mix classes."""
    rng = np.random.default_rng(12)
    n = 48

    def centres():
        return rng.uniform(-1, 1, (n, 3)).astype(F32)

    def radii(lo, hi):
        return rng.uniform(lo, hi, (n, 1)).astype(F32)

    tri = (centres()[:, None] + rng.uniform(-0.15, 0.15, (n, 3, 3))
           ).astype(F32).reshape(-1, 3)
    pts = [np.concatenate([centres(), radii(0.04, 0.1)], 1) for _ in range(3)]
    nrm = rng.standard_normal((n, 3)).astype(F32)
    lines = []
    for _ in range(2):
        c = centres()
        v = np.stack([c, c + rng.uniform(-0.2, 0.2, (n, 3)).astype(F32)], 1)
        r = rng.uniform(0.02, 0.06, (n, 2, 1)).astype(F32)
        lines.append(np.concatenate([v, r], 2).reshape(-1, 4))
    starts = 2 * np.arange(n, dtype=np.int32)
    s = pt.Scene()
    s.attach(pt.TriangleGeometry(tri, np.arange(3 * n, dtype=np.int32)
                                 .reshape(-1, 3)))
    s.attach(pt.PointGeometry(pts[0], kind="sphere"))
    s.attach(pt.PointGeometry(pts[1], kind="disc"))
    s.attach(pt.PointGeometry(pts[2], kind="oriented_disc", normals=nrm))
    s.attach(pt.LineSegmentsGeometry(lines[0], starts, kind="round"))
    s.attach(pt.LineSegmentsGeometry(lines[1], starts, kind="flat"))
    return s.commit(device=device)


SCENES = {
    ("kinds", False, False): lambda d="cpu": kinds_scene(False, False, d),
    ("kinds", True, False): lambda d="cpu": kinds_scene(True, False, d),
    ("kinds", False, True): lambda d="cpu": kinds_scene(False, True, d),
    ("kinds", True, True): lambda d="cpu": kinds_scene(True, True, d),
    ("robust", False, True): lambda d="cpu": sphere_scene(False, True, d),
    ("robust", True, True): lambda d="cpu": sphere_scene(True, True, d),
    ("tri", False, False): lambda d="cpu": sphere_scene(False, False, d),
    ("tri", True, False): lambda d="cpu": sphere_scene(True, False, d),
    ("scattered", False, False): scattered_scene,
}
_scenes, _plain = {}, {}


def scene(key):
    if key not in _scenes:
        _scenes[key] = SCENES[key]()
    return _scenes[key]


def rays(n, seed=0, masked=False, spread=3.0):
    """n rays from U(-spread, spread)^3, half of them aimed at U(-1, 1)^3,
    the rest toward N(0, 1)^3 (numpy seed ``seed``); ``masked``: ray masks
    from {1, 2, 3}."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-spread, spread, (n, 3)).astype(F32)
    d = rng.standard_normal((n, 3)).astype(F32)
    aim = rng.uniform(-1, 1, (n // 2, 3)).astype(F32)
    d[:n // 2] = aim - org[:n // 2]
    mask = (rng.choice(np.array([1, 2, 3], np.uint32), n) if masked
            else 0xFFFFFFFF)
    return pt.make_rays(org, d, mask=mask, device="cpu")


def inputs(r):
    return (r.org, r.dir, r.tnear, r.tfar, r.mask.to(torch.int32))


def plain(key, occ, attrs):
    """The plain version on the scene's BIG rays, computed once."""
    if (key, occ, attrs) not in _plain:
        cs = scene(key)
        x = inputs(rays(BIG, seed=1, masked=key[1]))
        _plain[key, occ, attrs] = (x, tr.traverse_packed_reference(
            cs.packed, *x, occ, attrs, cs.robust))
    return _plain[key, occ, attrs]


def first(res, n):
    return (res.t[:n], res.best[:n], res.visits[:, :n],
            None if res.attrs is None else res.attrs[:, :n])


def same(a, b):
    """Outputs (t, best, visits, attrs) equal bit for bit."""
    for u, v in zip(a, b):
        assert (u is None) == (v is None)
        if u is not None:
            np.testing.assert_array_equal(bits(u).numpy(), bits(v).numpy())


def check_counts(res, n):
    """Every ray finished once; the lane steps are the rays' steps, those
    of leaf passes its leaf visits; a leaf pass of n waiting lanes dealt
    their 8n items in ceil(n / 4) rounds of 32."""
    slots, steps, finished, warps = (int(v) for v in res.sched)
    leaf_slots, leaf_steps, item_slots = (int(v) for v in res.leaf_sched)
    assert finished == n
    assert steps == int(res.visits.sum(dtype=torch.int64))
    assert leaf_steps == int(res.visits[1].sum(dtype=torch.int64))
    assert slots % 32 == 0 and steps <= slots
    assert leaf_slots % 32 == 0 and leaf_steps <= leaf_slots <= slots
    passes, rounds = leaf_slots // 32, item_slots // 32
    assert item_slots % 32 == 0
    assert leaf_steps <= 4 * rounds <= leaf_steps + 3 * passes
    assert warps >= 1


def twin(key, x, occ, attrs, fn=None):
    """The twin (or the twin entry ``fn`` of a copy of csrc/) on x."""
    cs = scene(key)
    if fn is None:
        return tr.traverse_twin(cs.packed, *x, occ, attrs, cs.robust)
    outs = tr._outputs(x[0].shape[0], x[0].device, attrs,
                       unwritten=True)
    assert fn(*tr._call_args(cs.packed, *x, None, outs, occ, attrs,
                             cs.robust), tr._ptr(outs[6])) == 0
    return tr._result(outs)


def run_both(key, n, occ, attrs, fn=None):
    """The twin on the first n of the scene's rays equals the plain
    version there bit for bit, with its counts; returns both."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    x, a = plain(key, occ, attrs)
    b = twin(key, [t[:n].contiguous() for t in x], occ, attrs, fn)
    same(first(a, n), first(b, n))
    assert int(a.overflow) == 0 and int(b.overflow) == 0
    check_counts(b, n)
    return a, b


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("family,masked,robust,occ,attrs", INSTANTIATIONS)
def test_batch_sizes(family, masked, robust, occ, attrs, n):
    """Each of the 20 instantiations (its own persistent kernel) at 1, 31,
    32, 33 and 4,097 rays: every ray written once, bit-equal to the plain
    version."""
    key = (family, masked, robust)
    cs = scene(key)
    assert cs.packed.has_mask == masked and cs.robust == robust
    entry, flags = tr.kernel_instantiation(cs.packed, occ, attrs, robust)
    assert entry == "persistent_kernel"
    assert flags == (int(occ), int(attrs), int(masked), int(robust),
                     int(family == "kinds"), 0, 0, 0)
    a, _ = run_both(key, n, occ, attrs)
    if n == BIG:
        assert int((a.best >= 0).sum()) > 200


@pytest.mark.parametrize("key", [("kinds", False, False),
                                 ("kinds", True, True),
                                 ("robust", True, True),
                                 ("tri", False, False),
                                 ("tri", True, False)])
def test_dead_rays_only(key):
    """A batch of dead rays (tnear > tfar, and ray mask 0 where the scene
    has no mask chunk) ends before any step: every ray written with tfar,
    no hit and no visit, and no warp pass."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    cs = scene(key)
    n = 100
    org, d, tnear, tfar, mask = (t.clone() for t in inputs(rays(n, 5)))
    tnear[: n // 2] = 2.0
    tfar[: n // 2] = 1.0
    mask[n // 2:] = 0
    if cs.packed.has_mask:      # the mask chunk decides: keep them dead
        tnear[n // 2:] = 2.0
        tfar[n // 2:] = 1.0
    for occ, attrs in TRI_VARIANTS:
        if attrs and not cs.packed.tri_attrs:
            continue
        b = tr.traverse_twin(cs.packed, org, d, tnear, tfar, mask, occ,
                             attrs, cs.robust)
        assert int(b.visits.abs().sum()) == 0
        assert (b.best == -1).all()
        np.testing.assert_array_equal(bits(b.t).numpy(), bits(tfar).numpy())
        assert int(b.sched[0]) == 0 and int(b.sched[2]) == n


def test_mixed_leaves():
    """The scattered scene's leaves mix classes, so that one round of a
    leaf pass runs several class tests; every class gets hits; closest and
    occluded at 33 and 4,097 rays."""
    key = ("scattered", False, False)
    cs = scene(key)
    p = cs.packed
    tags = p.leaves[:, p.chunk_at("kind"):p.chunk_at("kind") + 8]
    mixed = sum(len(set(row.tolist()) - {0}) >= 2 for row in tags)
    assert mixed >= 8
    for occ in (False, True):
        for n in (33, BIG):
            a, _ = run_both(key, n, occ, False)
    _, a = plain(key, False, False)
    assert set(a.class_slots.nonzero().flatten().tolist()) == {0, 2, 3, 4, 5,
                                                               6}
    prim = p.pid_map[a.best[a.best >= 0].long()]
    assert set(cs.prim_kind[prim.long()].tolist()) >= {0, 2, 3, 4, 5, 6}


# the scheduler's other constants: (kStaticRefillLanes, kStaticLeafLanes)
FORMS = ((1, 1), (8, 8), (32, 32))
FORM_CONSTANTS = ("kStaticRefillLanes", "kStaticLeafLanes")


def twin_forms(tmp):
    """Twin libraries built from copies of csrc/ with FORMS' constants,
    all at once; {form: traverse_twin entry}."""
    names, targets = [], {}
    for form in FORMS:
        name = "twin_" + "_".join(map(str, form))
        root = os.path.join(tmp, name)
        os.makedirs(root)
        shutil.copy(os.path.join(_build.CSRC, "traverse_cpu.cpp"), root)
        src = open(os.path.join(_build.CSRC, "traverse.cuh")).read()
        for const, v in zip(FORM_CONSTANTS, form):
            src, k = re.subn(rf"constexpr int {const} = \d+;",
                             f"constexpr int {const} = {v};", src)
            assert k == 1, const
        open(os.path.join(root, "traverse.cuh"), "w").write(src)
        base = _build.TARGETS["traverse_twin"]
        targets[name] = _build.Target(
            os.path.join(root, "libtwin.so"),
            (os.path.join(root, "traverse_cpu.cpp"),),
            (os.path.join(root, "traverse.cuh"),), base.flags)
        names.append(name)
    _build.build_all(names, targets)
    out = {}
    for form, name in zip(FORMS, names):
        fn = ctypes.CDLL(targets[name].path).traverse_twin
        fn.restype = ctypes.c_int
        fn.argtypes = tr._ARGS + [ctypes.c_void_p]
        out[form] = fn
    return out


def test_design_forms(tmp_path):
    """Refills at 1, 8 and 32 idle lanes and leaf passes at 1, 8 and 32
    waiting lanes: the same bits as the plain version on the masked robust
    mixed scene, the scattered scene, the masked robust sphere and the
    masked sphere in normal mode, with the counts as check_counts holds
    them."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    fns = twin_forms(str(tmp_path))
    for key, variants in ((("kinds", True, True), ((False, False),
                                                   (True, False))),
                          (("scattered", False, False), ((False, False),)),
                          (("robust", True, True), TRI_VARIANTS),
                          (("tri", True, False), TRI_VARIANTS)):
        for fn in fns.values():
            for occ, attrs in variants:
                run_both(key, 1025, occ, attrs, fn=fn)


@pytest.mark.cuda
def test_static_scheduler_on_card():
    """On an NVIDIA GPU: the 20 instantiations and the scattered scene at
    4,097 rays and at twice as many rays as an SM's thread limit over all
    SMs allows lanes (so every warp refills); bit-equal to the plain
    version, every ray finished once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    props = torch.cuda.get_device_properties(0)
    lanes = props.multi_processor_count * props.max_threads_per_multi_processor
    big = 2 * lanes + 33
    for key, make in SCENES.items():
        cs = make("cuda")
        variants = (TRI_VARIANTS if key[0] in ("robust", "tri")
                    else ((False, False), (True, False)))
        for n in (BIG, big):
            x = [t.cuda() for t in inputs(rays(n, seed=n, masked=key[1]))]
            for occ, attrs in variants:
                a = tr.traverse_packed_reference(cs.packed, *x, occ, attrs,
                                                 cs.robust)
                b = tr.traverse_kernel(cs.packed, *x, occ, attrs, cs.robust)
                torch.cuda.synchronize()
                assert torch.equal(bits(a.t), bits(b.t))
                assert torch.equal(a.best, b.best)
                assert torch.equal(a.visits, b.visits)
                if attrs:
                    assert torch.equal(bits(a.attrs), bits(b.attrs))
                assert int(b.overflow) == 0
                check_counts(b, n)
                if n == big:       # more rays than resident lanes: refilled
                    resident = (int(b.sched[3]) * 32
                                * props.multi_processor_count)
                    assert n > resident
