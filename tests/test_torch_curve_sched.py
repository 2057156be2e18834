"""The curve variants' persistent warps (B7, B8) through the kernel's g++ twin.

On the card every curve variant, static or moving, runs persistent warps
(``run_warp`` in ``csrc/traverse.cuh``): lanes refilled from a global ray
counter as their rays finish, leaves postponed until enough lanes wait at
one, and a leaf pass of its own (``curve_pass``) that deals the waiting
lanes' (ray, slot) items across the warp and, in scenes with round curves,
queues the cone stage's candidates and polishes them 32 at a time. The twin
runs the same code over 32 emulated lanes. Its outputs start as values no
traversal writes, so each case below shows that every ray was written (its
outputs equal the plain version's bit for bit: t, best, node and leaf
visits) and written once (the rays-finished count equals the batch), and
that the lane steps the scheduler counted are the rays' steps:

- all 32 curve instantiations: flat (B7) and round (B8) x {closest,
  occluded} x {mask chunk or not} x {robust or not} x {static or 2-step},
  on the check scenes of test_torch_curves.py and test_torch_round.py, and
  both families over 3 steps (windows);
- batches of 1, 31, 32, 33 and 4,097 rays;
- a batch of dead rays only;
- one leaf that holds round, flat and triangle slots and empty ones;
- rays along fat straight round curves, so that each round slot yields a
  candidate in several of its segments, and a leaf pass queues more of
  them than the ring holds at once;
- a long-tail ray: rays along a row of diagonal curves whose boxes they
  enter and whose curves they miss, among ordinary rays;
- the scheduler's other constants (a leaf pass for one waiting lane, a
  refill at 8 idle lanes): a twin copy built with them gives the same
  bits;
- the plain version's counters of slot tests and round candidates take
  only the slots that the mask chunk and the windows let through, as the
  kernel tests only those.

No Pallas reference runs here: test_torch_curves.py and
test_torch_round.py hold the plain version against it. The card runs the
same check in its card-only test at the end, on batches larger than its
resident lanes, so that its warps refill:
``python -m pytest --noconftest tests/test_torch_curve_sched.py -m cuda``.
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
from embree_tpu_torch import scene as pscene
from embree_tpu_torch.accel import traverse as tr
from test_torch_curves import BACKDROP, fat_curves, steps_of
from test_torch_motion_sched import bits
from test_torch_round import one_thread  # noqa: F401 (module-wide autouse)


@pytest.fixture(scope="module", autouse=True)
def _native_route():
    """The native builder's route (EMBREE_TPU_NATIVE_BUILD=1) at every
    prim count: the mixed-leaf scene's expected slot order is the
    native builder's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EMBREE_TPU_NATIVE_BUILD", "1")
        yield


F32 = np.float32
KIND_CURVE_ROUND = 9
FLAGS = [(m, r) for m in (False, True) for r in (False, True)]
SIZES = (1, 31, 32, 33, 4097)
ROW = 512                      # curves of the long-tail row
SHIFT = (0.0, 0.0, 0.6)        # the check scenes' motion, along z


@pytest.fixture(autouse=True)
def round_packed(monkeypatch):
    """Round curves among the port's packed kinds (the kernel's B8 route,
    as EMBREE_TPU_KERNEL_ROUND=1 packs them)."""
    monkeypatch.setattr(pscene, "PACKED_KINDS",
                        pscene.PACKED_KINDS | {KIND_CURVE_ROUND})


def check_scene(family, masked=False, robust=False, steps=1, device="cpu"):
    """The check scenes of test_torch_curves.py (``flat``: 6 fat flat
    Bezier curves, numpy seed 4) and test_torch_round.py (``round``: 24 fat
    round Bezier curves, seed 4) beside the backdrop triangle, at rate 4;
    ``masked``: the curves 0x2, the triangle 0x1; ``steps`` > 1: the
    curves move along z over that many steps, the triangle stays."""
    n = 6 if family == "flat" else 24
    cp, idx = fat_curves(np.random.default_rng(4), n)
    s = pt.Scene(robust=robust)
    s.attach(pt.CurveGeometry(steps_of(cp, SHIFT, steps) if steps > 1
                              else cp, idx, basis="bezier", kind=family,
                              tessellation_rate=4,
                              mask=0x2 if masked else 0xFFFFFFFF))
    s.attach(pt.TriangleGeometry(*BACKDROP, mask=0x1 if masked
                                 else 0xFFFFFFFF))
    return s.commit(device=device)


def mixed_leaf_scene(device="cpu"):
    """3 round and 2 flat fat Bezier curves and the backdrop triangle
    (numpy seed 3): one leaf of 3 round, 2 flat and 1 triangle slot and 2
    empty ones."""
    rng = np.random.default_rng(3)
    cp, idx = fat_curves(rng, 3)
    cp2, idx2 = fat_curves(rng, 2)
    s = pt.Scene()
    s.attach(pt.CurveGeometry(cp, idx, basis="bezier", kind="round"))
    s.attach(pt.CurveGeometry(cp2, idx2, basis="bezier", kind="flat"))
    s.attach(pt.TriangleGeometry(*BACKDROP))
    return s.commit(device=device)


def wiggle_scene(device="cpu"):
    """16 round Bezier curves that wiggle across the x axis, CPs (0, 0),
    (1, 1), (2, -1), (3, 0) in x and y (radius 0.12), stacked in z 0.01
    apart: a ray along x near the stack crosses each of them about three
    times, in other segments (two leaves of 8 slots)."""
    z = (np.arange(16) - 7.5) * 0.01
    cp = np.asarray([[(0, 0, zz, 0.12), (1, 1, zz, 0.12), (2, -1, zz, 0.12),
                      (3, 0, zz, 0.12)] for zz in z], F32).reshape(-1, 4)
    s = pt.Scene()
    s.attach(pt.CurveGeometry(cp, (4 * np.arange(16)).astype(np.int32),
                              basis="bezier", kind="round"))
    return s.commit(device=device)


def row_scene(family, device="cpu"):
    """ROW thin straight curves across x = 3 ... 11, each the diagonal from
    (x, -0.5, -0.5) to (x, 0.5, 0.5) (radius 0.02): a ray along x at
    y = -z = 0.3 enters every box and misses every curve."""
    x = 3.0 + 8.0 * np.arange(ROW) / ROW
    t = np.linspace(-0.5, 0.5, 4)
    cp = np.zeros((ROW, 4, 4), F32)
    cp[:, :, 0] = x[:, None]
    cp[:, :, 1] = t
    cp[:, :, 2] = t
    cp[:, :, 3] = 0.02
    s = pt.Scene()
    s.attach(pt.CurveGeometry(cp.reshape(-1, 4), (4 * np.arange(ROW))
                              .astype(np.int32), basis="bezier",
                              kind=family))
    s.attach(pt.TriangleGeometry(*BACKDROP))
    return s.commit(device=device)


def aim_points(cs):
    """The CPs' positions of the scene's packed curve slots (step A)."""
    p = cs.packed
    leaves = p.leaves.cpu()
    f = leaves[:, :16 * 8].reshape(-1, 16, 8).view(torch.float32)
    kind = leaves[:, p.chunk_at("kind"):p.chunk_at("kind") + 8]
    pts = f.permute(0, 2, 1).reshape(-1, 4, 4)[:, :, :3]
    return pts[(kind >= 8).reshape(-1)].reshape(-1, 3).numpy()


def rays(cs, n, seed=0, masked=False, n_tail=0):
    """n rays from U(-2, 2)^3 (numpy seed ``seed``): half aimed near the
    scene's curve CPs, half toward N(0, 1)^3, times U[0, 1) with 1/8 of
    them at 0, 0.5 and 1 and 1/16 outside [0, 1]; ``masked``: ray masks
    from {1, 2, 3}; ``n_tail``: that many of them, from the middle of the
    batch on, along +x at y = -z = 0.3 from x = -4 (the row's rays)."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-2, 2, (n, 3)).astype(F32)
    d = rng.standard_normal((n, 3)).astype(F32)
    pts = aim_points(cs)
    half = n // 2
    aim = pts[rng.integers(0, len(pts), half)] + rng.normal(0, 0.05,
                                                            (half, 3))
    d[:half] = (aim - org[:half]).astype(F32)
    at = n // 2
    org[at:at + n_tail] = [-4.0, 0.3, -0.3]
    d[at:at + n_tail] = [1.0, 0.0, 0.0]
    d[at:at + n_tail, 1:] += rng.uniform(-1e-4, 1e-4, (n_tail, 2))
    time = rng.uniform(0, 1, n).astype(F32)
    time[: n // 8] = np.resize(np.array([0.0, 0.5, 1.0], F32), n // 8)
    time[n // 8: n // 8 + n // 16] = np.resize(np.array([-0.25, 1.25], F32),
                                               n // 16)
    mask = (rng.choice(np.array([1, 2, 3], np.uint32), n) if masked
            else 0xFFFFFFFF)
    return pt.make_rays(org, d, time=time, mask=mask, device="cpu")


def inputs(r):
    return (r.org, r.dir, r.tnear, r.tfar, r.mask.to(torch.int32), r.time)


def twin_with(fn, cs, x, occ):
    """The twin entry ``fn`` of a library built from this tree's csrc or a
    copy of it, as ``traverse_twin`` calls it."""
    time = tr._time(cs.packed, x[0], x[5])
    outs = tr._outputs(x[0].shape[0], x[0].device, False,
                       unwritten=True)
    assert fn(*tr._call_args(cs.packed, *x[:5], time, outs, occ, False,
                             cs.robust), tr._ptr(outs[6])) == 0
    return tr._result(outs)


def same(a, b):
    np.testing.assert_array_equal(bits(a.t).numpy(), bits(b.t).numpy())
    np.testing.assert_array_equal(a.best.numpy(), b.best.numpy())
    np.testing.assert_array_equal(a.visits.numpy(), b.visits.numpy())


def run_both(cs, r, occ, fn=None):
    """The twin and the plain version on the same rays; the twin's outputs
    equal the plain version's bit for bit, and its counts show each ray
    finished once and the lanes' steps are the rays' steps. Returns both."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    x = inputs(r)
    a = tr.traverse_packed_reference(cs.packed, *x[:5], occ, False,
                                     cs.robust, time=x[5])
    b = (tr.traverse_twin(cs.packed, *x[:5], occ, False, cs.robust,
                          time=x[5]) if fn is None else twin_with(fn, cs, x,
                                                                  occ))
    same(a, b)
    assert int(a.overflow) == 0 and int(b.overflow) == 0
    check_counts(b, r.org.shape[0])
    return a, b


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


VARIANT_CASES = [(fam, m, r, st, occ) for fam in ("flat", "round")
                 for m, r in FLAGS for st in (1, 2)
                 for occ in (False, True)]


@pytest.mark.parametrize("family,masked,robust,steps,occ", VARIANT_CASES)
def test_every_variant(family, masked, robust, steps, occ):
    """Each of the 32 curve instantiations on its check scene at 256 rays
    (its own persistent kernel: mask, robust, motion and round flags as
    named)."""
    cs = check_scene(family, masked, robust, steps)
    entry, flags = tr.kernel_instantiation(cs.packed, occ, False, robust)
    assert entry == "persistent_kernel"
    assert flags == (int(occ), 0, int(masked), int(robust), 1,
                     int(steps > 1), 1, int(family == "round"))
    a, _ = run_both(cs, rays(cs, 256, seed=steps, masked=masked), occ)
    assert int((a.best >= 0).sum()) > 10
    if family == "round":
        assert int(a.round_candidates) > 0


@pytest.mark.parametrize("family", ["flat", "round"])
def test_windows(family):
    """Both families over 3 steps (per-slot windows), at 4,097 rays."""
    cs = check_scene(family, steps=3)
    assert cs.packed.has_win
    for occ in (False, True):
        run_both(cs, rays(cs, 4097, seed=3), occ)


@pytest.mark.parametrize("family", ["flat", "round"])
@pytest.mark.parametrize("n", SIZES)
def test_batch_sizes(n, family):
    """1, 31, 32, 33 and 4,097 rays, closest and occluded: every ray
    written once, bit-equal to the plain version."""
    cs = check_scene(family)
    for occ in (False, True):
        a, _ = run_both(cs, rays(cs, n, seed=n), occ)
    if n > 1000:
        assert int((a.best >= 0).sum()) > 100


@pytest.mark.parametrize("family", ["flat", "round"])
def test_dead_rays_only(family):
    """Dead rays only (tnear > tfar, and ray mask 0) end before their first
    step: tfar, no hit, no visit, no warp pass."""
    cs = check_scene(family)
    r = rays(cs, 100, seed=5)
    n = 100
    tnear = r.tnear.clone()
    tnear[: n // 2] = 2.0
    r.tfar[: n // 2] = 1.0
    mask = r.mask.clone()
    mask[n // 2:] = 0
    r = pt.RayBatch(r.org, r.dir, tnear, r.tfar, r.time, mask)
    for occ in (False, True):
        _, b = run_both(cs, r, occ)
        assert int(b.visits.abs().sum()) == 0
        assert (b.best == -1).all()
        assert int(b.sched[0]) == 0 and int(b.leaf_sched.sum()) == 0


def test_mixed_leaf():
    """One leaf of round, flat and triangle slots with two empty ones: each
    class gets its own test inside one item round, and each class hits."""
    cs = mixed_leaf_scene()
    p = cs.packed
    kind = p.leaves[:, p.chunk_at("kind"):p.chunk_at("kind") + 8]
    assert p.leaves.shape[0] == 1
    assert kind[0].tolist() == [9, 9, 9, 8, 8, 0, 0, 0]
    assert p.pid_map.tolist()[-2:] == [-1, -1]
    r = rays(cs, 4097, seed=7)
    for occ in (False, True):
        a, _ = run_both(cs, r, occ)
    slot_kind = kind[0][a.best[a.best >= 0] % 8]
    assert set(slot_kind.tolist()) == {0, 8, 9}


def test_many_candidates():
    """Rays along x through the stack of wiggling round curves: each round
    slot test yields more than one candidate on average (a segment yields
    at most one, so several segments of a slot polish), and an item round
    of 32 slots queues about 60, more than one batch of 32, so the ring is
    polished as it fills and wraps."""
    cs = wiggle_scene()
    rng = np.random.default_rng(12)
    n = 4097
    org = np.concatenate([np.full((n, 1), -1.0),
                          rng.uniform(-0.05, 0.05, (n, 1)),
                          rng.uniform(-0.06, 0.06, (n, 1))], 1).astype(F32)
    d = np.concatenate([np.ones((n, 1)), rng.normal(0, 0.01, (n, 2))],
                       1).astype(F32)
    r = pt.make_rays(org, d, device="cpu")
    for occ in (False, True):
        a, _ = run_both(cs, r, occ)
    slot_tests = int(a.class_slots[KIND_CURVE_ROUND])
    assert int(a.round_candidates) > 1.5 * slot_tests
    assert int((a.best >= 0).sum()) > n // 2


@pytest.mark.parametrize("family", ["flat", "round"])
def test_long_tail_ray(family):
    """Rays along the row of diagonal curves, among 4,097 ordinary rays:
    they walk every leaf of the row while their warp's other lanes are
    refilled, and end as the plain version's do."""
    cs = row_scene(family)
    r = rays(cs, 4097, seed=9, n_tail=3)
    for occ in (False, True):
        a, b = run_both(cs, r, occ)
    steps = (a.visits[0] + a.visits[1]).numpy()
    tail = steps[4097 // 2:4097 // 2 + 3]
    assert tail.min() >= ROW // 8          # every leaf of the row
    assert tail.min() > 10 * np.median(steps)
    # lane slots that did work beat one ray per lane, where a warp of 32
    # rays in launch order runs as long as its longest
    per_warp = np.pad(steps, (0, -len(steps) % 32)).reshape(-1, 32).max(1)
    assert int(b.sched[1]) / int(b.sched[0]) > steps.sum() / (
        32 * per_warp.sum())


@pytest.mark.parametrize("family", ["flat", "round"])
def test_counters_take_live_slots(family):
    """The plain version's slot tests and round candidates, which a bound's
    operation count reads, leave out the slots that the mask chunk or the
    windows reject, as the kernel tests none of them: in the masked scene
    rays of mask 0x1 visit the curves' leaves and count no curve slot,
    rays of mask 0x2 count them; in the 3-step scene rays at time 1.25 (in
    no window) count no curve slot, rays at 0.25 count them."""
    tag = KIND_CURVE_ROUND if family == "round" else tr.KIND_CURVE_FLAT
    for cs, field, values in ((check_scene(family, masked=True), 4, (1, 2)),
                              (check_scene(family, steps=3), 5,
                               (1.25, 0.25))):
        x = list(inputs(rays(cs, 512, seed=6)))
        for value, counted in zip(values, (False, True)):
            x[field] = torch.full_like(x[field], value)
            a = tr.traverse_packed_reference(cs.packed, *x[:5], False, False,
                                             cs.robust, time=x[5])
            assert int(a.visits[1].sum()) > 100
            assert (int(a.class_slots[tag]) > 0) == counted
            if family == "round":
                assert (int(a.round_candidates) > 0) == counted


# the scheduler's other constants: (kCurveRefillLanes, kCurveLeafLanes)
FORMS = ((8, 1),)


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
        for const, v in zip(("kCurveRefillLanes", "kCurveLeafLanes"), form):
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
    """One waiting lane enough for a leaf pass, and a refill at 8 idle
    lanes: the same bits as the plain version on the round scene masked,
    robust and moving, the mixed leaf, and the candidate-heavy curves;
    the counts as check_counts holds them."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    fns = twin_forms(str(tmp_path))
    cases = [(check_scene("round", True, True, 2), True),
             (mixed_leaf_scene(), False), (wiggle_scene(), False)]
    for cs, masked in cases:
        r = rays(cs, 1025, seed=4, masked=masked)
        for fn in fns.values():
            for occ in (False, True):
                run_both(cs, r, occ, fn=fn)


@pytest.mark.cuda
def test_curve_scheduler_on_card():
    """On an NVIDIA GPU: the persistent kernel on the check scenes, the
    mixed leaf, the candidate-heavy curves and the long-tail row, at 4,097
    rays and at twice as many rays as an SM's thread limit over all SMs
    allows lanes (so every warp refills); bit-equal to the plain version,
    every ray finished once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    props = torch.cuda.get_device_properties(0)
    lanes = props.multi_processor_count * props.max_threads_per_multi_processor
    big = 2 * lanes + 33
    dev = "cuda"
    cases = [(check_scene(f, m, rb, st, dev), m, 0) for f in ("flat", "round")
             for m, rb in FLAGS for st in (1, 2)]
    cases += [(check_scene(f, steps=3, device=dev), False, 0)
              for f in ("flat", "round")]
    cases += [(mixed_leaf_scene(dev), False, 0), (wiggle_scene(dev), False, 0),
              (row_scene("flat", dev), False, 64),
              (row_scene("round", dev), False, 64)]
    for cs, masked, n_tail in cases:
        for n in (4097, big):
            x = [t.cuda() for t in inputs(rays(cs, n, seed=n, masked=masked,
                                                n_tail=n_tail))]
            for occ in (False, True):
                a = tr.traverse_packed_reference(cs.packed, *x[:5], occ,
                                                 False, cs.robust, time=x[5])
                b = tr.traverse_kernel(cs.packed, *x[:5], occ, False,
                                       cs.robust, time=x[5])
                torch.cuda.synchronize()
                assert torch.equal(bits(a.t), bits(b.t))
                assert torch.equal(a.best, b.best)
                assert torch.equal(a.visits, b.visits)
                assert int(b.overflow) == 0
                check_counts(b, n)
                if n == big:       # more rays than resident lanes: refilled
                    resident = (int(b.sched[3]) * 32
                                * props.multi_processor_count)
                    assert n > resident
