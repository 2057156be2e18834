"""The moving variants' persistent warps (B6) through the kernel's g++ twin.

On the card the moving variants of scenes without curves run persistent
warps: lanes refilled from a global ray counter as their rays finish, leaves
postponed until enough lanes wait at one (``run_warp`` in
``csrc/traverse.cuh``). The twin runs the same scheduler over 32 emulated
lanes. Its outputs start as values no traversal writes, so each case below
shows that every ray was written (its outputs equal the plain version's,
bit for bit) and written once (the rays-finished count equals the batch),
and that the lane steps the scheduler counted are the rays' steps:

- batches of 1, 31, 32, 33 and 4,097 rays, below, at and past one warp's
  lanes and a refill's worth, on a moving sphere, in every triangle variant
  (closest + attrs, closest, occluded; masked, robust);
- a batch of dead rays only (tnear > tfar, and ray mask 0), which end before
  their first step;
- a long-tail ray: rays along the motion direction through a band of
  moving triangles whose boxes they enter and whose triangles they miss,
  among ordinary rays, so that one lane runs long after its warp's other
  rays are done;
- the mixed-kind and windowed scenes of test_torch_motion.py.

The card runs the same cases in its card-only test at the end, and four
batches larger than its resident lanes, so that its warps refill:
``python -m pytest --noconftest tests/test_torch_motion_sched.py -m cuda``.
"""
import shutil

import numpy as np
import pytest
import torch

import embree_tpu_torch as pt
from embree_tpu_torch.accel import traverse as tr
from embree_tpu_torch.tools.viewer import sphere_mesh
from test_torch_round import one_thread  # noqa: F401 (module-wide autouse)

VARIANTS = ((False, True), (False, False), (True, False))   # (occ, attrs)
SIZES = (1, 31, 32, 33, 4097)
SHIFT = (0.25, 0.0, 0.0)       # the sphere's motion, along x
BAND = 640                     # triangles of the long-tail band


def bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def moving(verts, shift, steps=2):
    """``steps`` time steps of ``verts``, moving by ``shift`` in all."""
    s = np.asarray(shift, np.float32)
    return np.stack([verts + s * (k / (steps - 1)) for k in range(steps)])


def sphere_scene(masked=False, robust=False, band=False, device="cpu"):
    """A 2-step sphere_mesh(12, 24) moving along x; ``masked``: a second,
    smaller sphere with mask 0x2; ``band``: the long-tail band
    (``band_triangles``)."""
    s = pt.Scene(robust=robust)
    v, idx = sphere_mesh(12, 24)
    s.attach(pt.TriangleGeometry(moving(v, SHIFT), idx))
    if masked:
        s.attach(pt.TriangleGeometry(moving(v * 0.4 + 1.2, (0, -0.3, 0)),
                                     idx, mask=0x2))
    if band:
        tris, tidx = band_triangles()
        s.attach(pt.TriangleGeometry(moving(tris, (0.5, 0, 0)), tidx))
    return s.commit(device=device)


def band_triangles():
    """BAND triangles across the line y = 0, z = 3 (clear of the sphere)
    from x = 3 to 11, facing along it: in the yz plane each is the half of
    a square around the line beyond a diagonal that passes 0.1 from it, so
    a ray along x near the line enters every box and misses every
    triangle. The square turns by a quarter at each."""
    base = np.array([[1.0, -0.9], [1.0, 1.0], [-0.9, 1.0]], np.float32)
    out = []
    for k in range(BAND):
        c, s = [(1, 0), (0, 1), (-1, 0), (0, -1)][k % 4]
        yz = base @ np.array([[c, s], [-s, c]], np.float32) + [0.0, 3.0]
        x = np.full((3, 1), 3.0 + 8.0 * k / BAND, np.float32)
        out.append(np.concatenate([x, yz], 1))
    verts = np.concatenate(out).astype(np.float32)
    return verts, np.arange(3 * BAND, dtype=np.int32).reshape(-1, 3)


def rays(n, seed=0, masked=False, n_tail=0):
    """n rays from U(-2, 2)^3 toward N(0, 1)^3 with times U[0, 1) (numpy
    seed ``seed``); ``masked``: ray masks from {1, 2, 3}; ``n_tail``: that
    many of them, from the middle of the batch on, along +x near the line
    y = 0, z = 3 from x = -4 (the long-tail band's rays)."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    at = n // 2
    org[at:at + n_tail] = np.concatenate(
        [np.full((n_tail, 1), -4.0), rng.uniform(-0.05, 0.05, (n_tail, 2))
         + [0.0, 3.0]], 1)
    d[at:at + n_tail] = [1.0, 0.0, 0.0]
    d[at:at + n_tail, 1:] += rng.uniform(-1e-3, 1e-3, (n_tail, 2))
    time = rng.uniform(0, 1, n).astype(np.float32)
    mask = (rng.choice(np.array([1, 2, 3], np.uint32), n) if masked
            else 0xFFFFFFFF)
    return pt.make_rays(org, d, time=time, mask=mask, device="cpu")


def inputs(r):
    return (r.org, r.dir, r.tnear, r.tfar, r.mask.to(torch.int32), r.time)


def run_both(cs, r, occ, attrs):
    """The twin and the plain version on the same rays; the twin's outputs
    equal the plain version's bit for bit, and its counts show each ray
    finished once and the lanes' steps are the rays' steps. Returns both."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    x = inputs(r)
    a = tr.traverse_packed_reference(cs.packed, *x[:5], occ, attrs,
                                     cs.robust, time=x[5])
    b = tr.traverse_twin(cs.packed, *x[:5], occ, attrs, cs.robust,
                         time=x[5])
    np.testing.assert_array_equal(bits(a.t).numpy(), bits(b.t).numpy())
    np.testing.assert_array_equal(a.best.numpy(), b.best.numpy())
    np.testing.assert_array_equal(a.visits.numpy(), b.visits.numpy())
    if attrs:
        np.testing.assert_array_equal(bits(a.attrs).numpy(),
                                      bits(b.attrs).numpy())
    assert int(a.overflow) == 0 and int(b.overflow) == 0
    check_counts(b, r.org.shape[0])
    return a, b


def check_counts(res, n):
    slots, steps, finished, warps = (int(v) for v in res.sched)
    assert finished == n
    assert steps == int(res.visits.sum(dtype=torch.int64))
    assert slots % 32 == 0 and steps <= slots
    assert warps >= 1


@pytest.mark.parametrize("occ,attrs", VARIANTS)
@pytest.mark.parametrize("n", SIZES)
def test_batch_sizes(n, occ, attrs):
    """1, 31, 32, 33 and 4,097 rays on the moving sphere: every ray
    written once, bit-equal to the plain version."""
    cs = sphere_scene()
    assert tr.kernel_instantiation(cs.packed, False, False, False)[0] == \
        "persistent_kernel"
    a, _ = run_both(cs, rays(n, seed=n), occ, attrs)
    if n > 1000:
        assert int((a.best >= 0).sum()) > 100


@pytest.mark.parametrize("occ,attrs", VARIANTS)
@pytest.mark.parametrize("masked,robust", [(True, False), (False, True),
                                           (True, True)])
def test_masked_robust(masked, robust, occ, attrs):
    """The masked and robust triangle variants at 33 and 4,097 rays."""
    cs = sphere_scene(masked=masked, robust=robust)
    assert cs.packed.has_mask == masked
    for n in (33, 4097):
        run_both(cs, rays(n, seed=n + 1, masked=masked), occ, attrs)


@pytest.mark.parametrize("masked", [False, True])
def test_dead_rays_only(masked):
    """A batch of dead rays (tnear > tfar, and ray mask 0 where the scene
    has no mask chunk to test it against) ends before any step: every ray
    written with tfar, no hit and no visit, and no warp pass."""
    cs = sphere_scene(masked=masked)
    n = 100
    r = rays(n, seed=5)
    tnear = r.tnear.clone()
    tnear[: n // 2] = 2.0
    r.tfar[: n // 2] = 1.0
    mask = r.mask.clone()
    mask[n // 2:] = 0
    if masked:                     # the mask chunk decides: keep them dead
        tnear[n // 2:] = 2.0
        r.tfar[n // 2:] = 1.0
    r = pt.RayBatch(r.org, r.dir, tnear, r.tfar, r.time, mask)
    for occ, attrs in VARIANTS:
        _, b = run_both(cs, r, occ, attrs)
        assert int(b.visits.abs().sum()) == 0
        assert (b.best == -1).all()
        assert int(b.sched[0]) == 0


@pytest.mark.parametrize("occ,attrs", VARIANTS)
def test_long_tail_ray(occ, attrs):
    """Rays along the motion direction through the band of moving
    triangles, among 4,097 ordinary rays: they walk every leaf of the band
    while their warp's other lanes are refilled, and end as the plain
    version's do."""
    cs = sphere_scene(band=True)
    r = rays(4097, seed=9, n_tail=3)
    a, b = run_both(cs, r, occ, attrs)
    steps = (a.visits[0] + a.visits[1]).numpy()
    tail = steps[4097 // 2:4097 // 2 + 3]
    assert tail.min() >= BAND // 8          # every leaf of the band
    assert tail.min() > 10 * np.median(steps)
    # the share of lane slots that did work beats one ray per lane, where a
    # warp of 32 rays in launch order runs as long as its longest
    per_warp = np.pad(steps, (0, -len(steps) % 32)).reshape(-1, 32).max(1)
    assert int(b.sched[1]) / int(b.sched[0]) > steps.sum() / (
        32 * per_warp.sum())


@pytest.mark.parametrize("name", ["mixed_motion", "windowed"])
def test_kinds_and_windows(name):
    """The mixed-class variants (every kind moving) and the windowed
    variants at 4,097 rays."""
    from test_torch_motion import build
    cs = build(pt, name, threads=1).commit(device="cpu")
    assert tr.kernel_instantiation(cs.packed, False, False, False)[0] == \
        "persistent_kernel"
    r = rays(4097, seed=11)
    for occ, attrs in VARIANTS:
        if attrs and not cs.packed.tri_attrs:
            continue
        run_both(cs, r, occ, attrs)


@pytest.mark.cuda
def test_scheduler_on_card():
    """On an NVIDIA GPU: the persistent kernel on the same cases, and, on
    batches of twice as many rays as an SM's thread limit over all SMs
    allows lanes (so every warp refills), the masked and robust sphere, the
    long-tail band, and the mixed-kind and windowed scenes; bit-equal to
    the plain version, every ray finished once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    props = torch.cuda.get_device_properties(0)
    lanes = props.multi_processor_count * props.max_threads_per_multi_processor
    big = 2 * lanes + 33
    cases = [(sphere_scene(device="cuda"), n, False, 0) for n in SIZES]
    cases += [(sphere_scene(True, True, device="cuda"), 4097, True, 0),
              (sphere_scene(band=True, device="cuda"), 4097, False, 3),
              (sphere_scene(True, True, device="cuda"), big, True, 0),
              (sphere_scene(band=True, device="cuda"), big, False, 64)]
    from test_torch_motion import build
    cases += [(build(pt, name, threads=1).commit(device="cuda"), big, False,
               0) for name in ("mixed_motion", "windowed")]
    for cs, n, masked, n_tail in cases:
        x = [t.cuda() for t in inputs(rays(n, seed=n, masked=masked,
                                             n_tail=n_tail))]
        for occ, attrs in VARIANTS:
            if attrs and not cs.packed.tri_attrs:
                continue
            a = tr.traverse_packed_reference(cs.packed, *x[:5], occ, attrs,
                                             cs.robust, time=x[5])
            b = tr.traverse_kernel(cs.packed, *x[:5], occ, attrs, cs.robust,
                                   time=x[5])
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
