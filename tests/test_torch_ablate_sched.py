"""The two traversal ablation kernels on persistent warps, through their
g++ twin.

On the card the ablation kernels (``csrc/ablate_v7.cu``,
``csrc/ablate_v5.cu``) run B1's persistent warps (``run_warp`` in
``csrc/ablate.cuh``): lanes refilled from a global ray counter as their
rays retire or reach the step limit, leaves postponed until enough lanes
wait at one, and leaf passes that deal the waiting lanes' (ray, slot) items
across the warp (8 slots a v7 leaf, 4 a v5 leaf); v7's ``one_trip`` keeps
its lockstep 128-ray block. The twin runs the same code over 32 emulated
lanes. Its outputs start as values no walk writes, so each case below shows
that every ray was written (t bits, ids, both visit rows equal the plain
version's) and written once (the rays-finished count equals the batch),
that the lane steps the scheduler counted are the rays' steps, and that each
program's most steps (step row 0) survived rays of several programs sharing
a warp. All 18 instantiations (v7's 11 flag words, v5's 7) run:

- batches of 1, 31, 33 and 4,097 rays through the wrappers (padded to whole
  programs with dead rays), and of 1 and 33 rays unpadded (the launch's
  last refill runs past the batch; one_trip, which needs whole 128-ray
  sub-groups, refuses those);
- batches of dead rays only (``tnear > tfar``);
- v5 at UGRP 16, 8 and 4 (programs of 2,048, 1,024 and 512 rays);
- the deep chain of ``test_torch_ablate.py``, whose rays push past 64
  stack entries (v5 on the same chain with 4-slot records), and v5 on
  that chain with every triangle in two slots (ties in t).

No JAX reference runs here: ``test_torch_ablate.py`` holds the plain
versions against the JAX harnesses. The card runs the same check in its
card-only test at the end, on batches larger than its resident lanes, so
that its warps refill:
``python -m pytest --noconftest tests/test_torch_ablate_sched.py -m cuda``.
"""
import shutil

import numpy as np
import pytest
import torch

from embree_tpu_torch.perf import ablate_v7 as v7
from embree_tpu_torch.perf import harness, scenes, tables
from embree_tpu_torch.perf import kernel_ablate as v5
from test_torch_ablate import DEEP_NODES, DEEP_STEPS, deep_chain

MESH = (32, 64)
SIZES = (1, 31, 33, 4097)
UNPADDED = (1, 33)
BIG = SIZES[-1]
UGRPS = (16, 8, 4)


def _instantiations():
    """(unit, kernel name, flags, max_steps) of each flags word the
    kernels instantiate, from the harnesses' variant lists (v7's "no fetch"
    and "compute only" are one word; v5's full U16, U8 and U4 another)."""
    out = {}
    for _, kw in v7.VARIANTS:
        out.setdefault(("v7", v7.flag_bits(**kw)),
                       ("v7", v7.variant_name(**kw), dict(kw), v7.MAX_STEPS))
    for _, kw in v5.VARIANTS:
        kw = dict(kw)
        kw.pop("UGRP")
        steps = kw.pop("max_steps", None)
        out.setdefault(("v5", v5.flag_bits(**kw)),
                       ("v5", v5.variant_name(16, **kw), kw, steps))
    return list(out.values())


INSTANTIATIONS = _instantiations()
IDS = [name for _, name, _, _ in INSTANTIATIONS]
SCHEDULED = [v for v in INSTANTIATIONS if not v[2].get("one_trip")]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the file shares its worker with others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")


@pytest.fixture(scope="module")
def setup():
    """v7 and v5 tables of the 4,096-tri sphere and BIG sorted rays, on the
    CPU."""
    cs = scenes.sphere_scene(*MESH, device="cpu", threads=1)
    return ({"v7": tables.v7_tables(cs.packed).to("cpu"),
             "v5": tables.pack_v5(cs, threads=1).to("cpu")},
            scenes.harness_rays(BIG, device="cpu"))


def run(unit, fn, tabs, rays, kw, steps, ugrp=16):
    mod = v7 if unit == "v7" else v5
    args = (ugrp,) if unit == "v5" else ()
    extra = {} if steps is None else dict(max_steps=steps)
    return getattr(mod, fn)(tabs, *rays, *args, **kw, **extra)


def check(unit, plain, twin, n_padded):
    """The twin's result equals the plain version's (t bits, ids, every
    program's steps, each ray's node and leaf steps), every ray finished
    once, and the scheduler's lane steps are the rays' steps; where leaf
    passes dealt items, their lane steps are the rays' leaf steps."""
    np.testing.assert_array_equal(twin.t.view(torch.int32).numpy(),
                                  plain.t.view(torch.int32).numpy())
    np.testing.assert_array_equal(twin.best.numpy(), plain.best.numpy())
    np.testing.assert_array_equal(twin.steps[:, 0].numpy(),
                                  plain.steps[:, 0].numpy())
    np.testing.assert_array_equal(twin.visits.numpy(), plain.visits.numpy())
    slots, steps, finished, warps, leaf_slots, leaf_steps, items = (
        int(x) for x in twin.sched)
    assert finished == n_padded
    assert steps == int(plain.visits.sum()) and slots >= steps
    assert warps == 1
    if items:
        assert leaf_steps == int(plain.visits[1].sum())
        slots_per_leaf = 8 if unit == "v7" else tables.V5_SLOTS
        assert leaf_slots >= leaf_steps
        assert items >= slots_per_leaf * leaf_steps


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("unit,name,kw,steps", INSTANTIATIONS, ids=IDS)
def test_batch_sizes(setup, gxx, unit, name, kw, steps, n):
    """1, 31, 33 and 4,097 rays, padded to whole programs: bit-equal to the
    plain version, every ray (padding included) finished once."""
    tabs, rays = setup
    x = [r[:n] for r in rays]
    plain = run(unit, "traverse_plain", tabs[unit], x, kw, steps)
    twin = run(unit, "traverse_twin", tabs[unit], x, kw, steps)
    check(unit, plain, twin, plain.t.numel())
    if n == BIG and name in ("v7_full", "v5_full_U16"):
        assert int((twin.best >= 0).sum()) > 200
        # the lanes did useful work in more than a third of their slots
        assert int(twin.sched[1]) > int(twin.sched[0]) / 3


@pytest.mark.parametrize("n", UNPADDED)
@pytest.mark.parametrize("unit,name,kw,steps", SCHEDULED,
                         ids=[v[1] for v in SCHEDULED])
def test_unpadded_batches(setup, gxx, unit, name, kw, steps, n):
    """1 and 33 rays straight to the twin, no padding: the last refill
    takes indices past the batch, which no lane may start; the rays and
    their one program's most steps equal the plain version's."""
    tabs, rays = setup
    mod = v7 if unit == "v7" else v5
    prog = v7.PROG if unit == "v7" else 16 * harness.LANE
    x = [r[:n].contiguous() for r in rays]
    limit = steps if steps is not None else (
        v7.MAX_STEPS if unit == "v7" else harness.MAX_STEPS)
    tf, best, visits, prog_steps, sched = harness.run_native(
        unit, tabs[unit], x, prog, limit, mod.flag_bits(**kw))
    plain = run(unit, "traverse_plain", tabs[unit], x, kw, steps)
    np.testing.assert_array_equal(tf.view(torch.int32).numpy(),
                                  plain.t.reshape(-1)[:n].view(torch.int32)
                                  .numpy())
    np.testing.assert_array_equal(best.numpy(), plain.best.reshape(-1)[:n])
    np.testing.assert_array_equal(visits.numpy(), plain.visits[:, :n])
    assert prog_steps.tolist() == [int(plain.visits[:, :n].sum(0).max())]
    assert int(sched[2]) == n
    assert int(sched[1]) == int(plain.visits.sum())


def test_one_trip_needs_whole_sub_groups(setup, gxx):
    """one_trip runs 128-ray sub-groups in lockstep: the twin refuses 33
    unpadded rays and takes 128."""
    tabs, rays = setup
    bits = v7.flag_bits(one_trip=True)
    for n in (33, 128):
        x = [r[:n].contiguous() for r in rays]
        if n % harness.LANE:
            with pytest.raises(ValueError):
                harness.run_native("v7", tabs["v7"], x, v7.PROG,
                                   v7.MAX_STEPS, bits)
        else:
            sched = harness.run_native("v7", tabs["v7"], x, v7.PROG,
                                       v7.MAX_STEPS, bits)[4]
            assert int(sched[2]) == n


@pytest.mark.parametrize("unit,name,kw,steps", INSTANTIATIONS, ids=IDS)
def test_dead_rays_only(setup, gxx, unit, name, kw, steps):
    """97 rays with tnear > tfar: each finishes as it is taken, with no
    step, t = tfar and no hit; no lane slot is spent on them."""
    tabs, rays = setup
    x = [r[:97].clone() for r in rays]
    x[2].fill_(1.0)
    x[3].fill_(0.0)
    plain = run(unit, "traverse_plain", tabs[unit], x, kw, steps)
    twin = run(unit, "traverse_twin", tabs[unit], x, kw, steps)
    check(unit, plain, twin, plain.t.numel())
    assert not twin.visits.any() and bool((twin.best < 0).all())
    if not kw.get("one_trip"):
        assert int(twin.sched[0]) == 0


@pytest.mark.parametrize("ugrp", UGRPS)
@pytest.mark.parametrize("unit,name,kw,steps",
                         [v for v in INSTANTIATIONS if v[0] == "v5"],
                         ids=[v[1] for v in INSTANTIATIONS if v[0] == "v5"])
def test_v5_programs_share_warps(setup, gxx, unit, name, kw, steps, ugrp):
    """v5 at UGRP 16, 8 and 4 on 4,097 rays (3, 5 and 9 programs): a warp
    holds rays of neighbouring programs, and each program's lockstep count
    (step row 0) is still its own rays' most steps."""
    tabs, rays = setup
    plain = run(unit, "traverse_plain", tabs[unit], rays, kw, steps, ugrp)
    twin = run(unit, "traverse_twin", tabs[unit], rays, kw, steps, ugrp)
    check(unit, plain, twin, plain.t.numel())
    assert twin.steps.shape[0] == -(-BIG // (ugrp * harness.LANE))


def deep_v5():
    """The deep chain of test_torch_ablate.py with 4-slot v5 leaf records:
    each leaf holds its one triangle in slot 0 (count 1, prim id = leaf id,
    mask -1)."""
    tabs, rays = deep_chain()
    leaves = np.asarray(tabs.leaves)
    n = leaves.shape[0]
    rec = np.zeros((n, tables.V5_LEAF_WORDS), np.int32)
    rec[:, 0] = 1
    rec[:, 1] = np.arange(n)
    bits = leaves.view(np.int32)
    for k in range(9):
        rec[:, 8 + 4 * k] = bits[:, 8 * k]
    rec[:, 44] = -1
    return tables.AblateTables(tabs.nodes, rec.view(np.float32)), rays


def tied_v5():
    """deep_v5 with each leaf's triangle twice, in slots 0 and 1 (count 2,
    prim ids 2 * leaf and 2 * leaf + 1): every hit is a tie in t."""
    tabs, rays = deep_v5()
    rec = np.asarray(tabs.leaves).view(np.int32).copy()
    n = rec.shape[0]
    rec[:, 0] = 2
    rec[:, 1] = 2 * np.arange(n)
    rec[:, 2] = 2 * np.arange(n) + 1
    for k in range(9):
        rec[:, 8 + 4 * k + 1] = rec[:, 8 + 4 * k]
    rec[:, 45] = -1
    return tables.AblateTables(tabs.nodes, rec.view(np.float32)), rays


@pytest.mark.parametrize("unit,name,kw,steps",
                         [v for v in INSTANTIATIONS if v[0] == "v5"],
                         ids=[v[1] for v in INSTANTIATIONS if v[0] == "v5"])
def test_v5_ties_take_the_lowest_slot(gxx, unit, name, kw, steps):
    """Two slots of one leaf at the same t: the dealt items' fold keeps the
    lower slot's prim id, as the slot loop's strict < does."""
    tabs, rays = tied_v5()
    plain = run(unit, "traverse_plain", tabs, rays, kw, steps)
    twin = run(unit, "traverse_twin", tabs, rays, kw, steps)
    check(unit, plain, twin, plain.t.numel())
    if name == "v5_full_U16":
        hit = twin.best >= 0
        assert bool(hit.all()) and not bool((twin.best[hit] % 2).any())


@pytest.mark.parametrize("unit,name,kw,steps", INSTANTIATIONS, ids=IDS)
def test_stack_past_64_entries(gxx, unit, name, kw, steps):
    """The deep chain: every ray pushes 70 entries, 64-69 landing on
    56-61; bit-equal to the plain version in every variant (v7 at 100
    steps; v5 to completion or its pinned count)."""
    tabs, rays = deep_chain() if unit == "v7" else deep_v5()
    if unit == "v7":
        steps = DEEP_STEPS
    plain = run(unit, "traverse_plain", tabs, rays, kw, steps)
    twin = run(unit, "traverse_twin", tabs, rays, kw, steps)
    check(unit, plain, twin, plain.t.numel())
    if name in ("v7_full", "v5_full_U16"):
        assert int(twin.visits.sum(0).max()) == DEEP_NODES + 71
        assert float(twin.t.min()) > 11.0


# ---------------------------------------------------------------------------
# card-only: the kernels' refill against the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_ablation_scheduler_on_card():
    """On an NVIDIA GPU: every instantiation on twice as many rays as the
    card's resident lanes (plus 33), so that every warp refills: bit-equal
    to the plain version, every ray finished once, the lane steps the
    rays' steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    props = torch.cuda.get_device_properties(0)
    lanes = props.multi_processor_count * props.max_threads_per_multi_processor
    n = 2 * lanes + 33
    cs = scenes.sphere_scene(device="cuda")
    tabs = {"v7": tables.v7_tables(cs.packed).to("cuda"),
            "v5": tables.pack_v5(cs).to("cuda")}
    rays = scenes.harness_rays(n, device="cuda")
    for unit, name, kw, steps in INSTANTIATIONS:
        a = run(unit, "traverse_plain", tabs[unit], rays, kw, steps)
        b = run(unit, "traverse_kernel", tabs[unit], rays, kw, steps)
        torch.cuda.synchronize()
        assert torch.equal(a.t.view(torch.int32), b.t.view(torch.int32)), name
        assert torch.equal(a.best, b.best), name
        assert torch.equal(a.steps[:, 0], b.steps[:, 0]), name
        assert torch.equal(a.visits, b.visits), name
        assert int(b.sched[2]) == a.t.numel(), name
        assert int(b.sched[1]) == int(a.visits.sum()), name
        if not kw.get("one_trip"):
            resident = int(b.sched[3]) * 32 * props.multi_processor_count
            assert n > resident, name
