"""Round curves in the traversal kernel (B8): the port vs the JAX package.

The JAX package keeps native round curves on its generic engine unless
EMBREE_TPU_KERNEL_ROUND=1 or a caller widens ``scene._PACKED_KINDS``
(tests/test_pallas_kernel.py:211-233); its JAX side here widens the set
inside its subprocesses only, and the port's tests widen
``embree_tpu_torch.scene.PACKED_KINDS`` the same way (monkeypatch). The JAX
side runs in one subprocess per scene, all at once, with XLA limited to AVX
and its algebraic simplifier off, as in test_torch_curves.py (no FMA
contraction, no inexact rsqrt).

1. Traversal: the Pallas kernel in interpret mode on five round-curve
   scenes carried across with ``from_arrays`` (the round variant of
   test_pallas_kernel.py:175-193 scaled up to 24 curves; flat and round
   curves with masks; robust at rate 12; 2-step; 3-step windowed) against
   the port's plain version (class 9), and the g++ twin of the CUDA kernel
   against the plain version: prim ids, t bits, occlusion and step counts
   bit-equal. The port's own commit packs the JAX package's records.
2. Routing: round curves ride the generic engine by default in both
   packages and the kernel once widened; the kernel against the engine
   within the reference's own bounds (test_pallas_kernel.py:229-233).

The card-only test at the end imports no JAX: run it on the card with
``python -m pytest --noconftest tests/test_torch_round.py -m cuda``.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import embree_tpu_torch as pt
from embree_tpu_torch import scene as pscene
from embree_tpu_torch.accel import traverse as tr
from test_torch_curves import (BACKDROP, TABLES, _flags, build, fat_curves,
                               port_scene, rays_for, steps_of)
from test_torch_traverse import bits, port_rays
import torch_jaxref

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@pytest.fixture(scope="module", autouse=True)
def _native_route():
    """The port's commits take the JAX side's build route: the native
    builder (EMBREE_TPU_NATIVE_BUILD=1) at every prim count, so both
    packages pack the same tree."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EMBREE_TPU_NATIVE_BUILD", "1")
        yield


F32 = np.float32
KIND_CURVE_ROUND = 9


def round_geoms(et, rate=4, seed=4, n=24, steps=1):
    """test_pallas_kernel.py:175's _curve_scene("round") scaled up: n fat
    round Bezier curves (``steps`` time steps, moving along z) and the
    backdrop triangle."""
    cp, idx = fat_curves(np.random.default_rng(seed), n)
    return [et.CurveGeometry(steps_of(cp, (0, 0, 0.6), steps)
                             if steps > 1 else cp, idx, basis="bezier",
                             kind="round", tessellation_rate=rate),
            et.TriangleGeometry(*BACKDROP)]


def both_geoms(et):
    """Round Bezier and flat B-spline curves at one rate beside the
    triangle, masks 0x2 (curves) and 0x1 (triangle): classes 0, 8, 9."""
    rng = np.random.default_rng(7)
    cp, idx = fat_curves(rng, 12)
    sv = np.concatenate([rng.uniform(-1, 1, (18, 3)),
                         np.full((18, 1), 0.08)], 1).astype(F32)
    geoms = [et.CurveGeometry(cp, idx, basis="bezier", kind="round"),
             et.CurveGeometry(sv, np.arange(0, 15, 3, dtype=np.int32),
                              basis="bspline", kind="flat"),
             et.TriangleGeometry(*BACKDROP)]
    for g, m in zip(geoms, (0x2, 0x2, 0x1)):
        g.mask = m
    return geoms


# name -> (geometry builder, robust, knot times)
SCENES = {
    "static": (round_geoms, False, (0.0, 1.0)),
    "masked": (both_geoms, False, (0.0, 1.0)),
    "robust_rate12": (lambda et: round_geoms(et, rate=12, seed=6), True,
                      (0.0, 1.0)),
    "motion": (lambda et: round_geoms(et, seed=11, steps=2), False,
               (0.0, 1.0)),
    "windowed": (lambda et: round_geoms(et, seed=5, steps=3), False,
                 (0.0, 0.5, 1.0)),
}
MOVING = ("motion", "windowed")
# one subprocess per scene, all started together
JAX_PARTS = tuple((name,) for name in sorted(SCENES))
LONG_RUNNING = ("masked", "robust_rate12")


def trace_inputs(name):
    geoms, _, knots = SCENES[name]
    org, d, tn, tf, mask, time = rays_for(name, geoms, knots)
    return port_rays(org, d, tn, tf, mask) + (torch.from_numpy(time),)


# ---------------------------------------------------------------------------
# the JAX side (one subprocess per scene)
# ---------------------------------------------------------------------------

def _jax_reference(out_path, part):
    """The Pallas kernel in interpret mode on this part's scenes, committed
    with round curves among the packed kinds."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import embree_tpu as et
    from embree_tpu import scene as et_scene
    from embree_tpu.accel import traverse_pallas as tp
    from test_torch_traverse import jax_native_ready

    jax_native_ready()
    res = {}
    for name in JAX_PARTS[part]:
        geoms, robust, knots = SCENES[name]
        cs = build(et, geoms, robust, threads=1).commit()
        res[f"{name}/default_packed"] = np.array(cs.packed is not None)
        et_scene._PACKED_KINDS.add(KIND_CURVE_ROUND)
        try:
            cs = build(et, geoms, robust, threads=1).commit()
        finally:
            et_scene._PACKED_KINDS.discard(KIND_CURVE_ROUND)
        pk = cs.packed
        assert pk is not None and pk.nf == 16
        for k in ("prim_kind", "prim_geom", "prim_local", "prim_inst",
                  "prim_data", "prim_mask", "prim_t0", "prim_t1") + TABLES:
            res[f"{name}/{k}"] = np.asarray(getattr(cs, k))
        for k in ("node_lower", "node_upper", "node_child", "prim_order"):
            res[f"{name}/bvh.{k}"] = np.asarray(getattr(cs.bvh, k))
        res[f"{name}/packed.table"] = np.asarray(pk.table)
        res[f"{name}/packed.pid_map"] = np.asarray(pk.pid_map)
        res[f"{name}/flags"] = _flags(cs)
        org, d, tn, tf, mask, time = rays_for(name, geoms, knots)
        args = (jnp.asarray(org), jnp.asarray(d), jnp.asarray(tn),
                jnp.asarray(tf), jnp.asarray(mask.astype(np.int64))
                .astype(jnp.int32))
        t_, prim = tp.traverse_packed(pk, *args, interpret=True,
                                      robust=cs.robust,
                                      time=jnp.asarray(time))
        res[f"{name}/t"] = np.asarray(t_)
        res[f"{name}/prim"] = np.asarray(prim)
        _, oprim = tp.traverse_packed(pk, *args, interpret=True,
                                      occlusion=True, robust=cs.robust,
                                      time=jnp.asarray(time))
        res[f"{name}/occ"] = np.asarray(oprim) >= 0
    np.savez(out_path, **res)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one CPU thread: its tensors are small,
    and under the test run's parallel workers (and the JAX side's
    subprocesses) a thread pool per process oversubscribes the cores
    several times over. Elementwise ops, exact min/max and integer sums
    give the same bits on any thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jaxref_round")
    shared = torch_jaxref.shared_dir(tmp_path_factory)
    # the interpreted kernel runs longest on these two scenes: compiled
    # without LLVM's passes they took 6x and 1.4x the CPU, the other three
    # 0.75x
    envs = [torch_jaxref.env("--xla_cpu_max_isa=AVX "
                             "--xla_disable_hlo_passes=algsimp",
                             fast_compile=part[0] not in LONG_RUNNING,
                             EMBREE_TPU_NATIVE_BUILD="1")
            for part in JAX_PARTS]
    paths = [str(out / f"ref{k}.npz") for k in range(len(JAX_PARTS))]
    torch_jaxref.run([torch_jaxref.script(__file__, path, k)
                      for k, path in enumerate(paths)], shared, envs)
    ref = {}
    for path in paths:
        ref.update(np.load(path))
    return ref


@pytest.fixture
def round_packed(monkeypatch):
    """Round curves among the port's packed kinds, for one test."""
    monkeypatch.setattr(pscene, "PACKED_KINDS",
                        pscene.PACKED_KINDS | {KIND_CURVE_ROUND})


# ---------------------------------------------------------------------------
# 1. traversal against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sort_rays", [True, False])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_matches_pallas_bits(jax_ref, name, sort_rays):
    """The port's plain traversal on the carried-across table equals the
    Pallas kernel: prim ids, t bits and occlusion, with class-9 hits."""
    cs = port_scene(jax_ref, name)
    assert cs.packed.nf == 16 and 9 in cs.packed.kind_classes
    assert cs.packed.has_motion == (name in MOVING)
    org, d, tn, tf, mask, time = trace_inputs(name)
    t, prim = tr.traverse_packed(cs.packed, org, d, tn, tf, mask,
                                 sort_rays=sort_rays, robust=cs.robust,
                                 time=time)
    ref_prim = jax_ref[f"{name}/prim"]
    hit_kinds = jax_ref[f"{name}/prim_kind"][ref_prim[ref_prim >= 0]]
    assert (hit_kinds == 9).sum() > 20
    np.testing.assert_array_equal(prim.numpy(), ref_prim)
    np.testing.assert_array_equal(bits(t.numpy()), bits(jax_ref[f"{name}/t"]))
    _, oprim = tr.traverse_packed(cs.packed, org, d, tn, tf, mask,
                                  occlusion=True, sort_rays=sort_rays,
                                  robust=cs.robust, time=time)
    np.testing.assert_array_equal(oprim.numpy() >= 0, jax_ref[f"{name}/occ"])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_commit_packs_same_records(jax_ref, round_packed, name):
    """With round curves packed, the port's own commit packs the JAX
    package's 16-field records (tag-9 slots), its curve tables and its
    rate."""
    geoms, robust, _ = SCENES[name]
    cs = build(pt, geoms, robust, threads=1).commit(device="cpu")
    table = jax_ref[f"{name}/packed.table"]
    flags = json.loads(str(jax_ref[f"{name}/flags"]))
    recs = table.transpose(0, 2, 1).reshape(-1, table.shape[1])
    nn, nl = cs.packed.nodes.shape[0], cs.packed.leaves.shape[0]
    gn = flags["gn"] * 128
    np.testing.assert_array_equal(cs.packed.nodes.numpy(), recs[:nn, :32])
    np.testing.assert_array_equal(cs.packed.leaves.numpy(),
                                  recs[gn:gn + nl, :cs.packed.leaf_words])
    np.testing.assert_array_equal(cs.packed.pid_map.numpy(),
                                  jax_ref[f"{name}/packed.pid_map"][:nl * 8])
    for k in ("prim_kind", "prim_t0", "prim_t1") + TABLES:
        np.testing.assert_array_equal(getattr(cs, k).numpy(),
                                      jax_ref[f"{name}/{k}"], err_msg=k)
    assert (cs.packed.kind_classes, cs.packed.curve_rate) == (
        tuple(flags["kind_classes"]), flags["curve_rate"])


TWIN_CASES = [(name, occ) for name in sorted(SCENES) for occ in (False, True)]


@pytest.mark.parametrize("name,occ", TWIN_CASES)
def test_cpu_twin_matches_plain(round_packed, name, occ):
    """The kernel's per-ray logic (csrc/traverse.cuh, leaf_round_curve in
    the CURVES variants) compiled for the host equals the plain PyTorch
    version field for field, step counts included."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    geoms, robust, _ = SCENES[name]
    cs = build(pt, geoms, robust, threads=1).commit(device="cpu")
    org, d, tn, tf, mask, time = trace_inputs(name)
    m32 = mask.to(torch.int32)
    a = tr.traverse_packed_reference(cs.packed, org, d, tn, tf, m32, occ,
                                     False, cs.robust, time=time)
    b = tr.traverse_twin(cs.packed, org, d, tn, tf, m32, occ, False,
                         cs.robust, time=time)
    assert int((a.best >= 0).sum()) > 20 and int(a.class_slots[9]) > 0
    np.testing.assert_array_equal(bits(a.t.numpy()), bits(b.t.numpy()))
    np.testing.assert_array_equal(a.best.numpy(), b.best.numpy())
    np.testing.assert_array_equal(a.visits.numpy(), b.visits.numpy())
    assert int(a.overflow) == 0 and int(b.overflow) == 0


def test_curve_weights_layout():
    """The knot table: the ribbon's rows at the scene's rate, then the
    cubic Bernstein weights of k / max(rate, 8), each float64 rounded to
    float32 as the Pallas kernel's Python floats are."""
    for rate, n in ((4, 8), (12, 12)):
        w = tr.curve_weights(rate)
        assert w.dtype == np.float32 and w.shape == (7 * (rate + 1)
                                                     + 4 * (n + 1),)
        np.testing.assert_array_equal(w[:7 * (rate + 1)],
                                      tr.ribbon_weights(rate).reshape(-1))
        cubic = w[7 * (rate + 1):].reshape(n + 1, 4)
        t = np.arange(n + 1) / n
        s = 1.0 - t
        np.testing.assert_array_equal(cubic, np.stack(
            [s * s * s, 3 * s * s * t, 3 * s * t * t, t * t * t],
            1).astype(np.float32))


# ---------------------------------------------------------------------------
# 2. routing, and the kernel against the generic engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENES))
def test_round_routing(jax_ref, name):
    """Round curves ride the generic engine by default (packed is None in
    both packages) and the kernel once widened (class 9 with 16 fields)."""
    geoms, robust, _ = SCENES[name]
    cs = build(pt, geoms, robust, threads=1).commit(device="cpu")
    assert (cs.packed is not None) == bool(jax_ref[f"{name}/default_packed"])
    assert cs.packed is None
    pscene.PACKED_KINDS.add(KIND_CURVE_ROUND)
    try:
        cs = build(pt, geoms, robust, threads=1).commit(device="cpu")
    finally:
        pscene.PACKED_KINDS.discard(KIND_CURVE_ROUND)
    assert cs.packed is not None and 9 in cs.packed.kind_classes


def test_kernel_close_to_engine(round_packed):
    """Scene level, the kernel route (its plain version) against the
    generic engine on the static scene: hit masks agree on > 97% of the
    rays and t within 1% on > 95% of the rays both hit, the bounds of
    test_pallas_kernel.py:229-233."""
    geoms, _, knots = SCENES["static"]
    cs = build(pt, geoms, threads=1).commit(device="cpu")
    org, d, tn, tf, mask, time = rays_for("static", geoms, knots)
    r = pt.make_rays(org, d, tn, tf, time, mask, device="cpu")
    hk = pt.intersect(cs, r)
    hj = pt.intersect(cs, r, backend="jnp")
    mk, mj = hk.valid.numpy(), hj.valid.numpy()
    assert mj.sum() > 40 and (mk == mj).mean() > 0.97
    both = mk & mj
    tk, tj = hk.t.numpy()[both], hj.t.numpy()[both]
    assert (np.abs(tk - tj) / np.maximum(tj, 1e-3) < 0.01).mean() > 0.95
    np.testing.assert_array_equal(pt.occluded(cs, r).numpy(), mk)


# ---------------------------------------------------------------------------
# card-only: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_matches_plain_on_card_round():
    """On an NVIDIA GPU: every round scene's closest and occluded kernel
    equals the plain version bit for bit (t, best, step counts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    pscene.PACKED_KINDS.add(KIND_CURVE_ROUND)
    try:
        for name, (geoms, robust, _) in SCENES.items():
            cs = build(pt, geoms, robust, threads=1).commit(device="cuda")
            org, d, tn, tf, mask, time = (x.cuda() for x in
                                          trace_inputs(name))
            m32 = mask.to(torch.int32)
            for occ in (False, True):
                a = tr.traverse_packed_reference(cs.packed, org, d, tn, tf,
                                                 m32, occ, False, cs.robust,
                                                 time=time)
                b = tr.traverse_kernel(cs.packed, org, d, tn, tf, m32, occ,
                                       False, cs.robust, time=time)
                torch.cuda.synchronize()
                assert torch.equal(a.best, b.best), name
                assert torch.equal(a.t.view(torch.int32),
                                   b.t.view(torch.int32)), name
                assert torch.equal(a.visits, b.visits), name
                assert int(b.overflow) == 0
    finally:
        pscene.PACKED_KINDS.discard(KIND_CURVE_ROUND)


if __name__ == "__main__":
    _jax_reference(sys.argv[1], int(sys.argv[2]))
