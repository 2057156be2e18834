"""The two traversal ablations (perf/ablate_v7.py, perf/kernel_ablate.py):
the port's plain versions, the CPU twin of their CUDA kernels and the JAX
harnesses on the same tables and rays.

Scene: ``sphere_mesh(32, 64)``, 4,096 triangles, committed by the port
with one builder thread; v7 runs on its 8-slot records (2 node tiles, 6
leaf tiles), v5 on the 4-slot records ``pack_v5`` writes (5 and 10
tiles), so every fetch spans several tiles. Rays: the harnesses' ray set
cut to 4,096 (numpy seed 0, sorted by the coherence key): two v7 programs,
eight v5 programs at UGRP = 4.

1. The harnesses' own ``make_kernel`` kernels, run unmodified with
   ``pl.pallas_call`` patched to ``interpret=True``, in six subprocesses
   started together, under ``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (no FMA
   contraction, as in test_torch_traverse.py), get the same numpy tables
   (``AblateTables.tiles``) and rays. Every v7 variant pinned at 24 steps
   and the full one to completion, every v5 variant at UGRP = 4: t, ids and
   all three step rows (lockstep steps and fetch trips) bit-equal to the
   plain versions. No tolerance is needed.
2. The g++ twin of the CUDA kernels equals the plain version bit for bit
   (t, ids, step row 0, each ray's steps) on every variant at the
   harness's own UGRP.
3. The full variants against the JAX package's ``intersect``: equal hit
   masks, t within 1e-4 relative, prim ids equal but at near-ties. The
   port's v7 tables equal the ones ``v7_tables`` makes of the JAX package's
   unified table.

The card-only test at the end imports no JAX: run it on the card with
``python -m pytest --noconftest tests/test_torch_ablate.py -m cuda``.
"""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from embree_tpu_torch.perf import ablate_v7 as v7
from embree_tpu_torch.perf import kernel_ablate as v5
from embree_tpu_torch.perf import scenes, tables

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MESH = (32, 64)
N_RAYS = 4096
V5_UGRP = 4
COMPLETE = 200           # v7 "to completion": every ray retires before it
RAY_KEYS = ("org", "dir", "tnear", "tfar", "mask")

V7_CASES = {name: kw for name, kw in v7.VARIANTS}
V7_CASES["complete"] = dict(max_steps=COMPLETE)
V5_CASES = {name: kw for name, kw in v5.VARIANTS}
# six JAX subprocesses of about equal length (the interpreter traces each
# v7 variant in 5-22 s, each v5 variant at UGRP 4 in 2-6 s); "deep": the
# stack past 64 entries (deep_chain)
JAX_PARTS = (
    ("v7:complete", "v7:no leaf fetch"),
    ("v7:no leaf math", "v7:no fetch", "v7:bare", "v7:fetch only"),
    ("v7:no node math", "v7:no stack"),
    ("v7:full", "v7:no sort", "deep"),
    ("v7:one_trip", "v7:no node fetch", "v7:compute only"),
    tuple(f"v5:{n}" for n in V5_CASES) + ("intersect", "table"),
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one CPU thread (see
    test_torch_round.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    """(committed scene, v7 tables, v5 tables, rays), all on the CPU."""
    cs = scenes.sphere_scene(*MESH, device="cpu", threads=1)
    return (cs, tables.v7_tables(cs.packed), tables.pack_v5(cs, threads=1),
            scenes.harness_rays(N_RAYS, device="cpu"))


DEEP_NODES = 10
DEEP_NEAREST = 310       # the leaf at stack entry 56, which entry 64 aliases
DEEP_STEPS = 100


def deep_chain():
    """v7 tables and 2,048 rays that drive the stack past 64 entries: a
    chain of 10 nodes whose child 0 is the next node and children 1-7
    leaves (the last node: 8 leaves), all children the same box, so each
    node pushes 7 leaves (entries 0-69; 64-69 alias 56-61) and the rays pop
    them all. Leaf id 5 * (7k + c) holds one big triangle facing the rays
    at a depth that makes leaf 310 (node 8's child 7, entry 56) the nearest:
    the alias overwrites it, so no ray hits it."""
    box = np.int32((0x4080 << 16) | 0xC080)      # bf16 lo -4, hi 4
    nodes = np.zeros((DEEP_NODES, 32), np.int32)
    nodes[:, 8:] = box
    ids = np.zeros((DEEP_NODES, 8), np.int64)
    for k in range(DEEP_NODES):
        for c in range(8):
            ids[k, c] = 5 * (7 * k + c)
            nodes[k, c] = (k + 1 if c == 0 and k < DEEP_NODES - 1
                           else -ids[k, c] - 1)
    n_leaf = int(ids.max()) + 1
    leaves = np.zeros((n_leaf, 72), np.float32)
    depth = 1.0 + 0.001 * np.abs(np.arange(n_leaf) - DEEP_NEAREST)
    for k, v in enumerate(((-5.0, -5.0), (20.0, 0.0), (0.0, 20.0))):
        leaves[:, 24 * k + 0] = v[0]             # slot 0: v0, e1, e2
        leaves[:, 24 * k + 8] = v[1]
    leaves[:, 16] = -depth                       # v0.z
    tabs = tables.AblateTables(tables._pad_tiles(nodes, nodes=True),
                               tables._pad_tiles(leaves))
    rng = np.random.default_rng(3)
    org = np.concatenate([rng.uniform(-1, 1, (2048, 2)),
                          np.full((2048, 1), 10.0)], 1).astype(np.float32)
    d = np.concatenate([rng.normal(0, 0.01, (2048, 2)),
                        -np.ones((2048, 1))], 1).astype(np.float32)
    rays = (torch.from_numpy(org), torch.from_numpy(d),
            torch.zeros(2048), torch.full((2048,), float("inf")),
            torch.full((2048,), -1, dtype=torch.int32))
    return tabs, rays


# ---------------------------------------------------------------------------
# the JAX side (six subprocesses)
# ---------------------------------------------------------------------------

def _jax_reference(in_path, out_path, part):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    pallas_call = pl.pallas_call

    def interpret(*a, **k):
        return pallas_call(*a, **dict(k, interpret=True))

    pl.pallas_call = interpret
    import embree_tpu as et
    from perf import ablate_v7 as jv7
    from perf import kernel_ablate as jv5
    from test_torch_traverse import jax_native_ready

    d = np.load(in_path)

    class Tables:
        def __init__(self, unit):
            self.node_table = jnp.asarray(d[f"{unit}/node_table"])
            self.leaf_table = jnp.asarray(d[f"{unit}/leaf_table"])
            self.n_node_tiles = self.node_table.shape[0]
            self.n_leaf_tiles = self.leaf_table.shape[0]

    rays = [jnp.asarray(d[k]) for k in RAY_KEYS]
    jax_native_ready()
    res = {}
    for job in JAX_PARTS[part]:
        if job == "deep":
            out = jv7.traverse(Tables("deep"), *[jnp.asarray(d[f"deep/{k}"])
                                                for k in RAY_KEYS],
                               max_steps=DEEP_STEPS)
            for key, x in zip(("t", "best", "steps"), out):
                res[f"deep/{key}"] = np.asarray(x)
            continue
        if job == "intersect":
            verts, idx = scenes.sphere_mesh(*MESH)
            s = et.Scene()
            s.attach(et.TriangleGeometry(verts, idx))
            h = jax.jit(et.intersect)(s.commit(), et.make_rays(
                rays[0], rays[1]))
            res["intersect/valid"] = np.asarray(h.valid)
            res["intersect/t"] = np.asarray(h.t)
            res["intersect/prim"] = np.asarray(h.prim_id)
            continue
        if job == "table":
            s = et.Scene(threads=1)
            s.attach(et.TriangleGeometry(*scenes.sphere_mesh(*MESH)))
            pk = s.commit().packed
            res["table/table"] = np.asarray(pk.table)
            res["table/pid_map"] = np.asarray(pk.pid_map)
            res["table/gn"] = np.array(pk.gn)
            res["table/gl"] = np.array(pk.gl)
            continue
        unit, name = job.split(":")
        if unit == "v7":
            out = jv7.traverse(Tables("v7"), *rays, **V7_CASES[name])
        else:
            kw = dict(V5_CASES[name], UGRP=V5_UGRP)
            out = jv5.traverse(Tables("v5"), *rays, kw.pop("UGRP"), **kw)
        for key, x in zip(("t", "best", "steps"), out):
            res[f"{job}/{key}"] = np.asarray(x)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jax_ref(inputs, tmp_path_factory):
    _, t7, t5, rays = inputs
    out = tmp_path_factory.mktemp("jaxref_ablate")
    arrays = {k: x.numpy() for k, x in zip(RAY_KEYS, rays)}
    deep, deep_rays = deep_chain()
    for unit, tab in (("v7", t7), ("v5", t5), ("deep", deep)):
        arrays[f"{unit}/node_table"], arrays[f"{unit}/leaf_table"] = \
            tab.tiles()
    arrays.update({f"deep/{k}": x.numpy()
                   for k, x in zip(RAY_KEYS, deep_rays)})
    in_path = str(out / "in.npz")
    np.savez(in_path, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX",
               EMBREE_TPU_NATIVE_BUILD="1",
               PYTHONPATH=os.pathsep.join([ROOT, HERE]))
    paths = [str(out / f"ref{k}.npz") for k in range(len(JAX_PARTS))]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               in_path, path, str(k)], env=env, cwd=ROOT)
             for k, path in enumerate(paths)]
    try:
        codes = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert codes == [0] * len(procs), f"JAX side exited with {codes}"
    ref = {}
    for path in paths:
        ref.update(np.load(path))
    return ref


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_same(res, ref, rows=slice(None)):
    """t bits, ids and the step rows ``rows`` of a result equal ref's
    (t, best, steps)."""
    t, best, steps = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(bits(res.t.numpy()), bits(t))
    np.testing.assert_array_equal(res.best.numpy(), best)
    np.testing.assert_array_equal(res.steps.numpy()[:, rows],
                                  steps[:, rows])


def _ref(jax_ref, job):
    return tuple(jax_ref[f"{job}/{k}"] for k in ("t", "best", "steps"))


# ---------------------------------------------------------------------------
# 1. the plain versions against the JAX harnesses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(V7_CASES))
def test_v7_plain_matches_harness(inputs, jax_ref, name):
    """v7 (ablate_v7.py::make_kernel): t, slot ids, the pinned step count
    and the node and leaf fetch trips per program equal the harness's."""
    _, t7, _, rays = inputs
    res = v7.traverse(t7, *rays, **V7_CASES[name])
    assert res.t.shape == (N_RAYS // v7.PROG, v7.UGRP, 128)
    assert_same(res, _ref(jax_ref, f"v7:{name}"))
    if name in ("full", "complete", "no stack", "one_trip"):
        assert int((res.best >= 0).sum()) > 200
    if name == "complete":
        assert int(res.visits.sum(0).max()) < COMPLETE


@pytest.mark.parametrize("name", list(V5_CASES))
def test_v5_plain_matches_harness(inputs, jax_ref, name):
    """v5 (kernel_ablate.py::make_kernel) at UGRP 4: t, prim ids, each
    program's lockstep step count and its fetch trips equal the
    harness's."""
    _, _, t5, rays = inputs
    kw = dict(V5_CASES[name])
    kw.pop("UGRP")
    res = v5.traverse(t5, *rays, V5_UGRP, **kw)
    assert res.t.shape == (N_RAYS // (V5_UGRP * 128), V5_UGRP, 128)
    assert_same(res, _ref(jax_ref, f"v5:{name}"))
    if name.startswith("full"):
        assert int((res.best >= 0).sum()) > 200


# ---------------------------------------------------------------------------
# 2. the CPU twin of the CUDA kernels against the plain versions
# ---------------------------------------------------------------------------

def _twin_vs_plain(plain, twin):
    assert_same(twin, (plain.t, plain.best, plain.steps), rows=0)
    np.testing.assert_array_equal(twin.steps.numpy()[:, 3:],
                                  plain.steps.numpy()[:, 3:])
    np.testing.assert_array_equal(twin.visits.numpy(), plain.visits.numpy())
    # the kernels leave the fetch trips to the plain version
    assert not twin.steps[:, 1:3].any()


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")


@pytest.mark.parametrize("name", list(V7_CASES))
def test_v7_twin_matches_plain(inputs, gxx, name):
    """csrc/ablate.cuh's v7 step compiled for the host equals the plain
    version: t, slot ids, steps, each ray's node and leaf steps."""
    _, t7, _, rays = inputs
    kw = V7_CASES[name]
    _twin_vs_plain(v7.traverse_plain(t7, *rays, **kw),
                   v7.traverse_twin(t7, *rays, **kw))


@pytest.mark.parametrize("name", list(V5_CASES))
def test_v5_twin_matches_plain(inputs, gxx, name):
    """csrc/ablate.cuh's v5 step compiled for the host equals the plain
    version at the harness's own UGRP."""
    _, _, t5, rays = inputs
    kw = dict(V5_CASES[name])
    ugrp = kw.pop("UGRP")
    _twin_vs_plain(v5.traverse_plain(t5, *rays, ugrp, **kw),
                   v5.traverse_twin(t5, *rays, ugrp, **kw))


def test_stack_past_64_entries(jax_ref, gxx):
    """The deep chain: every ray pushes 70 entries (and visits them and
    the last node's child 0: 71 leaves); entries 64-69 land on
    56-61 as XLA's clamped ninth stack block puts them, so the nearest
    leaf (entry 56) is lost. Plain version == the JAX harness (t, slot
    ids, steps and fetch trips) == the twin."""
    tabs, rays = deep_chain()
    res = v7.traverse(tabs, *rays, max_steps=DEEP_STEPS)
    assert_same(res, _ref(jax_ref, "deep"))
    hit = res.best.reshape(-1) >= 0
    assert bool(hit.all())
    assert int(res.visits.sum(0).max()) == DEEP_NODES + 71
    # the nearest leaf's entry was overwritten: its t (11.0) is never hit
    assert float(res.t.min()) > 11.0
    _twin_vs_plain(res, v7.traverse_twin(tabs, *rays, max_steps=DEEP_STEPS))


def test_instantiated_variants_are_the_harnesses():
    """The kernels instantiate exactly the flag words of the harnesses'
    variants (ABL_V7_VARIANTS, ABL_V5_VARIANTS in csrc/ablate.cuh)."""
    src = open(os.path.join(ROOT, "embree_tpu_torch", "csrc",
                            "ablate.cuh")).read()

    def words(macro):
        body = re.search(rf"#define {macro}\(X\)(.*?)\n(?!\s)", src,
                         re.S).group(1)
        return sorted(int(w, 16) for w in re.findall(r"X\((0x[0-9A-F]+)\)",
                                                     body))

    assert words("ABL_V7_VARIANTS") == sorted(
        {v7.flag_bits(**kw) for _, kw in v7.VARIANTS})
    assert words("ABL_V5_VARIANTS") == sorted(
        {v5.flag_bits(**{k: v for k, v in kw.items()
                         if k not in ("UGRP", "max_steps")})
         for _, kw in v5.VARIANTS})
    assert v7.variant_name(f_node=False, f_leaf=False) == \
        "v7_no_f_node_f_leaf"
    assert v5.variant_name(16, do_fetch=False) == "v5_no_fetch_U16"


# ---------------------------------------------------------------------------
# 3. the full variants against intersect; the tables
# ---------------------------------------------------------------------------

def test_full_variants_match_intersect(inputs, jax_ref):
    """v7 to completion (slot ids through pid_map) and v5 full against the
    JAX package's intersect on the same rays: equal hit masks, t within
    1e-4 relative, prim ids equal on all but near-ties (> 99%)."""
    _, t7, t5, rays = inputs
    valid = jax_ref["intersect/valid"]
    t_ref = jax_ref["intersect/t"]
    prim_ref = jax_ref["intersect/prim"]
    assert valid.sum() > 400
    a = v7.traverse(t7, *rays, max_steps=COMPLETE)
    slot = a.best.reshape(-1)[:N_RAYS].long()
    p7 = torch.where(slot >= 0, torch.as_tensor(t7.pid_map)[
        slot.clamp(min=0)], -1).numpy()
    b = v5.traverse(t5, *rays, 16)
    for t, prim in ((a.t, p7), (b.t, b.best.reshape(-1)[:N_RAYS].numpy())):
        t = t.reshape(-1)[:N_RAYS].numpy()
        np.testing.assert_array_equal(prim >= 0, valid)
        np.testing.assert_allclose(t[valid], t_ref[valid], rtol=1e-4)
        assert (prim[valid] == prim_ref[valid]).mean() > 0.99


def test_v7_tables_equal_jax_table(inputs, jax_ref):
    """``v7_tables`` of the JAX package's unified table (native builder,
    one thread) equals the port's: node records, leaf records, pid_map."""
    _, t7, _, _ = inputs
    jt = tables.v7_tables(jax_ref["table/table"], int(jax_ref["table/gn"]),
                          int(jax_ref["table/gl"]))
    np.testing.assert_array_equal(jt.nodes, t7.nodes)
    np.testing.assert_array_equal(bits(jt.leaves), bits(t7.leaves))
    pid = jax_ref["table/pid_map"]
    np.testing.assert_array_equal(t7.pid_map[:pid.size], pid)


def test_v5_records(inputs):
    """pack_v5: every triangle sits in exactly one 4-slot record, with its
    id, its fields (v0, e1, e2) and its mask; counts 1-4; each leaf ref of
    a node record names a record with a count."""
    cs, _, t5, _ = inputs
    rec = t5.leaves.view(np.int32)
    cnt = rec[:, 0]
    used = cnt > 0
    assert cnt.max() <= 4 and used.sum() >= cs.num_prims // 4
    slots = np.arange(4)[None, :] < cnt[:, None]
    pids = rec[:, 1:5][slots]
    np.testing.assert_array_equal(np.sort(pids), np.arange(cs.num_prims))
    v0 = cs.tri_v0.numpy()
    e1 = (cs.tri_v1 - cs.tri_v0).numpy()
    f = t5.leaves[:, 8:44].reshape(-1, 9, 4).transpose(0, 2, 1)[slots]
    np.testing.assert_array_equal(f[:, 0:3], v0[pids])
    np.testing.assert_array_equal(f[:, 3:6], e1[pids])
    assert np.all(rec[:, 44:48][slots] == -1)
    refs = t5.nodes[:, :8]
    leaf_refs = refs[(refs < 0)]
    assert np.all(cnt[-leaf_refs - 1] > 0)
    assert leaf_refs.size == used.sum()


# ---------------------------------------------------------------------------
# card-only: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On an NVIDIA GPU: every v7 and v5 variant's kernel equals its plain
    version bit for bit (t, ids, step row 0, each ray's steps), and so does
    v7 on the deep chain (the stack past 64 entries)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    cs = scenes.sphere_scene(*MESH, device="cuda", threads=1)
    t7 = tables.v7_tables(cs.packed).to("cuda")
    t5 = tables.pack_v5(cs, threads=1).to("cuda")
    rays = scenes.harness_rays(N_RAYS, device="cuda")
    for name, kw in V7_CASES.items():
        a = v7.traverse_plain(t7, *rays, **kw)
        b = v7.traverse_kernel(t7, *rays, **kw)
        torch.cuda.synchronize()
        assert torch.equal(a.t.view(torch.int32), b.t.view(torch.int32)), name
        assert torch.equal(a.best, b.best), name
        assert torch.equal(a.steps[:, 0], b.steps[:, 0]), name
        assert torch.equal(a.visits, b.visits), name
    deep, deep_rays = deep_chain()
    deep, deep_rays = deep.to("cuda"), [x.cuda() for x in deep_rays]
    a = v7.traverse_plain(deep, *deep_rays, max_steps=DEEP_STEPS)
    b = v7.traverse_kernel(deep, *deep_rays, max_steps=DEEP_STEPS)
    assert torch.equal(a.t.view(torch.int32), b.t.view(torch.int32))
    assert torch.equal(a.best, b.best) and torch.equal(a.visits, b.visits)
    for name, kw in V5_CASES.items():
        kw = dict(kw)
        ugrp = kw.pop("UGRP")
        a = v5.traverse_plain(t5, *rays, ugrp, **kw)
        b = v5.traverse_kernel(t5, *rays, ugrp, **kw)
        torch.cuda.synchronize()
        assert torch.equal(a.t.view(torch.int32), b.t.view(torch.int32)), name
        assert torch.equal(a.best, b.best), name
        assert torch.equal(a.steps[:, 0], b.steps[:, 0]), name
        assert torch.equal(a.visits, b.visits), name


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2], int(sys.argv[3]))
