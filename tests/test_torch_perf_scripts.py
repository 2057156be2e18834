"""The port's perf scripts against the JAX package's (perf/sort_tax.py,
perf/compaction.py, perf/profile_steps.py, perf/bigscene.py,
perf/obb_hair.py), on the CPU at small sizes.

- sort_tax: every variant on 4,096 rows against its JAX namesake
  (``jax.lax.sort``, ``jnp.argsort``, the bucket ranks), in-process: the
  rows equal.
- compaction, profile_steps, bigscene: the scripts' ``main`` on small
  spheres (``sphere_mesh(8, 16)``, bigscene's block-ordered 16 x 16) at
  4,096 rays; each script's sphere bit-equal to the JAX script's, the
  hits against the JAX package's ``intersect`` on the same rays
  (in-process, its jnp engine on the CPU): equal hit masks, t within 1e-4
  relative (``ROADMAP.md``'s bar: the engines differ in FMA and in
  near-tie prims); the scripts' own invariants (live lanes' t bit-equal
  to the all-live run's; visits summed over blocks equal the per-ray
  visits, sorted and unsorted totals equal; no stack overflow).
- obb_hair: a hair scene of 256 flat Bezier strands written by
  ``chip_smoke.write_hair_scene`` (``utils/ply.write_xml`` and an .ecs),
  measured by the port and by the JAX tool's ``measure`` in a reference
  subprocess at 32 x 32: equal steps with the tier on and off, equal
  tier states, hits equal in both; a scene that fails is recorded and the
  run goes on.
"""
import functools
import importlib.util
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import embree_tpu_torch as pt
from embree_tpu_torch.perf import (bigscene, compaction, obb_hair,
                                   profile_steps, sort_tax)
from embree_tpu_torch.tools.viewer import sphere_mesh
from test_torch_round import one_thread  # noqa: F401 (module-wide autouse)
import torch_jaxref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 4096
RAYS = 4096
MESH = (8, 16)
HAIR_STRANDS = 256
HAIR_SIZE = 32


def jax_script(name):
    """A JAX perf script as a module (its top level only imports)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_perf_{name}", os.path.join(ROOT, "perf", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# sort_tax
# ---------------------------------------------------------------------------

def jax_variants(n):
    """perf/sort_tax.py's variants (defined inside its main) on n rows."""
    import jax
    import jax.numpy as jnp
    idx0 = jnp.arange(n, dtype=jnp.int32)

    def full_sort(key, *ops):
        return jax.lax.sort((key,) + ops + (idx0,), num_keys=1)

    def sort2_take(key, *ops):
        _, perm = jax.lax.sort((key, idx0), num_keys=1)
        return [o[perm] for o in ops]

    def sort2_rowgather(key, *ops):
        _, perm = jax.lax.sort((key, idx0), num_keys=1)
        return jnp.stack(ops, axis=-1)[perm]

    def argsort_rowgather(key, *ops):
        return jnp.stack(ops, axis=-1)[jnp.argsort(key)]

    def bucket_perm(key, *ops):
        b = key >> 26
        onehot = (b[:, None] == jnp.arange(16)[None, :]).astype(jnp.int32)
        within = jnp.cumsum(onehot, axis=0) - onehot
        counts = jnp.sum(onehot, axis=0)
        start = jnp.concatenate([jnp.zeros(1, jnp.int32),
                                 jnp.cumsum(counts)[:-1].astype(jnp.int32)])
        pos = jnp.sum(onehot * (start[None, :] + within), axis=1)
        inv = jnp.zeros(n, jnp.int32).at[pos].set(idx0)
        return jnp.stack(ops, axis=-1)[inv]

    def full_sort8(key, *ops):
        return full_sort((key >> 22).astype(jnp.int32), *ops)

    def sort2_scatter(key, *ops):
        _, perm = jax.lax.sort((key, idx0), num_keys=1)
        m = jnp.stack(ops, axis=-1)
        return jnp.zeros_like(m).at[perm].set(m)

    return {"a": full_sort, "b": sort2_take, "c": sort2_rowgather,
            "d": argsort_rowgather, "e": bucket_perm, "f": full_sort8,
            "g": sort2_scatter}


@pytest.mark.parametrize("name", sorted(sort_tax.VARIANTS))
def test_sort_tax_variant_matches_jax(name):
    import jax.numpy as jnp
    key, ops = sort_tax.inputs(ROWS, "cpu")
    got = sort_tax.VARIANTS[name](key, ops)
    want = jax_variants(ROWS)[name](jnp.asarray(key.numpy()),
                                    *(jnp.asarray(o.numpy()) for o in ops))
    got = got if isinstance(got, list) else [got]
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        assert g.numpy().tobytes() == w.tobytes(), name


def test_sort_tax_main_rows(capsys):
    out = sort_tax.main(["--cpu", "--rays", str(ROWS)])
    assert sorted(out) == sorted(sort_tax.VARIANTS)
    assert all(ms > 0 for ms, _ in out.values())
    text = capsys.readouterr().out
    assert all(sort_tax.LABELS[k] in text for k in out)


# ---------------------------------------------------------------------------
# compaction, profile_steps, bigscene
# ---------------------------------------------------------------------------

def rays_of(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32), rng)


@functools.lru_cache(maxsize=None)
def _jax_scene(mesh, block_order):
    import jax.numpy as jnp
    import embree_tpu as et
    verts, idx = (bigscene.sphere_mesh(*mesh) if block_order
                  else sphere_mesh(*mesh))
    s = et.Scene()
    s.attach(et.TriangleGeometry(jnp.asarray(verts), jnp.asarray(idx)))
    return s.commit()


@functools.lru_cache(maxsize=None)
def _jax_intersect():
    import jax
    import embree_tpu as et
    return jax.jit(lambda c, r: et.intersect(c, r, differentiable=False).t)


def jax_t(org, d, tfar=None, mesh=MESH, block_order=False):
    """t of the JAX package's intersect(differentiable=False) on the CPU,
    on a sphere of the viewer's (or bigscene's block) index order; one
    commit per sphere and one jitted function for all."""
    import jax.numpy as jnp
    import embree_tpu as et
    tfar = np.full(len(org), np.inf, np.float32) if tfar is None else tfar
    rays = et.make_rays(jnp.asarray(org), jnp.asarray(d),
                        tfar=jnp.asarray(tfar))
    return np.asarray(_jax_intersect()(_jax_scene(mesh, block_order), rays))


def same_hits(t, ref):
    t = np.asarray(t)
    hit = np.isfinite(t)
    np.testing.assert_array_equal(hit, np.isfinite(ref))
    assert hit.any() and not hit.all()
    np.testing.assert_allclose(t[hit], ref[hit], rtol=1e-4)


def test_profile_steps_sphere_matches_jax():
    for a, b in zip(sphere_mesh(*MESH), jax_script(
            "profile_steps").sphere_mesh(*MESH)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_compaction_matches_jax(capsys):
    out = compaction.main(["--cpu", "--rays", str(RAYS), "--mesh",
                           ",".join(map(str, MESH))])
    assert sorted(out) == sorted(compaction.FRACTIONS)
    assert len(lines := capsys.readouterr().out.splitlines()) == 4
    assert lines[0].startswith("dead=0%:") and "(ideal 0.10)" in lines[3]
    org, d, _ = rays_of(RAYS)
    t0 = out[0.0]["t"]
    for frac, r in out.items():
        live = ~r["dead"]
        assert 0 < int(r["dead"].sum()) < RAYS or frac == 0.0
        assert torch.equal(r["t"][live].view(torch.int32),
                           t0[live].view(torch.int32))
        assert not torch.isfinite(r["t"][r["dead"]]).any()
    # the all-live run against the JAX package; the 90% run's tfar too
    same_hits(t0, jax_t(org, d))
    r = out[0.9]
    tfar = np.where(r["dead"].numpy(), np.float32(-1), np.float32(np.inf))
    same_hits(r["t"], jax_t(org, d, tfar))


def test_profile_steps_matches_jax(capsys):
    out = profile_steps.main(["--cpu", "--rays", str(RAYS), "--mesh",
                              ",".join(map(str, MESH))])
    text = capsys.readouterr().out
    assert "visits/block" in text and "unsorted visits/block" in text
    res = out["result"]
    per_ray = res.visits.sum(0, dtype=torch.int64)
    assert int(out["blocks"].sum()) == int(per_ray.sum()) \
        == out["sorted"]["total"] == out["unsorted"]["total"]
    assert out["blocks"].shape[0] == -(-RAYS // profile_steps.BLOCK)
    assert out["overflow"] == 0 and (per_ray >= 1).all()
    # the sorted run's hits against the JAX package on the same rays
    org, d = (x.numpy() for x in out["inputs"][:2])
    t = torch.where(res.best >= 0, res.t, float("inf"))
    same_hits(t, jax_t(org, d))


def test_block_sums():
    v = torch.arange(10, dtype=torch.int32).reshape(2, 5)
    assert profile_steps.block_sums(v, 2).tolist() == [5 + 7, 9 + 11, 13]


def test_bigscene_matches_jax(capsys):
    n_theta, n_phi = 16, 16
    want = jax_script("bigscene").sphere_mesh(n_theta, n_phi)
    verts, idx = bigscene.sphere_mesh(n_theta, n_phi)
    for a, b in zip((verts, idx), want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # block order: all (a, b, d) first, unlike the viewer's interleave
    assert not np.array_equal(idx, sphere_mesh(n_theta, n_phi)[1])
    out = bigscene.main([str(n_theta), str(n_phi), str(RAYS), "--cpu"])
    text = capsys.readouterr().out
    assert f"tris={len(idx):,}" in text and "Mrays/s" in text
    assert out["overflow"] == 0 and out["visits_mean"] > 1
    assert out["node_mib"] > 0 and out["leaf_mib"] > 0
    org, d, _ = rays_of(RAYS)
    ref = jax_t(org, d, mesh=(n_theta, n_phi), block_order=True)
    assert out["hit_rate"] == float(np.isfinite(ref).mean()) > 0


# ---------------------------------------------------------------------------
# obb_hair
# ---------------------------------------------------------------------------

def _jax_reference(ecs, out_path):
    import jax
    jax.config.update("jax_platforms", "cpu")
    g = runpy.run_path(os.path.join(ROOT, "perf", "obb_hair.py"),
                       run_name="jax_obb_hair")
    with open(out_path, "w") as f:
        json.dump(g["measure"](ecs, HAIR_SIZE), f)


@pytest.fixture(scope="module")
def hair(tmp_path_factory):
    d = tmp_path_factory.mktemp("hair")
    ecs = chip_smoke.write_hair_scene(pt, str(d), HAIR_STRANDS, kind="flat")
    out = d / "jax.json"
    torch_jaxref.run([torch_jaxref.script(__file__, ecs, out)],
                     torch_jaxref.shared_dir(tmp_path_factory),
                     torch_jaxref.env())
    return ecs, json.loads(out.read_text())


def test_obb_hair_matches_jax(hair):
    ecs, want = hair
    got = obb_hair.measure(ecs, HAIR_SIZE, "cpu")
    keys = ("steps_on", "steps_off", "tier_active_on", "tier_active_off",
            "hits_equal", "step_reduction")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["hits_equal"] and got["tier_active_on"]
    assert got["steps_on"] < got["steps_off"]
    assert os.environ.get(obb_hair.ENV) is None


def test_obb_hair_main_records_errors(hair, tmp_path, capsys):
    ecs, _ = hair
    out = tmp_path / "obb.json"
    res = obb_hair.main(["--cpu", "--size", "8", "--scenes", ecs,
                         str(tmp_path / "missing.ecs"), "--out", str(out)])
    assert "error" in res["missing"] and "error" not in res["hair"]
    assert json.loads(out.read_text())["_meta"] == dict(
        size=8, platform="cpu", device="cpu")
    assert "wrote" in capsys.readouterr().out
    # the default scenes: the JAX tool's four, under --reference
    res = obb_hair.main(["--cpu", "--reference", str(tmp_path), "--out",
                         str(out)])
    assert sorted(k for k in res if k != "_meta") == sorted(
        os.path.basename(s)[:-4] for s in obb_hair.SCENES)
    assert all("error" in res[k] for k in res if k != "_meta")


if __name__ == "__main__":
    _jax_reference(*sys.argv[1:3])
