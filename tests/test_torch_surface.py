"""The port does all that embree_tpu does: its public surface against the
JAX package's.

1. Names. Every module of embree_tpu/ and of the port is parsed with
   ``ast`` (nothing of embree_tpu is imported for it): each public
   module-level ``def``/``class`` of the JAX package has a counterpart of
   the same name in the same module of the port, or stands on RENAMES with
   the port's name for it and one line of reason. The JAX package's tools,
   examples and perf scripts each have a counterpart in the port that
   defines ``main``; ``bench.py`` waits for the port's benchmark.
2. The helpers the port added last (core/math.py's vector, box and affine
   helpers, the ops' bounds, ``eval_curve_derivative``) against their jnp
   originals on seeded numpy inputs, in-process, each with its tolerance;
   ``native_available`` is true where g++ builds the native builder.
"""
import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "embree_tpu")
PORT_PKG = os.path.join(ROOT, "embree_tpu_torch")

# (JAX module, name) -> (port module, port name, why)
RENAMES = {
    ("accel/traverse_pallas.py", "traverse_packed"): (
        "accel/traverse.py", "traverse_packed",
        "the kernel's wrapper lives beside its CUDA launcher"),
    ("accel/traverse.py", "TraversalResult"): (
        "accel/traverse_generic.py", "TraversalResult",
        "the lockstep engine moved aside for the kernel's module"),
    ("accel/traverse.py", "slab_test"): (
        "accel/traverse_generic.py", "slab_test",
        "the lockstep engine moved aside for the kernel's module"),
    ("accel/traverse.py", "traverse"): (
        "accel/traverse_generic.py", "traverse",
        "the lockstep engine moved aside for the kernel's module"),
    ("accel/pack.py", "pack"): (
        "accel/pack.py", "pack_arrays",
        "packs host arrays; the scene-level entry is the commit"),
    ("accel/pack.py", "ltab_rows"): (
        "accel/pack.py", "leaf_words",
        "a leaf is a record of words on the card, not rows of a TPU tile"),
    ("parallel/mesh.py", "make_mesh"): (
        "parallel/render.py", "make_mesh",
        "the torch.distributed mesh lives with the sharded render"),
    ("parallel/mesh.py", "shard_rays"): (
        "parallel/render.py", "shard_rays",
        "the torch.distributed mesh lives with the sharded render"),
    ("parallel/mesh.py", "replicate"): (
        "parallel/render.py", "replicate",
        "the torch.distributed mesh lives with the sharded render"),
}
# scripts of the repository root and their state in the port
WAITING = {"bench.py": "the pre-port benchmark: the port's own benchmark "
                       "PR replaces it"}
SCRIPT_DIRS = ("examples", "perf", os.path.join("embree_tpu", "tools"))


def public_names(path):
    tree = ast.parse(open(path).read(), path)
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith("_")}


def jax_modules():
    out = []
    for d, _, files in os.walk(JAX_PKG):
        out += [os.path.relpath(os.path.join(d, f), JAX_PKG)
                for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("module", jax_modules())
def test_public_names_have_counterparts(module):
    names = public_names(os.path.join(JAX_PKG, module))
    port = os.path.join(PORT_PKG, module)
    have = public_names(port) if os.path.exists(port) else set()
    missing = []
    for name in sorted(names):
        if (module, name) in RENAMES:
            pmod, pname, why = RENAMES[module, name]
            assert why
            assert pname in public_names(os.path.join(PORT_PKG, pmod)), \
                f"{module}::{name} -> {pmod}::{pname} is not there"
        elif name not in have:
            missing.append(name)
    assert not missing, f"{module}: the port lacks {missing}"


def test_renames_name_real_jax_names():
    for (module, name) in RENAMES:
        assert name in public_names(os.path.join(JAX_PKG, module))


def scripts():
    out = []
    for d in SCRIPT_DIRS:
        out += [os.path.join(d, f) for f in sorted(os.listdir(
            os.path.join(ROOT, d))) if f.endswith(".py")
            and f != "__init__.py"]
    return out


@pytest.mark.parametrize("script", scripts())
def test_scripts_have_counterparts(script):
    rel = os.path.relpath(script, "embree_tpu")
    rel = script if rel.startswith("..") else rel
    port = os.path.join(PORT_PKG, rel)
    assert os.path.exists(port), f"{script}: no {port}"
    assert "main" in public_names(port), f"{port} defines no main"


def test_root_scripts_waiting():
    """The root's scripts of the JAX package that the port does not have
    are exactly the ones WAITING lists."""
    root = {f for f in os.listdir(ROOT) if f.endswith(".py")
            and "jax" in open(os.path.join(ROOT, f)).read()
            and f not in ("chip_smoke.py", "__graft_entry__.py")}
    assert root == set(WAITING)


# ---------------------------------------------------------------------------
# 2. the last helpers against their jnp originals
# ---------------------------------------------------------------------------

def _rng():
    return np.random.default_rng(7)


def _boxes(n=6):
    r = _rng()
    lo = r.normal(size=(n, 3)).astype(np.float32)
    return lo, lo + r.uniform(0.1, 2, (n, 3)).astype(np.float32)


def _affine(n=6, seed=7):
    r = np.random.default_rng(seed)
    m = r.normal(size=(n, 3, 4)).astype(np.float32)
    m[:, :, :3] += 2 * np.eye(3, dtype=np.float32)     # well conditioned
    return m


def _vec(n=6, seed=8):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


EXACT = dict(rtol=0, atol=0)
ARITH = dict(rtol=1e-6, atol=1e-6)      # a few roundings in another order
INVERSE = dict(rtol=1e-5, atol=1e-5)    # LAPACK's inverse against torch's
# central differences: XLA's CPU backend contracts the reference's products
# into FMA in this process (the port never does), and a last-bit difference
# of a value below 8 (ulp <= 1e-6) divided by 2 eps = 2e-4 moves the
# quotient by up to 5e-3
DERIV = dict(rtol=1e-3, atol=1e-2)


def _cases():
    lo, up = _boxes()
    p = _vec()
    a, b = _affine(), _affine(seed=9)
    cp = _rng().normal(size=(16, 4, 4)).astype(np.float32)
    t16 = _rng().uniform(size=16).astype(np.float32)
    verts = _vec(20, 3)
    tri = np.random.default_rng(4).integers(0, 20, (9, 3)).astype(np.int32)
    quad = np.random.default_rng(5).integers(0, 20, (9, 4)).astype(np.int32)
    r = _rng().uniform(0.1, 1, 6).astype(np.float32)
    r2 = _rng().uniform(0.1, 1, 6).astype(np.float32)
    return [
        ("core.math", "vec3", (p[:, 0], p[:, 1], p[:, 2]), EXACT),
        ("core.math", "length", (p,), ARITH),
        ("core.math", "sqr_length", (p,), ARITH),
        ("core.math", "aabb_empty", ((4, 2),), EXACT),
        ("core.math", "aabb_union", (lo, up, p, p + 1), EXACT),
        ("core.math", "aabb_extend_point", (lo, up, p), EXACT),
        ("core.math", "aabb_center", (lo, up), EXACT),
        ("core.math", "aabb_contains_point", (lo, up, 0.5 * (lo + up)),
         EXACT),
        ("core.math", "aabb_lerp", (lo, up, lo + 1, up + 2,
                                    _rng().uniform(size=6)
                                    .astype(np.float32)), ARITH),
        ("core.math", "affine_from_cols", (p, p + 1, p + 2, p + 3), EXACT),
        ("core.math", "affine_translate", (p[0],), EXACT),
        ("core.math", "affine_scale", (p[0],), EXACT),
        ("core.math", "affine_rotate", (p[1], np.float32(0.7)), ARITH),
        ("core.math", "affine_mul", (a, b), ARITH),
        ("core.math", "affine_inverse", (a,), INVERSE),
        ("core.math", "xfm_point", (a, p), ARITH),
        ("core.math", "xfm_vector", (a, p), ARITH),
        ("core.math", "xfm_normal", (a, p), INVERSE),
        ("core.math", "xfm_aabb", (a, lo, up), ARITH),
        ("ops.triangle", "triangle_bounds", (verts, tri), EXACT),
        ("ops.quad", "quad_bounds", (verts, quad), EXACT),
        ("ops.point", "point_bounds", (p, r), EXACT),
        ("ops.line", "line_bounds", (p, r, p[::-1].copy(), r2), EXACT),
        ("ops.curve", "eval_curve_derivative", ("bspline", cp, t16), DERIV),
    ]


CASES = _cases()


def _flat(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("case", CASES, ids=[c[1] for c in CASES])
def test_helper_matches_jnp(case):
    import importlib
    import jax.numpy as jnp
    module, name, args, tol = case
    jfn = getattr(importlib.import_module(f"embree_tpu.{module}"), name)
    tfn = getattr(importlib.import_module(f"embree_tpu_torch.{module}"),
                  name)

    def conv(x, lib):
        if isinstance(x, np.ndarray):
            return jnp.asarray(x) if lib == "jax" else torch.from_numpy(x)
        return x
    want = _flat(jfn(*(conv(x, "jax") for x in args)))
    got = _flat(tfn(*(conv(x, "torch") for x in args)))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        if tol is EXACT:
            assert g.tobytes() == w.tobytes(), f"{name}: not bit-equal"
        else:
            np.testing.assert_allclose(g, w, **tol)


def test_native_available():
    from embree_tpu_torch.native import native_available
    assert native_available() is True
