"""The three loop probes (perf/micro_ops.py, perf/micro_expand.py,
perf/micro_v8.py): the port's plain versions against the JAX harnesses.

1. The harnesses' own ``main()``, unmodified, run in three subprocesses
   started together, with ``pl.pallas_call`` patched to ``interpret=True``,
   each module's ``ITERS`` set to 64 and ``XLA_FLAGS=--xla_cpu_max_isa=AVX``
   (no FMA contraction, as in test_torch_ablate.py). Each runs ``main()``
   twice: once as is, and once with the argument of the call the harness
   times replaced by ``micro.distinct_x``, random int32 rows of the same
   shape (the harnesses' own x is the lane index in every row, so a port
   that reads the wrong row would still agree with them on it). The
   subprocess records each call's output under the name the harness prints
   after it, and fails on a ``FAILED`` line or on another count of probes
   than 14 / 12 / 19.
2. Every plain version equals its harness bit for bit (int32, tolerance 0)
   on both inputs at 64 iterations: 45 probes x 2 inputs.
3. Small semantic cases against jnp: the saturating float -> int32
   conversion, int32 wrap-around of *, ``pltpu.repeat``'s tile order and
   ``pltpu.roll``'s direction, and the bitonic networks' one-sided tie rule.
4. What runs without a card: the probe ids of the CUDA sources match
   ``PROBES``, the launcher refuses a CPU tensor, and ``main`` runs the
   plain versions with ``--device cpu``.

The card-only test at the end imports no JAX: run it on the card with
``python -m pytest --noconftest tests/test_torch_micro.py -m cuda``.
"""
import os
import re
import sys

import numpy as np
import pytest
import torch
import torch_jaxref

from embree_tpu_torch.perf import device, micro
from embree_tpu_torch.perf import micro_expand, micro_ops, micro_v8

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ITERS = 64
MODULES = {"micro_ops": micro_ops, "micro_expand": micro_expand,
           "micro_v8": micro_v8}
COUNTS = {"micro_ops": 14, "micro_expand": 12, "micro_v8": 19}
INPUTS = ("harness", "distinct")
CASES = [(unit, p.name, inp) for unit, mod in MODULES.items()
         for p in mod.PROBES for inp in INPUTS]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one CPU thread (see
    test_torch_round.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the JAX side (three subprocesses)
# ---------------------------------------------------------------------------

def _jax_reference(unit, x_path, out_path):
    """Run perf/<unit>.py's main() twice in interpret mode at ITERS
    iterations and save each probe's output by printed name."""
    import builtins
    import importlib

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    pallas_call = pl.pallas_call

    def interpret(*a, **k):
        return pallas_call(*a, **dict(k, interpret=True))

    pl.pallas_call = interpret
    mod = importlib.import_module(f"perf.{unit}")
    mod.ITERS = ITERS
    replacement = {"x": None}
    outs, names, results, failed = [], [], {}, []

    class Jax:
        """The module's ``jax``, whose ``jit`` records every output of the
        call the harness times (and feeds it the replacement x)."""

        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def jit(fn, *a, **k):
            f = jax.jit(fn, *a, **k)

            def call(x):
                if replacement["x"] is not None:
                    assert replacement["x"].shape == x.shape
                    x = jnp.asarray(replacement["x"])
                out = f(x)
                outs.append(np.asarray(out))
                return out
            return call

    def record(*args, **kw):
        text = " ".join(str(a) for a in args)
        builtins.print(text, **kw)
        if "FAILED" in text:
            failed.append(text)
            return
        m = re.match(r"^(.*?)\s+\S+ ns/iter$", text)
        assert m, text
        assert outs, f"{text}: no output recorded"
        for o in outs[1:]:
            assert np.array_equal(o, outs[0]), f"{text}: calls differ"
        names.append(m.group(1))
        results[f"{tag}|{m.group(1)}"] = outs[0]
        outs.clear()

    mod.jax = Jax()
    mod.print = record
    x_distinct = np.load(x_path)
    for tag, x in (("harness", None), ("distinct", x_distinct)):
        replacement["x"] = x
        names.clear()
        mod.main()
        assert not failed, failed
        assert len(names) == COUNTS[unit], (unit, names)
        assert len(set(names)) == len(names), names
    np.savez(out_path, keys=np.array(list(results)),
             **{f"a{k}": v for k, v in enumerate(results.values())})


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jaxref_micro")
    shared = torch_jaxref.shared_dir(tmp_path_factory)
    env = torch_jaxref.env("--xla_cpu_max_isa=AVX")
    cmds, paths = [], {}
    for unit, mod in MODULES.items():
        x_path = str(out / f"x_{unit}.npy")
        np.save(x_path, micro.distinct_x(mod.HARNESS).numpy())
        paths[unit] = str(out / f"ref_{unit}.npz")
        cmds.append(torch_jaxref.script(__file__, unit, x_path, paths[unit]))
    torch_jaxref.run(cmds, shared, env, timeout=600)
    ref = {}
    for unit, path in paths.items():
        d = np.load(path)
        for k, key in enumerate(d["keys"]):
            ref[f"{unit}|{key}"] = d[f"a{k}"]
    return ref


def _x(unit, inp):
    h = MODULES[unit].HARNESS
    return micro.harness_x(h) if inp == "harness" else micro.distinct_x(h)


# ---------------------------------------------------------------------------
# 2. plain versions == the harnesses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("unit,name,inp", CASES,
                         ids=[f"{u}:{n}:{i}" for u, n, i in CASES])
def test_plain_matches_harness(jax_ref, unit, name, inp):
    """The plain version's tile after 64 iterations equals the harness's,
    every int32 bit."""
    key = f"{unit}|{inp}|{name}"
    assert key in jax_ref, f"the harness printed no line {name!r}"
    ref = jax_ref[key]
    got = MODULES[unit].run(name, _x(unit, inp), ITERS)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_distinct_rows_differ():
    """The second input has distinct rows (the harnesses' has one row
    repeated), and both have the harnesses' shapes."""
    for unit, mod in MODULES.items():
        h = mod.HARNESS
        a, b = micro.harness_x(h), micro.distinct_x(h)
        assert a.shape == b.shape == (h.rows_in, 128)
        assert bool((a == a[0:1]).all())
        assert len({tuple(r) for r in b.tolist()}) == h.rows_in


# ---------------------------------------------------------------------------
# 3. semantics against jnp
# ---------------------------------------------------------------------------

def test_float_to_int_saturates_like_xla():
    """XLA's f32 -> s32 saturates and maps NaN to 0; micro.f2i does too,
    where torch's own cast does not."""
    import jax.numpy as jnp
    v = np.array([3e9, -3e9, np.nan, np.inf, -np.inf, 2.5, -2.5,
                  2147483520.0, -2147483648.0, 0.0, -0.0], np.float32)
    want = np.asarray(jnp.asarray(v).astype(jnp.int32))
    np.testing.assert_array_equal(micro.f2i(torch.from_numpy(v)).numpy(),
                                  want)
    assert want[0] == 2 ** 31 - 1 and want[1] == -2 ** 31 and want[2] == 0


def test_int32_products_and_sums_wrap_like_xla():
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    a = rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=np.int32)
    b = rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=np.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_array_equal(micro.mul(ta, tb).numpy(),
                                  np.asarray(ja * jb))
    np.testing.assert_array_equal(micro.add(ta, tb).numpy(),
                                  np.asarray(ja + jb))
    np.testing.assert_array_equal(micro.sub(ta, tb).numpy(),
                                  np.asarray(ja - jb))
    np.testing.assert_array_equal(micro.mul(ta, 3).numpy(),
                                  np.asarray(ja * 3))
    np.testing.assert_array_equal((ta >> 2).numpy(), np.asarray(ja >> 2))


def test_repeat_tiles_and_roll_direction():
    """In interpret mode ``pltpu.repeat(x, 8, 0)`` tiles the rows (row r is
    x[r % 16]) and ``pltpu.roll(x, 1, 0)`` moves row r - 1 to row r: the
    port's tile_rows and torch.roll give the same."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    def kernel(x_ref, rep_ref, roll_ref):
        rep_ref[...] = pltpu.repeat(x_ref[...], 8, 0)
        roll_ref[...] = pltpu.roll(x_ref[...], shift=1, axis=0)

    x = np.random.default_rng(2).integers(-1000, 1000, (16, 128),
                                          dtype=np.int32)
    rep, rolled = pl.pallas_call(
        kernel, out_shape=(jax.ShapeDtypeStruct((128, 128), jnp.int32),
                           jax.ShapeDtypeStruct((16, 128), jnp.int32)),
        interpret=True)(jnp.asarray(x))
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(micro.tile_rows(tx, 8).numpy(),
                                  np.asarray(rep))
    np.testing.assert_array_equal(torch.roll(tx, 1, 0).numpy(),
                                  np.asarray(rolled))
    # not the row-repeating expand: rows 0-7 are x's rows 0-7
    assert not np.array_equal(np.asarray(rep)[1], x[0])


def _jnp_bitonic(key, ref):
    """micro_v8.py:171-183's stages on an (8, n) block, in jnp."""
    import jax.numpy as jnp
    rowall = jnp.arange(8, dtype=jnp.int32)[:, None] + jnp.zeros(
        key.shape, jnp.int32)
    rc = rowall & 7
    for k, j in micro_v8.STAGES:
        perm = rowall ^ j
        key_p = jnp.take_along_axis(key, perm, axis=0)
        ref_p = jnp.take_along_axis(ref, perm, axis=0)
        keepmin = ((rc & k) == 0) == ((rc & j) == 0)
        swap = (key_p < key) == keepmin
        key = jnp.where(swap, key_p, key)
        ref = jnp.where(swap, ref_p, ref)
    return key, ref


def test_bitonic_keeps_the_one_sided_tie_rule():
    """With equal keys, one row of each pair takes its partner's ref:
    ``bitonic_pairs`` gives the harness's refs (duplicates included), not
    a textbook compare-exchange's (a permutation); and the probe's own key
    + ref network equals jnp's, per tile and per group."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 3, (128, 128), dtype=np.int32)   # many ties
    refs = rng.integers(-1000, 1000, (128, 128), dtype=np.int32)
    k, r = micro_v8.bitonic_pairs(torch.from_numpy(keys),
                                  torch.from_numpy(refs))
    for u in range(16):
        rows = slice(8 * u, 8 * u + 8)
        jk, jr = _jnp_bitonic(jnp.asarray(keys[rows]),
                              jnp.asarray(refs[rows]))
        np.testing.assert_array_equal(k[rows].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(r[rows].numpy(), np.asarray(jr))
    np.testing.assert_array_equal(k.numpy(), np.sort(
        keys.reshape(16, 8, 128), axis=1).reshape(128, 128))
    # refs are duplicated: not a permutation of each block's refs
    same = [sorted(r[8 * u:8 * u + 8, c].tolist())
            == sorted(refs[8 * u:8 * u + 8, c].tolist())
            for u in range(16) for c in range(128)]
    assert not all(same)
    # the probe itself: ref = key ^ 12345 travels with its key
    acc = torch.from_numpy(keys)
    jk, jr = _jnp_bitonic(jnp.asarray(keys[0:8]),
                          jnp.asarray(keys[0:8] ^ 12345))
    want = np.asarray(jk) + np.asarray(jr)
    np.testing.assert_array_equal(
        micro_v8.bitonic_ref(acc, 0, None)[0:8].numpy(), want)
    np.testing.assert_array_equal(
        micro_v8.bitonic_group(acc, 0, None)[0:8].numpy(), want)


# ---------------------------------------------------------------------------
# 4. without a card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("unit", list(MODULES))
def test_kernel_probe_ids_match(unit):
    """The CUDA source's probe enum lists PROBES in order, and the ids are
    0, 1, ... in the harness's order."""
    mod = MODULES[unit]
    src = open(os.path.join(ROOT, "embree_tpu_torch", "csrc",
                            f"{unit}.cu")).read()
    body = re.search(r"enum : int \{(.*?)\};", src, re.S).group(1)
    ids = [w.strip() for w in body.split(",") if w.strip()]
    assert ids[-1] == "kProbes"
    assert len(ids) - 1 == len(mod.PROBES) == COUNTS[unit]
    assert [p.kid for p in mod.PROBES] == list(range(len(mod.PROBES)))
    assert re.search(rf'extern "C" int {unit}\(int probe', src)


def test_launch_refuses_cpu_and_bad_tensors():
    """The kernel's wrapper takes only the harness's int32 tile on a CUDA
    device: a CPU tensor, another dtype or shape raise before any
    launch."""
    h = micro_ops.HARNESS
    p = micro_ops.PROBES[0]
    x = micro.harness_x(h)
    with pytest.raises(ValueError, match="CUDA"):
        micro.launch(h, p, x, 4)
    with pytest.raises(ValueError, match="int32"):
        micro.launch(h, p, x.float(), 4)
    with pytest.raises(ValueError, match=r"\(512, 128\)"):
        micro.launch(h, p, x[0:256], 4)
    with pytest.raises(ValueError, match="contiguous"):
        micro.launch(h, p, x.t().contiguous().t(), 4)
    assert not any(k.startswith("micro_ops:") for k in device.LAUNCHES)


def test_main_runs_plain_versions(capsys):
    """``--device cpu --iters 2`` prints one line per probe in the
    harness's format."""
    for unit, mod in MODULES.items():
        assert mod.main(["--device", "cpu", "--iters", "2"]) == 0
        out = capsys.readouterr().out.splitlines()
        lines = [s for s in out if s.endswith("ns/iter")]
        assert [s[:mod.HARNESS.width].rstrip() for s in lines] == [
            p.name for p in mod.PROBES]


# ---------------------------------------------------------------------------
# card-only: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On an NVIDIA GPU: every probe's kernel equals its plain version bit
    for bit on both inputs at 64 iterations and at 67 (an 8-row roll taken
    a multiple of 8 times reads the same in either direction), and the
    wrapper raises for a CUDA tensor of the wrong shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    for unit, mod in MODULES.items():
        h = mod.HARNESS
        for x in (micro.harness_x(h, "cuda"), micro.distinct_x(h, "cuda")):
            for p in mod.PROBES:
                for iters in (ITERS, ITERS + 3):
                    got = micro.launch(h, p, x, iters)
                    want = micro.run_plain(p.body, x, iters, h.rows_acc)
                    assert torch.equal(got, want), f"{unit}: {p.name}"
        with pytest.raises(ValueError, match="must be"):
            micro.launch(h, mod.PROBES[0], torch.zeros(
                (h.rows_in + 8, 128), dtype=torch.int32, device="cuda"), 4)


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2], sys.argv[3])
