"""The loop-probe kernels (``csrc/micro_ops.cu``, ``csrc/micro_expand.cu``,
``csrc/micro_v8.cu``) through their g++ twin (``csrc/micro_cpu.cpp``).

Each probe's kernel is written once against ``micro.cuh``'s block: the
twin runs the same passes over every thread of the block in turn, each
warp's reductions in lockstep, so it computes what the card computes from
the same layouts, tables and carried copies. Here it is held bit for bit
against the plain versions (the probe bodies of ``perf/micro_*.py``, which
``test_torch_micro.py`` holds against the JAX harnesses):

- all 45 probes of the three units, and micro_expand's row-min form of
  the masked min, on the harness's x and on ``micro.distinct_x``, at 64
  and 67 iterations (and at 0 and 1);
- the algebra the kernels rely on: the 19-exchange network sorts all 256
  0/1 vectors of 8 and random int32 blocks; the key + ref probes equal the
  sorted keys plus ``key ^ 12345`` where keys repeat; each thread's copy
  of acc[0, 0] equals the plain loop's acc[0, 0] at every iteration (the
  dynamic slices of micro_ops and micro_v8); the merge taken lane by lane,
  gathered rows where the lane's bit is set and x[72:144] elsewhere,
  equals the plain merge; micro_expand's masked min and select, run in
  stretches between the iterations at which a word's x + it crosses the
  probe's threshold, equal the plain loop at every iteration on rows whose
  words cross it, wrap past INT_MAX, lie near INT_MIN, or never cross.

No JAX runs here. On the card, ``tests/test_torch_micro.py -m cuda`` and
``chip_smoke.py`` phase 19 hold the kernels themselves against the plain
versions.
"""
import shutil

import numpy as np
import pytest
import torch

from embree_tpu_torch.perf import micro, micro_expand, micro_ops, micro_v8

MODULES = {"micro_ops": micro_ops, "micro_expand": micro_expand,
           "micro_v8": micro_v8}


def _kernels(mod):
    """A unit's probes and the other forms its kernel runs."""
    return mod.PROBES + getattr(mod, "FORMS", ())


INPUTS = ("harness", "distinct")
ITERS = (0, 1, 64, 67)
CASES = [(unit, p.name, inp, n) for unit, mod in MODULES.items()
         for p in _kernels(mod) for inp in INPUTS for n in ITERS]
# (unit, probe, rows a start step, start mask, the slice's lane gathered
# at acc[0, l] & 127, or read at lane l)
SLICES = (("micro_ops", "scalar-extract + dyn-slice (32,128) load", 32, 15,
           False),
          ("micro_v8", "dynslice (72,128) + lane gather", 72, 3, True),
          ("micro_v8", "dynslice (32,128) + lane gather", 32, 7, True))


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


def _x(unit, inp):
    h = MODULES[unit].HARNESS
    return micro.harness_x(h) if inp == "harness" else micro.distinct_x(h)


@pytest.fixture(scope="module")
def plain():
    """Every probe's plain tile at each of ITERS on both inputs, from one
    run of the plain loop per probe and input."""
    out = {}
    for unit, mod in MODULES.items():
        h = mod.HARNESS
        for inp in INPUTS:
            x = _x(unit, inp)
            for p in _kernels(mod):
                acc = x[0:h.rows_acc].clone()
                for it in range(max(ITERS) + 1):
                    if it in ITERS:
                        out[(unit, p.name, inp, it)] = acc
                    if it < max(ITERS):
                        acc = p.body(acc, it, x)
    return out


def _probe(unit, name):
    return micro.find(_kernels(MODULES[unit]), name)


@pytest.mark.parametrize("unit,name,inp,iters", CASES,
                         ids=[f"{u}:{n}:{i}:{k}" for u, n, i, k in CASES])
def test_twin_matches_plain(gxx, plain, unit, name, inp, iters):
    """The twin's tile equals the plain version's, every int32 bit."""
    h = MODULES[unit].HARNESS
    got = micro.twin(h, _probe(unit, name), _x(unit, inp), iters)
    np.testing.assert_array_equal(got.numpy(),
                                  plain[(unit, name, inp, iters)].numpy())


def test_twin_refuses_bad_input(gxx):
    h = micro_v8.HARNESS
    p = micro_v8.PROBES[0]
    with pytest.raises(ValueError, match="int32"):
        micro.twin(h, p, micro.harness_x(h)[0:256], 4)
    with pytest.raises(ValueError, match="int32"):
        micro.twin(h, p, micro.harness_x(h).float(), 4)


# ---------------------------------------------------------------------------
# the algebra the redesign relies on
# ---------------------------------------------------------------------------

def _blocks_x(blocks):
    """A micro_v8 x whose tile (rows 0-127) holds ``blocks``, (2048, 8):
    block 128 u + l is lane l of rows 8u .. 8u + 7; rows 128-511 random."""
    h = micro_v8.HARNESS
    x = micro.distinct_x(h).clone()
    tile = torch.from_numpy(blocks.astype(np.int32)).view(16, 128, 8)
    x[0:128] = tile.permute(0, 2, 1).reshape(128, 128)
    return x


def test_sort_network_sorts_all_01_vectors_and_random_blocks(gxx):
    """One iteration of the key-only probe is each 8-row block sorted,
    plus 1: on every 0/1 vector of 8 (and its complement order) and on
    random int32 blocks with the extremes."""
    rng = np.random.default_rng(11)
    ones = ((np.arange(256)[:, None] >> np.arange(8)) & 1)
    blocks = np.concatenate([ones, ones[::-1, ::-1],
                             rng.integers(-2 ** 31, 2 ** 31, (1528, 8)),
                             np.full((4, 8), -2 ** 31),
                             np.full((4, 8), 2 ** 31 - 1)])
    blocks[-6] = [2 ** 31 - 1, -2 ** 31, 0, -1, 1, 2 ** 31 - 1, -2 ** 31, 5]
    assert blocks.shape == (2048, 8)
    x = _blocks_x(blocks)
    want = (np.sort(blocks, axis=1) + 1).astype(np.int32)   # wraps
    for name in ("tile-parallel bitonic6 gather-form key-only (128,128)",
                 "tile-parallel bitonic6 roll-form key-only (128,128)"):
        got = micro.twin(micro_v8.HARNESS, _probe("micro_v8", name), x, 1)
        got = got.view(16, 8, 128).permute(0, 2, 1).reshape(2048, 8)
        np.testing.assert_array_equal(got.numpy(), want)


def test_key_ref_is_sorted_keys_plus_xor(gxx):
    """Where keys repeat, the harness's network (one-sided tie rule) leaves
    each ref equal to its key ^ 12345: the probe's output is the sorted
    keys plus their xor, which is what the kernel computes."""
    rng = np.random.default_rng(12)
    for hi in (2, 5, 2 ** 31):
        keys = rng.integers(-hi, hi, (2048, 8))
        x = _blocks_x(keys)
        acc = x[0:128]
        k, r = micro_v8.bitonic_pairs(acc, acc ^ 12345)
        np.testing.assert_array_equal(r.numpy(), (k ^ 12345).numpy())
        s = np.sort(keys.astype(np.int32), axis=1)
        want = (s.astype(np.int64) + (s ^ 12345)).astype(np.int32)
        for name in ("tile-parallel bitonic6 gather-form key+ref (128,128)",
                     "per-group bitonic6 x16 key+ref (8,128) [v7 style]"):
            got = micro.twin(micro_v8.HARNESS, _probe("micro_v8", name), x, 1)
            got = got.view(16, 8, 128).permute(0, 2, 1).reshape(2048, 8)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("unit,name,span,mask,gather", SLICES,
                         ids=[f"{s[0]}:{s[1]}" for s in SLICES])
@pytest.mark.parametrize("inp", INPUTS)
def test_slice_start_recurrence(gxx, unit, name, span, mask, gather, inp):
    """acc[0, 0] evolves on its own, z' = z + x[span (z & mask), z & 127]
    (lane 0 where the slice is not gathered): that recurrence, and every
    thread's copy of it in the twin, equal the plain loop's acc[0, 0] after
    each of 0 .. 40 iterations."""
    mod = MODULES[unit]
    h = mod.HARNESS
    p = _probe(unit, name)
    x = _x(unit, inp)
    acc = x[0:h.rows_acc].clone()
    z = int(x[0, 0])
    block = 128
    for it in range(41):
        assert z == int(acc[0, 0]), it
        aux = torch.full((block,), 0x7FC0DEAD, dtype=torch.int32)
        micro.twin(h, p, x, it, aux)
        assert bool((aux == acc[0, 0]).all()), it
        z = int(micro.add(torch.tensor(z),
                          x[span * (z & mask), z & 127 if gather else 0]))
        acc = p.body(acc, it, x)


@pytest.mark.parametrize("inp", INPUTS)
def test_merge_lane_split(inp):
    """merge72 taken lane by lane, as the kernel branches: lanes whose bit
    (acc[0] & 1) is set add x[0:72] gathered at acc[0] & 127, the others
    their x[72:144], tile rows 72-127 repeating rows 0-55; each iteration
    equals the plain merge's."""
    x = _x("micro_v8", inp)
    acc = x[0:128].clone()
    for it in range(24):
        want = micro_v8.merge72(acc, it, x)
        got = acc.clone()
        for lane in range(128):
            a0 = int(acc[0, lane])
            if a0 & 1:
                col = x[0:72, a0 & 127]
            else:
                col = x[72:144, lane]
            col = torch.cat([col, col[0:56]])
            got[:, lane] = micro.add(acc[:, lane], col)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        acc = want


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", list(micro_expand.CROSSINGS))
def test_crossing_probes_every_iteration(gxx, name, seed):
    """The masked min's and the select's kernels re-derive their operand
    only at the iterations where a word's x + it crosses the threshold T
    (0, 32): on rows whose words cross it, wrap past INT_MAX, lie near
    INT_MIN or never cross (``micro_expand.edge_x``), the twin's tile
    equals the plain loop's after each of the first 140 iterations."""
    h = micro_expand.HARNESS
    p = _probe("micro_expand", name)
    n = 140
    x = micro_expand.edge_x(micro_expand.CROSSINGS[name], n, 30 + seed)
    acc = x[0:8].clone()
    for it in range(n + 1):
        np.testing.assert_array_equal(micro.twin(h, p, x, it).numpy(),
                                      acc.numpy(), err_msg=f"iteration {it}")
        acc = p.body(acc, it, x)


def test_expand_wavefront_count():
    """micro_expand's gathers read x[0:8] transposed at 12 words an index:
    8 consecutive indices (the harness's x) meet 8 bank quads, so no
    conflict; random rows conflict, yet less than row-major x or a
    transposed copy at 8 words would."""
    h = micro_expand.HARNESS
    for name in micro_expand.GATHERS:
        wf, free = micro_expand.gather_wavefronts(name, micro.harness_x(h),
                                                  300)
        assert wf == free == (32 if name == micro_expand.GATHERS[0]
                              else 512), name
        x = micro.distinct_x(h)
        wf, free = micro_expand.gather_wavefronts(name, x, 100)
        assert wf > free, name
        g = 1 if name == micro_expand.GATHERS[0] else 16
        idx = (x[0:g].numpy().astype(np.int64)[None]
               + np.arange(100)[:, None, None]) & 127
        idx = idx.reshape(-1, 128)
        row_major = micro.busiest(idx, 32, np.arange(128) % 32) * 8 / 100
        stride8 = micro.busiest(idx, 8, np.arange(128) % 4) * 2 / 100
        assert wf < row_major and wf < stride8, name


def test_wavefront_count():
    """A warp's 4-byte reads take one wavefront per distinct word in its
    busiest bank: 32 lanes over 32 banks, or all on one word, take one;
    four words in one bank take four; the harness's x leaves micro_v8's
    lane gathers all but conflict-free, distinct rows do not."""
    lanes = np.arange(128)
    bank = lanes % 32
    assert micro.busiest(lanes[None], 32, bank) == 4
    assert micro.busiest(np.zeros((1, 128), np.int64), 32, bank) == 4
    assert micro.busiest(((lanes % 4) * 32)[None], 32, bank) == 16
    h = micro_v8.HARNESS
    for name in micro_v8.GATHERS:
        wf, free = micro_v8.gather_wavefronts(name, micro.harness_x(h), 2000)
        assert free <= wf <= 1.02 * free, name
        wf, free = micro_v8.gather_wavefronts(name, micro.distinct_x(h), 200)
        assert wf > free, name

