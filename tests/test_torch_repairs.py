"""Two repairs of the port, each held against the JAX package.

1. Moving normal derivatives do not make a scene move. The JAX merger
   drops the motion flag of a hermite curve's ``normal_derivatives``
   (``dn, dnb, _ = self._steps(...)``, embree_tpu/scene.py:628-630), so a
   scene whose only moving buffer they are stays static: ``has_motion`` is
   False and the oriented test reads the first step's normal spline at
   every ray time. The port's merger follows it.
2. ``intersect_brute`` always takes the round-line neighbor clip, as the
   JAX brute force does through ``_make_prim_test`` and ``_kind_test``
   (embree_tpu/scene.py:1369-1380, :1505-1528), also on scenes whose
   queries ride the kernel (a chain of thin round lines is packed).

The JAX side runs in this process: both checks hold the port to a
tolerance (t within 1e-4 relative), not to the bit.
"""
import numpy as np
import pytest
import torch

import embree_tpu_torch as pt

F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for this module's small torch ops (see
    test_torch_round.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import embree_tpu as et
    return jax, et


def _aimed_rays(targets, n, seed):
    """n rays from a shell of radius 2-3 around each target point in turn,
    aimed at it with a small jitter; times U(0, 1], none at 0."""
    rng = np.random.default_rng(seed)
    tgt = targets[np.arange(n) % len(targets)]
    v = rng.normal(size=(n, 3))
    org = tgt + v / np.linalg.norm(v, axis=1, keepdims=True) * \
        rng.uniform(2, 3, (n, 1))
    aim = tgt + rng.normal(0, 0.03, (n, 3))
    time = 1.0 - rng.uniform(0, 1, n)
    return (org.astype(F32), (aim - org).astype(F32), time.astype(F32))


def _hermite_geoms(et):
    """A hermite oriented strand: static vertices, tangents and normals;
    normal derivatives over 2 time steps, which differ a lot."""
    rng = np.random.default_rng(31)
    p = np.zeros((5, 4), F32)
    p[:, 0] = np.linspace(-1, 1, 5)
    p[:, 1] = 0.2 * rng.normal(size=5)
    p[:, 3] = 0.15
    tan = np.concatenate([np.tile([[0.5, 0, 0]], (5, 1)),
                          np.zeros((5, 1))], 1).astype(F32)
    nrm = rng.normal(size=(5, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(F32)
    dn = np.stack([np.zeros((5, 3)), 3.0 * rng.normal(size=(5, 3))]) \
        .astype(F32)
    return [et.CurveGeometry(p, np.arange(4, dtype=np.int32),
                             basis="hermite", kind="oriented", tangents=tan,
                             normals=nrm, normal_derivatives=dn)], p[:, :3]


def test_moving_normal_derivatives_stay_static():
    """Repair 1: the hermite oriented strand whose only moving buffer is
    its normal derivatives; rays at times in (0, 1]. Both packages commit
    a static scene (has_motion False), hit masks are equal and t agrees
    within 1e-4 relative."""
    jax, et = _jax()
    import jax.numpy as jnp
    scenes = []
    for pkg in (et, pt):
        geoms, pts = _hermite_geoms(pkg)
        s = pkg.Scene()
        for g in geoms:
            s.attach(g)
        scenes.append(s)
    cs_j = scenes[0].commit()
    cs_p = scenes[1].commit(device="cpu")
    assert not cs_j.has_motion and not cs_p.has_motion
    org, d, time = _aimed_rays(pts, 192, 5)
    hj = jax.jit(et.intersect)(cs_j, et.make_rays(
        jnp.asarray(org), jnp.asarray(d), time=jnp.asarray(time)))
    hp = pt.intersect(cs_p, pt.make_rays(org, d, time=time, device="cpu"))
    vj, vp = np.asarray(hj.valid), hp.valid.numpy()
    assert vj.sum() > 60
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_allclose(hp.t.numpy()[vj], np.asarray(hj.t)[vj],
                               rtol=1e-4)
    np.testing.assert_array_equal(hp.prim_id.numpy()[vj],
                                  np.asarray(hj.prim_id)[vj])


def _chain_geoms(et):
    """A zigzag chain of 12 thin round lines (radius 0.04-0.06, no fat
    joint, so the port and the JAX package both pack it for the kernel)."""
    rng = np.random.default_rng(32)
    v = np.zeros((13, 4), F32)
    v[:, 0] = np.linspace(-1.2, 1.2, 13)
    v[:, 1] = np.where(np.arange(13) % 2, 0.25, -0.25)
    v[:, 2] = 0.1 * rng.normal(size=13)
    v[:, 3] = rng.uniform(0.04, 0.06, 13)
    return et.LineSegmentsGeometry(v, np.arange(12, dtype=np.int32),
                                   kind="round"), v[:, :3]


def test_brute_force_clips_like_jax():
    """Repair 2: on the packed chain of thin round lines, rays aimed at
    the joints (into a neighbor's capped cone): the port's brute force
    equals the JAX package's, hit masks and prim ids equal, t within 1e-4
    relative."""
    jax, et = _jax()
    import jax.numpy as jnp
    gj, joints = _chain_geoms(et)
    gp, _ = _chain_geoms(pt)
    sj, sp = et.Scene(), pt.Scene()
    sj.attach(gj)
    sp.attach(gp)
    cs_j, cs_p = sj.commit(), sp.commit(device="cpu")
    assert cs_p.packed is not None
    org, d, _ = _aimed_rays(joints[1:-1], 256, 6)
    hj = jax.jit(et.intersect_brute)(cs_j, et.make_rays(
        jnp.asarray(org), jnp.asarray(d)))
    hp = pt.intersect_brute(cs_p, pt.make_rays(org, d, device="cpu"))
    vj = np.asarray(hj.valid)
    assert vj.sum() > 100
    np.testing.assert_array_equal(hp.valid.numpy(), vj)
    np.testing.assert_array_equal(hp.prim_id.numpy()[vj],
                                  np.asarray(hj.prim_id)[vj])
    np.testing.assert_allclose(hp.t.numpy()[vj], np.asarray(hj.t)[vj],
                               rtol=1e-4)
