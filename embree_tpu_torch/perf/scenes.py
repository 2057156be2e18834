"""The ablation harnesses' scene and rays (perf/kernel_ablate.py:341-372,
perf/ablate_v7.py:366-384).

The sphere is the bench scene, ``sphere_mesh(64, 128)``: 16,384 triangles
in the JAX package's index order (perf/profile_steps.py:17 and
perf/kernel_ablate.py:341 are the same function; the port's copy lives in
``tools/viewer.py``). The rays are the harnesses' 1,048,576 by default:
origins U(-2, 2)^3 and directions N(0, 1)^3 from numpy seed 0, sorted by
the traversal wrapper's coherence key, with tnear 0, tfar inf and mask -1.
"""
from __future__ import annotations

import numpy as np
import torch

from ..accel.traverse import _coherence_key
from ..tools import viewer

HARNESS_MESH = (64, 128)
HARNESS_RAYS = 1 << 20


def sphere_mesh(n_theta: int = HARNESS_MESH[0], n_phi: int = HARNESS_MESH[1],
                radius: float = 1.0):
    """(vertices (V, 3) float32, indices (2 n_theta n_phi, 3) int32)."""
    return viewer.sphere_mesh(n_theta, n_phi, radius)


def sphere_scene(n_theta: int = HARNESS_MESH[0],
                 n_phi: int = HARNESS_MESH[1], device="cuda", threads=0):
    """The sphere committed by the port (native BVH8, 8-slot records);
    ``threads``: the builder's OpenMP team (0 = all; 1 numbers the nodes
    the same way in every run)."""
    from .. import Scene, TriangleGeometry
    s = Scene(threads=threads)
    s.attach(TriangleGeometry(*sphere_mesh(n_theta, n_phi)))
    return s.commit(device=device)


def harness_rays(n: int = HARNESS_RAYS, seed: int = 0, device="cuda"):
    """(org (n, 3), dir (n, 3), tnear, tfar, mask) on ``device``, sorted by
    the coherence key as the harnesses' ``main()`` sorts them."""
    rng = np.random.default_rng(seed)
    org = torch.from_numpy(rng.uniform(-2, 2, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    org, d = org.to(device), d.to(device)
    perm = torch.sort(_coherence_key(org, d), stable=True).indices
    org, d = org[perm].contiguous(), d[perm].contiguous()
    tnear = torch.zeros(n, dtype=torch.float32, device=device)
    tfar = torch.full((n,), float("inf"), dtype=torch.float32, device=device)
    mask = torch.full((n,), -1, dtype=torch.int32, device=device)
    return org, d, tnear, tfar, mask
