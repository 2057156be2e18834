"""Plain intersectors, one module per primitive kind, that decide what a
timed call should have answered. Each module has

- ``prepare(arrays, device)``: its tables, from the buffers the benchmark
  generated and attached (never from anything the program made);
- ``closest(prep, org, dir, tnear, tfar, dtype)``: a dict of ``valid``,
  ``t``, ``u``, ``v``, ``ng`` and ``prim`` (-1 on a miss);
- ``any_hit(prep, org, dir, tnear, tfar, dtype)``: a bool tensor.

``dtype`` is the precision the tests run in: float64 for the reference,
bfloat16 for the control. They import torch alone: nothing of
embree_tpu_torch, jax or the JAX package.
"""
