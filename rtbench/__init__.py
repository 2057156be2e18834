"""The benchmark of embree_tpu_torch on one or four NVIDIA H100 cards.

``python rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Everything a cell needs is found by name:

- ``configs/<config>.json``: the scene's sizes, source and assumptions; its
  ``scene`` names a generator in ``scenes/`` and its ``reference`` a plain
  intersector in ``reference/``;
- ``traffic/<mix>.json``: the rays and the calls (read by ``traffic.py``,
  the one generator); its ``rays.kind`` names a module of ``rays/`` that
  draws a batch, its ``answer`` a module of ``answers/`` that makes each
  call, keeps its sampled answers and compares them;
- ``limits/<cell>.json``: the comparison's sample size and limits;
- ``metrics/<metric>.py``: one reader per metric.

So a cell of a new scene, ray law, query or primitive kind is new files
and a new entry of ``BENCHMARK.json``. Nothing here imports jax or the JAX
package; ``reference/`` imports nothing of embree_tpu_torch either.
"""
