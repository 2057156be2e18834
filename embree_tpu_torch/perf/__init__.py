"""H100 counterparts of the JAX package's TPU measurement harnesses under
``perf/``: the traversal ablations ``ablate_v7`` (``perf/ablate_v7.py``) and
``kernel_ablate`` (``perf/kernel_ablate.py``), each a hand-written CUDA
kernel (``csrc/ablate_v7.cu``, ``csrc/ablate_v5.cu``) with its plain PyTorch
version, and the scenes and tables they run on (``scenes``, ``tables``);
and the loop probes ``micro_ops``, ``micro_expand`` and ``micro_v8``
(``perf/micro_*.py``), a CUDA kernel each (``csrc/micro_*.cu``, one
template instantiation per probe) with plain PyTorch bodies, over their
shared harness ``micro``. Both families load their libraries, count their
launches and time their calls through ``device``.

Run on the card: ``python -m embree_tpu_torch.perf.ablate_v7``,
``python -m embree_tpu_torch.perf.kernel_ablate`` and
``python -m embree_tpu_torch.perf.micro_ops`` (``.micro_expand``,
``.micro_v8``).
"""
