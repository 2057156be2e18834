"""H100 counterparts of the JAX package's TPU measurement harnesses under
``perf/``: the traversal ablations ``ablate_v7`` (``perf/ablate_v7.py``) and
``kernel_ablate`` (``perf/kernel_ablate.py``), each a hand-written CUDA
kernel (``csrc/ablate_v7.cu``, ``csrc/ablate_v5.cu``) with its plain PyTorch
version, and the scenes and tables they run on (``scenes``, ``tables``).

Run on the card: ``python -m embree_tpu_torch.perf.ablate_v7`` and
``python -m embree_tpu_torch.perf.kernel_ablate``.
"""
