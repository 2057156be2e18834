"""Scene generators, one module per scene family. Each has
``generate(sizes, seed) -> dict`` (host numpy arrays: the buffers that are
attached, and ``kind``, the primitive kind the reference takes) and
``attach(pt, arrays) -> pt.Scene`` (``pt``: the embree_tpu_torch module)."""
