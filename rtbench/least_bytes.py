"""The least bytes a query moves, counted from shapes: every field of the
ray batch the call takes, read once; what the call returns (a hit batch or
a mask), written once; the scene's attached buffers (vertices, indices and
any other), read once. Nothing of the program's tables, sort or tree
counts, so the bound is the same whatever implements the query."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def nbytes(x) -> int:
    """Bytes of a tensor, an array, or a dataclass of tensors."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, np.ndarray):
        return int(x.nbytes)
    if dataclasses.is_dataclass(x):
        return sum(nbytes(getattr(x, f.name)) for f in dataclasses.fields(x))
    raise TypeError(f"cannot count the bytes of {type(x).__name__}")


def query_bytes(rays, answer, arrays: dict) -> int:
    """``rays``: the batch one call takes; ``answer``: what it returned;
    ``arrays``: what the scene generator made, whose arrays are the
    attached buffers."""
    buffers = sum(nbytes(x) for x in arrays.values()
                  if isinstance(x, np.ndarray))
    return nbytes(rays) + nbytes(answer) + buffers
