"""Native (C++) host runtime components, loaded via ctypes.

Port of embree_tpu/native/__init__.py with the same interface. The OpenMP
binned-SAH BVH8 builder (bvh_builder.cpp, a copy of the JAX package's) is
compiled at first use into the port's build directory (see _build.py), never
next to the sources.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from .. import _build

_lock = threading.Lock()
_lib = None


def load_library():
    """Load the native builder, compiling it first if needed. Raises
    RuntimeError when it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build.ensure("bvh_builder"))
        lib.set_build_threads.restype = None
        lib.set_build_threads.argtypes = [ctypes.c_int]
        lib.build_bvh8.restype = ctypes.c_int
        lib.build_bvh8.argtypes = [
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native builder builds and loads here. It only reports:
    a commit that needs the builder still raises where it cannot load."""
    try:
        load_library()
    except Exception:  # noqa: BLE001 — any build or load failure
        return False
    return True


def build_bvh8_native(lo, up, leaf_size=8, threads=0):
    """Build a BVH8 with the native builder.

    Args:
      lo, up: (n, 3) float32 primitive bounds (numpy, host).
    Returns:
      (node_lower, node_upper, node_child, prim_order, n_nodes) numpy arrays —
      same layout as accel/bvh.py BVH (leaf ref = -(start<<4|count)-1).
    """
    lib = load_library()
    lib.set_build_threads(int(threads))
    lo = np.ascontiguousarray(lo, np.float32)
    up = np.ascontiguousarray(up, np.float32)
    n = lo.shape[0]
    max_nodes = max(2, n)  # BVH8 nodes <= ceil(n / 2) in practice; n is safe
    node_lower = np.zeros((max_nodes, 8, 3), np.float32)
    node_upper = np.zeros((max_nodes, 8, 3), np.float32)
    node_child = np.zeros((max_nodes, 8), np.int32)
    prim_order = np.zeros(n, np.int32)
    count = lib.build_bvh8(n, lo, up, node_lower.reshape(-1),
                           node_upper.reshape(-1), node_child.reshape(-1),
                           prim_order, max_nodes, leaf_size)
    if count < 0:
        raise RuntimeError("native BVH build overflowed node budget")
    return (node_lower[:count], node_upper[:count], node_child[:count],
            prim_order, count)
