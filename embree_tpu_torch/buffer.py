"""Buffer slots, strides, and vertex attributes — the rtcore_buffer.h analog.

Role parity with RTCBufferType + rtcSetSharedGeometryBuffer /
rtcSetGeometryVertexAttributeCount (include/embree4/rtcore_buffer.h,
rtcore_geometry.h:176-210; BufferStrideTest verify.cpp:915): geometry data
may live at a byte OFFSET and non-natural byte STRIDE inside a shared
allocation, and per-vertex attributes are registered in numbered SLOTS that
rtcInterpolate addresses.

A copy of embree_tpu/buffer.py (numpy only). Buffers resolve to
contiguous arrays at registration (one host-side strided view; device
tensors are always dense), so the stride semantics are a host API surface;
``interpolate_slot`` calls the port's ``interpolate``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# RTCBufferType analog (rtcore_buffer.h enum)
BUFFER_TYPE_INDEX = 0
BUFFER_TYPE_VERTEX = 1
BUFFER_TYPE_VERTEX_ATTRIBUTE = 2
BUFFER_TYPE_NORMAL = 3
BUFFER_TYPE_TANGENT = 4
BUFFER_TYPE_FACE = 5


class BufferError(ValueError):
    """RTC_ERROR_INVALID_ARGUMENT analog for buffer registration."""


@dataclasses.dataclass
class Buffer:
    """A typed view into a shared allocation (rtcSetSharedGeometryBuffer).

    data: the backing array (any shape; interpreted as raw bytes).
    fmt: channel count K and dtype of one element (K floats / ints).
    offset / stride: BYTE offset of element 0 and BYTE distance between
      consecutive elements (0 = tightly packed). Both must be 4-byte
      aligned, matching the reference's constraint (rtcore_buffer.h docs;
      unaligned registration raises, the RTC_ERROR_INVALID_ARGUMENT path).
    count: number of elements (inferred from the allocation when omitted).
    """
    data: np.ndarray
    channels: int = 3
    dtype: type = np.float32
    offset: int = 0
    stride: int = 0            # bytes; 0 -> channels * itemsize
    count: Optional[int] = None

    def resolve(self) -> np.ndarray:
        itemsize = np.dtype(self.dtype).itemsize
        natural = self.channels * itemsize
        stride = self.stride or natural
        if stride % 4 or self.offset % 4:
            raise BufferError(
                f"buffer offset/stride must be 4-byte aligned "
                f"(offset={self.offset}, stride={stride})")
        if stride < natural:
            raise BufferError(
                f"stride {stride} smaller than element size {natural}")
        raw = np.ascontiguousarray(self.data).view(np.uint8).reshape(-1)
        avail = (raw.size - self.offset)
        n = self.count
        if n is None:
            n = 0 if avail < natural else (avail - natural) // stride + 1
        end = self.offset + (n - 1) * stride + natural if n else self.offset
        if end > raw.size:
            raise BufferError(
                f"buffer overrun: {n} elements of stride {stride} at offset "
                f"{self.offset} exceed the {raw.size}-byte allocation")
        view = np.lib.stride_tricks.as_strided(
            raw[self.offset:].view(np.uint8),
            shape=(n, natural), strides=(stride, 1))
        return np.ascontiguousarray(view).view(self.dtype).reshape(
            n, self.channels)


def _slots(geom) -> dict:
    s = getattr(geom, "_buffer_slots", None)
    if s is None:
        s = {}
        geom._buffer_slots = s
    return s


def set_vertex_attribute_count(geom, count: int):
    """rtcSetGeometryVertexAttributeCount analog: declares how many
    attribute slots the geometry carries; registering beyond it raises."""
    if count < 0 or count > 64:
        raise BufferError(f"vertex attribute count {count} out of range")
    geom._vertex_attribute_count = int(count)


def vertex_attribute_count(geom) -> int:
    return int(getattr(geom, "_vertex_attribute_count", 0))


def set_geometry_buffer(geom, buf_type: int, slot: int, buffer,
                        channels: int = None):
    """rtcSetSharedGeometryBuffer analog: register `buffer` (a Buffer with
    offset/stride semantics, or a plain array) under (type, slot)."""
    if not isinstance(buffer, Buffer):
        arr = np.asarray(buffer)
        if channels is None:
            channels = arr.shape[-1] if arr.ndim > 1 else 1
        buffer = Buffer(arr.reshape(arr.shape[0], -1)
                        if arr.ndim > 1 else arr[:, None],
                        channels=channels,
                        dtype=arr.dtype.type)
    if buf_type == BUFFER_TYPE_VERTEX_ATTRIBUTE:
        n = getattr(geom, "_vertex_attribute_count", None)
        if n is not None and slot >= n:
            raise BufferError(
                f"vertex attribute slot {slot} >= declared count {n} "
                "(rtcSetGeometryVertexAttributeCount)")
    _slots(geom)[(buf_type, slot)] = buffer.resolve()


def get_geometry_buffer(geom, buf_type: int, slot: int) -> np.ndarray:
    try:
        return _slots(geom)[(buf_type, slot)]
    except KeyError:
        raise BufferError(
            f"no buffer registered at (type={buf_type}, slot={slot})")


def interpolate_slot(geom, prim_id, u, v, slot: int = 0,
                     buf_type: int = BUFFER_TYPE_VERTEX_ATTRIBUTE):
    """rtcInterpolate through a registered attribute SLOT (the verify.cpp
    Interpolate*Test surface, addressed by slot instead of a raw array)."""
    from .interpolate import interpolate
    return interpolate(geom, prim_id, u, v,
                       get_geometry_buffer(geom, buf_type, slot))
