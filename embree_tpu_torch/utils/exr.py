"""Minimal OpenEXR 2.0 scanline image I/O (pure numpy + stdlib zlib; a copy
of embree_tpu/utils/exr.py).

The reference vendors tinyexr for this role (tutorials/common/image/,
tests compare renders against checked-in golden EXRs —
tests/CMakeLists.txt:4-41, tutorial.cpp:646-658). We only need the subset
those goldens use: single-part scanline images, INCREASING_Y line order,
NONE/ZIPS/ZIP compression, HALF/FLOAT/UINT channels.

read_exr returns (H, W, 3) float32 RGB (missing channels are zero-filled;
extra channels like A are ignored).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 0x01312F76
_PIX_DTYPE = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_COMP_LINES = {0: 1, 2: 1, 3: 16}   # NONE, ZIPS, ZIP


def _read_attrs(buf, i):
    attrs = {}
    while buf[i] != 0:
        j = buf.index(b"\0", i); name = buf[i:j].decode(); i = j + 1
        j = buf.index(b"\0", i); typ = buf[i:j].decode(); i = j + 1
        (size,) = struct.unpack_from("<i", buf, i); i += 4
        attrs[name] = (typ, buf[i:i + size]); i += size
    return attrs, i + 1


def _parse_chlist(raw):
    chans, i = [], 0
    while raw[i] != 0:
        j = raw.index(b"\0", i); name = raw[i:j].decode(); i = j + 1
        ptype, = struct.unpack_from("<i", raw, i)
        chans.append((name, ptype))
        i += 16                     # type, pLinear+pad, xSampling, ySampling
    return chans


def _predictor(data: bytes) -> np.ndarray:
    """Undo the ZIP delta predictor: t[i] = t[i-1] + t[i] - 128 (mod 256)."""
    d = np.frombuffer(data, np.uint8).astype(np.uint64)
    d = d + np.uint64(256) - np.uint64(128)
    d[0] += np.uint64(128)          # first byte stored raw (t[-1] implicit 0+128)
    rec = (np.cumsum(d) % 256).astype(np.uint8)
    return rec


def _zip_decode(data: bytes, raw_size: int) -> bytes:
    raw = zlib.decompress(data)
    rec = _predictor(raw)
    out = np.empty(len(rec), np.uint8)
    half = (len(rec) + 1) // 2
    out[0::2] = rec[:half]
    out[1::2] = rec[half:]
    return out.tobytes()


def read_exr(path) -> np.ndarray:
    buf = open(path, "rb").read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    attrs, i = _read_attrs(buf, 8)

    chans = _parse_chlist(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    if comp not in _COMP_LINES:
        raise ValueError(f"{path}: unsupported compression {comp}")
    xmin, ymin, xmax, ymax = struct.unpack("<iiii", attrs["dataWindow"][1])
    W, H = xmax - xmin + 1, ymax - ymin + 1
    lines = _COMP_LINES[comp]
    n_chunks = -(-H // lines)

    offsets = struct.unpack_from(f"<{n_chunks}Q", buf, i)
    row_bytes = sum(W * _PIX_DTYPE[t].itemsize for _, t in chans)

    planes = {name: np.zeros((H, W), np.float32) for name, _ in chans}
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8:off + 8 + size]
        nl = min(lines, ymax - y + 1)
        raw_size = row_bytes * nl
        if comp == 0:
            raw = data
        else:
            raw = _zip_decode(data, raw_size)
        pos = 0
        for line in range(nl):
            for name, ptype in chans:
                dt = _PIX_DTYPE[ptype]
                nb = W * dt.itemsize
                row = np.frombuffer(raw, dt, count=W, offset=pos)
                planes[name][y - ymin + line] = row.astype(np.float32)
                pos += nb

    img = np.zeros((H, W, 3), np.float32)
    for k, c in enumerate("RGB"):
        if c in planes:
            img[:, :, k] = planes[c]
    return img


def write_exr(path, img: np.ndarray):
    """Write (H, W, 3) float32 RGB as an uncompressed FLOAT scanline EXR."""
    img = np.asarray(img, np.float32)
    H, W, _ = img.shape

    def attr(name, typ, val):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<i", len(val)) + val)

    chlist = b""
    for c in "BGR":                  # alphabetical, required by the format
        chlist += c.encode() + b"\0" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
    chlist += b"\0"
    box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    header = struct.pack("<ii", _MAGIC, 2)
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", b"\0")
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\0")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    offset_pos = len(header)
    data_start = offset_pos + 8 * H
    chunks, offsets = [], []
    pos = data_start
    for y in range(H):
        row = b"".join(img[y, :, k].astype("<f4").tobytes() for k in (2, 1, 0))
        chunk = struct.pack("<ii", y, len(row)) + row
        offsets.append(pos)
        chunks.append(chunk)
        pos += len(chunk)

    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{H}Q", *offsets))
        for c in chunks:
            f.write(c)


def compare_images(a: np.ndarray, b: np.ndarray) -> float:
    """The reference's compareImages error (image.cpp:13): sum over pixels of
    mean squared channel difference — 'roughly the number of pixels that are
    completely off'. Returns inf on size mismatch."""
    if a.shape != b.shape:
        return float("inf")
    d = (a.astype(np.float64) - b.astype(np.float64)) ** 2
    return float(d.sum() / 3.0)


def quantize8(img: np.ndarray) -> np.ndarray:
    """8-bit framebuffer quantization matching Image4uc (the rendered image is
    stored as uint8 before comparison — tutorial.cpp:641)."""
    q = np.clip(img, 0.0, 1.0)
    return (255.0 * q).astype(np.uint8).astype(np.float32) / 255.0
