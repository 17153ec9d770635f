"""Dependency-free OpenEXR export (uncompressed f32 scanlines).

The accumulator is linear f32 radiance; PNG export quantizes to 8-bit
(matching the reference swapchain, render/png.py), while EXR preserves the
full dynamic range for downstream grading/compositing — the natural HDR
output for a headless renderer. Writes a minimal but fully standard
OpenEXR 2.0 file: single part, scanline storage, NO_COMPRESSION, FLOAT
channels B, G, R (alphabetical, as the format requires).
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_VERSION = 2


def _attr(name: bytes, type_: bytes, value: bytes) -> bytes:
    return name + b"\x00" + type_ + b"\x00" + struct.pack("<i", len(value)) + value


def _channels_attr() -> bytes:
    # alphabetical channel order; FLOAT (type 2), no subsampling
    out = b""
    for ch in (b"B", b"G", b"R"):
        out += ch + b"\x00" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
    return out + b"\x00"


def write_exr(path: str, rgb_f32: np.ndarray) -> None:
    """Write an (H, W, 3) float32 array as a linear OpenEXR file."""
    img = np.asarray(rgb_f32, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join([
        _attr(b"channels", b"chlist", _channels_attr()),
        _attr(b"compression", b"compression", b"\x00"),  # NO_COMPRESSION
        _attr(b"dataWindow", b"box2i", box),
        _attr(b"displayWindow", b"box2i", box),
        _attr(b"lineOrder", b"lineOrder", b"\x00"),      # INCREASING_Y
        _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
        _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
    ]) + b"\x00"

    start = 8 + len(header) + 8 * h  # magic+version, header, offset table
    row_bytes = 4 + 4 + 3 * 4 * w    # y, pixel-data size, B/G/R planes
    offsets = struct.pack("<" + "Q" * h,
                          *[start + y * row_bytes for y in range(h)])

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, _VERSION))
        f.write(header)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * 4 * w))
            # per-scanline planar, channels in header (alphabetical) order
            f.write(np.ascontiguousarray(img[y, :, 2]).tobytes())  # B
            f.write(np.ascontiguousarray(img[y, :, 1]).tobytes())  # G
            f.write(np.ascontiguousarray(img[y, :, 0]).tobytes())  # R


def read_exr(path: str) -> np.ndarray:
    """Minimal reader for files produced by write_exr (tests/tools)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b"\x00", pos)
        name = data[pos:e]
        pos = e + 1
        e = data.index(b"\x00", pos)
        pos = e + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = data[pos : pos + size]
        pos += size
    pos += 1  # header terminator
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs[b"dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    pos += 8 * h  # offset table
    img = np.empty((h, w, 3), np.float32)
    for _ in range(h):
        y, nbytes = struct.unpack_from("<ii", data, pos)
        pos += 8
        plane = np.frombuffer(data, np.float32, 3 * w, pos).reshape(3, w)
        img[y, :, 2] = plane[0]  # B
        img[y, :, 1] = plane[1]  # G
        img[y, :, 0] = plane[2]  # R
        pos += nbytes
    return img
