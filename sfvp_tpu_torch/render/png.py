"""Dependency-free PNG export.

The reference presents via a GLFW swapchain blit of a B8G8R8A8Unorm storage
image (ref main.cpp:463, 661-682); on a headless host the equivalent
output surface is a PNG file. ``tonemap_unorm_u8`` reproduces the
reference's display transform exactly: clamp to [0,1] and round to 8-bit
UNORM — NO gamma/sRGB encode (the swapchain format is Unorm, not Srgb).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap_unorm_u8(img: np.ndarray) -> np.ndarray:
    """Linear clamp + round to u8 — bit-matches imageStore to rgba8 unorm."""
    x = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    return np.round(x * 255.0).astype(np.uint8)


def tonemap_srgb_u8(img: np.ndarray) -> np.ndarray:
    """sRGB OETF variant (nicer on real displays; NOT the parity transform)."""
    x = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    lo = x * 12.92
    hi = 1.055 * np.power(x, 1.0 / 2.4) - 0.055
    out = np.where(x <= 0.0031308, lo, hi)
    return np.round(out * 255.0).astype(np.uint8)


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(rgb_u8: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode an (H, W, 3) uint8 array as 8-bit RGB PNG bytes."""
    img = np.asarray(rgb_u8)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    # filter byte 0 per scanline
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw, compress_level))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb_u8))
