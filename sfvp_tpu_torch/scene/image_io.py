"""Dependency-free image loading for textures and environment maps (PNG,
PPM and Radiance .hdr), a copy of sfvp_tpu.scene.image_io (numpy only), so
that both packages decode an image to the same float32 texels.

The reference has no texture support at all (materials are flat Kd/Ke,
ref main.cpp:47-56, closesthit.rchit:60-62); this feeds the framework's
`map_Kd` extension and its equirect skies. The PNG decoder is the inverse
of render/png.py's encoder and handles the baseline cases texture assets
actually use: 8-bit greyscale/RGB/RGBA (color types 0/2/6), all five
scanline filters, non-interlaced.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _defilter(raw: np.ndarray, h: int, w: int, ch: int) -> np.ndarray:
    """Undo PNG scanline filtering. raw: (h, 1 + w*ch) u8 with the filter
    byte leading each row."""
    stride = w * ch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f = int(raw[y, 0])
        line = raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 1:  # sub
            cur = line.copy()
            for x in range(ch, stride):
                cur[x] = (cur[x] + cur[x - ch]) & 0xFF
        elif f == 2:  # up
            cur = (line + prev) & 0xFF
        elif f == 3:  # average
            cur = line.copy()
            for x in range(stride):
                a = cur[x - ch] if x >= ch else 0
                cur[x] = (cur[x] + ((a + prev[x]) >> 1)) & 0xFF
        elif f == 4:  # paeth
            cur = line.copy()
            for x in range(stride):
                a = cur[x - ch] if x >= ch else 0
                b = prev[x]
                c = prev[x - ch] if x >= ch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {f}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 from PNG bytes (8-bit grey/RGB/RGBA, non-interlaced;
    alpha is dropped)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos = 8
    ihdr = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG missing IHDR")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if depth != 8 or comp != 0 or filt != 0 or interlace != 0:
        raise ValueError(
            f"unsupported PNG (depth={depth}, color={ctype}, "
            f"interlace={interlace}); only 8-bit non-interlaced supported"
        )
    ch = {0: 1, 2: 3, 6: 4}.get(ctype)
    if ch is None:
        raise ValueError(f"unsupported PNG color type {ctype}")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    raw = raw.reshape(h, 1 + w * ch)
    px = _defilter(raw, h, w, ch).reshape(h, w, ch)
    if ch == 1:
        return np.repeat(px, 3, axis=2)
    return px[:, :, :3].copy()


def decode_ppm(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 from a binary P6 PPM (maxval 255)."""
    if not data.startswith(b"P6"):
        raise ValueError("not a binary P6 PPM")
    # header: magic, width, height, maxval — with comments allowed
    tokens = []
    pos = 2
    while len(tokens) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        tokens.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    w, h, maxval = tokens
    if maxval != 255:
        raise ValueError(f"unsupported PPM maxval {maxval}")
    return np.frombuffer(data[pos:pos + 3 * w * h], np.uint8).reshape(h, w, 3).copy()


def srgb_to_linear(u8: np.ndarray) -> np.ndarray:
    """Exact sRGB EOTF on uint8 pixel data -> float32 linear radiance."""
    x = u8.astype(np.float32) / 255.0
    return np.where(
        x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4
    ).astype(np.float32)


def decode_hdr(data: bytes) -> np.ndarray:
    """Radiance RGBE (.hdr) decoder -> (H, W, 3) float32 LINEAR radiance.

    Dependency-free, like the PNG/PPM decoders. Supports the standard
    ``-Y H +X W`` orientation with new-style RLE scanlines (the format
    every .hdr exporter writes) plus flat (unencoded) scanlines. HDR is
    the native format for image-based lighting: an 8-bit sky clips the
    sun at 1.0, which is exactly what env importance sampling exists to
    handle."""
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance .hdr file")
    # header: lines until the blank line; then the resolution line
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported .hdr orientation {res!r}")
    h, w = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8, offset=eol + 1)
    rgbe = np.zeros((h, w, 4), np.uint8)
    i = 0
    for y in range(h):
        if (w < 8 or w > 0x7FFF or buf[i] != 2 or buf[i + 1] != 2
                or (int(buf[i + 2]) << 8 | int(buf[i + 3])) != w):
            # flat scanline
            rgbe[y] = buf[i:i + 4 * w].reshape(w, 4)
            i += 4 * w
            continue
        i += 4
        for c in range(4):  # RLE per component plane
            x = 0
            while x < w:
                n = int(buf[i])
                if n > 128:  # run of buf[i+1]
                    rgbe[y, x:x + n - 128, c] = buf[i + 1]
                    x += n - 128
                    i += 2
                else:        # n literal bytes
                    rgbe[y, x:x + n, c] = buf[i + 1:i + 1 + n]
                    x += n
                    i += 1 + n
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(
        e > 0, np.ldexp(np.float32(1.0), e - 136), np.float32(0.0)
    ).astype(np.float32)  # 2^(e-128) / 256 folds in the mantissa scale
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(
        np.float32
    )


def load_image(path: str, srgb: bool = True) -> np.ndarray:
    """(H, W, 3) float32 linear image from a PNG, PPM or Radiance .hdr
    file. HDR data is already linear radiance; ``srgb`` only applies to
    the 8-bit formats."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        u8 = decode_png(data)
    elif data[:2] == b"P6":
        u8 = decode_ppm(data)
    elif data[:2] == b"#?":
        return decode_hdr(data)
    else:
        raise ValueError(f"unsupported image format: {path}")
    if srgb:
        return srgb_to_linear(u8)
    return (u8.astype(np.float32) / 255.0)
