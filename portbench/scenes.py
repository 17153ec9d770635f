"""The benchmark's inputs, made from a configuration's and a traffic mix's
data alone, and handed the same to both sides: the program and the plain
reference.

- ``obj``: an OBJ + MTL under ``portbench/scenes/`` (the Cornell Box, a
  copy of the Vulkan reference's asset); the program parses the file with
  its own loader, the reference with its own.
- ``sphere``: a frozen copy of the JAX package's procedural bumpy UV sphere
  (``sphere_mesh``, as bench.py's ``_sphere(n)`` calls it), returned as
  arrays.
- an environment map: an 8-bit RGB image drawn from the traffic mix's
  numbers (bench.py ``bench_env_nee_100k``'s sun sky), written as a PNG
  for the program's ingest; the reference reads the same pixels.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def sphere_mesh(n_lat: int, n_lon: int, radius: float = 1.0,
                bump: float = 0.0, center=(0.0, 0.0, 0.0)):
    """UV sphere with about 2 * n_lat * n_lon triangles and a sinusoidal
    bump, wound so that the normal -normalize(cross(e01, e02)) points away
    from the centre; diffuse (0.7, 0.7, 0.7), no emission. Returns (tris
    (T, 3, 3) f32, diffuse (T, 3) f32, emission (T, 3) f32)."""
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon + 1)[:-1]
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    r = radius * (1.0 + bump * np.sin(6 * th) * np.cos(6 * ph))
    x = r * np.sin(th) * np.cos(ph) + center[0]
    y = r * np.cos(th) + center[1]
    z = r * np.sin(th) * np.sin(ph) + center[2]
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)

    def vid(i, j):
        return i * n_lon + (j % n_lon)

    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j + 1), vid(i + 1, j)
            if i > 0:
                faces.append((a, b, c))
            if i < n_lat - 1:
                faces.append((a, c, d))
    faces = np.asarray(faces, np.int64)
    want = verts[faces].mean(axis=1) - np.asarray(center, np.float32)
    tris = verts[faces]
    n = -np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    flip = (n * want).sum(axis=1) < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    t = len(tris)
    return (tris.astype(np.float32),
            np.full((t, 3), 0.7, np.float32), np.zeros((t, 3), np.float32))


def sun_map(height: int, width: int, gray: int, sun_rows, sun_cols,
            sun: int) -> np.ndarray:
    """An (H, W, 3) uint8 sky of one gray level with a rectangle of sun."""
    img = np.full((height, width, 3), gray, np.uint8)
    img[sun_rows[0]:sun_rows[1], sun_cols[0]:sun_cols[1]] = sun
    return img


def encode_png(rgb_u8: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 array as 8-bit RGB PNG bytes (filter 0)."""
    h, w = rgb_u8.shape[:2]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + rgb_u8[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def obj_path(config: dict) -> str:
    return str(HERE / "scenes" / config["scene"]["obj"])


def reference_geometry(config: dict):
    """(tris, diffuse, emission) of a configuration's scene as the
    reference reads it."""
    scene = config["scene"]
    if scene["kind"] == "obj":
        from .reference.objfile import load_scene

        return load_scene(obj_path(config))
    if scene["kind"] == "sphere":
        return sphere_mesh(scene["n_lat"], scene["n_lon"],
                           bump=scene["bump"])
    raise ValueError(f"unknown scene kind {scene['kind']!r}")


def env_image(traffic: dict):
    """The traffic mix's environment map as uint8 pixels, or None."""
    env = traffic.get("env_map")
    if env is None:
        return None
    if env["kind"] != "sun":
        raise ValueError(f"unknown environment map kind {env['kind']!r}")
    return sun_map(env["height"], env["width"], env["gray"], env["sun_rows"],
                   env["sun_cols"], env["sun"])
