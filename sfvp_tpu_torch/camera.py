"""Pinhole camera / primary-ray generation.

Parity target (ref shaders/raygen.rgen:50-57):
  screenPos = pixel + (r1, r2)           # subpixel jitter
  inUV      = screenPos / (W, H)
  d         = inUV * 2 - 1
  origin    = (0, -1, 5)
  target    = (d.x, d.y - 1, 2)
  direction = normalize(target - origin)

Generalized as target = center + d.x*right + d.y*up (see CameraConfig).
The thin lens of sfvp_tpu.camera is not carried over yet.
"""

from __future__ import annotations

import torch

from .config import CameraConfig
from .utils import vec
from .utils.vec import f32


def generate_rays_soa(px, py, r1, r2, cam: CameraConfig, width: int,
                      height: int):
    """px, py: int tensors (pixel column/row); r1, r2: jitter in [0,1].
    Returns (origin, direction) as component tuples."""
    dx = (px.to(torch.float32) + r1) * f32(2.0 / width) - 1.0
    dy = (py.to(torch.float32) + r2) * f32(2.0 / height) - 1.0

    cx, cy, cz = (f32(c) for c in cam.center)
    rx, ry, rz = (f32(c) for c in cam.right)
    ux, uy, uz = (f32(c) for c in cam.up)
    ox, oy, oz = (f32(c) for c in cam.origin)

    d = (
        cx + dx * rx + dy * ux - ox,
        cy + dx * ry + dy * uy - oy,
        cz + dx * rz + dy * uz - oz,
    )
    d = vec.normalize(d)
    o = vec.splat((ox, oy, oz), like=d[0])
    return o, d
