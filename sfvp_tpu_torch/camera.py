"""Pinhole camera / primary-ray generation.

Parity target (ref shaders/raygen.rgen:50-57):
  screenPos = pixel + (r1, r2)           # subpixel jitter
  inUV      = screenPos / (W, H)
  d         = inUV * 2 - 1
  origin    = (0, -1, 5)
  target    = (d.x, d.y - 1, 2)
  direction = normalize(target - origin)

Generalized as target = center + d.x*right + d.y*up (see CameraConfig),
with sfvp_tpu.camera's thin lens for depth of field (``apply_thin_lens_soa``).
"""

from __future__ import annotations

import numpy as np
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


def lens_frame(cam: CameraConfig) -> tuple:
    """The thin lens of ``cam`` as float32 constants: (lens_radius,
    focus_dist, right, up, forward), the three axes normalized as
    vec.normalize does (x * (1 / sqrt(x . x)) in float32). The CUDA
    kernels take the same numbers (kernels/build.py make_params).
    ValueError when the focal plane is not in front of the lens
    (``focus_dist <= 0``), as sfvp_tpu's."""
    if cam.focus_dist <= 0.0:
        raise ValueError(
            f"thin-lens camera needs focus_dist > 0 (got "
            f"{cam.focus_dist}); with the focal plane at distance 0 every "
            f"ray re-aims at its own origin and the render degenerates")

    def unit(v):
        v = np.asarray(v, np.float32)
        inv = np.float32(1.0) / np.sqrt(np.float32(v[0] * v[0] + v[1] * v[1]
                                                   + v[2] * v[2]))
        return tuple(float(c * inv) for c in v)

    fwd = np.asarray(cam.center, np.float32) - np.asarray(cam.origin,
                                                          np.float32)
    return (f32(cam.lens_radius), f32(cam.focus_dist), unit(cam.right),
            unit(cam.up), unit(fwd))


def apply_thin_lens_soa(o, d, rl1, rl2, cam: CameraConfig):
    """Thin-lens depth of field (sfvp_tpu/camera.py:49-90; the reference
    camera is a pure pinhole, ref raygen.rgen:50-57): offset each origin by
    a uniform disk sample of radius ``cam.lens_radius`` in the lens plane
    and re-aim at the point of the pinhole ray on the focal PLANE at depth
    ``focus_dist`` along the camera's forward axis, so a flat wall at that
    depth stays sharp across the frame.

    rl1, rl2: uniforms in [0, 1), drawn by the integrator after the two
    jitter numbers and ONLY when lens_radius > 0, so pinhole streams are
    untouched. Raises ValueError when ``focus_dist <= 0``."""
    lr, fd, rn, un, fwd = lens_frame(cam)
    # uniform disk (polar; radius sqrt for uniform area density)
    rad = lr * torch.sqrt(torch.clamp_min(rl1, 0.0))
    phi = f32(2.0 * np.pi) * rl2
    lx = rad * torch.cos(phi)
    ly = rad * torch.sin(phi)
    t_focal = fd / torch.clamp_min(vec.dot(d, fwd), 1e-4)
    focal = vec.add(o, vec.scale(d, t_focal))
    o2 = (o[0] + lx * rn[0] + ly * un[0],
          o[1] + lx * rn[1] + ly * un[1],
          o[2] + lx * rn[2] + ly * un[2])
    return o2, vec.normalize(vec.sub(focal, o2))
