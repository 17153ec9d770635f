"""Direction sampling and the tangent-frame construction.

Parity targets (ref shaders/raygen.rgen:14-39):
  - ``createCoordinateSystem``: branch on |N.x| > |N.y|
  - ``sampleHemisphere``: *uniform* hemisphere, z = rand1, pdf = 1/(2*pi)
  - ``sampleDirection``: rotate hemisphere sample into the normal's frame

Plus the cosine-weighted variant. The GGX and dielectric samplers of
sfvp_tpu.sampling are not carried over yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import vec
from .utils.vec import f32

TWO_PI = f32(2.0 * np.pi)
INV_TWO_PI = f32(1.0 / (2.0 * np.pi))
INV_PI = f32(1.0 / np.pi)


def coordinate_system_soa(n):
    """Tangent + bitangent for normal n, ref shaders/raygen.rgen:14-21."""
    nx, ny, nz = n
    use_x = torch.abs(nx) > torch.abs(ny)
    inv_a = vec.inv_sqrt(nx * nx + nz * nz)
    inv_b = vec.inv_sqrt(ny * ny + nz * nz)
    t = (
        torch.where(use_x, nz * inv_a, 0.0),
        torch.where(use_x, 0.0, -nz * inv_b),
        torch.where(use_x, -nx * inv_a, ny * inv_b),
    )
    b = vec.cross(n, t)
    return t, b


def hemisphere_uniform_local(r1, r2):
    """Uniform hemisphere in local coords; pdf = 1/(2*pi). z = r1 directly,
    ref shaders/raygen.rgen:23-30."""
    s = torch.sqrt(torch.clamp_min(1.0 - r1 * r1, 0.0))
    phi = TWO_PI * r2
    return (torch.cos(phi) * s, torch.sin(phi) * s, r1)


def hemisphere_cosine_local(r1, r2):
    """Cosine-weighted hemisphere; pdf = cos(theta)/pi; cos(theta)=sqrt(1-r1)."""
    z = torch.sqrt(torch.clamp_min(1.0 - r1, 0.0))
    s = torch.sqrt(torch.clamp_min(r1, 0.0))
    phi = TWO_PI * r2
    return (torch.cos(phi) * s, torch.sin(phi) * s, z)


def to_world_soa(local_dir, n):
    t, b = coordinate_system_soa(n)
    lx, ly, lz = local_dir
    return vec.add(vec.add(vec.scale(t, lx), vec.scale(b, ly)),
                   vec.scale(n, lz))


def sample_direction_uniform_soa(r1, r2, n):
    """ref shaders/raygen.rgen:32-39: uniform hemisphere around n."""
    return to_world_soa(hemisphere_uniform_local(r1, r2), n)


def sample_direction_cosine_soa(r1, r2, n):
    return to_world_soa(hemisphere_cosine_local(r1, r2), n)
