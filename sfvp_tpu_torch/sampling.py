"""Direction sampling and the tangent-frame construction.

Parity targets (ref shaders/raygen.rgen:14-39):
  - ``createCoordinateSystem``: branch on |N.x| > |N.y|
  - ``sampleHemisphere``: *uniform* hemisphere, z = rand1, pdf = 1/(2*pi)
  - ``sampleDirection``: rotate hemisphere sample into the normal's frame

Plus the cosine-weighted variant, the GGX microfacet functions (Smith
Lambda, D, VNDF sampling and its pdf) and the smooth dielectric's Snell +
Fresnel split of sfvp_tpu.sampling (:83-176), with 1/sqrt as two correctly
rounded ops where it calls rsqrt (utils/vec.py inv_sqrt).
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


# ------------------------------ GGX microfacet -----------------------------
# Trowbridge-Reitz/GGX glossy reflection with Smith height-correlated
# shadowing and VNDF importance sampling (Heitz 2018, "Sampling the GGX
# Distribution of Visible Normals"); the reference's shader model is
# diffuse + emission only (ref closesthit.rchit:60-62).


def ggx_lambda(cos_t, alpha):
    """Smith Lambda for GGX; cos_t clamped away from 0."""
    c = torch.clamp_min(torch.abs(cos_t), 1e-6)
    c2 = c * c
    tan2 = torch.clamp_min(1.0 - c2, 0.0) / c2
    return 0.5 * (-1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))


def ggx_d(cos_h, alpha):
    """GGX normal distribution D(h) (isotropic)."""
    a2 = alpha * alpha
    c = torch.clamp_min(cos_h, 0.0)
    denom = c * c * (a2 - 1.0) + 1.0
    return a2 * INV_PI / torch.clamp_min(denom * denom, 1e-12)


def ggx_sample_vndf_local(r1, r2, wo_l, alpha):
    """Sample a half-vector from the distribution of visible normals, in
    the local (tangent, bitangent, normal) frame; wo_l.z > 0 required."""
    wox, woy, woz = wo_l
    # stretch the view vector into the hemisphere configuration
    vx, vy, vz = alpha * wox, alpha * woy, woz
    inv_len = vec.inv_sqrt(torch.clamp_min(vx * vx + vy * vy + vz * vz,
                                           1e-20))
    vx, vy, vz = vx * inv_len, vy * inv_len, vz * inv_len
    # orthonormal basis around v
    lensq = vx * vx + vy * vy
    inv_l = vec.inv_sqrt(torch.clamp_min(lensq, 1e-20))
    ok = lensq > 1e-12
    t1 = (torch.where(ok, -vy * inv_l, 1.0),
          torch.where(ok, vx * inv_l, 0.0),
          torch.zeros_like(vx))
    t2 = vec.cross((vx, vy, vz), t1)
    # disk sample warped toward the hemisphere seen from v
    rr = torch.sqrt(torch.clamp_min(r1, 0.0))
    phi = TWO_PI * r2
    p1 = rr * torch.cos(phi)
    p2 = rr * torch.sin(phi)
    s = 0.5 * (1.0 + vz)
    p2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = vec.add(vec.add(vec.scale(t1, p1), vec.scale(t2, p2)),
                 vec.scale((vx, vy, vz), p3))
    # unstretch back to the ellipsoid
    hx, hy, hz = alpha * nh[0], alpha * nh[1], torch.clamp_min(nh[2], 1e-6)
    inv_h = vec.inv_sqrt(torch.clamp_min(hx * hx + hy * hy + hz * hz, 1e-20))
    return (hx * inv_h, hy * inv_h, hz * inv_h)


def ggx_vndf_pdf(cos_o, cos_h, alpha):
    """Solid-angle pdf of a VNDF-sampled outgoing direction:
    G1(wo) * D(h) / (4 cos_o)."""
    g1 = 1.0 / (1.0 + ggx_lambda(cos_o, alpha))
    return g1 * ggx_d(cos_h, alpha) / torch.clamp_min(4.0 * cos_o, 1e-6)


def dielectric_reflect_refract_soa(d, normal, ior):
    """Smooth-dielectric interface (mtype 3). ``d``: unit incident
    direction (into the surface); ``normal``: the geometric normal, either
    orientation (flipped toward the incident side here); ``ior``: index of
    refraction behind the front face (air = 1 outside).

    Returns ``(refl_dir, refr_dir, fresnel, tir)``: the mirror direction
    about the incident-side normal, the Snell-refracted direction (unit;
    meaningless under TIR), the exact unpolarized Fresnel reflectance (1
    under TIR) and the total-internal-reflection mask."""
    n_dot_d = vec.dot(d, normal)
    entering = n_dot_d < 0
    n_d = vec.where(entering, normal, vec.scale(normal, -1.0))
    eta = torch.where(entering, 1.0 / ior, ior)
    cos_i = torch.clamp(-vec.dot(d, n_d), 0.0, 1.0)
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    # exact unpolarized Fresnel: F = (r_s^2 + r_p^2)/2 with eta = n1/n2
    rs = (eta * cos_i - cos_t) / torch.clamp_min(eta * cos_i + cos_t, 1e-12)
    rp = (eta * cos_t - cos_i) / torch.clamp_min(eta * cos_t + cos_i, 1e-12)
    fres = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    refl_d = vec.sub(d, vec.scale(n_d, 2.0 * vec.dot(d, n_d)))
    refr_d = vec.add(vec.scale(d, eta), vec.scale(n_d, eta * cos_i - cos_t))
    return refl_d, refr_d, fres, tir
