"""Light tables for next-event estimation (NEE), the counterpart of
sfvp_tpu.integrate.lights: the area-light table (lights.py:21-115) and the
importance distribution over an environment map's texels (lights.py
:118-263).

NEE is an extension over the reference integrator (which relies purely on
BSDF sampling hitting the light, ref shaders/raygen.rgen:62-84): at each
diffuse hit a point is sampled on an emissive triangle (area-weighted),
its visibility is tested with a shadow ray, and the direct contribution
f * Le * G / pdf is added. To stay unbiased, BSDF-path emission is then
only counted on camera rays and after specular bounces. Lights are treated
as double-sided, matching the reference's facing-cull-disable behavior
(ref main.cpp:525).

Both are built by the JAX package's NumPy code, line for line, so their
CDFs and ``total_area`` (a Python float summed from float32 areas) are bit
for bit the same, and so is every float32 constant derived from them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.vec import f32

# light rows of the (16, L) table: v0, v1, v2, normal, Le (xyz each), cdf;
# the layout of sfvp_tpu/kernels/megakernel_regen.py:135-139, which the
# CUDA kernels read
N_LIGHT_ROWS = 16
CDF_ROW = 15
# lights up to which sfvp_tpu's sample_light picks by a compare-sum over
# the CDF; beyond, by searchsorted (lights.py:86-97)
COMPARE_SUM_MAX = 64


class LightTable(NamedTuple):
    rows: torch.Tensor  # (16, L) f32: v0, v1, v2, n, le (xyz each), cdf
    total_area: float   # static
    num: int            # static

    @property
    def cdf(self) -> torch.Tensor:
        """(L,) area-weighted selection CDF."""
        return self.rows[CDF_ROW]

    @property
    def inv_area(self) -> float:
        """float32(1 / total_area): the area pdf of a light sample."""
        return float(np.float32(1.0 / max(self.total_area, 1e-30)))


def build_light_table(scene, device) -> Optional[LightTable]:
    """Collect emissive triangles from a host Scene onto ``device``; None
    if the scene has no area lights."""
    em = np.asarray(scene.face_emission, np.float32)
    lit = np.any(em > 0, axis=1)
    if not lit.any():
        return None
    tris = scene.triangles()[lit]  # (L, 3, 3)
    le = em[lit]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    cr = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(cr, axis=1)
    n = cr / np.maximum(np.linalg.norm(cr, axis=1, keepdims=True), 1e-30)
    total = float(area.sum())
    cdf = np.cumsum(area) / max(total, 1e-30)

    cols = [tris[:, c, a] for c in range(3) for a in range(3)]
    cols += [n[:, a] for a in range(3)] + [le[:, a] for a in range(3)]
    cols.append(cdf.astype(np.float32))
    rows = np.stack([np.asarray(c, np.float32) for c in cols], axis=0)
    return LightTable(
        rows=torch.as_tensor(rows, device=device).contiguous(),
        total_area=total,
        num=int(lit.sum()),
    )


def build_light_table_from_buffers(buffers) -> Optional[LightTable]:
    """Build from SceneBuffers (device columns, read once on the host),
    onto the buffers' device."""
    import types

    t = buffers.num_tris

    def col(f):
        return getattr(buffers, f)[:t].cpu().numpy()

    scene = types.SimpleNamespace(
        face_emission=np.stack([col("er"), col("eg"), col("eb")], axis=1),
        triangles=lambda: np.stack(
            [col("v0x"), col("v0y"), col("v0z"),
             col("v1x"), col("v1y"), col("v1z"),
             col("v2x"), col("v2y"), col("v2z")],
            axis=1,
        ).reshape(t, 3, 3),
    )
    return build_light_table(scene, device=buffers.device)


def light_index(lights: LightTable, r_sel, fused: bool = False):
    """The light a selection number picks, (N,) int64.

    ``fused=False``: sfvp_tpu's sample_light rule: up to 64 lights the
    count of CDF entries below r_sel, beyond that searchsorted (side
    "right"); then at most L - 1. ``fused=True``: the fused kernels' rule
    (megakernel_regen.py:676-688, megakernel_bvh.py:1849-1860), the count
    of CDF entries below r_sel among the first L - 1, by a binary search
    over the non-decreasing CDF, as the CUDA kernels do
    (csrc/common.cuh pick_light)."""
    cdf = lights.cdf
    if fused:
        return torch.searchsorted(cdf[: lights.num - 1].contiguous(), r_sel)
    if lights.num <= COMPARE_SUM_MAX:
        li = (r_sel[..., None] > cdf).sum(-1)
    else:
        li = torch.searchsorted(cdf, r_sel, right=True)
    return torch.clamp_max(li, lights.num - 1)


def sample_light(lights: LightTable, r_sel, r1, r2, fused: bool = False):
    """Area-uniform sample over all lights.

    Returns (point (3-tuple), normal (3-tuple), Le (3-tuple), pdf_area).
    pdf_area == 1/total_area (triangle chosen proportional to area).
    ``fused`` picks the light by the fused kernels' rule (light_index).
    """
    li = light_index(lights, r_sel, fused)
    rows = lights.rows[:CDF_ROW, li]  # (15, N)
    v0, v1, v2, n, le = (tuple(rows[i:i + 3]) for i in range(0, 15, 3))

    # uniform barycentric (sqrt warp)
    su = torch.sqrt(torch.clamp_min(r1, 0.0))
    b0 = 1.0 - su
    b1 = su * (1.0 - r2)
    b2 = su * r2
    point = tuple(a * b0 + b * b1 + c * b2 for a, b, c in zip(v0, v1, v2))
    return point, n, le, lights.inv_area


class EnvDistribution(NamedTuple):
    """Luminance x solid-angle importance distribution over the texels of
    an equirect environment map (NEE for image-based lighting: without
    it, a small bright sun in the map converges only through lucky BSDF
    samples), its CDF and probabilities on the map's device."""

    cdf: torch.Tensor       # (H*W,) f32 texel-selection CDF
    pdf_flat: torch.Tensor  # (H*W,) f32 texel-selection probability
    width: int
    height: int

    @property
    def inv_patch(self) -> float:
        """float32(W * H / (2 pi^2)): 1 / (dtheta * dphi) of a cell."""
        return f32(self.width * self.height / (2.0 * math.pi * math.pi))

    def pdf_sa_at(self, ti, sin_theta):
        """Exact solid-angle density of the sampler at a direction inside
        cell ti with polar angle theta: the sampler jitters UNIFORMLY in
        (theta, phi) inside the cell, so the density is flat_prob /
        (dtheta * dphi * sin(theta_sample))."""
        return (self.pdf_flat[ti] * self.inv_patch
                / torch.clamp_min(sin_theta, 1e-6))


def _dilate3x3(lum):
    """3x3 max-dilate a (H, W) luminance/weight grid, wrapping in
    longitude and clamping at the poles: the radiance LOOKUP is bilinear,
    so cells beside a bright feature can return blended-bright values and
    their pdf must be scaled to the bright neighbour."""
    lum = np.max(
        [np.roll(lum, s, axis=1) for s in (-1, 0, 1)], axis=0
    )
    pad = np.pad(lum, ((1, 1), (0, 0)), mode="edge")
    return np.max([pad[:-2], pad[1:-1], pad[2:]], axis=0)


# Grid-height cap of the pooled proposal of a map past
# ENV_EXACT_CDF_MAX_BYTES (sfvp_tpu lights.py ENV_DIST_MAX_H)
ENV_DIST_MAX_H = 256
# The proposal rule, not a memory limit: sfvp_tpu samples a map whose three
# float32 planes take at most 2 MiB by its exact texel CDF and a larger one
# by the pooled 256 x 512 proposal (its ENV_VMEM_MAX_BYTES, lights.py
# :212-223, imgfetch.py:38-48). The choice fixes the sample streams, so the
# port keeps it to draw the same directions from the same numbers.
ENV_EXACT_CDF_MAX_BYTES = 2 * 1024 * 1024


def build_env_distribution(table, max_h=None) -> EnvDistribution:
    """table: the scene's environment TextureTable (one equirect image).

    max_h (optional): cap the grid at (max_h, 2*max_h) by pooling fine
    texel weights into the coarse cell holding each fine texel's centre;
    the sampler then jitters uniformly inside the coarse cell while the
    radiance is still fetched at full resolution, an unbiased proposal.
    The summation stays in numpy (``np.add.at``) in sfvp_tpu's order."""
    h, w = table.shape0()

    def plane(c):
        return c[: h * w].cpu().numpy().reshape(h, w)

    r, g, b = plane(table.tr), plane(table.tg), plane(table.tb)
    lum = _dilate3x3(0.2126 * r + 0.7152 * g + 0.0722 * b)
    # texel solid angle: dOmega = (2pi/W)(pi/H) sin(theta_row); image row 0
    # is the top (theta ~ 0)
    theta = (np.arange(h) + 0.5) * (np.pi / h)
    d_omega = (2 * np.pi / w) * (np.pi / h) * np.sin(theta)[:, None]
    weight = np.maximum(lum, 1e-8) * d_omega
    if max_h is not None and (h > max_h or w > 2 * max_h):
        h2, w2 = min(h, max_h), min(w, 2 * max_h)
        ri = ((np.arange(h) + 0.5) * (h2 / h)).astype(np.int64)
        ci = ((np.arange(w) + 0.5) * (w2 / w)).astype(np.int64)
        pooled = np.zeros((h2, w2), weight.dtype)
        np.add.at(pooled, (ri[:, None], ci[None, :]), weight)
        # re-dilate at the coarse scale and floor for full support
        weight = np.maximum(_dilate3x3(pooled), pooled.sum() * 1e-12)
        h, w = h2, w2
    total = float(weight.sum())
    flat = (weight / total).reshape(-1)
    cdf = np.cumsum(flat)
    dev = table.device
    return EnvDistribution(
        cdf=torch.as_tensor(cdf.astype(np.float32), device=dev),
        pdf_flat=torch.as_tensor(flat.astype(np.float32), device=dev),
        width=w, height=h)


def env_exact_cdf(table) -> bool:
    """Whether env NEE samples ``table`` by its exact texel CDF
    (ENV_EXACT_CDF_MAX_BYTES)."""
    h, w = table.shape0()
    return 3 * w * h * 4 <= ENV_EXACT_CDF_MAX_BYTES


def env_distribution_for(table) -> EnvDistribution:
    """THE proposal of env NEE, shared by the wavefront integrator and the
    fused kernels: the exact texel CDF, or past ENV_EXACT_CDF_MAX_BYTES the
    pooled coarse proposal, as sfvp_tpu picks it."""
    if env_exact_cdf(table):
        return build_env_distribution(table)
    return build_env_distribution(table, max_h=ENV_DIST_MAX_H)


def env_cell(dist: EnvDistribution, r_sel):
    """The cell a selection number picks, (N,) int64: the count of CDF
    entries <= r_sel (searchsorted, side "right"), at most H*W - 1; the
    kernels' binary search (csrc/common.cuh env_sample) counts the same."""
    ti = torch.searchsorted(dist.cdf, r_sel, right=True)
    return torch.clamp_max(ti, dist.width * dist.height - 1)


def sample_env(dist: EnvDistribution, r_sel, r1, r2):
    """Draw a world direction ~ the env importance distribution.

    Returns (direction 3-tuple, pdf_solid_angle). Directions use the
    equirect convention of textures.sample_environment: longitude from
    atan2(z, x), image row 0 at +y."""
    ti = env_cell(dist, r_sel)
    row = ti // dist.width
    col = ti % dist.width
    theta = (row.to(torch.float32) + r1) * f32(math.pi / dist.height)
    phi = ((col.to(torch.float32) + r2) * f32(2 * math.pi / dist.width)
           - f32(math.pi))
    st = torch.sin(theta)
    d = (st * torch.cos(phi), torch.cos(theta), st * torch.sin(phi))
    return d, dist.pdf_sa_at(ti, st)


def env_pdf(dist: EnvDistribution, d):
    """Solid-angle pdf the sampler above assigns to direction d (for MIS
    weighting of BSDF-path sky hits)."""
    dx, dy, dz = d
    u = torch.atan2(dz, dx) * f32(0.5 / math.pi) + 0.5
    theta = torch.acos(torch.clamp(dy, -1.0, 1.0))
    row = torch.clamp((theta * f32(dist.height / math.pi)).to(torch.int32),
                      0, dist.height - 1)
    col = torch.clamp(
        torch.remainder((u * dist.width).to(torch.int32), dist.width),
        0, dist.width - 1)
    return dist.pdf_sa_at((row * dist.width + col).long(), torch.sin(theta))
