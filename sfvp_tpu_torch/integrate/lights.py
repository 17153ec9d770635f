"""Area-light table for next-event estimation (NEE), the area-light half of
sfvp_tpu.integrate.lights (lights.py:21-115). Environment-map NEE comes
with environment maps (ROADMAP.md A.13).

NEE is an extension over the reference integrator (which relies purely on
BSDF sampling hitting the light, ref shaders/raygen.rgen:62-84): at each
diffuse hit a point is sampled on an emissive triangle (area-weighted),
its visibility is tested with a shadow ray, and the direct contribution
f * Le * G / pdf is added. To stay unbiased, BSDF-path emission is then
only counted on camera rays and after specular bounces. Lights are treated
as double-sided, matching the reference's facing-cull-disable behavior
(ref main.cpp:525).

The table is built by the JAX package's NumPy code, line for line, so its
CDF and ``total_area`` (a Python float summed from float32 areas) are bit
for bit the same, and so is every float32 constant derived from them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

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
