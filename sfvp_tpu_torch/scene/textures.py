"""Texture tables and filtered sampling (extension; the reference has no
textures, its materials are flat Kd/Ke, ref main.cpp:47-56), the
counterpart of sfvp_tpu.scene.textures.

All images are flattened into ONE structure-of-arrays texel pool (three
(N,) float32 channel columns) plus a per-texture (offset, width, height)
descriptor table, on one device. Sampling a batch of hits is then a few
gathers over the pool, any mix of sizes. UV convention: OBJ origin at the
bottom left; wrap (repeat) addressing; bilinear filtering. An environment
map is texture 0 of a table of its own.

The CUDA kernels read the same pool (csrc/common.cuh texel_bilinear,
env_lookup) and keep this module's operation order, so on the card the
kernels and these functions agree bit for bit.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.vec import f32

# float32 constants of the equirect mapping, as sfvp_tpu forms them
INV_TWO_PI = f32(0.5 / math.pi)
INV_PI = f32(1.0 / math.pi)


class TextureTable(NamedTuple):
    tr: torch.Tensor      # (N,) f32 texel red (linear)
    tg: torch.Tensor      # (N,) f32
    tb: torch.Tensor      # (N,) f32
    off: torch.Tensor     # (K,) i32 first texel of each texture
    width: torch.Tensor   # (K,) i32
    height: torch.Tensor  # (K,) i32
    # (height, width) of each texture as Python ints, known at upload, so
    # that a launch reads a map's size without a copy from the device
    dims: Tuple[Tuple[int, int], ...]

    @property
    def num_textures(self) -> int:
        return int(self.off.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tr.device

    def shape0(self):
        """(height, width) of texture 0 as Python ints (an environment
        map's)."""
        return self.dims[0]

    @property
    def tensors(self):
        """The table's six tensors, in field order."""
        return self[:-1]

    def to(self, device) -> "TextureTable":
        return TextureTable(*(a.to(device) for a in self.tensors), self.dims)


def table_from_arrays(tr, tg, tb, off, width, height,
                      device) -> TextureTable:
    """A table from host arrays (numpy, or anything ``np.asarray`` reads,
    such as the fields of sfvp_tpu's TextureTable) on ``device``."""
    def col(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)

    width, height = np.asarray(width, np.int32), np.asarray(height, np.int32)
    dims = tuple(zip(height.tolist(), width.tolist()))
    return TextureTable(col(tr, np.float32), col(tg, np.float32),
                        col(tb, np.float32), col(off, np.int32),
                        col(width, np.int32), col(height, np.int32), dims)


def build_texture_table(paths: List[str], device,
                        srgb: bool = True) -> Optional[TextureTable]:
    """Load every image and pack the SoA pool on ``device``; None when
    ``paths`` is empty."""
    if not paths:
        return None
    from .image_io import load_image

    chans = [[], [], []]
    off, width, height = [], [], []
    total = 0
    for p in paths:
        img = load_image(p, srgb=srgb)  # (H, W, 3) f32 linear
        h, w = img.shape[:2]
        off.append(total)
        width.append(w)
        height.append(h)
        flat = img.reshape(-1, 3)
        for c in range(3):
            chans[c].append(np.ascontiguousarray(flat[:, c]))
        total += h * w
    return table_from_arrays(*(np.concatenate(c) for c in chans), off, width,
                             height, device=device)


def equirect_uv(table: TextureTable, d):
    """The (u, v) an equirect map is read at in direction ``d`` (unit
    vectors, y-up): longitude from atan2(z, x), latitude from acos(y),
    v clamped to the band of texel centres so that the sampler's repeat
    wrap never blends the poles together."""
    dx, dy, dz = d
    u = torch.atan2(dz, dx) * INV_TWO_PI + 0.5
    # OBJ-convention v runs bottom-up; acos(y)/pi is 0 at +y (the top)
    v = 1.0 - torch.acos(torch.clamp(dy, -1.0, 1.0)) * INV_PI
    h = table.height[0].to(torch.float32)
    return u, torch.clamp(v, 0.5 / h, 1.0 - 0.5 / h)


def sample_environment(table: TextureTable, d):
    """Equirectangular environment lookup for miss directions (extension;
    the reference sky is the constant (0.7, 0.6, 0.5), ref miss.rmiss:10):
    ``sample_bilinear`` of texture 0 at ``equirect_uv``."""
    u, v = equirect_uv(table, d)
    zero_id = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    return sample_bilinear(table, zero_id, u, v)


def bilinear_taps(table: TextureTable, tex_id, u, v):
    """The four texel indices of a bilinear fetch and their weights:
    ((i00, i10, i01, i11), (w00, w10, w01, w11)), wrap (repeat)
    addressing inside each texture, v from the bottom."""
    tid = torch.clamp_min(tex_id, 0).long()
    wi = table.width[tid]
    hi = table.height[tid]
    w = wi.to(torch.float32)
    h = hi.to(torch.float32)
    base = table.off[tid]
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    x = uu * w - 0.5
    y = (1.0 - vv) * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    def wrap(i, n):
        # torch.remainder keeps the divisor's sign, as jnp.mod does
        return torch.remainder(i.to(torch.int32), n)

    x0i, x1i = wrap(x0, wi), wrap(x0 + 1, wi)
    y0i, y1i = wrap(y0, hi), wrap(y0 + 1, hi)

    def idx(yi, xi):
        return (base + yi * wi + xi).long()

    taps = (idx(y0i, x0i), idx(y0i, x1i), idx(y1i, x0i), idx(y1i, x1i))
    weights = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
    return taps, weights


def blend(chans, taps, weights):
    """a*w00 + b*w10 + c*w01 + d*w11 per channel of ``chans``, the texels
    at ``taps``, in sfvp_tpu's order."""
    w00, w10, w01, w11 = weights
    out = []
    for ch in chans:
        a, b, c, d = (ch[i] for i in taps)
        out.append(a * w00 + b * w10 + c * w01 + d * w11)
    return tuple(out)


def sample_bilinear(table: TextureTable, tex_id, u, v):
    """Bilinear-filtered fetch, SoA over hits: (tex_id (N,) i32, u, v (N,)
    f32) -> (r, g, b). tex_id < 0 samples white (untextured)."""
    taps, weights = bilinear_taps(table, tex_id, u, v)
    out = blend((table.tr, table.tg, table.tb), taps, weights)
    white = tex_id < 0
    return tuple(torch.where(white, 1.0, o) for o in out)
