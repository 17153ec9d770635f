"""Ray/triangle intersection in plain PyTorch: the counterpart of
sfvp_tpu.kernels.intersect and the closest-hit oracle of the integrator
and of the plain twins of the CUDA kernels.

Semantics matched (the reference's hardware ``traceRayEXT``,
ref shaders/raygen.rgen:63-75, main.cpp:414-538):
  - no backface culling (ref main.cpp:525); Moller-Trumbore accepts hits
    with either det sign
  - opaque geometry, closest hit wins; of equal t the lowest triangle id
  - valid window t in (t_min, t_max)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import vec
from ..utils.vec import f32

_DET_EPS = f32(1e-12)


class Hit(NamedTuple):
    t: torch.Tensor      # (N,) f32, +inf on miss
    prim: torch.Tensor   # (N,) int64, -1 on miss
    u: torch.Tensor      # (N,) f32 barycentric
    v: torch.Tensor      # (N,) f32 barycentric


def moller_trumbore_soa(o, d, p0, p1, p2, t_min, t_max):
    """SoA Moller-Trumbore, no culling. o, d, p0..p2 are component tuples
    with broadcastable shapes. Returns (valid, t, u, v)."""
    e1 = vec.sub(p1, p0)
    e2 = vec.sub(p2, p0)
    pv = vec.cross(d, e2)
    det = vec.dot(e1, pv)
    nonzero = torch.abs(det) > _DET_EPS
    inv_det = torch.where(nonzero, 1.0 / det, 0.0)
    tv = vec.sub(o, p0)
    u = vec.dot(tv, pv) * inv_det
    qv = vec.cross(tv, e1)
    v = vec.dot(d, qv) * inv_det
    t = vec.dot(e2, qv) * inv_det
    valid = (
        nonzero
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > f32(t_min))
        & (t < f32(t_max))
    )
    return valid, t, u, v


def trace_brute(o, d, scene, t_min, t_max, active=None) -> Hit:
    """Closest hit of every ray over all triangles of ``scene``
    (SceneBuffers), as one broadcast (rays x triangles) Moller-Trumbore.
    argmin keeps the first of equal distances, as the JAX package's
    sequential ``t < best`` scan does.

    o, d: component tuples of (N,) tensors.
    """
    n = scene.num_tris

    def col(name):
        return getattr(scene, name)[:n].unsqueeze(0)          # (1, T)

    p0 = (col("v0x"), col("v0y"), col("v0z"))
    p1 = (col("v1x"), col("v1y"), col("v1z"))
    p2 = (col("v2x"), col("v2y"), col("v2z"))
    o2 = tuple(a.unsqueeze(1) for a in o)                      # (N, 1)
    d2 = tuple(a.unsqueeze(1) for a in d)
    valid, t, u, v = moller_trumbore_soa(o2, d2, p0, p1, p2, t_min, t_max)
    t = torch.where(valid, t, float("inf"))
    prim = torch.argmin(t, dim=1, keepdim=True)
    bt = torch.gather(t, 1, prim).squeeze(1)
    prim = prim.squeeze(1)
    miss = torch.isinf(bt)
    bu = torch.where(miss, 0.0, torch.gather(u, 1, prim[:, None]).squeeze(1))
    bv = torch.where(miss, 0.0, torch.gather(v, 1, prim[:, None]).squeeze(1))
    prim = torch.where(miss, -1, prim)
    if active is not None:
        bt = torch.where(active, bt, float("inf"))
        prim = torch.where(active, prim, -1)
    return Hit(t=bt, prim=prim, u=bu, v=bv)
