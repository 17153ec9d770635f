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
        & (t < (t_max if torch.is_tensor(t_max) else f32(t_max)))
    )
    return valid, t, u, v


def _all_tests(o, d, scene, t_min, t_max):
    """Moller-Trumbore of every ray against every triangle of ``scene``:
    (valid, t, u, v), each (N, T)."""
    n = scene.num_tris
    if torch.is_tensor(t_max):
        t_max = t_max.unsqueeze(1)                             # (N, 1)

    def col(name):
        return getattr(scene, name)[:n].unsqueeze(0)          # (1, T)

    p0 = (col("v0x"), col("v0y"), col("v0z"))
    p1 = (col("v1x"), col("v1y"), col("v1z"))
    p2 = (col("v2x"), col("v2y"), col("v2z"))
    o2 = tuple(a.unsqueeze(1) for a in o)                      # (N, 1)
    d2 = tuple(a.unsqueeze(1) for a in d)
    return moller_trumbore_soa(o2, d2, p0, p1, p2, t_min, t_max)


def trace_brute(o, d, scene, t_min, t_max, active=None) -> Hit:
    """Closest hit of every ray over all triangles of ``scene``
    (SceneBuffers), as one broadcast (rays x triangles) Moller-Trumbore.
    argmin keeps the first of equal distances, as the JAX package's
    sequential ``t < best`` scan does.

    o, d: component tuples of (N,) tensors; t_max: a scalar or an (N,)
    tensor (a shadow ray's distance to its light sample).
    """
    valid, t, u, v = _all_tests(o, d, scene, t_min, t_max)
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


def any_hit_tests(o, d, scene, t_min, t_max, active) -> int:
    """The triangle tests that a scan in id order stopping at its first hit
    (the CUDA kernels' brute_any_hit, csrc/common.cuh) takes over the
    ``active`` rays: for each, the first hit triangle's id plus one, or
    every triangle. A count for a kernel's bound, not a result."""
    valid = _all_tests(o, d, scene, t_min, t_max)[0][active]
    first = torch.where(valid.any(1), valid.int().argmax(1) + 1,
                        scene.num_tris)
    return int(first.sum(dtype=torch.int64))
