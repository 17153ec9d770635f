"""Wavefront path-tracing integrator in plain PyTorch: the parity subset of
sfvp_tpu.integrate.wavefront and the port's in-package oracle.

A wave of rays (pixels x samples) advances in lockstep through
trace -> shade, vectorised over the wave; terminated rays are masked.
``trace_wave`` is also the body of the plain twins of the CUDA kernels
(kernels/megakernel.py, kernels/megakernel_regen.py): it takes the colour
to add into, so a twin can reproduce its kernel's summation order.

Parity-mode semantics preserved exactly (ref shaders/raygen.rgen:41-91):
  - color += weight * emission on EVERY segment, including the miss segment
    (sky (0.7,0.6,0.5), ref shaders/miss.rmiss:10)
  - emissive hits do NOT terminate the path; only a miss (or the depth cap)
    does
  - uniform hemisphere sampling, weight *= brdf * cos(theta) * 2*pi
  - hit position from barycentrics, geometric normal =
    -normalize(cross(e01, e02)) (ref shaders/closesthit.rchit:43-57)
  - progressive accumulation new = (color + old*frame)/(frame+1), in f32

The subset is diffuse and mirror materials, uniform and cosine sampling,
and Russian roulette. Everything else raises NotImplementedError in
``require_slice`` and never falls back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import rng
from ..camera import generate_rays_soa
from ..config import RenderConfig
from ..kernels.intersect import trace_brute
from ..sampling import (
    INV_PI,
    TWO_PI,
    sample_direction_cosine_soa,
    sample_direction_uniform_soa,
)
from ..utils import vec
from ..utils.vec import f32

# brdf * cos / pdf of uniform sampling: Kd/pi * cos * 2pi, the float32
# product the JAX package forms as (INV_PI * TWO_PI)
UNIFORM_SCALE = float(np.float32(INV_PI) * np.float32(TWO_PI))


class RenderState(NamedTuple):
    accum: torch.Tensor    # (H, W, 3) f32 running mean over steps
    frame: int             # progressive step counter
    mrays: torch.Tensor    # () f32 cumulative traced segments / 1e6


def init_state(height: int, width: int, device) -> RenderState:
    return RenderState(
        accum=torch.zeros((height, width, 3), dtype=torch.float32,
                          device=device),
        frame=0,
        mrays=torch.zeros((), dtype=torch.float32, device=device),
    )


def require_slice(cfg: RenderConfig, scene) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item that brings it,
    for any feature this package does not run yet."""
    todo = []
    if cfg.use_nee or cfg.use_mis:
        todo.append("next-event estimation / MIS (ROADMAP.md A.11)")
    if cfg.camera.lens_radius > 0.0:
        todo.append("thin-lens depth of field (ROADMAP.md A.12)")
    mt = scene.mtype[: scene.num_tris].cpu().numpy()
    if np.any(mt >= 2):
        todo.append("GGX glossy and dielectric materials (ROADMAP.md A.12)")
    if cfg.traversal == "bvh" or scene.num_tris > cfg.brute_force_max_tris:
        todo.append(
            f"BVH traversal ({scene.num_tris} triangles, brute force takes "
            f"<= {cfg.brute_force_max_tris}; ROADMAP.md A.9-A.10)")
    if todo:
        raise NotImplementedError(
            "not ported to sfvp_tpu_torch yet: " + "; ".join(todo))
    if cfg.sampling not in ("uniform", "cosine"):
        raise ValueError(f"unknown sampling {cfg.sampling!r}")
    cfg.spp_chunks()  # raises on a chunk that does not divide spp


def has_mirror_faces(scene) -> bool:
    return bool((scene.mtype[: scene.num_tris] == 1).any())


def shade_inputs(scene, hit):
    """Gather per-hit shading data (SoA), mirroring the closest-hit shader
    (ref shaders/closesthit.rchit:50-65) plus the mirror extension."""
    prim = torch.clamp_min(hit.prim, 0)
    p0 = (scene.v0x[prim], scene.v0y[prim], scene.v0z[prim])
    p1 = (scene.v1x[prim], scene.v1y[prim], scene.v1z[prim])
    p2 = (scene.v2x[prim], scene.v2y[prim], scene.v2z[prim])
    w = 1.0 - hit.u - hit.v
    position = vec.add(
        vec.add(vec.scale(p0, w), vec.scale(p1, hit.u)), vec.scale(p2, hit.v)
    )
    normal = vec.scale(
        vec.normalize(vec.cross(vec.sub(p1, p0), vec.sub(p2, p0))), -1.0
    )
    diffuse = (scene.dr[prim], scene.dg[prim], scene.db[prim])
    emission = (scene.er[prim], scene.eg[prim], scene.eb[prim])
    specular = (scene.sr[prim], scene.sg[prim], scene.sb[prim])
    return position, normal, diffuse, emission, specular, scene.mtype[prim]


def trace_wave(cfg: RenderConfig, scene, px, py, sample_ids, frame: int,
               global_shape, color=None, has_mirrors: bool = False,
               rr_every_depth: bool = True):
    """Trace one wave of camera paths: ray i is sample ``sample_ids[i]`` of
    global pixel (px[i], py[i]). Each segment's radiance is added into
    ``color`` (zeros when None) in depth order.

    ``rr_every_depth``: draw the roulette number at every depth, as the
    wavefront integrator and K1 do; K2 draws it only from rr_start_depth
    on (sfvp_tpu/kernels/megakernel.py:336), which shifts its later draws.

    Returns (color tuple of (M,) f32, segments traced per ray (M,) int32).
    """
    gh, gw = global_shape
    uniform = cfg.sampling == "uniform"
    t_min, t_max = cfg.t_min, cfg.t_max
    seed = rng.sample_seed(px, py, sample_ids, frame, cfg.spp_per_step)
    r1, seed = rng.rand(seed)
    r2, seed = rng.rand(seed)
    o, d = generate_rays_soa(px, py, r1, r2, cfg.camera, gw, gh)
    weight = vec.splat((1.0, 1.0, 1.0), like=o[0])
    if color is None:
        color = vec.splat((0.0, 0.0, 0.0), like=o[0])
    sky = vec.splat([f32(s) for s in cfg.sky_emission], like=o[0])
    done = torch.zeros(o[0].shape, dtype=torch.bool, device=o[0].device)
    segs = torch.zeros(o[0].shape, dtype=torch.int32, device=o[0].device)

    for depth in range(cfg.max_depth):
        active = torch.logical_not(done)
        hit = trace_brute(o, d, scene, t_min, t_max, active=active)
        miss = hit.prim < 0
        position, normal, diffuse, emission, spec, mtype = shade_inputs(
            scene, hit)
        emission = vec.where(miss, sky, emission)
        emit_w = active.to(torch.float32)
        color = vec.add(color, vec.scale(vec.mul(weight, emission), emit_w))

        r1, seed = rng.rand(seed)
        r2, seed = rng.rand(seed)
        if uniform:
            new_dir = sample_direction_uniform_soa(r1, r2, normal)
            cos_t = vec.dot(new_dir, normal)
            scale = vec.scale(diffuse, UNIFORM_SCALE * cos_t)
        else:
            new_dir = sample_direction_cosine_soa(r1, r2, normal)
            scale = diffuse  # pdf = cos/pi cancels the cosine
        if has_mirrors:
            # perfect mirror: reflect about the normal flipped toward the
            # incoming ray (geometry is double-sided)
            is_mirror = (mtype == 1) & torch.logical_not(miss)
            n_dot_d = vec.dot(d, normal)
            n_f = vec.where(n_dot_d > 0, vec.scale(normal, -1.0), normal)
            refl = vec.sub(d, vec.scale(n_f, 2.0 * vec.dot(d, n_f)))
            new_dir = vec.where(is_mirror, refl, new_dir)
            scale = vec.where(is_mirror, spec, scale)

        cont = active & torch.logical_not(miss)
        rr_on = depth >= cfg.rr_start_depth
        if cfg.use_rr and (rr_on or rr_every_depth):
            p = torch.clamp(vec.maxc(vec.mul(weight, scale)), 0.05, 0.95)
            r_rr, seed = rng.rand(seed)
            if rr_on:
                cont = cont & (r_rr < p)
                scale = vec.scale(scale, 1.0 / p)

        o = vec.where(cont, position, o)
        d = vec.where(cont, new_dir, d)
        weight = vec.where(cont, vec.mul(weight, scale), weight)
        done = torch.logical_not(cont)
        segs += active.to(torch.int32)
    return color, segs


def accumulate(state: RenderState, color_sum, segs: torch.Tensor,
               spp: int) -> RenderState:
    """Fold one step's per-pixel colour sums into the running mean.

    The JAX driver donates the state to the jitted step; the counterpart
    here is that ``state.accum`` is updated IN PLACE and returned in the
    new state, so a step consumes the state it is given. In IEEE f32,
    (accum*f + color)/(f+1) is bitwise the JAX package's
    (color + accum*f)/(f+1).

    ``segs``: the step's traced segments as an int64 count; it is added to
    the f32 ``mrays`` field once per step, so a step's ~1e8 segments are
    rounded to f32 once, not summed in it.
    """
    h, w = state.accum.shape[:2]

    def const(x):
        # a divisor on the device: PyTorch's CUDA division by a Python
        # scalar multiplies by its reciprocal, which rounds differently
        return torch.tensor(x, dtype=torch.float32, device=state.accum.device)

    color = vec.to_array(tuple(c.reshape(h, w) for c in color_sum))
    color = color / const(spp)
    f = float(state.frame)
    accum = state.accum.mul_(f).add_(color).div_(const(f + 1.0))
    mrays = state.mrays + segs.to(torch.float32) / const(1e6)
    return RenderState(accum=accum, frame=state.frame + 1, mrays=mrays)


def sum_chunks(cfg: RenderConfig, npix: int, wave, device):
    """One step's per-pixel colour totals and int64 segment total, chunk
    by chunk in the order of sfvp_tpu's wavefront loop: each chunk's
    samples are summed per pixel, then the chunks are added in sequence.

    ``wave(chunk_idx) -> (colr, colg, colb, segs)`` traces one chunk, ray i
    being sample chunk_idx*spp_chunk + i // npix of local pixel i % npix.
    """
    chunk = cfg.spp_chunk
    color = vec.splat((0.0, 0.0, 0.0), like=torch.empty(npix, device=device))
    segs = torch.zeros((), dtype=torch.int64, device=device)
    for chunk_idx in range(cfg.spp_chunks()):
        *wc, seg = wave(chunk_idx)
        color = vec.add(color, tuple(c.reshape(chunk, npix).sum(dim=0)
                                     for c in wc))
        segs = segs + seg.sum(dtype=torch.int64)
    return color, segs


def make_render_step(cfg: RenderConfig, scene,
                     global_shape: Optional[tuple] = None):
    """Build ``render_step(state, row0=0) -> state`` for a (local) image of
    the shape of ``state.accum``, on the device of ``scene``.

    ``row0`` is the global row offset of this accumulator band; rays are
    generated in GLOBAL pixel coordinates of ``global_shape`` (default: the
    config's), so a band renders bitwise the rows of the full image.
    """
    require_slice(cfg, scene)
    gshape = global_shape if global_shape is not None else (cfg.height,
                                                            cfg.width)
    chunk = cfg.spp_chunk
    mirrors = has_mirror_faces(scene)
    dev = scene.device

    def render_step(state: RenderState, row0: int = 0) -> RenderState:
        h, w = state.accum.shape[0], state.accum.shape[1]
        n = h * w
        idx = torch.arange(n, device=dev)
        px = (idx % w).repeat(chunk)
        py = (idx // w + row0).repeat(chunk)

        def wave(chunk_idx):
            s_ids = (chunk_idx * chunk
                     + torch.arange(chunk, device=dev)).repeat_interleave(n)
            color, seg = trace_wave(cfg, scene, px, py, s_ids, state.frame,
                                    gshape, has_mirrors=mirrors)
            return (*color, seg)

        color_sum, segs = sum_chunks(cfg, n, wave, dev)
        return accumulate(state, color_sum, segs, cfg.spp_per_step)

    return render_step
