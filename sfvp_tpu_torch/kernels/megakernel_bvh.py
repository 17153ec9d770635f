"""K5 and K9, the path-tracing kernel with in-thread sample regeneration
over the 8-wide BVH (K5, the port's default route for large scenes) or
over the two-level BVH of an instanced scene (K9, the default route of
instanced scenes).

``bvh_regen_render`` (K5) and ``tlas_regen_render`` (K9) trace all
``spp`` samples of every pixel of a (local) image and return each pixel's
colour total and segment count: on a CUDA device through the hand-written
kernel csrc/bvh_regen_render.cu, on the CPU through the plain PyTorch twin
``bvh_regen_render_plain``, which is K1's twin with the brute-force trace
swapped for a payload trace through the trace hook of
integrate.wavefront.trace_wave: K3's twin (``packet_trace_plain``) over a
wide BVH, K7's (``two_level_trace_plain``) over a two-level one. Each
sample's radiance is added straight into the pixel total, K1's order.

Counterpart of sfvp_tpu/kernels/megakernel_bvh.py
(make_bvh_regen_render_step, single-level and with ``tl=``), for diffuse
and mirror materials, uniform and cosine sampling, Russian roulette with a
roulette number drawn at every bounce, and next-event estimation with MIS,
whose shadow rays take the any-hit walk of K4 (the twin's
``packet_occlusion_plain``) or of K8 (``two_level_occlusion_plain``). As in
K1, any number of lights runs in the kernel (ROADMAP.md A.19). K5 also
runs K1's environment sky, environment NEE and map_Kd textures (a textured
tree's ``tris_aux`` rows, megakernel_bvh.py:303-400) at any map size;
sfvp_tpu's deferred env records and its wavefront route for env NEE on an
oversized map (dispatch.py:303-316) draw the same streams and have no
counterpart. K9 refuses both until ROADMAP.md A.13b.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import RenderConfig
from ..integrate.lights import (
    EnvDistribution,
    LightTable,
    build_light_table_from_buffers,
    env_distribution_for,
)
from ..integrate.wavefront import (
    RenderState,
    accumulate,
    has_mirror_faces,
    payload_surface,
    trace_wave,
)
from . import build
from .megakernel_regen import check_images
from .bvh_packet import (
    DeviceWide,
    packet_occlusion_plain,
    packet_trace_plain,
    payload_from_planes,
    ray_planes,
)
from .bvh_tlas import (
    DeviceTwoLevel,
    two_level_occlusion_plain,
    two_level_trace_plain,
)


def bvh_regen_render_plain(dw, frame: int, row0: int, *,
                           cfg: RenderConfig, global_shape, npix: int,
                           has_mirrors: bool,
                           lights: Optional[LightTable] = None,
                           env=None,
                           env_dist: Optional[EnvDistribution] = None,
                           textures=None, counts: Optional[dict] = None):
    """Plain PyTorch twin of the K5 kernel (``dw`` a DeviceWide) and of
    the K9 kernel (``dw`` a DeviceTwoLevel): same arguments, same results.
    Samples run one wave at a time, each adding into the running per-pixel
    totals, which is the kernel's summation order; NEE in the kernel's
    float order. ``env``, ``env_dist``, ``textures``: K1's
    (megakernel_regen.regen_render_plain), the texture coordinates from
    the textured tree's payload. ``counts`` gathers the traversal's pops (the closest-hit
    twin's) and the segments that hit ("hits"), and under NEE the shadow
    rays ("shadow_rays") and their pops ("shadow_node_pops", ...). Returns
    (colr, colg, colb, segs), each (npix,)."""
    if isinstance(dw, DeviceTwoLevel):
        trace_plain, occlusion_plain = (two_level_trace_plain,
                                        two_level_occlusion_plain)
    else:
        trace_plain, occlusion_plain = packet_trace_plain, packet_occlusion_plain
    gw = global_shape[1]
    dev = dw.device
    pix = torch.arange(npix, device=dev)
    px = pix % gw
    py = pix // gw + row0

    def trace(o, d, t_max, active=None):
        planes = trace_plain(dw, cfg.t_min, ray_planes(o, d, t_max, active),
                             counts)
        if counts is not None:
            counts["hits"] = (counts.get("hits", 0)
                              + int(torch.isfinite(planes[0]).sum()))
        return payload_from_planes(planes)

    shadow = None if counts is None else {}

    def occluded(o, d, t_max, active):
        if shadow is not None:
            shadow["rays"] = shadow.get("rays", 0) + int(active.sum())
        occ = occlusion_plain(
            dw, cfg.t_min, ray_planes(o, d, t_max, active), shadow)
        return occ & active

    surface = payload_surface(cfg, trace, textures)
    color = None
    segs = torch.zeros(npix, dtype=torch.int32, device=dev)
    for s in range(cfg.spp_per_step):
        color, seg = trace_wave(cfg, None, px, py, s, frame, global_shape,
                                color=color, has_mirrors=has_mirrors,
                                surface=surface, lights=lights,
                                occluded=occluded, fused_nee=True, env=env,
                                env_dist=env_dist)
        segs += seg
    if shadow:
        counts.update({f"shadow_{k}": v for k, v in shadow.items()})
    return (*color, segs)


def _render(fn_name, params_of, dw, frame, row0, cfg, global_shape, npix,
            has_mirrors, lights, env=None, env_dist=None, textures=None):
    """Launch K5 or K9 (``fn_name``) over the tree's params
    (``params_of``, a build.*_params)."""
    tp = params_of(dw, cfg.t_min)
    params = build.make_params(
        cfg, frame=frame, row0=row0, global_shape=global_shape, npix=npix,
        num_tris=0, tp=0, lights=lights, env=env, env_dist=env_dist,
        textures=textures)
    check_images(params, tp.device, env, env_dist, textures)
    if params.use_nee:
        build.check_lights(lights.rows, tp.device)
    return build.launch(fn_name, tp, params, has_mirrors, npix,
                        lights=lights.rows if params.use_nee else None)


def bvh_regen_render(dw: DeviceWide, frame: int, row0: int, *,
                     cfg: RenderConfig, global_shape, npix: int,
                     has_mirrors: bool, lights: Optional[LightTable] = None,
                     env=None, env_dist: Optional[EnvDistribution] = None,
                     textures=None):
    """K5 on the BVH's device: the CUDA kernel for CUDA tensors (or an
    error), the plain twin for CPU tensors. ``lights``: the scene's light
    table on the same device, for ``cfg.use_nee``; ``env``, ``env_dist``:
    its environment map and the map's NEE distribution; ``textures``: the
    texture pool of a textured tree (``dw.tris_aux``).
    ``bvh_regen_render.launches`` counts kernel launches."""
    if (dw.tris_aux is None) != (textures is None):
        raise ValueError("a textured tree (tris_aux) comes with its texture "
                         "pool, and only it")
    if dw.device.type == "cpu":
        return bvh_regen_render_plain(
            dw, frame, row0, cfg=cfg, global_shape=global_shape, npix=npix,
            has_mirrors=has_mirrors, lights=lights, env=env,
            env_dist=env_dist, textures=textures)
    out = _render("sfvp_bvh_regen_render", build.wide_params, dw, frame, row0,
                  cfg, global_shape, npix, has_mirrors, lights, env, env_dist,
                  textures)
    bvh_regen_render.launches += 1
    return out


bvh_regen_render.launches = 0


def tlas_regen_render(dt: DeviceTwoLevel, frame: int, row0: int, *,
                      cfg: RenderConfig, global_shape, npix: int,
                      has_mirrors: bool, lights: Optional[LightTable] = None):
    """K9 on the two-level BVH's device: the CUDA kernel for CUDA tensors
    (or an error), the plain twin for CPU tensors. ``lights``: the
    flattened scene's light table on the same device, for ``cfg.use_nee``.
    ``tlas_regen_render.launches`` counts kernel launches."""
    if dt.device.type == "cpu":
        return bvh_regen_render_plain(
            dt, frame, row0, cfg=cfg, global_shape=global_shape, npix=npix,
            has_mirrors=has_mirrors, lights=lights)
    out = _render("sfvp_tlas_regen_render", build.two_level_params, dt, frame,
                  row0, cfg, global_shape, npix, has_mirrors, lights)
    tlas_regen_render.launches += 1
    return out


tlas_regen_render.launches = 0


def make_bvh_regen_render_step(cfg: RenderConfig, buffers,
                               wide: Optional[DeviceWide] = None,
                               global_shape: Optional[tuple] = None,
                               tl: Optional[DeviceTwoLevel] = None):
    """Progressive render step driven by K5 (``wide``: the scene's wide
    BVH on the device of ``buffers``, bvh_packet.device_wide) or, for an
    instanced scene, by K9 (``tl``: its two-level BVH,
    bvh_tlas.device_two_level, with ``buffers`` the FLATTENED scene's,
    which give the materials and the light table): ``render_step(state,
    row0=0) -> state``, one kernel launch per step. The config is checked
    by dispatch. With ``cfg.use_nee`` the scene's light table is built and
    placed on its device once, here, and so is the environment's
    distribution under NEE (K5)."""
    if (wide is None) == (tl is None):
        raise ValueError("make_bvh_regen_render_step traces one tree: pass "
                         "either wide= (K5) or tl= (K9)")
    gshape = global_shape if global_shape is not None else (cfg.height,
                                                            cfg.width)
    has_mirrors = has_mirror_faces(buffers)
    lights = build_light_table_from_buffers(buffers) if cfg.use_nee else None
    if tl is None:
        env_dist = (env_distribution_for(buffers.env)
                    if cfg.use_nee and buffers.env is not None else None)
        images = dict(env=buffers.env, env_dist=env_dist,
                      textures=(buffers.textures if wide.tris_aux is not None
                                else None))
        render, tree = bvh_regen_render, wide
    else:
        from ..dispatch import require_single_level_images

        require_single_level_images(buffers)
        images = {}
        render, tree = tlas_regen_render, tl

    def render_step(state: RenderState, row0: int = 0) -> RenderState:
        h, w = state.accum.shape[0], state.accum.shape[1]
        *color, segs = render(
            tree, state.frame, row0, cfg=cfg, global_shape=gshape,
            npix=h * w, has_mirrors=has_mirrors, lights=lights, **images)
        return accumulate(state, color, segs.sum(dtype=torch.int64),
                          cfg.spp_per_step)

    return render_step
