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
K1, any number of lights runs in the kernel (ROADMAP.md A.19).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import RenderConfig
from ..integrate.lights import LightTable, build_light_table_from_buffers
from ..integrate.wavefront import (
    RenderState,
    accumulate,
    has_mirror_faces,
    payload_surface,
    trace_wave,
)
from . import build
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
                           counts: Optional[dict] = None):
    """Plain PyTorch twin of the K5 kernel (``dw`` a DeviceWide) and of
    the K9 kernel (``dw`` a DeviceTwoLevel): same arguments, same results.
    Samples run one wave at a time, each adding into the running per-pixel
    totals, which is the kernel's summation order; NEE in the kernel's
    float order. ``counts`` gathers the traversal's pops (the closest-hit
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

    surface = payload_surface(cfg, trace)
    color = None
    segs = torch.zeros(npix, dtype=torch.int32, device=dev)
    for s in range(cfg.spp_per_step):
        color, seg = trace_wave(cfg, None, px, py, s, frame, global_shape,
                                color=color, has_mirrors=has_mirrors,
                                surface=surface, lights=lights,
                                occluded=occluded, fused_nee=True)
        segs += seg
    if shadow:
        counts.update({f"shadow_{k}": v for k, v in shadow.items()})
    return (*color, segs)


def _render(fn_name, params_of, dw, frame, row0, cfg, global_shape, npix,
            has_mirrors, lights):
    """Launch K5 or K9 (``fn_name``) over the tree's params
    (``params_of``, a build.*_params)."""
    tp = params_of(dw, cfg.t_min)
    params = build.make_params(
        cfg, frame=frame, row0=row0, global_shape=global_shape, npix=npix,
        num_tris=0, tp=0, lights=lights)
    if params.use_nee:
        build.check_lights(lights.rows, tp.device)
    return build.launch(fn_name, tp, params, has_mirrors, npix,
                        lights=lights.rows if params.use_nee else None)


def bvh_regen_render(dw: DeviceWide, frame: int, row0: int, *,
                     cfg: RenderConfig, global_shape, npix: int,
                     has_mirrors: bool, lights: Optional[LightTable] = None):
    """K5 on the BVH's device: the CUDA kernel for CUDA tensors (or an
    error), the plain twin for CPU tensors. ``lights``: the scene's light
    table on the same device, for ``cfg.use_nee``.
    ``bvh_regen_render.launches`` counts kernel launches."""
    if dw.device.type == "cpu":
        return bvh_regen_render_plain(
            dw, frame, row0, cfg=cfg, global_shape=global_shape, npix=npix,
            has_mirrors=has_mirrors, lights=lights)
    out = _render("sfvp_bvh_regen_render", build.wide_params, dw, frame, row0,
                  cfg, global_shape, npix, has_mirrors, lights)
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
    placed on its device once, here."""
    if (wide is None) == (tl is None):
        raise ValueError("make_bvh_regen_render_step traces one tree: pass "
                         "either wide= (K5) or tl= (K9)")
    render, tree = ((bvh_regen_render, wide) if tl is None
                    else (tlas_regen_render, tl))
    gshape = global_shape if global_shape is not None else (cfg.height,
                                                            cfg.width)
    has_mirrors = has_mirror_faces(buffers)
    lights = build_light_table_from_buffers(buffers) if cfg.use_nee else None

    def render_step(state: RenderState, row0: int = 0) -> RenderState:
        h, w = state.accum.shape[0], state.accum.shape[1]
        *color, segs = render(
            tree, state.frame, row0, cfg=cfg, global_shape=gshape,
            npix=h * w, has_mirrors=has_mirrors, lights=lights)
        return accumulate(state, color, segs.sum(dtype=torch.int64),
                          cfg.spp_per_step)

    return render_step
