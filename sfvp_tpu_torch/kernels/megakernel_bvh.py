"""K5, the path-tracing kernel with in-thread sample regeneration over the
8-wide BVH: the port's default route for large scenes.

``bvh_regen_render`` traces all ``spp`` samples of every pixel of a
(local) image and returns each pixel's colour total and segment count: on
a CUDA device through the hand-written kernel csrc/bvh_regen_render.cu,
on the CPU through its plain PyTorch twin ``bvh_regen_render_plain``,
which is K1's twin with the brute-force trace swapped for K3's twin
(``packet_trace_plain``) through the trace hook of
integrate.wavefront.trace_wave. Each sample's radiance is added straight
into the pixel total, K1's order.

Counterpart of sfvp_tpu/kernels/megakernel_bvh.py
(make_bvh_regen_render_step), single-level, for diffuse and mirror
materials, uniform and cosine sampling, Russian roulette with a roulette
number drawn at every bounce, and next-event estimation with MIS, whose
shadow rays take the any-hit walk of K4 (the twin's
``packet_occlusion_plain``). As in K1, any number of lights runs in the
kernel (ROADMAP.md A.19).
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


def bvh_regen_render_plain(dw: DeviceWide, frame: int, row0: int, *,
                           cfg: RenderConfig, global_shape, npix: int,
                           has_mirrors: bool,
                           lights: Optional[LightTable] = None,
                           counts: Optional[dict] = None):
    """Plain PyTorch twin of the K5 kernel: same arguments, same results.
    Samples run one wave at a time, each adding into the running per-pixel
    totals, which is the kernel's summation order; NEE in the kernel's
    float order. ``counts`` gathers the traversal's pops
    (packet_trace_plain), and under NEE the shadow rays ("shadow_rays")
    and their pops ("shadow_node_pops", "shadow_leaf_pops"). Returns
    (colr, colg, colb, segs), each (npix,)."""
    gw = global_shape[1]
    dev = dw.device
    pix = torch.arange(npix, device=dev)
    px = pix % gw
    py = pix // gw + row0

    def trace(o, d, t_max, active=None):
        return payload_from_planes(packet_trace_plain(
            dw, cfg.t_min, ray_planes(o, d, t_max, active), counts))

    shadow = None if counts is None else {}

    def occluded(o, d, t_max, active):
        if shadow is not None:
            shadow["rays"] = shadow.get("rays", 0) + int(active.sum())
        occ = packet_occlusion_plain(
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
    wp = build.wide_params(dw, cfg.t_min)
    params = build.make_params(
        cfg, frame=frame, row0=row0, global_shape=global_shape, npix=npix,
        num_tris=0, tp=0, lights=lights)
    if params.use_nee:
        build.check_lights(lights.rows, wp.device)
    out = build.launch("sfvp_bvh_regen_render", wp, params, has_mirrors,
                       npix, lights=lights.rows if params.use_nee else None)
    bvh_regen_render.launches += 1
    return out


bvh_regen_render.launches = 0


def make_bvh_regen_render_step(cfg: RenderConfig, buffers, wide: DeviceWide,
                               global_shape: Optional[tuple] = None,
                               tl=None):
    """Progressive render step driven by K5: ``render_step(state, row0=0)
    -> state``, one kernel launch per step. ``wide``: the scene's wide BVH
    on the device of ``buffers`` (bvh_packet.device_wide). The config is
    checked by dispatch.select_render_step. With ``cfg.use_nee`` the
    scene's light table is built and placed on its device once, here.
    ``tl`` (two-level instancing) raises: it comes with ROADMAP.md A.14."""
    if tl is not None:
        raise NotImplementedError(
            "the two-level (instanced) BVH kernel K9 is not ported to "
            "sfvp_tpu_torch yet (ROADMAP.md A.14)")
    gshape = global_shape if global_shape is not None else (cfg.height,
                                                            cfg.width)
    has_mirrors = has_mirror_faces(buffers)
    lights = build_light_table_from_buffers(buffers) if cfg.use_nee else None

    def render_step(state: RenderState, row0: int = 0) -> RenderState:
        h, w = state.accum.shape[0], state.accum.shape[1]
        *color, segs = bvh_regen_render(
            wide, state.frame, row0, cfg=cfg, global_shape=gshape,
            npix=h * w, has_mirrors=has_mirrors, lights=lights)
        return accumulate(state, color, segs.sum(dtype=torch.int64),
                          cfg.spp_per_step)

    return render_step
