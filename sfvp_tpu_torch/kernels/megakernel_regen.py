"""K1, the brute-force path-tracing kernel with in-thread sample
regeneration: the port's default main-path kernel.

``regen_render`` traces all ``spp`` samples of every pixel of a (local)
image and returns each pixel's colour total and segment count: on a CUDA
tensor through the hand-written kernel csrc/regen_render.cu, on a CPU
tensor through its plain PyTorch twin ``regen_render_plain``. Each sample's
radiance is added straight into the pixel total (the order of
sfvp_tpu/kernels/megakernel_regen.py:629-631), so K1 matches the
wavefront integrator to f32 summation order (~1e-6), not bitwise.

Counterpart of sfvp_tpu/kernels/megakernel_regen.py (make_regen_render_step)
for every material (diffuse, mirror, GGX glossy, smooth dielectric; its
:497-540, :723-781, :839-889, :976-1044), the thin-lens camera (:232-246,
:368), uniform and cosine sampling, Russian roulette, next-event
estimation with MIS, an equirect environment sky with its
importance-sampled NEE (alone or beside the area lights) and map_Kd
textures (its :144-218). The light table, the environment's pool and CDF
and the texel pool are read from device memory, so any number of lights
and any map or atlas size runs in the kernel: sfvp_tpu's MAX_KERNEL_LIGHTS
(megakernel_regen.py:110-116), ENV_VMEM_MAX_BYTES and TEX_VMEM_MAX_BYTES
are TPU VMEM limits and have no counterpart here (ROADMAP.md A.19); so is
the 48 KB of shared memory, a table past 227 KB going through it in
tiles (build.table_plan).
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
    brute_occluded,
    brute_surface,
    count_materials,
    has_mirror_faces,
    material_flags,
    require_slice,
    trace_wave,
)
from ..scene.buffers import SceneBuffers
from . import build
from .intersect import any_hit_tests
from .megakernel import buffers_from_table, scene_table


def regen_render_plain(table, frame: int, row0: int, *, cfg: RenderConfig,
                       num_tris: int, global_shape, npix: int,
                       has_mirrors: bool, lights: Optional[LightTable] = None,
                       env=None, env_dist: Optional[EnvDistribution] = None,
                       textures=None, counts: Optional[dict] = None,
                       has_glossy: bool = False, has_diel: bool = False):
    """Plain PyTorch twin of the K1 kernel: same arguments, same results.
    Samples run one wave at a time, each adding into the running per-pixel
    totals, which is the kernel's summation order; NEE (toward the area
    lights and, with ``env_dist``, the environment) in the kernel's float
    order, its shadow rays by brute force. ``env``: the sky of a miss;
    ``textures``: the map_Kd pool of a (27, Tp) table. ``counts`` gathers
    the shadow rays ("shadow_rays") and the triangle tests the kernel's
    early-exit scan takes on them ("shadow_tests"), and the segments
    on GGX and dielectric faces ("glossy_hits", "diel_hits"). Returns
    (colr, colg, colb, segs), each (npix,)."""
    gw = global_shape[1]
    scene = buffers_from_table(table, num_tris, textures)
    pix = torch.arange(npix, device=table.device)
    px = pix % gw
    py = pix // gw + row0
    occluded = surface = None  # trace_wave's brute-force rays
    if counts is not None:
        brute_hit = brute_surface(cfg, scene)

        def surface(o, d, active):
            out = brute_hit(o, d, active)
            count_materials(counts, out[6], active & ~out[0])
            return out

        brute = brute_occluded(cfg, scene)

        def occluded(o, d, t_max, active):
            counts["shadow_rays"] = (counts.get("shadow_rays", 0)
                                     + int(active.sum()))
            counts["shadow_tests"] = counts.get("shadow_tests", 0) + (
                any_hit_tests(o, d, scene, cfg.t_min, t_max, active))
            return brute(o, d, t_max, active)
    color = None
    segs = torch.zeros(npix, dtype=torch.int32, device=table.device)
    for s in range(cfg.spp_per_step):
        color, seg = trace_wave(cfg, scene, px, py, s, frame, global_shape,
                                color=color, has_mirrors=has_mirrors,
                                lights=lights, occluded=occluded,
                                surface=surface, fused_nee=True, env=env,
                                env_dist=env_dist,
                                has_glossy=has_glossy, has_diel=has_diel)
        segs += seg
    return (*color, segs)


def check_images(params, device, env=None, env_dist=None,
                 textures=None) -> None:
    """What K1 and K5 take beside the scene: the environment's pool (and
    under its NEE its CDF) and the texture pool on the scene's device."""
    for table in (env, textures):
        if table is not None:
            build.check_env(table, device)
    if params.use_env_nee:
        for name, t in (("cdf", env_dist.cdf), ("pdf", env_dist.pdf_flat)):
            if (t.device != torch.device(device)
                    or t.dtype != torch.float32 or not t.is_contiguous()):
                raise ValueError(f"env distribution {name} on {t.device}, "
                                 f"scene on {device}")


def regen_render(table, frame: int, row0: int, *, cfg: RenderConfig,
                 num_tris: int, global_shape, npix: int, has_mirrors: bool,
                 lights: Optional[LightTable] = None, env=None,
                 env_dist: Optional[EnvDistribution] = None, textures=None,
                 has_glossy: bool = False, has_diel: bool = False):
    """K1 on ``table``'s device: the CUDA kernel for a CUDA tensor (or an
    error), the plain twin for a CPU tensor. ``lights``: the scene's light
    table on the same device, for ``cfg.use_nee``; ``env``, ``env_dist``,
    ``textures``: its environment map, the map's NEE distribution and its
    texture pool there; ``has_mirrors``, ``has_glossy``, ``has_diel``: the
    scene has such faces (integrate.wavefront.material_flags).
    ``regen_render.launches`` counts kernel launches."""
    if table.device.type == "cpu":
        return regen_render_plain(
            table, frame, row0, cfg=cfg, num_tris=num_tris,
            global_shape=global_shape, npix=npix, has_mirrors=has_mirrors,
            lights=lights, env=env, env_dist=env_dist, textures=textures,
            has_glossy=has_glossy, has_diel=has_diel)
    build.check_table(table, num_tris)
    if (table.shape[0] == 27) != (textures is not None):
        raise ValueError("a (27, Tp) table comes with its texture pool")
    params = build.make_params(
        cfg, frame=frame, row0=row0, global_shape=global_shape, npix=npix,
        num_tris=num_tris, tp=table.shape[1], lights=lights, env=env,
        env_dist=env_dist, textures=textures, rows=table.shape[0],
        has_glossy=has_glossy, has_diel=has_diel)
    check_images(params, table.device, env, env_dist, textures)
    if params.use_nee:
        build.check_lights(lights.rows, table.device)
    out = build.launch("sfvp_regen_render", table, params, has_mirrors, npix,
                       lights=lights.rows if params.use_nee else None)
    regen_render.launches += 1
    return out


regen_render.launches = 0


def make_regen_render_step(cfg: RenderConfig, scene: SceneBuffers,
                           global_shape: Optional[tuple] = None):
    """Progressive render step driven by K1: ``render_step(state, row0=0)
    -> state``, one kernel launch per step. With ``cfg.use_nee`` the
    scene's light table, and with an environment map its distribution,
    are built and placed on its device once, here."""
    require_slice(cfg, scene)
    gshape = global_shape if global_shape is not None else (cfg.height,
                                                            cfg.width)
    table = scene_table(scene)
    num_tris = scene.num_tris
    has_mirrors = has_mirror_faces(scene)
    mats = material_flags(scene)
    lights = build_light_table_from_buffers(scene) if cfg.use_nee else None
    env_dist = (env_distribution_for(scene.env)
                if cfg.use_nee and scene.env is not None else None)

    def render_step(state: RenderState, row0: int = 0) -> RenderState:
        h, w = state.accum.shape[0], state.accum.shape[1]
        *color, segs = regen_render(
            table, state.frame, row0, cfg=cfg, num_tris=num_tris,
            global_shape=gshape, npix=h * w, has_mirrors=has_mirrors,
            lights=lights, env=scene.env, env_dist=env_dist,
            textures=scene.textures, **mats)
        return accumulate(state, color, segs.sum(dtype=torch.int64),
                          cfg.spp_per_step)

    return render_step
