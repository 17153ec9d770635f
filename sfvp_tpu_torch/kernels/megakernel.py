"""K2, the chunked brute-force path-tracing kernel, and its scene table.

``wave_render`` traces one wave of ``spp_chunk`` samples x ``npix`` pixels
and returns each ray's colour and segment count: on a CUDA tensor through
the hand-written kernel csrc/wave_render.cu, on a CPU tensor through its
plain PyTorch twin ``wave_render_plain``. ``make_wave_render_step`` sums a
pixel's samples chunk by chunk exactly as sfvp_tpu's
make_render_step_pallas does (megakernel.py:429-446), so K2 keeps the
wavefront integrator's summation order and matches it sample for sample.

Counterpart of sfvp_tpu/kernels/megakernel.py (make_wave_kernel,
make_render_step_pallas, scene_table).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import RenderConfig
from ..integrate.wavefront import (
    RenderState,
    accumulate,
    has_mirror_faces,
    material_flags,
    require_slice,
    sum_chunks,
    trace_wave,
)
from ..scene.buffers import FIELDS, UV_FIELDS, SceneBuffers
from . import build


def scene_table(scene: SceneBuffers) -> torch.Tensor:
    """(20, Tp) f32 triangle table: rows 0-8 vertex coords, 9-11 Kd,
    12-14 Ke, 15-17 Ks, 18 material type (as f32), 19 roughness; textured
    scenes append rows 20-26: u0 v0 u1 v1 u2 v2 texid+1 (0 = untextured).
    The layout of sfvp_tpu's scene_table (megakernel.py:82-105)."""
    cols = [getattr(scene, k).to(torch.float32) for k in FIELDS]
    if scene.has_textures:
        cols += [getattr(scene, k) for k in UV_FIELDS]
        cols.append(scene.tex.to(torch.float32) + 1.0)
    return torch.stack(cols, dim=0).contiguous()


def buffers_from_table(table: torch.Tensor, num_tris: int,
                       textures=None) -> SceneBuffers:
    """SceneBuffers over the first ``num_tris`` columns of a scene table
    (the inverse of ``scene_table``, with the scene's ``textures`` for a
    textured table), for the plain twins."""
    cols = {k: table[i, :num_tris] for i, k in enumerate(FIELDS)}
    cols["mtype"] = cols["mtype"].round().to(torch.int32)
    if textures is not None:
        cols.update({k: table[20 + i, :num_tris]
                     for i, k in enumerate(UV_FIELDS)})
        cols["tex"] = table[26, :num_tris].round().to(torch.int32) - 1
        cols["textures"] = textures
    return SceneBuffers(**cols, num_tris=num_tris)


def wave_render_plain(table, frame: int, chunk_idx: int, row0: int, *,
                      cfg: RenderConfig, num_tris: int, global_shape,
                      npix: int, has_mirrors: bool):
    """Plain PyTorch twin of the K2 kernel: same arguments, same results.
    Ray i of the wave is sample chunk_idx*spp_chunk + i // npix of local
    pixel i % npix. Returns (colr, colg, colb, segs), each (chunk*npix,)."""
    gw = global_shape[1]
    n_rays = cfg.spp_chunk * npix
    idx = torch.arange(n_rays, device=table.device)
    pix = idx % npix
    px = pix % gw
    py = pix // gw + row0
    sample_ids = chunk_idx * cfg.spp_chunk + idx // npix
    color, segs = trace_wave(
        cfg, buffers_from_table(table, num_tris), px, py, sample_ids, frame,
        global_shape, has_mirrors=has_mirrors, rr_every_depth=False)
    return (*color, segs)


def wave_render(table, frame: int, chunk_idx: int, row0: int, *,
                cfg: RenderConfig, num_tris: int, global_shape, npix: int,
                has_mirrors: bool):
    """K2 on ``table``'s device: the CUDA kernel for a CUDA tensor (or an
    error), the plain twin for a CPU tensor. ``wave_render.launches``
    counts kernel launches."""
    if table.device.type == "cpu":
        return wave_render_plain(
            table, frame, chunk_idx, row0, cfg=cfg, num_tris=num_tris,
            global_shape=global_shape, npix=npix, has_mirrors=has_mirrors)
    build.check_table(table, num_tris)
    if table.shape[0] != 20:
        raise ValueError("K2 takes an untextured (20, Tp) table")
    params = build.make_params(
        cfg, frame=frame, row0=row0, global_shape=global_shape, npix=npix,
        num_tris=num_tris, tp=table.shape[1], chunk_idx=chunk_idx)
    out = build.launch("sfvp_wave_render", table, params, has_mirrors,
                       cfg.spp_chunk * npix)
    wave_render.launches += 1
    return out


wave_render.launches = 0


def make_wave_render_step(cfg: RenderConfig, scene: SceneBuffers,
                          global_shape: Optional[tuple] = None):
    """Progressive render step driven by K2: ``render_step(state, row0=0)
    -> state``, with the semantics of integrate.make_render_step. K2 has
    neither environment maps, textures, GGX, dielectrics nor a thin lens
    (dispatch takes the eager loop for them, as sfvp_tpu's does,
    dispatch.py:242-256)."""
    require_slice(cfg, scene)
    if (scene.env is not None or scene.has_textures
            or cfg.camera.lens_radius > 0.0
            or any(material_flags(scene).values())):
        raise ValueError("K2 renders neither environment maps, textures, "
                         "GGX, dielectrics nor a thin lens; dispatch."
                         "select_render_step takes the eager wavefront "
                         "loop for them")
    gshape = global_shape if global_shape is not None else (cfg.height,
                                                            cfg.width)
    table = scene_table(scene)
    num_tris = scene.num_tris
    has_mirrors = has_mirror_faces(scene)

    def render_step(state: RenderState, row0: int = 0) -> RenderState:
        h, w = state.accum.shape[0], state.accum.shape[1]
        npix = h * w

        def wave(chunk_idx):
            return wave_render(
                table, state.frame, chunk_idx, row0, cfg=cfg,
                num_tris=num_tris, global_shape=gshape, npix=npix,
                has_mirrors=has_mirrors)

        color, segs = sum_chunks(cfg, npix, wave, table.device)
        return accumulate(state, color, segs, cfg.spp_per_step)

    return render_step
