"""Wavefront path-tracing integrator in plain PyTorch: the parity subset of
sfvp_tpu.integrate.wavefront and the port's in-package oracle.

A wave of rays (pixels x samples) advances in lockstep through
trace -> shade, vectorised over the wave; terminated rays are masked.
``trace_wave`` is also the body of the plain twins of the CUDA kernels
(kernels/megakernel.py, kernels/megakernel_regen.py,
kernels/megakernel_bvh.py): it takes the colour to add into, so a twin can
reproduce its kernel's summation order, and a trace hook, so the same
loop runs over brute force (``brute_surface``) or the wide BVH's payload
trace (``payload_surface``, K3, K6 or K7 on a CUDA tensor), and a shadow
hook, so next-event estimation tests its shadow rays by brute force
(``brute_occluded``), by an any-hit trace (K4 or K8 on a CUDA tensor) or,
on a route without one, by the payload trace (``payload_occluded``, K6).

Large scenes run here through ``make_render_step(...,
trace_payload_fn=...)``, the payload path of sfvp_tpu's wavefront loop,
with its pixel-tile swizzle (``PACKET_TILE``) and its per-bounce ray sort
(``sort_key``), neither of which changes a pixel's colour sum. The step's building block,
``render_step.render_pixels``, also drives the adaptive sampler
(integrate/adaptive.py).

Parity-mode semantics preserved exactly (ref shaders/raygen.rgen:41-91):
  - color += weight * emission on EVERY segment, including the miss segment
    (sky (0.7,0.6,0.5), ref shaders/miss.rmiss:10)
  - emissive hits do NOT terminate the path; only a miss (or the depth cap)
    does
  - uniform hemisphere sampling, weight *= brdf * cos(theta) * 2*pi
  - hit position from barycentrics, geometric normal =
    -normalize(cross(e01, e02)) (ref shaders/closesthit.rchit:43-57)
  - progressive accumulation new = (color + old*frame)/(frame+1), in f32

It runs every material of sfvp_tpu's (diffuse, mirror, GGX glossy with
VNDF sampling and the smooth dielectric; its wavefront.py:355-645), the
thin-lens camera (:670), uniform and cosine sampling, Russian roulette,
next-event estimation toward area lights with balance-heuristic MIS
(integrate/lights.py), map_Kd textures and an equirect environment sky
with its own importance-sampled NEE (scene/textures.py, lights.py
EnvDistribution; sfvp_tpu wavefront.py :105-114, :168-193, :412-453,
:515-536), over brute force or the wide BVH.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import rng
from ..camera import apply_thin_lens_soa, generate_rays_soa, lens_frame
from ..config import RenderConfig
from ..kernels.intersect import trace_brute
from ..scene.textures import sample_bilinear, sample_environment
from ..sampling import (
    INV_PI,
    TWO_PI,
    coordinate_system_soa,
    dielectric_reflect_refract_soa,
    ggx_d,
    ggx_lambda,
    ggx_sample_vndf_local,
    ggx_vndf_pdf,
    sample_direction_cosine_soa,
    sample_direction_uniform_soa,
)
from ..utils import vec
from ..utils.vec import f32
from .lights import (
    EnvDistribution,
    LightTable,
    build_light_table_from_buffers,
    env_distribution_for,
    env_pdf,
    sample_env,
    sample_light,
)

# brdf * cos / pdf of uniform sampling: Kd/pi * cos * 2pi, the float32
# product the JAX package forms as (INV_PI * TWO_PI)
UNIFORM_SCALE = float(np.float32(INV_PI) * np.float32(TWO_PI))
# the solid-angle pdf of a uniform hemisphere sample, 1/TWO_PI in float32
UNIFORM_PDF = f32(1.0 / TWO_PI)
# a shadow ray stops this fraction short of its light sample
SHADOW_SCALE = f32(1.0 - 1e-3)
# side of the payload route's square pixel tiles: 32 x 32 is K6's 1024-ray
# packet (kernels/bvh_packet2.PACKET), so a packet covers one compact screen
# tile instead of one image row. Applied on every payload route, as sfvp_tpu
# does (its packet_tile_size), to keep the wave order of the JAX package.
PACKET_TILE = 32


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
    """Raise ValueError for a config no route can render: an unknown
    sampling or traversal, a chunk that does not divide spp, an open lens
    without a focal plane in front of it."""
    if cfg.camera.lens_radius > 0.0:
        lens_frame(cfg.camera)  # raises when focus_dist <= 0
    if cfg.sampling not in ("uniform", "cosine"):
        raise ValueError(f"unknown sampling {cfg.sampling!r}")
    if cfg.traversal not in ("auto", "brute", "bvh"):
        raise ValueError(f"unknown traversal {cfg.traversal!r}")
    cfg.spp_chunks()  # raises on a chunk that does not divide spp


def has_mirror_faces(scene) -> bool:
    return bool((scene.mtype[: scene.num_tris] == 1).any())


def material_flags(scene) -> dict:
    """Which of the materials past diffuse and mirror the scene has, as the
    ``has_glossy`` and ``has_diel`` keywords of trace_wave and the fused
    kernels' wrappers: code for a material is traced (and in the kernels
    compiled) only for a scene that has it, as sfvp_tpu's has_glossy and
    has_diel (its dispatch.py:174-175)."""
    mt = scene.mtype[: scene.num_tris]
    return {"has_glossy": bool((mt == 2).any()),
            "has_diel": bool((mt == 3).any())}


def count_materials(counts: dict, mtype, hit) -> None:
    """Add the hits (mask ``hit``) on GGX and dielectric faces (``mtype``
    2 and 3) into ``counts`` ("glossy_hits", "diel_hits"): the twins'
    count of the material work of their kernels' bounds."""
    for key, m in (("glossy_hits", 2), ("diel_hits", 3)):
        counts[key] = counts.get(key, 0) + int(((mtype == m) & hit).sum())


class GgxFrame(NamedTuple):
    """The shading frame of a GGX hit (sfvp_tpu wavefront.py:355-403): the
    normal flipped toward the incoming ray ``n_g`` with its tangent basis,
    the view direction in it ``wo_l`` (its z clamped at 1e-6), alpha =
    max(rough^2, 1e-4), Smith's Lambda of the view direction, and the Ks
    tint that is the Fresnel F0."""
    tng: tuple
    btg: tuple
    n_g: tuple
    wo_l: tuple
    alpha: torch.Tensor
    lam_o: torch.Tensor
    spec: tuple


def ggx_frame(d, normal, rough, spec) -> GgxFrame:
    wo = vec.scale(d, -1.0)
    n_g = vec.where(vec.dot(d, normal) > 0, vec.scale(normal, -1.0), normal)
    tng, btg = coordinate_system_soa(n_g)
    woz = torch.clamp_min(vec.dot(wo, n_g), 1e-6)
    wo_l = (vec.dot(wo, tng), vec.dot(wo, btg), woz)
    alpha = torch.clamp_min(rough * rough, 1e-4)
    return GgxFrame(tng, btg, n_g, wo_l, alpha, ggx_lambda(woz, alpha), spec)


def ggx_fresnel(spec, coh):
    """Schlick's Fresnel with the Ks tint as F0."""
    m1 = 1.0 - coh
    f5 = m1 * m1
    f5 = f5 * f5 * m1
    return tuple(s + (1.0 - s) * f5 for s in spec)


def ggx_eval(g: GgxFrame, wl):
    """(f_r per channel, the VNDF pdf, cos of the light direction to n_g)
    of the light direction ``wl`` (sfvp_tpu wavefront.py:389-403)."""
    wl_l = (vec.dot(wl, g.tng), vec.dot(wl, g.btg), vec.dot(wl, g.n_g))
    cos_i = wl_l[2]
    woz = g.wo_l[2]
    h = vec.add(g.wo_l, wl_l)
    h = vec.scale(h, vec.inv_sqrt(torch.clamp_min(vec.dot(h, h), 1e-20)))
    dgg = ggx_d(h[2], g.alpha)
    g2 = 1.0 / (1.0 + g.lam_o + ggx_lambda(cos_i, g.alpha))
    fr = ggx_fresnel(g.spec, torch.clamp_min(vec.dot(g.wo_l, h), 1e-6))
    denom = torch.clamp_min(4.0 * woz * torch.clamp_min(cos_i, 1e-6), 1e-6)
    f = tuple(fc * dgg * g2 / denom for fc in fr)
    return f, ggx_vndf_pdf(woz, h[2], g.alpha), cos_i


def ggx_bounce(g: GgxFrame, r1, r2):
    """The GGX bounce (sfvp_tpu wavefront.py:566-588): a VNDF half-vector
    from the same r1, r2 as the hemisphere sample, the reflected direction
    in world space, its weight F * G2 / G1(wo), whether it lies above the
    surface (z > 1e-5; below, the path is absorbed) and the half-vector's
    z for its pdf."""
    h_l = ggx_sample_vndf_local(r1, r2, g.wo_l, g.alpha)
    coh = torch.clamp_min(vec.dot(g.wo_l, h_l), 1e-6)
    wi_l = vec.sub(vec.scale(h_l, 2.0 * coh), g.wo_l)
    wi = vec.add(vec.add(vec.scale(g.tng, wi_l[0]), vec.scale(g.btg, wi_l[1])),
                 vec.scale(g.n_g, wi_l[2]))
    g2_over_g1 = (1.0 + g.lam_o) / (1.0 + g.lam_o
                                    + ggx_lambda(wi_l[2], g.alpha))
    return (wi, vec.scale(ggx_fresnel(g.spec, coh), g2_over_g1),
            wi_l[2] > 1e-5, h_l[2])


def light_bsdf(wl, normal, diffuse, uniform: bool, ggx, is_glossy):
    """(brdf per channel, cos to the shading normal, bsdf pdf) of a light
    direction: Kd/pi, cos_s and the diffuse sampling pdf, or on the GGX
    lanes (``ggx`` a GgxFrame, ``is_glossy`` their mask) f_r, cos to n_g
    and the VNDF pdf (sfvp_tpu wavefront.py:484-488, :499-504)."""
    cos_s = vec.dot(wl, normal)
    brdf = vec.scale(diffuse, INV_PI)
    if ggx is None:
        return brdf, cos_s, bsdf_pdf(uniform, cos_s)
    f_g, pdf_g, cos_i = ggx_eval(ggx, wl)
    cos_s = torch.where(is_glossy, cos_i, cos_s)
    return (vec.where(is_glossy, f_g, brdf), cos_s,
            torch.where(is_glossy, pdf_g, bsdf_pdf(uniform, cos_s)))


def shade_inputs(scene, hit):
    """Gather per-hit shading data (SoA), mirroring the closest-hit shader
    (ref shaders/closesthit.rchit:50-65) plus the material extensions:
    (position, normal, diffuse, emission, specular, mtype, rough), rough
    the GGX roughness (mtype 2) or the encoded IOR (Ni - 1) / 4 (mtype
    3)."""
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
    if scene.textures is not None:
        # map_Kd: the per-corner vt interpolated with the barycentrics of
        # the position, then a bilinear fetch (sfvp_tpu wavefront.py:105-114)
        u_hit = (scene.u0[prim] * w + scene.u1[prim] * hit.u
                 + scene.u2[prim] * hit.v)
        v_hit = (scene.v0t[prim] * w + scene.v1t[prim] * hit.u
                 + scene.v2t[prim] * hit.v)
        texc = sample_bilinear(scene.textures, scene.tex[prim], u_hit, v_hit)
        diffuse = vec.mul(diffuse, texc)
    return (position, normal, diffuse, emission, specular, scene.mtype[prim],
            scene.rough[prim])


def shade_from_payload(pay, textures=None):
    """Shading inputs from a payload trace (kernels/bvh_packet.py), as
    sfvp_tpu's _shade_from_payload (wavefront.py:258-290), with 1/sqrt as
    two correctly rounded ops where it calls rsqrt. The wide layout keeps
    Ks in the albedo lanes of mirrors, glossy and dielectric faces and
    packs mtype + roughness in one lane (accel/wide.py): its integer part
    is the material, its fraction the GGX roughness or the encoded IOR
    (glossy lanes hold at most 2.96, so the floor splits them from the
    dielectric's 3.0 and up as sfvp_tpu's kernels split the lane at 2.98,
    megakernel_bvh.py:1388-1400). With ``textures`` and a textured
    payload, the albedo is modulated by the bilinear fetch at the
    payload's (texu, texv, texid); the specular tint stays as it is.
    Returns (miss, position, normal, diffuse, emission, specular, mtype,
    rough, t)."""
    miss = torch.isinf(pay.t)
    w = 1.0 - pay.u - pay.v
    position = vec.add(
        vec.add(vec.scale(pay.p0, w), vec.scale(pay.p1, pay.u)),
        vec.scale(pay.p2, pay.v),
    )
    nrm = vec.cross(vec.sub(pay.p1, pay.p0), vec.sub(pay.p2, pay.p0))
    inv_len = vec.inv_sqrt(torch.clamp_min(vec.dot(nrm, nrm), 1e-30))
    normal = vec.scale(nrm, -inv_len)
    diffuse = pay.albedo
    if textures is not None and pay.texid is not None:
        diffuse = vec.mul(diffuse, sample_bilinear(textures, pay.texid,
                                                   pay.texu, pay.texv))
    mtype = torch.floor(pay.mtype)
    return (miss, position, normal, diffuse, pay.emission, pay.albedo,
            mtype, pay.mtype - mtype, pay.t)


def brute_surface(cfg: RenderConfig, scene) -> Callable:
    """Trace hook of ``trace_wave`` over every triangle of ``scene``:
    ``surface(o, d, active) -> (miss, position, normal, diffuse, emission,
    specular, mtype, rough, t)``, t the hit distance."""

    def surface(o, d, active):
        hit = trace_brute(o, d, scene, cfg.t_min, cfg.t_max, active=active)
        return (hit.prim < 0, *shade_inputs(scene, hit), hit.t)

    return surface


def brute_occluded(cfg: RenderConfig, scene) -> Callable:
    """Shadow hook of ``trace_wave`` over every triangle of ``scene``:
    ``occluded(o, d, t_max, active) -> (N,) bool``, whether a triangle
    lies in (t_min, t_max) along the ray, as sfvp_tpu's trace_fn branch
    (``trace_brute(...).prim >= 0``, wavefront.py:304-308)."""

    def occluded(o, d, t_max, active):
        return trace_brute(o, d, scene, cfg.t_min, t_max,
                           active=active).prim >= 0

    return occluded


def payload_surface(cfg: RenderConfig, trace_payload_fn,
                    textures=None) -> Callable:
    """Trace hook of ``trace_wave`` over a payload trace
    ``trace_payload_fn(o, d, t_max, active) -> Payload``, with the scene's
    texture table for a textured tree."""

    def surface(o, d, active):
        return shade_from_payload(
            trace_payload_fn(o, d, cfg.t_max, active=active), textures)

    return surface


def payload_occluded(trace_payload_fn) -> Callable:
    """Shadow hook of ``trace_wave`` through a payload trace, for a route
    with no any-hit kernel (K6's): a triangle lies in (t_min, t_max) where
    the closest hit in that window is finite, as sfvp_tpu's
    _shadow_occluded (wavefront.py:299-303)."""

    def occluded(o, d, t_max, active):
        return torch.isfinite(trace_payload_fn(o, d, t_max, active=active).t)

    return occluded


def sort_rays(cfg: RenderConfig, stream: bool) -> bool:
    """Whether the wavefront loop sorts its bounce rays: ``cfg.
    sort_bounce_rays`` when set; by default where K6 traces (``stream``),
    and nowhere else. K6 walks the tree per packet of 1024 consecutive
    rays, so which triangle wins an exact tie in t depends on which rays
    share a packet: sorted as sfvp_tpu sorts them by default, its packets
    hold the rays of sfvp_tpu's. The parity has a price on an H100: the
    sort gathers a bounce wave's live rays into few packets, whose walks
    then run one after another in few blocks (K6 2x slower on the 500k
    sphere's third bounce, chip_smoke.py phase 24). K3 and K7 trace per
    ray, where the order changes no result and the sort only costs
    time."""
    if cfg.sort_bounce_rays is not None:
        return bool(cfg.sort_bounce_rays)
    return bool(stream)


def make_sort_key(cfg: RenderConfig, scene, on: bool) -> Optional[Callable]:
    """The per-bounce ray sort key of sfvp_tpu's payload path
    (wavefront.py:200-256), or None when off (``sort_rays``):
    ``key(o, d, done, prev_mtype) -> (N,) int32``, (material << 24) |
    (direction octant << 21) | 7-bit-per-axis position morton, the
    material bits only on scenes with mirror, glossy or dielectric faces
    and when ``cfg.sort_material_key`` (sfvp_tpu's _sort_key, :217); dead
    rays get 2**30. Sorting permutes the rays of a wave and never changes
    a ray's result."""
    if not on:
        return None
    sort_material = cfg.sort_material_key and (
        has_mirror_faces(scene) or any(material_flags(scene).values()))
    t = scene.num_tris
    cols = {f: np.asarray(getattr(scene, f)[:t].cpu()) for f in (
        "v0x", "v0y", "v0z", "v1x", "v1y", "v1z", "v2x", "v2y", "v2z")}
    lo = np.asarray(
        [min(cols[f"v{c}{a}"].min() for c in range(3)) for a in "xyz"],
        np.float32)
    hi = np.asarray(
        [max(cols[f"v{c}{a}"].max() for c in range(3)) for a in "xyz"],
        np.float32)
    inv_extent = 1.0 / np.maximum(hi - lo, 1e-6)

    def q7(c, a):
        x = torch.clamp((c - float(lo[a])) * float(inv_extent[a]), 0.0, 1.0)
        return (x * 127.0).to(torch.int32)

    def expand7(v):
        # interleave 7 bits with 2-bit gaps (morton, 21 bits total)
        v = (v | (v << 8)) & 0x100F00F
        v = (v | (v << 4)) & 0x10C30C3
        v = (v | (v << 2)) & 0x1249249
        return v

    def key(o, d, done, prev_mtype):
        morton = ((expand7(q7(o[0], 0)) << 2) | (expand7(q7(o[1], 1)) << 1)
                  | expand7(q7(o[2], 2)))
        octant = ((d[0] >= 0).to(torch.int32) * 4
                  + (d[1] >= 0).to(torch.int32) * 2
                  + (d[2] >= 0).to(torch.int32))
        k = (octant << 21) | morton
        if sort_material:
            k = k | (torch.clamp(prev_mtype.to(torch.int32), 0, 3) << 24)
        return torch.where(done, 2**30, k)

    return key


def emission_weight(use_mis: bool, count_emit, pdf_prev, miss, d, normal,
                    t_hit, emission, inv_area: Optional[float],
                    p_env=None, env_nee: bool = False):
    """Weight of the emission a path segment adds under NEE, in the
    branches of sfvp_tpu/integrate/wavefront.py:380-453 (the fused kernels
    compute the same, megakernel_regen.py:545-628). ``inv_area``: the area
    pdf 1/total_area of the area lights, None without any; ``env_nee``: the
    environment is light-sampled too, ``p_env`` the env pdf of ``d`` under
    MIS (lights.env_pdf).

    Area lights alone: 1 on camera rays, after mirrors and on misses;
    otherwise 0, or under MIS the balance weight p_bsdf / (p_bsdf + p_nee)
    of an emissive hit, with p_nee the area pdf turned into solid angle by
    t^2 / |cos|. The environment alone: 1 on every hit, and on a miss 1
    after a camera ray or a mirror, else 0 or under MIS p_bsdf / (p_bsdf +
    p_env). Both: each source's own rule (a miss the env's, a hit the
    area lights')."""
    area = inv_area is not None
    if not use_mis:
        if area and env_nee:
            full = count_emit
        elif env_nee:
            full = count_emit | torch.logical_not(miss)
        else:
            full = count_emit | miss
        return full.to(torch.float32)
    if env_nee:
        w_env = pdf_prev / torch.clamp_min(pdf_prev + p_env, 1e-30)
        if not area:
            return torch.where(count_emit | torch.logical_not(miss), 1.0,
                               w_env)
    cos_l_hit = torch.abs(vec.dot(d, normal))
    t_safe = torch.where(miss, 0.0, t_hit)
    p_nee_hit = (t_safe * t_safe) * inv_area / torch.clamp_min(cos_l_hit,
                                                               1e-6)
    w_bsdf = pdf_prev / torch.clamp_min(pdf_prev + p_nee_hit, 1e-30)
    is_emissive = (vec.maxc(emission) > 0) & torch.logical_not(miss)
    surf = torch.where(is_emissive, w_bsdf, 0.0)
    if env_nee:
        return torch.where(count_emit, 1.0, torch.where(miss, w_env, surf))
    return torch.where(count_emit | miss, 1.0, surf)


def bsdf_pdf(uniform: bool, cos_s):
    """Solid-angle pdf of the diffuse bounce toward a light direction:
    1/(2 pi) for uniform sampling, max(cos, 0)/pi for cosine sampling."""
    if uniform:
        return torch.full_like(cos_s, UNIFORM_PDF)
    return torch.clamp_min(cos_s, 0.0) * INV_PI


def nee_direct(lights: LightTable, r_sel, rl1, rl2, position, normal,
               diffuse, weight, shadow_q, occluded, use_mis: bool,
               uniform: bool, fused: bool, ggx=None, is_glossy=None):
    """The direct light one light sample brings to a hit, times the path
    weight: a (3,) tuple of (N,), zero where ``shadow_q`` is off, the light
    is behind the surface or the shadow ray is blocked. ``ggx``,
    ``is_glossy``: the GGX frame of the hits and the mask of the glossy
    ones, which take the GGX brdf and pdf (``light_bsdf``).

    Two float orders of the same estimate: the wavefront integrator's
    (sfvp_tpu/integrate/wavefront.py:476-513: the shadow ray to
    sqrt(dist2) * (1 - 1e-3), (brdf * Le) * cos_s * cos_l / (dist2 *
    pdf_area), then the MIS weight) and, with ``fused``, that of the fused
    kernels K1 and K5 (megakernel_regen.py:702-797, megakernel_bvh.py
    :1874-1945: the shadow ray to (1 / (1 / sqrt(dist2))) * (1 - 1e-3),
    w * brdf * Le * (cos_s * cos_l / dist2 * total_area * w_mis)), with
    their light pick (lights.light_index)."""
    q, nl, le, pdf_area = sample_light(lights, r_sel, rl1, rl2, fused)
    to_l = vec.sub(q, position)
    dist2 = torch.clamp_min(vec.dot(to_l, to_l), 1e-12)
    if fused:
        inv_dist = vec.inv_sqrt(dist2)
        wl = vec.scale(to_l, inv_dist)
        smax = (1.0 / inv_dist) * SHADOW_SCALE
    else:
        dist = torch.sqrt(dist2)
        wl = vec.scale(to_l, 1.0 / dist)
        smax = dist * SHADOW_SCALE
    brdf_l, cos_s, p_bsdf_l = light_bsdf(wl, normal, diffuse, uniform, ggx,
                                         is_glossy)
    cos_l = torch.abs(vec.dot(wl, nl))  # double-sided light
    shadow_q = shadow_q & (cos_s > 0)
    visible = shadow_q & torch.logical_not(occluded(position, wl, smax,
                                                    shadow_q))
    area = f32(lights.total_area)
    if use_mis:
        # balance heuristic in solid-angle measure
        if fused:
            p_nee_sa = dist2 / (area * torch.clamp_min(cos_l, 1e-6))
        else:
            p_nee_sa = dist2 * pdf_area / torch.clamp_min(cos_l, 1e-6)
        w_nee = p_nee_sa / torch.clamp_min(p_nee_sa + p_bsdf_l, 1e-30)
    if fused:
        g_pdf = cos_s * cos_l / dist2 * area
        if use_mis:
            g_pdf = g_pdf * w_nee
        direct = vec.scale(vec.mul(vec.mul(weight, brdf_l), le), g_pdf)
    else:
        g_over_pdf = cos_s * cos_l / (dist2 * pdf_area)
        direct = vec.scale(vec.mul(brdf_l, le), g_over_pdf)
        if use_mis:
            direct = vec.scale(direct, w_nee)
        direct = vec.mul(weight, direct)
    return vec.where(visible, direct, vec.splat((0.0, 0.0, 0.0),
                                                like=cos_s))


def env_nee_direct(env, dist: EnvDistribution, r_sel, rl1, rl2, position,
                   normal, diffuse, weight, shadow_q, occluded, use_mis: bool,
                   uniform: bool, fused: bool, t_max: float, ggx=None,
                   is_glossy=None):
    """The direct light one environment sample brings to a hit, times the
    path weight: a (3,) tuple of (N,), zero where ``shadow_q`` is off, the
    direction is below the surface or its shadow ray (to t_max (1 - 1e-3))
    is blocked. The direction comes from the env importance distribution
    (lights.sample_env), the radiance from the map (sample_environment).

    Two float orders of the same estimate: the wavefront integrator's
    (sfvp_tpu/integrate/wavefront.py:515-536: (brdf * Le) * (cos_s / pdf),
    then the MIS weight, then the path weight) and, with ``fused``, that of
    the fused kernels K1 and K5 (megakernel_regen.py:799-909: w * brdf *
    Le * g_w, g_w = cos_s / pdf times the MIS weight). ``ggx``,
    ``is_glossy``: as nee_direct's."""
    wl, pdf_sa = sample_env(dist, r_sel, rl1, rl2)
    brdf_l, cos_s, p_bsdf_l = light_bsdf(wl, normal, diffuse, uniform, ggx,
                                         is_glossy)
    shadow_q = shadow_q & (cos_s > 0)
    smax = torch.full_like(cos_s, f32(np.float32(t_max)
                                     * np.float32(SHADOW_SCALE)))
    visible = shadow_q & torch.logical_not(occluded(position, wl, smax,
                                                    shadow_q))
    env_le = sample_environment(env, wl)
    if use_mis:
        w_env = pdf_sa / torch.clamp_min(pdf_sa + p_bsdf_l, 1e-30)
    if fused:
        g_w = cos_s / torch.clamp_min(pdf_sa, 1e-12)
        if use_mis:
            g_w = g_w * w_env
        direct = vec.scale(vec.mul(vec.mul(weight, brdf_l), env_le), g_w)
    else:
        inv_pdf = 1.0 / torch.clamp_min(pdf_sa, 1e-12)
        direct = vec.scale(vec.mul(brdf_l, env_le), cos_s * inv_pdf)
        if use_mis:
            direct = vec.scale(direct, w_env)
        direct = vec.mul(weight, direct)
    return vec.where(visible, direct, vec.splat((0.0, 0.0, 0.0),
                                                like=cos_s))


def trace_wave(cfg: RenderConfig, scene, px, py, sample_ids, frame: int,
               global_shape, color=None, has_mirrors: bool = False,
               rr_every_depth: bool = True, surface=None, sort_key=None,
               lights: Optional[LightTable] = None, occluded=None,
               fused_nee: bool = False, env=None,
               env_dist: Optional[EnvDistribution] = None,
               has_glossy: bool = False, has_diel: bool = False):
    """Trace one wave of camera paths: ray i is sample ``sample_ids[i]`` of
    global pixel (px[i], py[i]). Each segment's radiance is added into
    ``color`` (zeros when None) in depth order. With an open lens
    (``cfg.camera.lens_radius > 0``) two more numbers a sample, drawn
    after the jitter, move the camera ray through the thin lens.

    ``has_mirrors``, ``has_glossy``, ``has_diel`` (``material_flags``):
    the scene has such faces, so their shading is traced: the mirror
    reflection; the GGX brdf under NEE and the VNDF bounce (r1, r2 the
    hemisphere sample's), a bounce below the surface ending the path; the
    dielectric's reflect-or-refract choice by r1 against the Fresnel
    term, tinted by Ks at each interface, the IOR 1 + 4 rough. Mirrors and
    dielectrics take no light sample, and the emission their bounce finds
    counts in full.

    ``rr_every_depth``: draw the roulette number at every depth, as the
    wavefront integrator, K1 and K5 do; K2 draws it only from
    rr_start_depth on (sfvp_tpu/kernels/megakernel.py:336), which shifts
    its later draws.

    ``surface``: the trace hook (``brute_surface`` over ``scene`` when
    None). ``sort_key`` (make_sort_key): reorder the wave by this key
    before every bounce after the first, with one gather of the float
    state and one of the integer state, and scatter the results back to
    wave order at the end.

    ``lights`` (integrate/lights.py): next-event estimation when
    ``cfg.use_nee``, with MIS when ``cfg.use_mis`` too; without lights
    neither engages, so a scene with no emissive triangle renders as
    without them. At every hit the light sample's three numbers are drawn
    before the bounce's. ``occluded(o, d, t_max, active) -> (N,) bool``:
    the shadow-ray hook (``brute_occluded`` over ``scene`` when None).
    ``fused_nee``: the NEE terms in the fused kernels' float order
    (``nee_direct``, ``env_nee_direct``), as the twins of K1 and K5 take
    them.

    ``env`` (scene/textures.py TextureTable): the equirect sky a miss
    reads instead of ``cfg.sky_emission``; ``env_dist``
    (lights.env_distribution_for) samples it at every hit under
    ``cfg.use_nee``, after the area lights' sample, with its own three
    numbers, alone or beside the area lights.

    Returns (color tuple of (M,) f32, segments traced per ray (M,) int32).
    """
    gh, gw = global_shape
    uniform = cfg.sampling == "uniform"
    use_nee = cfg.use_nee and lights is not None
    use_env_nee = cfg.use_nee and env_dist is not None
    any_nee = use_nee or use_env_nee
    use_mis = cfg.use_mis and any_nee
    if surface is None:
        surface = brute_surface(cfg, scene)
    if any_nee and occluded is None:
        occluded = brute_occluded(cfg, scene)
    seed = rng.sample_seed(px, py, sample_ids, frame, cfg.spp_per_step)
    r1, seed = rng.rand(seed)
    r2, seed = rng.rand(seed)
    o, d = generate_rays_soa(px, py, r1, r2, cfg.camera, gw, gh)
    if cfg.camera.lens_radius > 0.0:
        rl1, seed = rng.rand(seed)
        rl2, seed = rng.rand(seed)
        o, d = apply_thin_lens_soa(o, d, rl1, rl2, cfg.camera)
    weight = vec.splat((1.0, 1.0, 1.0), like=o[0])
    if color is None:
        color = vec.splat((0.0, 0.0, 0.0), like=o[0])
    sky = vec.splat([f32(s) for s in cfg.sky_emission], like=o[0])
    dev = o[0].device
    done = torch.zeros(o[0].shape, dtype=torch.bool, device=dev)
    segs = torch.zeros(o[0].shape, dtype=torch.int32, device=dev)
    if any_nee:
        # emission counts in full on camera rays and after mirrors
        count_emit = torch.ones(o[0].shape, dtype=torch.bool, device=dev)
        pdf_prev = torch.zeros(o[0].shape, device=dev)
    if sort_key is not None:
        slot = torch.arange(o[0].shape[0], device=dev)
        prev_mtype = torch.zeros(o[0].shape, device=dev)

    for depth in range(cfg.max_depth):
        if sort_key is not None and depth > 0:
            perm = torch.sort(sort_key(o, d, done, prev_mtype),
                              stable=True).indices
            fl = [*o, *d, *weight, *color, prev_mtype]
            it = [seed, done.long(), segs.long(), slot]
            if any_nee:
                fl.append(pdf_prev)
                it.append(count_emit.long())
            fl = torch.stack(fl)[:, perm]
            it = torch.stack(it)[:, perm]
            o, d, weight, color = (tuple(fl[i:i + 3]) for i in (0, 3, 6, 9))
            prev_mtype = fl[12]
            seed, done, segs, slot = (it[0], it[1].bool(), it[2].int(),
                                      it[3])
            if any_nee:
                pdf_prev, count_emit = fl[13], it[4].bool()
        active = torch.logical_not(done)
        (miss, position, normal, diffuse, emission, spec, mtype, rough,
         t_hit) = surface(o, d, active)
        if env is not None:
            # image-based sky: the equirect map in the miss direction
            sky = sample_environment(env, d)
        emission = vec.where(miss, sky, emission)
        emit_w = active.to(torch.float32)
        if any_nee:
            emit_w = emission_weight(
                use_mis, count_emit, pdf_prev, miss, d, normal, t_hit,
                emission, lights.inv_area if use_nee else None,
                env_pdf(env_dist, d) if use_env_nee and use_mis else None,
                use_env_nee) * emit_w
        color = vec.add(color, vec.scale(vec.mul(weight, emission), emit_w))

        hit = torch.logical_not(miss)
        is_mirror = (mtype == 1) & hit
        # specular faces (delta BSDFs) take no light sample
        is_spec = is_mirror
        if has_diel:
            is_diel = (mtype == 3) & hit
            is_spec = is_mirror | is_diel
        ggx = is_glossy = None
        if has_glossy:
            is_glossy = (mtype == 2) & hit
            ggx = ggx_frame(d, normal, rough, spec)
        if use_nee:
            r_sel, seed = rng.rand(seed)
            rl1, seed = rng.rand(seed)
            rl2, seed = rng.rand(seed)
            shadow_q = active & torch.logical_not(miss | is_spec)
            color = vec.add(color, nee_direct(
                lights, r_sel, rl1, rl2, position, normal, diffuse, weight,
                shadow_q, occluded, use_mis, uniform, fused_nee, ggx,
                is_glossy))
        if use_env_nee:
            r_sel, seed = rng.rand(seed)
            rl1, seed = rng.rand(seed)
            rl2, seed = rng.rand(seed)
            shadow_q = active & torch.logical_not(miss | is_spec)
            color = vec.add(color, env_nee_direct(
                env, env_dist, r_sel, rl1, rl2, position, normal, diffuse,
                weight, shadow_q, occluded, use_mis, uniform, fused_nee,
                cfg.t_max, ggx, is_glossy))

        r1, seed = rng.rand(seed)
        r2, seed = rng.rand(seed)
        if uniform:
            new_dir = sample_direction_uniform_soa(r1, r2, normal)
            cos_t = vec.dot(new_dir, normal)
            scale = vec.scale(diffuse, UNIFORM_SCALE * cos_t)
        else:
            new_dir = sample_direction_cosine_soa(r1, r2, normal)
            scale = diffuse  # pdf = cos/pi cancels the cosine
        if has_glossy:
            wi_g, scale_g, g_valid, h_z = ggx_bounce(ggx, r1, r2)
            new_dir = vec.where(is_glossy, wi_g, new_dir)
            scale = vec.where(is_glossy, scale_g, scale)
        if use_mis:
            # the pdf of the sampled direction, taken before the mirror
            # override (mirror paths never read it: count_emit is set)
            if uniform:
                new_pdf = torch.full_like(pdf_prev, UNIFORM_PDF)
            else:
                new_pdf = torch.clamp_min(vec.dot(new_dir, normal),
                                          0.0) * INV_PI
            if has_glossy:
                new_pdf = torch.where(
                    is_glossy, ggx_vndf_pdf(ggx.wo_l[2], h_z, ggx.alpha),
                    new_pdf)
        if has_mirrors:
            # perfect mirror: reflect about the normal flipped toward the
            # incoming ray (geometry is double-sided)
            n_dot_d = vec.dot(d, normal)
            n_f = vec.where(n_dot_d > 0, vec.scale(normal, -1.0), normal)
            refl = vec.sub(d, vec.scale(n_f, 2.0 * vec.dot(d, n_f)))
            new_dir = vec.where(is_mirror, refl, new_dir)
            scale = vec.where(is_mirror, spec, scale)
        if has_diel:
            # Snell refraction with the exact Fresnel split; the IOR rides
            # in rough as (Ni - 1) / 4 (scene/objload.py), the tint is Ks
            refl_d, refr_d, fres, tir = dielectric_reflect_refract_soa(
                d, normal, 1.0 + 4.0 * rough)
            diel_dir = vec.where(tir | (r1 < fres), refl_d, refr_d)
            new_dir = vec.where(is_diel, diel_dir, new_dir)
            scale = vec.where(is_diel, spec, scale)

        cont = active & hit
        if has_glossy:
            # a GGX bounce below the surface is absorbed
            cont = cont & torch.logical_not(is_glossy
                                            & torch.logical_not(g_valid))
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
        if any_nee:
            count_emit = is_spec
        if use_mis:
            pdf_prev = torch.where(cont, new_pdf, pdf_prev)
        if sort_key is not None:
            prev_mtype = torch.where(cont, mtype.to(torch.float32), 0.0)
    if sort_key is not None:
        back = torch.empty_like(slot)
        back[slot] = torch.arange(slot.shape[0], device=dev)
        color = tuple(c[back] for c in color)
        segs = segs[back]
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
                     global_shape: Optional[tuple] = None,
                     trace_payload_fn: Optional[Callable] = None,
                     occlusion_fn: Optional[Callable] = None,
                     stream: bool = False):
    """Build ``render_step(state, row0=0) -> state`` for a (local) image of
    the shape of ``state.accum``, on the device of ``scene``.

    ``row0`` is the global row offset of this accumulator band; rays are
    generated in GLOBAL pixel coordinates of ``global_shape`` (default: the
    config's), so a band renders bitwise the rows of the full image.

    ``trace_payload_fn(o, d, t_max, active) -> Payload``: trace through a
    payload trace (kernels/bvh_packet.make_packet_trace, K3 on a CUDA
    device; kernels/bvh_packet2.make_packet_trace2, K6) instead of brute
    force. Then the step traces the image in ``PACKET_TILE`` square pixel
    tiles when the tile divides both sides, so that K6's
    1024-ray packets are compact screen tiles (sfvp_tpu wavefront.py
    :704-746); and, when ``sort_rays(cfg, stream)`` is on (``stream``:
    the payload trace is K6, dispatch.packet_trace_kwargs), every bounce
    after the first sorts the wave by ``make_sort_key``. Neither changes a
    pixel's colour sum.

    A textured scene is shaded through its texture table (the payload
    trace carries the hit's vt and texture id); a scene with an
    environment map reads it on every miss and, under ``cfg.use_nee``,
    samples it at every hit (``env_nee_direct``, its distribution built
    once here).

    With ``cfg.use_nee`` the scene's area lights are sampled at every hit
    (integrate/lights.py, the table built once here) and their shadow rays
    traced by ``occlusion_fn(o, d, t_max, active) -> (N,) bool``
    (kernels/bvh_packet.make_packet_occlusion, K4 on a CUDA device); with
    none, by the payload trace (``payload_occluded``) or, without one
    either, by brute force.

    ``render_step.render_pixels(px, py, frame) -> (color_sum, segs)``
    traces ``cfg.spp_per_step`` samples of step ``frame`` for each of the
    (N,) GLOBAL pixels (px, py): per-pixel colour sums (a tuple of three
    (N,) tensors) and the int64 total of traced segments.
    """
    require_slice(cfg, scene)
    gshape = global_shape if global_shape is not None else (cfg.height,
                                                            cfg.width)
    chunk = cfg.spp_chunk
    mirrors = has_mirror_faces(scene)
    mats = material_flags(scene)
    dev = scene.device
    lights = build_light_table_from_buffers(scene) if cfg.use_nee else None
    env = scene.env
    env_dist = (env_distribution_for(env) if cfg.use_nee and env is not None
                else None)
    if trace_payload_fn is None:
        surface, sort_key, ts = brute_surface(cfg, scene), None, 0
    else:
        surface = payload_surface(cfg, trace_payload_fn, scene.textures)
        sort_key = make_sort_key(cfg, scene, sort_rays(cfg, stream))
        ts = PACKET_TILE
        if occlusion_fn is None:
            occlusion_fn = payload_occluded(trace_payload_fn)

    def render_pixels(px, py, frame: int):
        n = px.shape[0]
        pxw, pyw = px.repeat(chunk), py.repeat(chunk)

        def wave(chunk_idx):
            s_ids = (chunk_idx * chunk
                     + torch.arange(chunk, device=dev)).repeat_interleave(n)
            color, seg = trace_wave(cfg, scene, pxw, pyw, s_ids, frame,
                                    gshape, has_mirrors=mirrors,
                                    surface=surface, sort_key=sort_key,
                                    lights=lights, occluded=occlusion_fn,
                                    env=env, env_dist=env_dist, **mats)
            return (*color, seg)

        return sum_chunks(cfg, n, wave, dev)

    def render_step(state: RenderState, row0: int = 0) -> RenderState:
        h, w = state.accum.shape[0], state.accum.shape[1]
        idx = torch.arange(h * w, device=dev)
        swizzle = ts > 0 and h % ts == 0 and w % ts == 0
        if swizzle:
            # wave slot i is pixel i % ts^2 of tile i // ts^2, row-major
            tile, within = idx // (ts * ts), idx % (ts * ts)
            px = (tile % (w // ts)) * ts + within % ts
            py = (tile // (w // ts)) * ts + within // ts
        else:
            px, py = idx % w, idx // w
        color_sum, segs = render_pixels(px, py + row0, state.frame)
        if swizzle:
            pix = py * w + px
            color_sum = tuple(torch.empty_like(c).index_copy_(0, pix, c)
                              for c in color_sum)
        return accumulate(state, color_sum, segs, cfg.spp_per_step)

    render_step.render_pixels = render_pixels
    return render_step
