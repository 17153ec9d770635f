"""Backend dispatch: the render step for a config and scene.

The port runs the brute-force and single-level BVH routes of
sfvp_tpu.dispatch.select_render_step (dispatch.py:236-364), and the
instanced routes of select_instanced_render_step (dispatch.py:373-531):

  - brute (``traversal="brute"``, or "auto" up to brute_force_max_tris
    triangles): K1 (kernels/megakernel_regen.py) by default, K2
    (kernels/megakernel.py) with ``megakernel_regen=False``; K2 has no
    next-event estimation, so with ``cfg.use_nee`` the eager wavefront
    integrator (integrate/wavefront.py, no kernel) takes its place, as
    sfvp_tpu's jnp wavefront does (dispatch.py:245-256);
  - bvh (``traversal="bvh"``, or "auto" beyond): the wide BVH
    (accel/wide.py) traced by K5 (kernels/megakernel_bvh.py) by default,
    or with ``megakernel_regen=False`` by the wavefront loop
    (integrate/wavefront.py) over the payload trace K3 and, with
    ``cfg.use_nee``, the any-hit trace K4 for its shadow rays
    (kernels/bvh_packet.py); on a streamed scene (``stream_tris``) over
    the packet trace K6 (kernels/bvh_packet2.py) for both, as sfvp_tpu's
    ``packet_trace_kwargs`` (dispatch.py:534-561); the loop sorts its
    bounce rays where integrate/wavefront.py ``sort_rays`` says (by
    default on K6's route only);
  - instanced (a list of accel.instances.Instance): the two-level BVH
    (accel/tlas.py) traced by K9 (kernels/megakernel_bvh.py with ``tl=``)
    by default, or with ``megakernel_regen=False`` by the wavefront loop
    over the two-level payload trace K7 and, with ``cfg.use_nee``, the
    two-level any-hit trace K8 (kernels/bvh_tlas.py); materials and
    lights come from the flattened scene's buffers.

Environment maps (the sky of a miss, and under ``cfg.use_nee`` its
importance-sampled NEE) and map_Kd textures run on every single-level
route: inside K1 and K5 at any map or atlas size (sfvp_tpu's
ENV_VMEM_MAX_BYTES, TEX_VMEM_MAX_BYTES and MAX_KERNEL_TEXTURES gates,
dispatch.py:164-205, are memory gates and are dropped, and so are its
deferred env records and its preference for the wavefront loop under
env NEE on an oversized map, dispatch.py:303-316: K5 draws the same
streams); on the wavefront loop around K3, K4 and K6, whose payload
carries the hit's vt and texture id; and in the eager loop that brute
force with ``megakernel_regen=False`` takes with either, as sfvp_tpu
takes its jnp loop (K2 has neither, dispatch.py:245-256). Instanced
scenes refuse both (ROADMAP.md A.13b).

``select_wavefront_kwargs`` gives the adaptive sampler
(integrate/adaptive.py) the same trace as the wavefront loop.

The TPU's VMEM gates have no meaning on the GPU (ROADMAP.md A.19): every
scene lives in device memory, and so does the light table, so any number
of lights stays on the fused kernels (sfvp_tpu sends more than
MAX_KERNEL_LIGHTS = 16384 to its wavefront loop, dispatch.py:149-159), and
no instanced scene leaves K9 for want of on-chip memory
(``_instanced_fused_blockers``, dispatch.py:422-479, is not ported). The
scene's device picks the implementation
inside each kernel wrapper: a CUDA tensor runs the hand-written kernel, a
CPU tensor its plain PyTorch twin. A config outside the ported slice
raises NotImplementedError naming its ROADMAP.md item; nothing falls back
to another integrator.

One of them stays as a rule of route parity, not of memory: the stream
decision (``stream_tris``) takes K6 where sfvp_tpu does, on a scene whose
wide BVH outgrows sfvp_tpu's VMEM budget (``STREAM_SCENE_BYTES``), so both
packages trace the same scene through the same kernel.

SFVP_DISPATCH_DEBUG=1 prints the route taken (stderr, one line per
selection).
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

from .config import RenderConfig
from .integrate.wavefront import require_slice, sort_rays


def _dbg(choice: str, **why) -> None:
    if os.environ.get("SFVP_DISPATCH_DEBUG", "") not in ("", "0"):
        detail = " ".join(f"{k}={v}" for k, v in why.items())
        print(f"[sfvp_tpu_torch dispatch] {choice} {detail}".rstrip(),
              file=sys.stderr, flush=True)


# sfvp_tpu's vmem_scene_budget (sfvp_tpu/config.py:138-140): the wide BVH
# size above which it streams triangle rows and traces through K6
STREAM_SCENE_BYTES = 13 * 1024 * 1024


def stream_tris(cfg: RenderConfig, wide) -> bool:
    """Whether the wavefront loop traces the host WideBVH ``wide`` through
    K6: ``cfg.stream_tris`` when set, else whether its node and leaf rows
    (and texture rows) exceed STREAM_SCENE_BYTES (sfvp_tpu dispatch.py
    :266-270)."""
    if cfg.stream_tris is not None:
        return bool(cfg.stream_tris)
    nbytes = wide.nodes.nbytes + wide.tris.nbytes + (
        wide.tris_aux.nbytes if wide.tris_aux is not None else 0)
    return nbytes > STREAM_SCENE_BYTES


def packet_trace_kwargs(cfg: RenderConfig, dw, stream: bool) -> dict:
    """make_render_step kwargs of the wavefront loop over the device wide
    BVH ``dw``: K6 as the payload trace and no any-hit kernel (shadow rays
    go through K6) on a streamed scene, else K3 and, with
    ``cfg.use_nee``, K4 (sfvp_tpu dispatch.py:534-561); and ``stream``,
    from which the loop decides whether it sorts its bounce rays
    (integrate/wavefront.py sort_rays)."""
    from .kernels.bvh_packet import make_packet_occlusion, make_packet_trace

    if stream:
        from .kernels.bvh_packet2 import make_packet_trace2

        return {"trace_payload_fn": make_packet_trace2(dw, t_min=cfg.t_min),
                "occlusion_fn": None, "stream": True}
    return {"trace_payload_fn": make_packet_trace(dw, t_min=cfg.t_min),
            "occlusion_fn": (make_packet_occlusion(dw, t_min=cfg.t_min)
                             if cfg.use_nee else None)}


def _need_wide(wide):
    if wide is None:
        raise ValueError(
            "the bvh route traces the scene's wide BVH: pass wide="
            "accel.wide.build_wide_from_buffers(buffers)")


def select_wavefront_kwargs(cfg: RenderConfig, buffers, wide=None) -> dict:
    """make_render_step kwargs of a wavefront-loop integrator on a
    single-level scene: the packet traces on the bvh route
    (``packet_trace_kwargs``, over the host WideBVH ``wide``), none (brute
    force) otherwise. Shared by select_render_step and the adaptive
    sampler, as sfvp_tpu's select_wavefront_kwargs (dispatch.py:564-580);
    an instanced scene's come from ``instanced_wavefront_kwargs``."""
    if resolve_traversal(cfg, buffers) != "bvh":
        return {}
    _need_wide(wide)
    from .kernels.bvh_packet import device_wide

    stream = stream_tris(cfg, wide)
    _dbg("wavefront(packet kernels)", stream=stream, tris=buffers.num_tris,
         device=buffers.device, sort=sort_rays(cfg, stream), nee=cfg.use_nee,
         env=buffers.env is not None, tex=buffers.has_textures)
    return packet_trace_kwargs(cfg, device_wide(wide, buffers.device),
                               stream)


def resolve_traversal(cfg: RenderConfig, buffers) -> str:
    """"brute" or "bvh": "auto" takes the BVH above
    ``cfg.brute_force_max_tris`` triangles."""
    if cfg.traversal == "auto":
        return ("brute" if buffers.num_tris <= cfg.brute_force_max_tris
                else "bvh")
    return cfg.traversal


def select_render_step(cfg: RenderConfig, buffers,
                       global_shape: Optional[tuple] = None,
                       wide=None) -> Callable:
    """Returns ``render_step(state, row0=0) -> state``. ``wide``: the
    scene's host WideBVH (accel.wide.build_wide_from_buffers), which the
    bvh route needs; the Renderer builds it once at set-up."""
    require_slice(cfg, buffers)
    dev = buffers.device
    t = buffers.num_tris
    if resolve_traversal(cfg, buffers) == "bvh":
        _need_wide(wide)
        if cfg.megakernel_regen:
            from .kernels.bvh_packet import device_wide
            from .kernels.megakernel_bvh import make_bvh_regen_render_step

            _dbg("megakernel_bvh(fused regen)", tris=t, device=dev)
            return make_bvh_regen_render_step(
                cfg, buffers, device_wide(wide, dev),
                global_shape=global_shape)
        from .integrate.wavefront import make_render_step

        return make_render_step(
            cfg, buffers, global_shape=global_shape,
            **select_wavefront_kwargs(cfg, buffers, wide))
    if cfg.megakernel_regen:
        from .kernels.megakernel_regen import make_regen_render_step

        _dbg("megakernel_regen(brute)", tris=t, device=dev)
        return make_regen_render_step(cfg, buffers, global_shape=global_shape)
    if cfg.use_nee or buffers.env is not None or buffers.has_textures:
        from .integrate.wavefront import make_render_step

        _dbg("wavefront(brute)", tris=t, device=dev)
        return make_render_step(cfg, buffers, global_shape=global_shape)
    from .kernels.megakernel import make_wave_render_step

    _dbg("megakernel(chunked parity)", tris=t, device=dev)
    return make_wave_render_step(cfg, buffers, global_shape=global_shape)


def require_single_level_images(buffers) -> None:
    """Raise NotImplementedError for an environment map or map_Kd textures
    on an instanced scene (``buffers`` the flattened scene's): the
    two-level routes K7, K8 and K9 come with them in ROADMAP.md A.13b."""
    what = [w for w, on in (("environment maps", buffers.env is not None),
                            ("map_Kd textures", buffers.has_textures)) if on]
    if what:
        raise NotImplementedError(
            f"{' and '.join(what)} on instanced scenes (the two-level "
            "routes K7, K8, K9) are not ported to sfvp_tpu_torch yet "
            "(ROADMAP.md A.13b)")


def instanced_wavefront_kwargs(cfg: RenderConfig, dt) -> dict:
    """make_render_step kwargs of the instanced wavefront loop over the
    device two-level BVH ``dt`` (kernels/bvh_tlas.device_two_level): K7
    as the payload trace and, with ``cfg.use_nee``, K8 as the shadow
    trace, as sfvp_tpu's instanced_wavefront_kwargs on its pallas
    backend; the bounce rays unsorted unless the config asks."""
    from .kernels.bvh_tlas import make_two_level_occlusion, make_two_level_trace

    return {
        "trace_payload_fn": make_two_level_trace(dt, t_min=cfg.t_min),
        "occlusion_fn": (make_two_level_occlusion(dt, t_min=cfg.t_min)
                         if cfg.use_nee else None),
    }


def select_instanced_render_step(cfg: RenderConfig, flat_buffers, tl,
                                 global_shape: Optional[tuple] = None
                                 ) -> Callable:
    """The render step of an instanced scene: ``flat_buffers`` the
    flattened scene's buffers on the render device
    (accel.instances.flatten_instances, for materials and lights), ``tl``
    its host TwoLevelBVH (accel.tlas.build_two_level); the Renderer builds
    both once at set-up. K9 by default, the wavefront loop over K7 (and K8
    under NEE) with ``megakernel_regen=False``. The config is checked on
    the flattened buffers, so the features of later slices still raise,
    an environment map or textures among them (A.13b)."""
    require_slice(cfg, flat_buffers)
    require_single_level_images(flat_buffers)
    from .kernels.bvh_tlas import device_two_level

    dev = flat_buffers.device
    dt = device_two_level(tl, dev)
    why = dict(instances=tl.num_instances, tris=flat_buffers.num_tris,
               nodes=int(tl.nodes.shape[0]), device=dev)
    if cfg.megakernel_regen:
        from .kernels.megakernel_bvh import make_bvh_regen_render_step

        _dbg("megakernel_bvh(fused two-level regen)", **why)
        return make_bvh_regen_render_step(cfg, flat_buffers, tl=dt,
                                          global_shape=global_shape)
    from .integrate.wavefront import make_render_step

    _dbg("wavefront(tlas packet)", nee=cfg.use_nee, **why)
    return make_render_step(cfg, flat_buffers, global_shape=global_shape,
                            **instanced_wavefront_kwargs(cfg, dt))
