"""Render configuration.

The reference (yknishidate/single-file-vulkan-pathtracing) hardcodes every
knob as a compile-time constant; those constants are the de-facto spec and
are the defaults here:

- resolution 1024x1024            (ref main.cpp:16-17)
- 32 samples per frame            (ref shaders/raygen.rgen:43)
- max path depth 8                (ref shaders/raygen.rgen:62)
- tmin 0.001 / tmax 10000         (ref shaders/raygen.rgen:72-73)
- sky emission (0.7, 0.6, 0.5)    (ref shaders/miss.rmiss:10)
- uniform-hemisphere sampling, pdf = 1/(2*pi)  (ref shaders/raygen.rgen:23-30,79)
- camera origin (0,-1,5), target plane z=2     (ref shaders/raygen.rgen:55-56)
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera expressed as: ray target = center + d.x*right + d.y*up,
    direction = normalize(target - origin), with d in NDC [-1,1]^2.

    Defaults reproduce the reference frustum exactly
    (ref shaders/raygen.rgen:55-57): origin (0,-1,5),
    target (d.x, d.y - 1, 2)  ==  center (0,-1,2) + d.x*(1,0,0) + d.y*(0,1,0).
    """

    origin: Tuple[float, float, float] = (0.0, -1.0, 5.0)
    center: Tuple[float, float, float] = (0.0, -1.0, 2.0)
    right: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    # thin-lens depth of field (extension; 0 = pinhole like the reference).
    # Added after v1: config_hash omits these at their defaults so pinhole
    # hashes (and existing checkpoints/goldens) are unchanged.
    lens_radius: float = 0.0
    focus_dist: float = 0.0

    @staticmethod
    def look_at(origin, target, up=(0.0, 1.0, 0.0), fov_y_deg=60.0, aspect=1.0):
        """General constructor: build the (center, right, up) frame from a
        classic look-at + vertical field of view."""
        import math

        import numpy as np

        o = np.asarray(origin, np.float64)
        tgt = np.asarray(target, np.float64)
        fwd = tgt - o
        fwd = fwd / np.linalg.norm(fwd)
        upv = np.asarray(up, np.float64)
        r = np.cross(fwd, upv)
        r = r / np.linalg.norm(r)
        u = np.cross(r, fwd)
        half_h = math.tan(math.radians(fov_y_deg) / 2.0)
        half_w = half_h * aspect
        center = o + fwd
        # NDC d.y grows DOWN the image (row-major pixel convention, same as
        # the reference frustum), so world-up must map to NEGATIVE d.y for
        # an upright image.
        return CameraConfig(
            origin=tuple(map(float, o)),
            center=tuple(map(float, center)),
            right=tuple(map(float, r * half_w)),
            up=tuple(map(float, -u * half_h)),
        )


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1024
    height: int = 1024
    spp_per_step: int = 32          # samples per progressive step ("frame")
    max_depth: int = 8              # path segments per sample
    t_min: float = 0.001
    t_max: float = 10000.0
    sky_emission: Tuple[float, float, float] = (0.7, 0.6, 0.5)
    camera: CameraConfig = CameraConfig()

    # sampling: "uniform" = reference parity (pdf 1/2pi, ref raygen.rgen:23-30);
    # "cosine" = cosine-weighted importance sampling (faster convergence,
    # identical converged image).
    sampling: str = "uniform"

    # Extensions the reference does NOT have (ref raygen.rgen:62-84 is naive
    # PT). Off by default == parity mode.
    use_nee: bool = False            # next-event estimation
    use_mis: bool = False            # balance-heuristic MIS (requires NEE)
    use_rr: bool = False             # Russian roulette
    rr_start_depth: int = 3

    # Execution knobs (do not affect the image in expectation). The JAX
    # package's TPU knobs (backend, block rows, the VMEM budget) are
    # unhashed and have no counterpart here.
    spp_chunk: int = 1               # samples folded into one ray wave
    # "auto" | "brute" | "bvh"
    traversal: str = "auto"
    # "auto": brute force up to this many triangles, the wide BVH beyond
    brute_force_max_tris: int = 256
    # in-lane sample regeneration: one thread runs all spp samples of its
    # pixel back to back (kernel K1, K5 on the BVH). Off = the chunked
    # kernel K2, or on the BVH the wavefront loop over the trace kernel
    # K3, which keep the wavefront integrator's per-sample summation order.
    megakernel_regen: bool = True
    # re-sort the wavefront loop's rays every bounce by (direction octant,
    # position morton) on the BVH route (integrate/wavefront.py
    # make_sort_key); dead rays sort last. Execution knob: never changes
    # the image. Off by default here (sfvp_tpu turns it on): on an H100
    # the sort costs more than the trace gains, a 1024x1024 8-spp
    # wavefront step of the 100k sphere taking ~190 ms with it and ~138 ms
    # without (chip_smoke.py, ray-sort phase).
    sort_bounce_rays: bool = False
    # prepend the surface material type to that sort key; only engages on
    # scenes that mix materials. Execution knob: never changes the image.
    sort_material_key: bool = True
    # the packet trace K6 (kernels/bvh_packet2.py) as the wavefront loop's
    # payload and shadow trace on the bvh route: None = as sfvp_tpu decides
    # it, when the wide BVH's rows exceed its VMEM budget of 13 MiB
    # (dispatch.STREAM_SCENE_BYTES); True/False = force. Execution knob:
    # K6 and K3 differ only in which triangle wins an exact tie in t.
    stream_tris: Optional[bool] = None
    # debug config: assert a finite accumulator at every observed step
    # boundary of the progressive loop.
    debug_nan: bool = False

    def spp_chunks(self):
        if self.spp_per_step % self.spp_chunk != 0:
            raise ValueError(
                f"spp_per_step={self.spp_per_step} must be divisible by "
                f"spp_chunk={self.spp_chunk}"
            )
        return self.spp_per_step // self.spp_chunk

    # fields that affect the accumulated image (whitelist — execution knobs
    # like backend/traversal/block sizes/sorting never change the estimate).
    # spp_chunk is an execution knob since round 5: per-sample streams are
    # derived from (pixel, global sample index), so folding samples into
    # waves is chunk-layout INVARIANT up to f32 summation order
    # (test_spp_chunk_invariance) and dispatch may auto-tune it
    # (dispatch._auto_chunk_cfg). config_hash hashes the constant 1 in its
    # place so every default-chunk hash (goldens, existing checkpoints)
    # stays stable; checkpoints written with spp_chunk>1 under older
    # versions hash differently and refuse resume — correct, since their
    # accumulated bits depend on the old chunked summation order (the
    # round-4 fused re-route of chunked-NEE configs already changed those
    # bits once, see docs/ROADMAP.md).
    _IMAGE_FIELDS = (
        "width", "height", "spp_per_step", "max_depth", "t_min", "t_max",
        "sky_emission", "camera", "sampling", "use_nee", "use_rr",
        "rr_start_depth",
    )
    # image-affecting fields added AFTER v1: hashed only when non-default,
    # so hashes of configs that do not use them are stable across versions
    # (existing checkpoints/goldens keep verifying).
    _IMAGE_FIELDS_OPT = ("use_mis",)

    def config_hash(self) -> str:
        """Stable hash of everything that affects the accumulated image;
        stored in checkpoints so resume can refuse a mismatched config."""
        d = dataclasses.asdict(self)
        keep = {k: d[k] for k in self._IMAGE_FIELDS}
        # legacy constant: v1 hashed spp_chunk; pinning 1 here keeps every
        # default-chunk hash bit-stable now that the field is an
        # execution knob (see _IMAGE_FIELDS comment)
        keep["spp_chunk"] = 1
        for k in self._IMAGE_FIELDS_OPT:
            if d[k] != getattr(type(self), k):
                keep[k] = d[k]
        # camera fields added after v1 (DOF): hashed only when non-default
        # so existing pinhole hashes stay stable
        for k in ("lens_radius", "focus_dist"):
            if keep["camera"].get(k) == getattr(CameraConfig, k):
                keep["camera"] = {
                    kk: v for kk, v in keep["camera"].items() if kk != k
                }
        blob = json.dumps(keep, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]
