"""Counter-based PCG random numbers, bit-exact with the reference's GLSL
and with sfvp_tpu.rng.

Reference recipes (ref shaders/common.glsl:13-37):
  - ``pcg``:   state' = state*747796405 + 2891336453;
               word = ((state' >> ((state' >> 28)+4)) ^ state') * 277803737;
               out  = (word >> 22) ^ word
  - ``pcg2d``: 2D hash used only for seeding
  - ``rand``:  float(pcg(seed)) * (1/float(0xffffffff))
               note: float(0xffffffffu) rounds to 2^32 in fp32, so the scale
               is exactly 2^-32 — rand can return values in [0, 1].

Seeding (ref shaders/raygen.rgen:47-48):
  s = pcg2d(uvec2(pixel.xy) * (sample + spp*frame + 1)); seed = s.x + s.y

PyTorch has no uint32 ``+`` or ``>>`` on every device, so a uint32 word is
held in an int64 tensor and every step is masked back to 32 bits. Each
product below stays under 2^63 before the mask (the multipliers are < 2^30),
except ``sample_seed``'s pixel-by-multiplier product, which ``_mul32``
splits into 16-bit halves.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
# float(0xffffffffu) rounds to 4294967296.0 in fp32 => scale is exactly 2^-32
_RAND_SCALE = 2.0**-32


def _u32(x, device=None) -> torch.Tensor:
    """A uint32 word as an int64 tensor (Python ints and int tensors)."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for a, b in [0, 2^32), without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def pcg(state: torch.Tensor):
    """One PCG step. Returns ``(value, new_state)``, uint32 words in int64.

    Matches GLSL ``uint pcg(inout uint state)`` exactly, including the
    quirk that the *pre*-permutation LCG output becomes the new state.
    """
    prev = (state * 747796405 + 2891336453) & _M32
    shift = (prev >> 28) + 4
    word = (((prev >> shift) ^ prev) * 277803737) & _M32
    return (word >> 22) ^ word, prev


def pcg2d(vx: torch.Tensor, vy: torch.Tensor):
    """GLSL ``uvec2 pcg2d(uvec2 v)``, statement-for-statement.

    Note the sequencing: ``v.y += v.x*k`` uses the *already updated* v.x.
    """
    k = 1664525
    c = 1013904223
    vx = (vx * k + c) & _M32
    vy = (vy * k + c) & _M32
    vx = (vx + vy * k) & _M32
    vy = (vy + vx * k) & _M32
    vx = vx ^ (vx >> 16)
    vy = vy ^ (vy >> 16)
    vx = (vx + vy * k) & _M32
    vy = (vy + vx * k) & _M32
    vx = vx ^ (vx >> 16)
    vy = vy ^ (vy >> 16)
    return vx, vy


def rand(seed: torch.Tensor):
    """GLSL ``float rand(inout uint seed)``: returns ``(u, new_seed)`` with
    u = float32 in [0, 1] (inclusive upper due to the fp32 rounding quirk)."""
    val, seed = pcg(seed)
    return val.to(torch.float32) * _RAND_SCALE, seed


def sample_seed(px, py, sample_index, frame, spp: int) -> torch.Tensor:
    """Per-(pixel, sample, frame) seed, ref shaders/raygen.rgen:47-48.

    px, py: integer tensors (pixel x = column, y = row).
    sample_index: int or integer tensor, the sample number within the step.
    frame: int, the progressive-step counter.
    spp: samples per step (the reference's hardcoded ``maxSamples``).
    """
    dev = px.device
    m = (_u32(sample_index, dev) + _mul32(_u32(spp, dev), _u32(frame, dev))
         + 1) & _M32
    sx, sy = pcg2d(_mul32(_u32(px), m), _mul32(_u32(py), m))
    return (sx + sy) & _M32
