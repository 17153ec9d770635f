"""The least time a step of a cell could take on the card, from frozen
counts: the yardstick of ``kernels_roofline``.

Operations: the rays a step needs (the cell's frozen ``rays_per_sample``
and ``shadow_rays_per_sample``, counted by the plain reference when the
cell was added, times the step's samples) times a floor per ray. A
segment's floor is one ray-triangle test and the least shading and
sampling a diffuse bounce needs; a shadow ray's is one test. Bytes: the
scene's triangle and material rows read once, the environment map and its
distribution read once, and the accumulator read and written once. The
constants are counted from ``reference/tracer.py`` (FP32 operations; a
square root, a reciprocal, a sine or a cosine counts one; an integer or a
select none); what a step needs beyond the floor is not counted, so the
share is a lower bound of the kernel's.
"""

from __future__ import annotations

import json
from pathlib import Path

# RefScene._test with the edges stored: cross(d, e2) 9, det 5, |det| > eps
# 2, 1/det 1, o - v0 3, u 6, cross(tv, e1) 9, v 6, t 6, the window and
# barycentric compares 6, the closest-hit compare 1
TEST_OPS = 54
# render_slots on a diffuse hit, with a stored normal: the position 17,
# the emission added 6, two random numbers 4, the cosine hemisphere 8, the
# tangent frame 26, to world 15, the weight 3 (cosine sampling, no
# roulette: the least of the cells' estimators)
SHADE_OPS = 79
SEGMENT_OPS = TEST_OPS + SHADE_OPS
# a triangle's three vertices, its diffuse and emitted colour, float32
TRIANGLE_BYTES = (9 + 3 + 3) * 4
# an environment texel's three channels, its CDF and pdf entries, float32
ENV_TEXEL_BYTES = 5 * 4

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str):
    """(FP32 operations/s, bytes/s) of the card ``kind``, or None."""
    with open(PEAKS) as f:
        table = json.load(f)
    if kind not in table:
        return None
    row = table[kind]
    return row["fp32_flops_per_s"], row["hbm_bytes_per_s"]


def step_ops(frozen: dict, samples: int) -> float:
    """FP32 operations a step of ``samples`` camera samples needs."""
    return samples * (frozen["rays_per_sample"] * SEGMENT_OPS
                      + frozen["shadow_rays_per_sample"] * TEST_OPS)


def step_bytes(num_tris: int, env_texels: int, pixels: int) -> float:
    return (num_tris * TRIANGLE_BYTES + env_texels * ENV_TEXEL_BYTES
            + 2 * pixels * 3 * 4)


def least_step_s(frozen: dict, samples: int, num_tris: int,
                 env_texels: int, pixels: int, kind: str):
    """The larger of the operations over the FP32 peak and the bytes over
    the memory bandwidth, in seconds; None for a card not in the table."""
    pk = peaks(kind)
    if pk is None:
        return None
    flops, bw = pk
    return max(step_ops(frozen, samples) / flops,
               step_bytes(num_tris, env_texels, pixels) / bw)
