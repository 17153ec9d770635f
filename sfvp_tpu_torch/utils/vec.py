"""SoA vec3 math on tensors: a vector field is a tuple of three
same-shaped tensors (the layout of sfvp_tpu.utils.vec). The operation order
of every helper matches the JAX package, so both round the same way."""

from __future__ import annotations

import numpy as np
import torch

V3 = tuple  # (x, y, z)


def f32(x) -> float:
    """A Python float holding the float32 rounding of ``x``: tensor
    arithmetic with it then matches the JAX package's np.float32 constants
    (PyTorch rounds a Python scalar to the tensor's float32 first)."""
    return float(np.float32(x))


def splat(scalar3, like: torch.Tensor) -> V3:
    """Broadcast a length-3 constant to a component tuple shaped like
    ``like`` (float32, on its device)."""
    return tuple(torch.full_like(like, float(s), dtype=torch.float32)
                 for s in scalar3)


def from_array(arr: torch.Tensor) -> V3:
    """(..., 3) -> component tuple."""
    return (arr[..., 0], arr[..., 1], arr[..., 2])


def to_array(v) -> torch.Tensor:
    return torch.stack(tuple(v), dim=-1)


def add(a, b) -> V3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b) -> V3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a, b) -> V3:
    """Elementwise (Hadamard) product."""
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(a, s) -> V3:
    return (a[0] * s, a[1] * s, a[2] * s)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b) -> V3:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def inv_sqrt(x):
    """1/sqrt(x) as two correctly rounded ops, as the numpy oracle
    (tools/oracle_ref.py) computes it. Not torch.rsqrt: on a CUDA device
    that is the approximate rsqrtf, whose last-bit errors flip hit/miss
    decisions; on an H100 it put K1's 128², 1024-spp Cornell render 1.34e-4
    (relative RMSE) from the oracle, against 2.2e-6 with 1/sqrt. The CUDA
    kernels compute 1.0f / sqrtf(x) alike."""
    return 1.0 / torch.sqrt(x)


def normalize(a) -> V3:
    return scale(a, inv_sqrt(dot(a, a)))


def where(mask, a, b) -> V3:
    return (
        torch.where(mask, a[0], b[0]),
        torch.where(mask, a[1], b[1]),
        torch.where(mask, a[2], b[2]),
    )


def maxc(a):
    """Max component."""
    return torch.maximum(a[0], torch.maximum(a[1], a[2]))
