"""P3 and P4, the equirect environment fetch over a wave of directions: the
fetch K1 and K5 run on every miss and for the radiance of every env NEE
sample, as a kernel of its own.

``env_fetch`` (P3) looks each of (3, N) unit directions up in an
environment map: on a CUDA tensor through the hand-written kernel
csrc/env_fetch.cu, which calls the device function of K1 and K5
(csrc/common.cuh env_lookup); on a CPU tensor through its plain twin, the
package's ``scene/textures.py sample_environment``. Counterpart of
benchmarks/probe_envfetch.py (``run``), which checks the TPU kernel's
in-kernel fetch against sample_environment.

``env_fetch_ablate`` (P4) runs the fetch with parts of it taken away, the
GPU meaning of benchmarks/probe_envfetch_ablate.py's ladder (``main``),
each beside its twin: "trig" writes the direction's (u, v, u + v) alone;
"noread" keeps the index and weight math with the texels replaced by 1.0
and writes the weights' sum; "half" reads the texels from a float16 copy
of the map (``half_map``), the counterpart of the TPU's bf16 operand;
"full" is P3. The TPU ladder's "high" and "noconc" change the MXU's
precision and a concat, which the GPU fetch does not have.
"""

from __future__ import annotations

import torch

from ..scene.textures import (
    TextureTable,
    bilinear_taps,
    blend,
    equirect_uv,
    sample_environment,
)
from . import build

# the kernel's template modes (csrc/env_fetch.cu EnvFetchMode)
ABLATIONS = {"full": 0, "trig": 1, "noread": 2, "half": 3}


def half_map(env: TextureTable) -> torch.Tensor:
    """(3, H*W) float16 copy of the environment map's texels (round to
    nearest even), P4's "half" operand."""
    h, w = env.shape0()
    return torch.stack([c[: h * w] for c in (env.tr, env.tg, env.tb)]
                       ).to(torch.float16).contiguous()


def env_fetch_plain(env: TextureTable, dirs: torch.Tensor,
                    mode: str = "full", half=None) -> torch.Tensor:
    """Plain PyTorch twin of P3 (``mode`` "full") and of P4's variants:
    (3, N) directions in, (3, N) planes out."""
    d = tuple(dirs)
    if mode == "full":
        return torch.stack(sample_environment(env, d))
    u, v = equirect_uv(env, d)
    if mode == "trig":
        return torch.stack([u, v, u + v])
    zero = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    taps, weights = bilinear_taps(env, zero, u, v)
    if mode == "noread":
        ones = torch.ones(env.tr.shape, device=u.device)
        (s,) = blend((ones,), taps, weights)
        return torch.stack([s, s, s])
    if mode == "half":
        hm = half_map(env) if half is None else half
        return torch.stack(blend(tuple(hm.to(torch.float32)), taps, weights))
    raise ValueError(f"unknown env fetch mode {mode!r}; one of "
                     f"{sorted(ABLATIONS)}")


def _check(env: TextureTable, dirs: torch.Tensor) -> None:
    if (dirs.dtype != torch.float32 or dirs.dim() != 2 or dirs.shape[0] != 3
            or not dirs.is_contiguous()):
        raise ValueError(f"directions must be contiguous float32 (3, N) "
                         f"planes, got {dirs.dtype} {tuple(dirs.shape)}")
    if dirs.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take a CUDA tensor, got "
                         f"{dirs.device}")
    build.check_env(env, dirs.device)


def _launch(env: TextureTable, dirs: torch.Tensor, mode: str, half=None):
    _check(env, dirs)
    params = build.Params()
    build.set_env(params, env)
    params.inv_two_pi, params.inv_pi = build.INV_TWO_PI, build.INV_PI
    if mode == "half":
        half = half_map(env) if half is None else half
        if half.device != dirs.device or half.dtype != torch.float16:
            raise ValueError("the half map is float16 on the directions' "
                             "device")
    return build.launch_env_fetch(params, dirs, ABLATIONS[mode],
                                  half if mode == "half" else None)


def env_fetch(env: TextureTable, dirs: torch.Tensor) -> torch.Tensor:
    """P3 on the directions' device: the CUDA kernel for a CUDA tensor (or
    an error), the plain twin for a CPU tensor. ``env_fetch.launches``
    counts kernel launches."""
    if dirs.device.type == "cpu":
        return env_fetch_plain(env, dirs)
    out = _launch(env, dirs, "full")
    env_fetch.launches += 1
    return out


env_fetch.launches = 0


def env_fetch_ablate(env: TextureTable, dirs: torch.Tensor, mode: str,
                     half=None) -> torch.Tensor:
    """P4, the variant ``mode`` of ABLATIONS on the directions' device:
    the CUDA kernel for a CUDA tensor (or an error), the plain twin for a
    CPU tensor; ``half``: a ``half_map`` made once for the "half" mode.
    ``env_fetch_ablate.launches`` counts kernel launches."""
    if mode not in ABLATIONS:
        raise ValueError(f"unknown env fetch mode {mode!r}; one of "
                         f"{sorted(ABLATIONS)}")
    if dirs.device.type == "cpu":
        return env_fetch_plain(env, dirs, mode, half)
    out = _launch(env, dirs, mode, half)
    env_fetch_ablate.launches += 1
    return out


env_fetch_ablate.launches = 0
