"""Backend dispatch: the render step for a config and scene.

The port runs the brute-force route of sfvp_tpu.dispatch.select_render_step
(dispatch.py:236-254): K1 (kernels/megakernel_regen.py) by default, K2
(kernels/megakernel.py) with ``megakernel_regen=False``. The scene's device
picks the implementation inside each kernel wrapper: a CUDA tensor runs the
hand-written kernel, a CPU tensor its plain PyTorch twin. A config outside
the ported slice raises NotImplementedError naming its ROADMAP.md item;
nothing falls back to another integrator.

SFVP_DISPATCH_DEBUG=1 prints the route taken (stderr, one line per
selection).
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

from .config import RenderConfig
from .integrate.wavefront import require_slice


def _dbg(choice: str, **why) -> None:
    if os.environ.get("SFVP_DISPATCH_DEBUG", "") not in ("", "0"):
        detail = " ".join(f"{k}={v}" for k, v in why.items())
        print(f"[sfvp_tpu_torch dispatch] {choice} {detail}".rstrip(),
              file=sys.stderr, flush=True)


def select_render_step(cfg: RenderConfig, buffers,
                       global_shape: Optional[tuple] = None) -> Callable:
    """Returns ``render_step(state, row0=0) -> state``."""
    require_slice(cfg, buffers)
    dev = buffers.device
    if cfg.megakernel_regen:
        from .kernels.megakernel_regen import make_regen_render_step

        _dbg("megakernel_regen(brute)", tris=buffers.num_tris, device=dev)
        return make_regen_render_step(cfg, buffers, global_shape=global_shape)
    from .kernels.megakernel import make_wave_render_step

    _dbg("megakernel(chunked parity)", tris=buffers.num_tris, device=dev)
    return make_wave_render_step(cfg, buffers, global_shape=global_shape)
