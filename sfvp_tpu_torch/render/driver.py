"""Progressive render driver (ref main.cpp:643-685): step the render step,
optionally writing PNG frames, JSONL metrics and checkpoints. PyTorch runs
eagerly and launches asynchronously on a CUDA device; the host waits for
the device (``torch.cuda.synchronize``) only at the observation boundaries
where the JAX driver blocks (sfvp_tpu/render/driver.py:162).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..integrate.wavefront import RenderState, init_state
from ..scene import Scene, upload
from .checkpoint import load_checkpoint, save_checkpoint
from .exr import write_exr
from .png import tonemap_srgb_u8, tonemap_unorm_u8, write_png


def write_image(path: str, img_f32: np.ndarray, srgb: bool = False) -> None:
    """Write by extension: .exr = linear f32 HDR; anything else = PNG
    through the unorm (reference-parity) or sRGB tonemap."""
    if path.lower().endswith(".exr"):
        write_exr(path, img_f32)
    else:
        tonemap = tonemap_srgb_u8 if srgb else tonemap_unorm_u8
        write_png(path, tonemap(img_f32))


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Renderer:
    """Owns the render step plus the progressive state for one scene and
    config, on one device.

    Usage:
        r = Renderer(cfg, scene, device="cuda")
        r.run(steps=32, out="out.png")

    Each step updates the accumulator in place (integrate.accumulate), the
    counterpart of the JAX driver's donated state: the renderer owns its
    state, so no caller sees the old one change. A scene on the BVH route
    gets its wide BVH (``self.wide``) built once at set-up, in
    ``self.bvh_build_s`` host seconds.

    ``scene`` may also be a list of ``accel.instances.Instance``: the
    renderer then shades from the flattened scene's buffers and builds its
    two-level BVH (``self.tl``) once at set-up, in ``self.bvh_build_s``
    (dispatch.select_instanced_render_step).
    """

    def __init__(self, cfg: RenderConfig, scene, device):
        from ..dispatch import (
            resolve_traversal,
            select_instanced_render_step,
            select_render_step,
        )

        self.cfg = cfg
        self.device = torch.device(device)
        # the tree of a large or instanced scene, built once here on the
        # host (the one place that builds it); dispatch checks the config
        self.wide = self.tl = None
        self.bvh_build_s = 0.0
        if isinstance(scene, (list, tuple)):
            from ..accel.instances import flatten_instances
            from ..accel.tlas import build_two_level

            self.buffers = upload(flatten_instances(scene), device=self.device)
            t0 = time.perf_counter()
            self.tl = build_two_level(scene)
            self.bvh_build_s = time.perf_counter() - t0
            self._step = select_instanced_render_step(cfg, self.buffers,
                                                      self.tl)
        else:
            self.buffers = upload(scene, device=self.device)
            if resolve_traversal(cfg, self.buffers) == "bvh":
                from ..accel.wide import build_wide_from_buffers

                t0 = time.perf_counter()
                self.wide = build_wide_from_buffers(self.buffers)
                self.bvh_build_s = time.perf_counter() - t0
            self._step = select_render_step(cfg, self.buffers, wide=self.wide)
        self.state = init_state(cfg.height, cfg.width, self.device)

    def resume(self, checkpoint_path: str) -> None:
        self.state, _ = load_checkpoint(
            checkpoint_path, self.cfg.config_hash(), device=self.device)

    def _save_checkpoint(self, path: str) -> None:
        save_checkpoint(path, self.state, self.cfg.config_hash())

    def step(self, n: int = 1) -> RenderState:
        for _ in range(n):
            self.state = self._step(self.state)
        return self.state

    def image(self) -> np.ndarray:
        """Current progressive estimate, (H, W, 3) float32 on host."""
        return self.state.accum.cpu().numpy()

    def run(
        self,
        steps: int,
        out: Optional[str] = None,
        frame_every: int = 0,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
        log_path: Optional[str] = None,
        srgb: bool = False,
        progress: bool = True,
    ) -> np.ndarray:
        return run_progressive(
            self, steps, out=out, frame_every=frame_every,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, log_path=log_path,
            srgb=srgb, progress=progress,
        )


def run_progressive(
    r: Renderer,
    steps: int,
    out: Optional[str] = None,
    frame_every: int = 0,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    log_path: Optional[str] = None,
    srgb: bool = False,
    progress: bool = True,
) -> np.ndarray:
    """The progressive loop (ref main.cpp:643-685). Each observed step
    writes one JSONL record with the JAX driver's keys."""
    log_f = open(log_path, "a") if log_path else None
    spp_step = r.cfg.spp_per_step
    try:
        synchronize(r.device)
        t_prev = time.perf_counter()
        mrays_prev = float(r.state.mrays)
        for i in range(steps):
            r.state = r._step(r.state)
            # observe only at logging/export boundaries
            last = i == steps - 1
            boundary = (
                last
                or (frame_every and (i + 1) % frame_every == 0)
                or (checkpoint_every and (i + 1) % checkpoint_every == 0)
                or progress
                or log_f is not None
            )
            if not boundary:
                continue
            synchronize(r.device)
            if r.cfg.debug_nan and not bool(
                torch.isfinite(r.state.accum).all()
            ):
                raise FloatingPointError(
                    f"non-finite accumulator at step {r.state.frame}"
                )
            now = time.perf_counter()
            frame = r.state.frame
            mrays_tot = float(r.state.mrays)
            n_samples = r.cfg.width * r.cfg.height * spp_step
            rec = {
                "step": frame,
                "spp": frame * spp_step,
                "step_s": round(now - t_prev, 5),
                "mrays_step": round(mrays_tot - mrays_prev, 3),
                "mrays_per_s": round(
                    (mrays_tot - mrays_prev) / max(now - t_prev, 1e-9), 2
                ),
                # mean traced segments per path (max_depth = nothing
                # terminated)
                "avg_path_len": round(
                    (mrays_tot - mrays_prev) * 1e6 / n_samples, 3
                ),
            }
            t_prev, mrays_prev = now, mrays_tot
            if log_f:
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()
            if progress:
                print(
                    f"step {rec['step']:5d}  spp {rec['spp']:7d}  "
                    f"{rec['step_s']*1e3:8.1f} ms  "
                    f"{rec['mrays_per_s']:8.1f} Mray/s",
                    flush=True,
                )
            if frame_every and (i + 1) % frame_every == 0 and out:
                base, ext = os.path.splitext(out)
                write_image(f"{base}_step{frame:05d}{ext or '.png'}",
                            r.image(), srgb=srgb)
            if (
                checkpoint_path
                and checkpoint_every
                and (i + 1) % checkpoint_every == 0
            ):
                r._save_checkpoint(checkpoint_path)
        img = r.image()
        if out:
            write_image(out, img, srgb=srgb)
        if checkpoint_path:
            r._save_checkpoint(checkpoint_path)
        return img
    finally:
        if log_f:
            log_f.close()


def render(cfg: RenderConfig, scene: Scene, steps: int, *, device,
           **kwargs) -> np.ndarray:
    """One-shot convenience: render ``steps`` progressive steps, return the
    (H, W, 3) float32 image."""
    return Renderer(cfg, scene, device).run(steps, **kwargs)
