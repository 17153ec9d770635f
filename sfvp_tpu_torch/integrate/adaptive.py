"""Adaptive sampling: variance-driven progressive rendering, the port of
sfvp_tpu/integrate/adaptive.py (an extension; the reference samples every
pixel uniformly, ref raygen.rgen:43).

Adaptivity is per tile with a fixed budget: every adaptive step renders
exactly K = ceil(frac * n_tiles) tiles, those with the highest estimated
relative variance of their pixel means, as one ray wave of K * tile^2
pixels through the wavefront loop's ``render_pixels``
(integrate/wavefront.py), with the full-frame loop's trace: brute force,
K3 (and K4 under NEE), K6 on a streamed scene, or K7 (and K8) on an
instanced one (dispatch.select_wavefront_kwargs,
instanced_wavefront_kwargs).

Estimator: each pixel keeps the running sum s1 and sum of squares s2 of
its per-step sample means and its step count n. The image is s1 / n; the
priority of a tile is the mean over its pixels of Var[step mean] / n /
(luma^2 + 1e-4), the estimated relative error of the pixel estimate. As in
all adaptive Monte Carlo, choosing where to sample from the estimates
introduces a vanishing bias; the estimator itself is the plain mean.
"""

from __future__ import annotations

import json
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import RenderConfig

_FORMAT_VERSION = 1


class AdaptiveState(NamedTuple):
    s1: torch.Tensor     # (H, W, 3) f32 sum of per-step sample means
    s2: torch.Tensor     # (H, W, 3) f32 sum of their squares
    count: torch.Tensor  # (H, W) i32 steps rendered per pixel
    frame: int           # global step counter (the seed stream)
    mrays: torch.Tensor  # () f32 cumulative traced segments / 1e6


def init_adaptive_state(height: int, width: int, device) -> AdaptiveState:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return AdaptiveState(s1=zeros(height, width, 3), s2=zeros(height, width, 3),
                         count=zeros(height, width, dtype=torch.int32),
                         frame=0, mrays=zeros())


def adaptive_image(state: AdaptiveState) -> torch.Tensor:
    n = torch.clamp_min(state.count, 1).to(torch.float32)[..., None]
    return state.s1 / n


def tile_priorities(state: AdaptiveState, tile: int) -> torch.Tensor:
    """(H / tile, W / tile) priorities in sfvp_tpu's operation order
    (adaptive.py:117-127): the unbiased variance of the step means over
    luma^2 + 1e-4, 1e30 for pixels rendered fewer than twice, the mean over
    each tile."""
    n = torch.clamp_min(state.count, 1).to(torch.float32)
    mean = state.s1 / n[..., None]
    var = torch.clamp_min(state.s2 / n[..., None] - mean * mean, 0.0) * (
        n / torch.clamp_min(n - 1.0, 1.0))[..., None]
    luma = mean.sum(dim=-1)
    rel = (var.sum(dim=-1) / n) / (luma * luma + 1e-4)
    rel = torch.where(state.count < 2, 1e30, rel)
    h, w = rel.shape
    return rel.reshape(h // tile, tile, w // tile, tile).mean(dim=(1, 3))


def select_tiles(priorities: torch.Tensor, k: int) -> torch.Tensor:
    """The ids (row-major) of the ``k`` tiles of highest priority, highest
    first, equal priorities in index order, as jax.lax.top_k orders them."""
    return torch.sort(priorities.reshape(-1), descending=True,
                      stable=True).indices[:k]


def tile_pixels(tid: torch.Tensor, tile: int, tiles_per_row: int):
    """(px, py) of the tiles ``tid``, tile after tile, each row-major
    (sfvp_tpu adaptive.py:130-133): the wave order."""
    within = torch.arange(tile * tile, device=tid.device)
    px = ((tid % tiles_per_row)[:, None] * tile
          + within[None, :] % tile).reshape(-1)
    py = ((tid // tiles_per_row)[:, None] * tile
          + within[None, :] // tile).reshape(-1)
    return px, py


def make_adaptive_steps(cfg: RenderConfig, buffers, frac: float = 0.25,
                        tile: int = 16, trace_kwargs: Optional[dict] = None,
                        wide=None):
    """Returns (uniform_step, adaptive_step), both AdaptiveState ->
    AdaptiveState:

    - uniform_step renders every pixel once (the warmup);
    - adaptive_step renders only the top ``frac`` of tiles by estimated
      relative variance, a wave of K * tile^2 pixels.

    ``trace_kwargs``: make_render_step kwargs of the trace (an instanced
    scene's, dispatch.instanced_wavefront_kwargs); by default the
    full-frame loop's (dispatch.select_wavefront_kwargs over the host
    WideBVH ``wide`` on the bvh route).
    """
    from ..dispatch import select_wavefront_kwargs
    from .wavefront import make_render_step

    h, w = cfg.height, cfg.width
    if h % tile or w % tile:
        raise ValueError(
            f"image {w}x{h} not divisible by adaptive tile size {tile}")
    if trace_kwargs is None:
        trace_kwargs = select_wavefront_kwargs(cfg, buffers, wide)
    render_pixels = make_render_step(cfg, buffers,
                                     **trace_kwargs).render_pixels
    dev = buffers.device
    # divisors on the device: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently
    spp = torch.tensor(cfg.spp_per_step, dtype=torch.float32, device=dev)
    mega = torch.tensor(1e6, dtype=torch.float32, device=dev)
    tpw = w // tile
    n_tiles = tpw * (h // tile)
    k_tiles = max(1, int(np.ceil(frac * n_tiles)))

    def scatter(state: AdaptiveState, px, py, color_sum, segs):
        mean = torch.stack([c / spp for c in color_sum], dim=-1)
        ones = torch.ones(px.shape, dtype=torch.int32, device=dev)
        return AdaptiveState(
            s1=state.s1.index_put((py, px), mean, accumulate=True),
            s2=state.s2.index_put((py, px), mean * mean, accumulate=True),
            count=state.count.index_put((py, px), ones, accumulate=True),
            frame=state.frame + 1,
            mrays=state.mrays + segs.to(torch.float32) / mega)

    def uniform_step(state: AdaptiveState) -> AdaptiveState:
        idx = torch.arange(h * w, device=dev)
        px, py = idx % w, idx // w
        return scatter(state, px, py, *render_pixels(px, py, state.frame))

    def adaptive_step(state: AdaptiveState) -> AdaptiveState:
        tid = select_tiles(tile_priorities(state, tile), k_tiles)
        px, py = tile_pixels(tid, tile, tpw)
        return scatter(state, px, py, *render_pixels(px, py, state.frame))

    uniform_step.pixels = h * w
    adaptive_step.pixels = k_tiles * tile * tile
    return uniform_step, adaptive_step


class AdaptiveRenderer:
    """Progressive renderer with variance-driven tile selection: ``warmup``
    uniform steps, then adaptive steps on the noisiest ``frac`` of the
    tiles, on one device. Its set-up is the Renderer's
    (render/driver.py): a scene on the bvh route gets its wide BVH
    (``self.wide``), a list of accel.instances.Instance its two-level BVH
    (``self.tl``), built once, in ``self.bvh_build_s`` host seconds."""

    def __init__(self, cfg: RenderConfig, scene, device, frac: float = 0.25,
                 tile: int = 16, warmup: int = 2):
        from ..dispatch import (
            instanced_wavefront_kwargs,
            require_single_level_images,
            resolve_traversal,
        )
        from ..scene import upload

        self.cfg, self.frac, self.tile, self.warmup = cfg, frac, tile, warmup
        self.device = torch.device(device)
        self.wide = self.tl = None
        self.bvh_build_s = 0.0
        trace_kwargs = None
        if isinstance(scene, (list, tuple)):
            from ..accel.instances import flatten_instances
            from ..accel.tlas import build_two_level
            from ..kernels.bvh_tlas import device_two_level

            self.buffers = upload(flatten_instances(scene), device=self.device)
            require_single_level_images(self.buffers)
            t0 = time.perf_counter()
            self.tl = build_two_level(scene)
            self.bvh_build_s = time.perf_counter() - t0
            trace_kwargs = instanced_wavefront_kwargs(
                cfg, device_two_level(self.tl, self.device))
        else:
            self.buffers = upload(scene, device=self.device)
            if resolve_traversal(cfg, self.buffers) == "bvh":
                from ..accel.wide import build_wide_from_buffers

                t0 = time.perf_counter()
                self.wide = build_wide_from_buffers(self.buffers)
                self.bvh_build_s = time.perf_counter() - t0
        self._uniform, self._adaptive = make_adaptive_steps(
            cfg, self.buffers, frac=frac, tile=tile,
            trace_kwargs=trace_kwargs, wide=self.wide)
        self.state = init_adaptive_state(cfg.height, cfg.width, self.device)

    def _step_fn(self):
        return (self._uniform if self.state.frame < self.warmup
                else self._adaptive)

    def step(self, n: int = 1) -> AdaptiveState:
        for _ in range(n):
            self.state = self._step_fn()(self.state)
        return self.state

    def image(self) -> np.ndarray:
        """Current estimate, (H, W, 3) float32 on the host."""
        return adaptive_image(self.state).cpu().numpy()

    # checkpoint / resume in sfvp_tpu's npz format (adaptive.py:183-234),
    # so a checkpoint of either package resumes in the other
    def save_checkpoint(self, path: str) -> None:
        tmp = path + ".tmp"
        st = self.state
        np.savez(
            tmp,
            version=np.int32(_FORMAT_VERSION),
            kind=np.bytes_(b"adaptive"),
            s1=st.s1.cpu().numpy(),
            s2=st.s2.cpu().numpy(),
            count=st.count.cpu().numpy(),
            frame=np.int32(st.frame),
            mrays=np.float32(st.mrays.item()),
            config_hash=np.bytes_(self.cfg.config_hash().encode()),
            # the adaptive knobs decide WHERE samples go: a resume refuses
            # a renderer that would change the distribution mid-run
            frac=np.float32(self.frac),
            tile=np.int32(self.tile),
            warmup=np.int32(self.warmup),
        )
        # numpy appends .npz to the tmp name
        os.replace(tmp + ".npz", path)

    def resume(self, path: str) -> None:
        with np.load(path) as z:
            got = bytes(z["config_hash"]).decode()
            want = self.cfg.config_hash()
            if got != want:
                raise ValueError(
                    f"checkpoint config hash {got} != expected {want}; "
                    "refusing to resume into a different render "
                    "configuration")
            if bytes(z["kind"]) != b"adaptive":
                raise ValueError("not an adaptive-sampling checkpoint")
            # frac as stored, in float32 (sfvp_tpu compares the float32
            # it stored with the float64 it holds, and so refuses its own
            # checkpoint of a frac such as 0.1)
            got_knobs = (float(z["frac"]), int(z["tile"]), int(z["warmup"]))
            want_knobs = (float(np.float32(self.frac)), int(self.tile),
                          int(self.warmup))
            if got_knobs != want_knobs:
                raise ValueError(
                    f"checkpoint adaptive knobs (frac, tile, warmup)="
                    f"{got_knobs} != renderer {want_knobs}; refusing to "
                    "change the sampling distribution mid-run")

            def dev(a, dtype):
                return torch.as_tensor(np.asarray(a, dtype), device=self.device)

            self.state = AdaptiveState(
                s1=dev(z["s1"], np.float32), s2=dev(z["s2"], np.float32),
                count=dev(z["count"], np.int32), frame=int(z["frame"]),
                mrays=dev(z["mrays"], np.float32))

    def run(self, steps: int, out: Optional[str] = None, srgb: bool = False,
            progress: bool = True, checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0,
            log_path: Optional[str] = None) -> np.ndarray:
        """``steps`` steps; each prints sfvp_tpu's progress line (with
        ``progress``) and, with ``log_path``, appends one JSONL record: the
        step, mean spp, pixels rendered, host seconds (synchronised),
        traced Mrays and Mrays/s."""
        from ..render.driver import synchronize, write_image

        spp = self.cfg.spp_per_step
        log_f = open(log_path, "a") if log_path else None
        try:
            synchronize(self.device)
            t0 = time.perf_counter()
            mrays0 = float(self.state.mrays)
            for i in range(steps):
                fn = self._step_fn()
                self.state = fn(self.state)
                if progress or log_f:
                    synchronize(self.device)
                    now = time.perf_counter()
                    mrays = float(self.state.mrays)
                    mean_spp = float(self.state.count.float().mean()) * spp
                    if progress:
                        print(f"step {self.state.frame:5d}  "
                              f"{(now - t0) * 1e3:8.1f} ms  "
                              f"mean spp {mean_spp:.1f}", flush=True)
                    if log_f:
                        log_f.write(json.dumps({
                            "step": self.state.frame, "mean_spp": mean_spp,
                            "pixels": fn.pixels,
                            "step_s": round(now - t0, 5),
                            "mrays_step": round(mrays - mrays0, 3),
                            "mrays_per_s": round(
                                (mrays - mrays0) / max(now - t0, 1e-9), 2),
                        }) + "\n")
                        log_f.flush()
                    t0, mrays0 = now, mrays
                if (checkpoint_path and checkpoint_every
                        and (i + 1) % checkpoint_every == 0):
                    self.save_checkpoint(checkpoint_path)
            img = self.image()
            if out:
                write_image(out, img, srgb=srgb)
            if checkpoint_path:
                self.save_checkpoint(checkpoint_path)
            return img
        finally:
            if log_f:
                log_f.close()
