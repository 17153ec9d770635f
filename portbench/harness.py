"""One run of one cell: set-up, the measured window, the reading of the
trace, the check against the plain reference, the result line.

The window is a user's progressive render as the CLI observes it: the
``sfvp_tpu_torch`` Renderer built from the cell's scene and config, then
observed steps back to back (``Renderer.step()``, then a synchronise)
until ``--seconds`` are spent. The state starts at a frame drawn from the
seed with an empty accumulator, as a render resumed at that frame whose
image so far is black, so every seed traces other PCG streams and the
window's own samples are the whole image the check compares.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

import numpy as np

from . import spec

# modules that may not be loaded when the window closes, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "sfvp_tpu")
WARMUP_STEPS = 2
# the traced slice of a --trace 1 run: it starts this far into the window
# and lasts at least TRACE_S seconds and TRACE_MIN_STEPS steps
TRACE_AT = 0.3
TRACE_S = 0.5
TRACE_MIN_STEPS = 10
# slots (pixel, frame) the reference renders at once
REF_SLOTS = 1 << 18


def process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclasses.dataclass
class Record:
    """What a run measured; the metric readers read it."""

    cell: spec.Cell
    device_kind: str
    samples_per_step: int
    num_tris: int
    env_texels: int
    pixels: int
    setup_s: float = 0.0
    kernel_load_s: Optional[float] = None
    bvh_build_s: Optional[float] = None
    step_s: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    traced: Optional[range] = None      # indices of the profiled steps
    activity: object = None             # trace.Activity of those steps

    def untraced(self, values):
        """``values`` of the steps outside the profiled slice."""
        if self.traced is None:
            return list(values)
        return [v for i, v in enumerate(values) if i not in self.traced]

    def least_step_s(self):
        from .roofline import least_step_s

        return least_step_s(self.cell.frozen, self.samples_per_step,
                            self.num_tris, self.env_texels, self.pixels,
                            self.device_kind)


def render_config(config: dict, traffic: dict, overrides: dict):
    """The program's RenderConfig of a cell."""
    from sfvp_tpu_torch.config import CameraConfig, RenderConfig

    cam = config["camera"]
    camera = (CameraConfig() if cam["kind"] == "reference" else
              CameraConfig.look_at(origin=tuple(cam["origin"]),
                                   target=tuple(cam["target"]),
                                   fov_y_deg=cam["fov_y_deg"]))
    kw = dict(width=config["width"], height=config["height"],
              spp_per_step=config["spp_per_step"],
              max_depth=config["max_depth"], t_min=config["t_min"],
              t_max=config["t_max"],
              sky_emission=tuple(config["sky_emission"]), camera=camera,
              sampling=traffic["sampling"], use_rr=traffic["use_rr"],
              use_nee=traffic["use_nee"], use_mis=traffic["use_mis"])
    kw.update({k: v for k, v in overrides.items() if k in kw})
    return RenderConfig(**kw)


def reference_camera(config: dict):
    from .reference.tracer import Camera

    cam = config["camera"]
    if cam["kind"] == "reference":
        return Camera.reference()
    return Camera.look_at(cam["origin"], cam["target"],
                          fov_y_deg=cam["fov_y_deg"])


def program_scene(config: dict, env_u8, tmpdir: str):
    """The program's Scene: its own OBJ ingest, or the arrays of the
    frozen recipe; the environment map as a PNG in ``tmpdir``."""
    from . import scenes

    if config["scene"]["kind"] == "obj":
        from sfvp_tpu_torch import load_obj

        scene = load_obj(scenes.obj_path(config))
    else:
        from sfvp_tpu_torch.scene.objload import Scene

        tris, kd, ke = scenes.reference_geometry(config)
        t = len(tris)
        scene = Scene(vertices=tris.reshape(-1, 3),
                      indices=np.arange(3 * t, dtype=np.uint32),
                      face_diffuse=kd, face_emission=ke,
                      face_specular=np.zeros((t, 3), np.float32),
                      face_mat_type=np.zeros((t,), np.int32),
                      material_names=["default"],
                      face_material_id=np.zeros((t,), np.int32))
    if env_u8 is not None:
        fd, path = tempfile.mkstemp(suffix=".png", prefix="portbench_sky_",
                                    dir=tmpdir)
        with os.fdopen(fd, "wb") as f:
            f.write(scenes.encode_png(env_u8))
        scene.env_map = path
    return scene


def first_frame(seed: int, below: int) -> int:
    return int(np.random.default_rng([seed, 1]).integers(0, below))


def check_pixels(seed: int, height: int, width: int, count: int):
    """(py, px) of ``count`` distinct pixels drawn from the seed."""
    flat = np.sort(np.random.default_rng([seed, 2]).choice(
        height * width, size=min(count, height * width), replace=False))
    return flat // width, flat % width


def reference_accum(cell: spec.Cell, cfg, px, py, frame0: int, frames: int,
                    device, dtype, stats=None):
    """The plain reference's progressive mean at pixels (px, py) after
    ``frames`` steps from ``frame0``, from an empty accumulator: (P, 3)."""
    import torch

    from . import scenes
    from .reference import tracer

    tris, kd, ke = scenes.reference_geometry(cell.config)
    env_u8 = scenes.env_image(cell.traffic)
    env = None if env_u8 is None else tracer.srgb_to_linear(env_u8)
    scene = tracer.RefScene(tris, kd, ke, device, dtype, env_rgb=env)
    rd = tracer.Render(cfg.width, cfg.height, cfg.spp_per_step,
                       cfg.max_depth, cfg.t_min, cfg.t_max,
                       tuple(cfg.sky_emission), reference_camera(cell.config))
    est = tracer.Estimator(uniform=cfg.sampling == "uniform",
                           use_rr=cfg.use_rr, use_nee=cfg.use_nee,
                           use_mis=cfg.use_mis)
    p = len(px)
    block = max(1, REF_SLOTS // p)
    totals = []
    for f0 in range(0, frames, block):
        nf = min(block, frames - f0)
        fr = np.arange(frame0 + f0, frame0 + f0 + nf)
        slot_px = np.repeat(px, nf)
        slot_py = np.repeat(py, nf)
        slot_fr = np.tile(fr, p)
        totals.append(tracer.render_slots(scene, rd, est, slot_px, slot_py,
                                          slot_fr, stats).reshape(p, nf, 3))
    colors = torch.cat(totals, dim=1)
    return tracer.accumulate(colors, frame0, cfg.spp_per_step)


def compare(program: np.ndarray, reference: np.ndarray) -> float:
    """Relative RMSE of the program's values against the reference's,
    float64; NaN or inf if either is not finite."""
    a = np.asarray(program, np.float64)
    b = np.asarray(reference, np.float64)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return float("inf")
    return float(np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-300)))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def one_core():
    """Keep the process on one of the cores it may use (the highest), so
    that the host's part of a step does not move between cores: load
    from one process with one thread steadies the host's share of the
    step."""
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", overrides: Optional[dict] = None,
        fault: Optional[Callable] = None, max_steps: Optional[int] = None,
        root=spec.ROOT, whole_process: bool = False,
        early: Optional[dict] = None):
    """One run; returns (result dict, check lines). ``overrides`` shrink a
    cell for a CPU rehearsal (config keys, ``check_pixels``, the sphere's
    ``n_lat``/``n_lon``); ``fault(renderer)`` breaks the timed path for a
    test; ``max_steps`` ends the window early. ``whole_process``: set-up
    counts from the process's start (the command line), else from this
    call; ``early`` names the seconds of its first phases."""
    t_start = time.perf_counter()
    before = process_age_s() if whole_process else 0.0
    phases = dict(early or {})
    phases["before run"] = before - sum(phases.values())
    overrides = dict(overrides or {})
    cell = spec.cell(workload, root)
    if "n_lat" in overrides:
        cell.config["scene"].update(n_lat=overrides["n_lat"],
                                    n_lon=overrides["n_lon"])
    import torch

    dev = torch.device(device)
    from sfvp_tpu_torch.render.driver import Renderer
    from sfvp_tpu_torch.integrate.wavefront import RenderState

    from . import scenes
    from .trace import ISSUE, STEP, read_trace

    t0 = time.perf_counter()
    phases["imports"] = t0 - t_start
    kernel_load_s = None
    if dev.type == "cuda":
        from sfvp_tpu_torch.kernels import build

        torch.zeros((), device=dev)
        t1 = time.perf_counter()
        phases["context"] = t1 - t0
        build.library()
        kernel_load_s = time.perf_counter() - t1
        phases["kernel library"] = kernel_load_s
    cfg = render_config(cell.config, cell.traffic, overrides)
    env_u8 = scenes.env_image(cell.traffic)
    tmpdir = tempfile.mkdtemp(prefix="portbench_")
    try:
        t0 = time.perf_counter()
        scene = program_scene(cell.config, env_u8, tmpdir)
        t1 = time.perf_counter()
        phases["scene"] = t1 - t0
        r = Renderer(cfg, scene, dev)
        phases["renderer"] = time.perf_counter() - t1
    finally:
        for name in os.listdir(tmpdir):
            os.unlink(os.path.join(tmpdir, name))
        os.rmdir(tmpdir)
    if fault is not None:
        fault(r)
    frame0 = first_frame(seed, cell.traffic["first_frame_below"])
    r.state = r.state._replace(frame=max(0, frame0 - WARMUP_STEPS))
    t0 = time.perf_counter()
    for _ in range(WARMUP_STEPS):
        r.step()
    sync(dev)
    phases["warm-up"] = time.perf_counter() - t0
    r.state = RenderState(accum=r.state.accum.zero_(), frame=frame0,
                          mrays=torch.zeros((), dtype=torch.float32,
                                            device=dev))
    sync(dev)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    rec = Record(cell=cell, device_kind=kind,
                 samples_per_step=cfg.width * cfg.height * cfg.spp_per_step,
                 num_tris=int(r.buffers.num_tris),
                 env_texels=0 if env_u8 is None else env_u8.shape[0]
                 * env_u8.shape[1], pixels=cfg.width * cfg.height,
                 kernel_load_s=kernel_load_s,
                 bvh_build_s=r.bvh_build_s if r.wide is not None else None)

    # ---------------------------------------------------------- the window
    rec.setup_s = before + (time.perf_counter() - t_start)
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
          + f"; {rec.setup_s:.3f} s in all", flush=True)
    t_win = time.perf_counter()
    prof = None
    trace_dir = None
    t_end = t_win + seconds
    now = t_win
    while True:
        i = len(rec.step_s)
        if trace and prof is None and rec.traced is None and (
                now - t_win >= TRACE_AT * seconds):
            trace_dir = tempfile.mkdtemp(prefix="portbench_trace_")
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            trace_first, t_trace = i, time.perf_counter()
        if prof is not None:
            with torch.profiler.record_function(STEP):
                t0 = time.perf_counter()
                with torch.profiler.record_function(ISSUE):
                    r.step()
                with torch.profiler.record_function("portbench.sync"):
                    sync(dev)
            now = time.perf_counter()
            if (now - t_trace >= TRACE_S
                    and i + 1 - trace_first >= TRACE_MIN_STEPS):
                prof.__exit__(None, None, None)
                rec.traced = range(trace_first, i + 1)
                prof_done = prof
                prof = None
        else:
            t0 = time.perf_counter()
            r.step()
            sync(dev)
            now = time.perf_counter()
        rec.step_s.append(now - t0)
        if (now >= t_end and prof is None) or (
                max_steps is not None and len(rec.step_s) >= max_steps):
            break
    rec.window_s = now - t_win
    if prof is not None:  # the window ended inside the slice
        prof.__exit__(None, None, None)
        rec.traced = range(trace_first, len(rec.step_s))
        prof_done = prof
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    frames_done = r.state.frame - frame0
    mrays = float(r.state.mrays)
    py, px = check_pixels(seed, cfg.height, cfg.width,
                          overrides.get("check_pixels",
                                        cell.frozen["check_pixels"]))
    program = r.state.accum[torch.as_tensor(py, device=dev),
                            torch.as_tensor(px, device=dev)].cpu().numpy()
    del r
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rec.traced is not None:
        path = os.path.join(trace_dir, "trace.json")
        try:
            prof_done.export_chrome_trace(path)
            rec.activity = read_trace(path)
        finally:
            for name in os.listdir(trace_dir):
                os.unlink(os.path.join(trace_dir, name))
            os.rmdir(trace_dir)

    n = len(rec.step_s)
    print(f"program's own count (RenderState.mrays): {mrays:.3f} Mrays "
          f"traced in the window, {mrays / rec.window_s:.1f} Mrays/s, "
          f"{mrays * 1e6 / (n * rec.samples_per_step):.4f} segments a "
          f"sample (frozen for the roofline: "
          f"{cell.frozen['rays_per_sample']})", flush=True)

    # ---------------------------------------------------------- the check
    t_ref = time.perf_counter()
    stats = {}
    ref = reference_accum(cell, cfg, px, py, frame0, n, dev,
                          torch.float32, stats).cpu().numpy()
    ref_s = time.perf_counter() - t_ref
    rel = compare(program, ref)
    limits = cell.frozen["limits"]
    checks = {"rel_rmse": {"value": rel, "limit": limits["rel_rmse"]},
              "frames_missing": {"value": abs(n - frames_done),
                                 "limit": limits["frames_missing"]}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    print(f"reference: {len(px)} pixels x {n} frames in {ref_s:.2f} s, "
          f"{stats['segments'] / stats['samples']:.4f} segments and "
          f"{stats['shadow_rays'] / stats['samples']:.4f} shadow rays a "
          "sample", flush=True)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": kind, "count": 1, "memory_peak_bytes": memory_peak}
    if dev.type == "cuda":
        dev_info["power_limit"] = power_limit()
    result = {"correct": correct, "attempted": n, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if trace and rec.activity is not None:
        dev_info["busy_s"] = rec.activity.busy_s
        dev_info["window_s"] = rec.activity.window_s
        result["breakdown"] = {"device_ops": rec.activity.device_ops,
                               "idle_gaps": rec.activity.idle_gaps}
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    result["checks"] = checks
    return result, lines


def forbidden_modules():
    return sorted({name.split(".", 1)[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the "
                                 "sfvp_tpu_torch benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    early = {"interpreter": process_age_s()}
    import torch

    early["torch"] = process_age_s() - early["interpreter"]
    one_core()
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card and has no "
              "CPU fallback", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, lines = run(args.workload, args.seed, args.seconds,
                        bool(args.trace), whole_process=True, early=early)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
