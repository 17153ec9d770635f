"""Smoke test of the PyTorch / CUDA port (sfvp_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1, no result line) on failure:
  1. device   a CUDA device of compute capability 9.0 (Hopper), and the
              card's name and power limit from nvidia-smi;
  2. build    nvcc builds the kernels K1 and K2 from csrc/;
  3. twins    each kernel against its plain PyTorch twin at 256x256,
              depth 8: parity at 8 spp, cosine + Russian roulette, and a
              Cornell variant with mirror faces;
  4. oracle   K1 at 128x128, 32 spp x 32 steps, against the numpy
              transcription of the reference's shaders
              (tests/golden/oracle_128_1024spp.npz);
  5. main     the main path as a user runs it: ``sfvp_tpu_torch.cli`` on
              the Cornell Box at 1024x1024, 32 spp per step, depth 8,
              8 steps, writing a PNG and a JSONL log (through K1), then
              two steps of the Renderer with megakernel_regen=False
              (through K2); each kernel's launch count must rise;
  6. times    K1 and K2 against their twins at the main path's shape,
              timed with CUDA events; the last timed step of each kernel
              is held to its twin's with the bounds of phase 3 (for K2,
              all 32 one-sample launches of a step).

The line before the last is the kernel report as one JSON object; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
MAIN_W = MAIN_H = 1024
MAIN_SPP, MAIN_DEPTH, MAIN_STEPS, K2_STEPS = 32, 8, 8, 2
# kernel vs twin on the card (a few of ~0.5M paths may diverge after a
# 1-ulp hit/miss flip, each moving one pixel by up to ~0.1)
TWIN_REL_RMSE, TWIN_OFF_FRAC, TWIN_OFF_ABS, SEGS_REL = 1e-4, 1e-3, 1e-4, 1e-4
ORACLE_REL_RMSE = 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name):
    print(f"== {name}", flush=True)


def rel_rmse(a, b):
    return float(torch.sqrt(((a - b) ** 2).mean()) / torch.sqrt((b ** 2).mean()))


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events, after
    one warm-up run; and the last run's result."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def device_phase():
    phase("device")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap}, the kernels are sm_90a")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def build_phase():
    from sfvp_tpu_torch.kernels import build

    phase("build")
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    log = lib.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())


def cornell_buffers(device, mirrors=False):
    from sfvp_tpu_torch import load_obj, upload
    from sfvp_tpu_torch.scene import from_arrays

    s = load_obj()
    if not mirrors:
        return upload(s, device=device)
    # tall box and back wall as tinted mirrors: the bundled MTL is illum 2
    # throughout and never reaches the mirror branch
    names = [s.material_names[i] for i in s.face_material_id]
    mt = np.asarray([n in ("tallBox", "backWall") for n in names], np.int32)
    spec = np.where(mt[:, None] == 1, np.float32([0.9, 0.85, 0.8]),
                    np.float32(0.0))
    return from_arrays(s.triangles(), s.face_diffuse, s.face_emission, spec,
                       mt, device=device)


def twin_phase():
    from sfvp_tpu_torch import RenderConfig
    from sfvp_tpu_torch.kernels.megakernel import (
        scene_table, wave_render, wave_render_plain)
    from sfvp_tpu_torch.kernels.megakernel_regen import (
        regen_render, regen_render_plain)

    phase("twins: kernel vs plain PyTorch twin at 256x256, depth 8")
    size, spp = 256, 8
    cases = {
        "parity": (dict(), False),
        "cosine_rr": (dict(sampling="cosine", use_rr=True, rr_start_depth=2),
                      False),
        "mirror": (dict(), True),
    }
    worst = {"K1": 0.0, "K2": 0.0}
    for case, (kw, mirrors) in cases.items():
        buffers = cornell_buffers(DEVICE, mirrors)
        table = scene_table(buffers)
        has_mirrors = bool((buffers.mtype > 0).any())
        for kernel in ("K1", "K2"):
            cfg = RenderConfig(width=size, height=size, spp_per_step=spp,
                               max_depth=8, spp_chunk=spp, **kw)
            args = dict(cfg=cfg, num_tris=buffers.num_tris,
                        global_shape=(size, size), npix=size * size,
                        has_mirrors=has_mirrors)
            if kernel == "K1":
                got = regen_render(table, 3, 0, **args)
                exp = regen_render_plain(table, 3, 0, **args)
            else:
                got = wave_render(table, 3, 0, 0, **args)
                exp = wave_render_plain(table, 3, 0, 0, **args)
                got = [c.reshape(spp, -1).sum(0) for c in got]
                exp = [c.reshape(spp, -1).sum(0) for c in exp]
            worst[kernel] = max(worst[kernel],
                                compare(f"{kernel} {case}", got, exp, spp))
    return worst


def compare(label, got, exp, spp):
    """Hold a kernel's (colr, colg, colb, segs) per-pixel totals over
    ``spp`` samples against its twin's with the card bounds; print the
    measured values and return the largest absolute pixel difference."""
    img_g = torch.stack(got[:3], -1) / spp
    img_e = torch.stack(exp[:3], -1) / spp
    diff = (img_g - img_e).abs()
    rel = rel_rmse(img_g, img_e)
    off = float((diff.amax(-1) > TWIN_OFF_ABS).float().mean())
    seg_g = int(got[3].sum(dtype=torch.int64))
    seg_e = int(exp[3].sum(dtype=torch.int64))
    seg_rel = abs(seg_g - seg_e) / seg_e
    mx = float(diff.max())
    print(f"  {label:12s} rel_rmse={rel:.3e} pixels_off={off:.3e} "
          f"max_abs={mx:.3e} segs={seg_g} vs {seg_e} (rel {seg_rel:.3e})")
    check(rel < TWIN_REL_RMSE and off < TWIN_OFF_FRAC and seg_rel <= SEGS_REL,
          f"{label} disagrees with its twin: rel_rmse {rel}, pixels off "
          f"{off}, segment rel diff {seg_rel}")
    return mx


def oracle_phase():
    from sfvp_tpu_torch import RenderConfig, init_state
    from sfvp_tpu_torch.kernels.megakernel_regen import make_regen_render_step

    phase("oracle: K1 at 128x128, 32 spp x 32 steps vs the numpy oracle")
    with np.load(os.path.join(ROOT, "tests", "golden",
                              "oracle_128_1024spp.npz")) as z:
        ref = torch.from_numpy(z["accum"]).to(DEVICE)
        frames, spp = int(z["frames"]), int(z["spp"])
    cfg = RenderConfig(width=128, height=128, spp_per_step=spp, max_depth=8)
    step = make_regen_render_step(cfg, cornell_buffers(DEVICE))
    st = init_state(128, 128, DEVICE)
    for _ in range(frames):
        st = step(st)
    rel = rel_rmse(st.accum, ref)
    off = float(((st.accum - ref).abs().amax(-1) > 1e-4).float().mean())
    print(f"  relative RMSE vs oracle: {rel:.3e} (bound {ORACLE_REL_RMSE}); "
          f"{off:.3%} of pixels off by > 1e-4, max abs "
          f"{float((st.accum - ref).abs().max()):.3e}")
    check(rel <= ORACLE_REL_RMSE, f"K1 vs oracle relative RMSE {rel}")


def main_path_phase(tmp):
    from sfvp_tpu_torch import RenderConfig, Renderer, cli, load_obj
    from sfvp_tpu_torch.kernels.megakernel import wave_render
    from sfvp_tpu_torch.kernels.megakernel_regen import regen_render

    phase(f"main path: cli at {MAIN_W}x{MAIN_H}, {MAIN_SPP} spp, depth "
          f"{MAIN_DEPTH}, {MAIN_STEPS} steps (K1); Renderer with "
          f"megakernel_regen=False, {K2_STEPS} steps (K2)")
    out, log = os.path.join(tmp, "cornell.png"), os.path.join(tmp, "run.jsonl")
    regen_render.launches = 0
    wave_render.launches = 0
    rc = cli.main(["--device", DEVICE, "--width", str(MAIN_W), "--height",
                   str(MAIN_H), "--spp", str(MAIN_SPP), "--max-depth",
                   str(MAIN_DEPTH), "--steps", str(MAIN_STEPS), "--out", out,
                   "--log", log, "--quiet"])
    k2 = Renderer(RenderConfig(width=MAIN_W, height=MAIN_H,
                               spp_per_step=MAIN_SPP, max_depth=MAIN_DEPTH,
                               megakernel_regen=False), load_obj(), DEVICE)
    k2_img = k2.run(K2_STEPS, progress=False)
    launches = {"K1": regen_render.launches, "K2": wave_render.launches}
    print(f"  launches during the main path: {launches}")
    check(rc == 0, f"cli returned {rc}")
    check(launches["K1"] == MAIN_STEPS,
          f"K1 launched {launches['K1']} times, expected {MAIN_STEPS}")
    check(launches["K2"] == K2_STEPS * MAIN_SPP,
          f"K2 launched {launches['K2']} times, expected "
          f"{K2_STEPS * MAIN_SPP}")
    check(os.path.getsize(out) > 0, "no PNG written")
    recs = [json.loads(x) for x in open(log).read().splitlines()]
    check(len(recs) == MAIN_STEPS, f"{len(recs)} log records")
    for rec in recs:
        print(f"  step {rec['step']}: {rec['step_s'] * 1e3:.2f} ms, "
              f"{rec['mrays_per_s']} Mrays/s, avg path {rec['avg_path_len']}")
    for name, img in (("K1", _read_png(out)), ("K2", k2_img)):
        img = np.asarray(img, np.float32)
        check(img.shape[:2] == (MAIN_H, MAIN_W), f"{name} image {img.shape}")
        check(np.isfinite(img).all(), f"{name} image has non-finite values")
        check(img.max() > 0, f"{name} image is all zero")
        sat = float((img >= 1.0).all(-1).mean())
        check(sat < 0.5, f"{name} image saturated ({sat:.1%} white)")
        print(f"  {name} image mean {img.mean():.4f}, {sat:.2%} white")
    return launches, recs


def _read_png(path):
    """Decode the renderer's own 8-bit RGB PNG (filter type 0 rows)."""
    import struct
    import zlib

    data = open(path, "rb").read()
    w, h = struct.unpack(">II", data[16:24])
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    check((rows[:, 0] == 0).all(), "unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, 3).astype(np.float32) / 255.0


def timing_phase():
    from sfvp_tpu_torch import RenderConfig
    from sfvp_tpu_torch.kernels.megakernel import (
        scene_table, wave_render, wave_render_plain)
    from sfvp_tpu_torch.kernels.megakernel_regen import (
        regen_render, regen_render_plain)

    phase(f"times and twin check at the main path's shape ({MAIN_W}x"
          f"{MAIN_H}, {MAIN_SPP} spp, depth {MAIN_DEPTH}), per step, CUDA "
          "events")
    buffers = cornell_buffers(DEVICE)
    table = scene_table(buffers)
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, spp_per_step=MAIN_SPP,
                       max_depth=MAIN_DEPTH)
    args = dict(cfg=cfg, num_tris=buffers.num_tris,
                global_shape=(MAIN_H, MAIN_W), npix=MAIN_W * MAIN_H,
                has_mirrors=False)

    def k2_step(fn):
        # the main path's K2 step: one launch per sample (spp_chunk 1,
        # chunk_idx 0..spp-1), per-pixel totals added launch by launch
        def step():
            total = fn(table, 1, 0, 0, **args)
            for c in range(1, MAIN_SPP):
                total = [a + b for a, b in
                         zip(total, fn(table, 1, c, 0, **args))]
            return total
        return step

    runs = {
        "K1": (cuda_ms(lambda: regen_render(table, 1, 0, **args), 10),
               cuda_ms(lambda: regen_render_plain(table, 1, 0, **args), 1)),
        "K2": (cuda_ms(k2_step(wave_render), 3),
               cuda_ms(k2_step(wave_render_plain), 1)),
    }
    times, worst = {}, {}
    for k, ((ms, got), (plain, exp)) in runs.items():
        print(f"  {k}: kernel {ms:.3f} ms/step, plain twin {plain:.1f} ms/step")
        worst[k] = compare(f"{k} main", got, exp, MAIN_SPP)
        times[k] = (ms, plain)
    return times, worst


def main() -> int:
    card = device_phase()
    build_phase()
    worst = twin_phase()
    oracle_phase()
    with tempfile.TemporaryDirectory() as tmp:
        launches, _ = main_path_phase(tmp)
    times, worst_main = timing_phase()
    worst = {k: max(worst[k], worst_main[k]) for k in worst}
    report = {"kernels": [
        {"name": "regen_render (K1)", "route": "cuda",
         "source": "sfvp_tpu_torch/csrc/regen_render.cu",
         "replaces": "sfvp_tpu/kernels/megakernel_regen.py:1137",
         "launches": launches["K1"], "max_abs_err": worst["K1"],
         "ms": times["K1"][0], "plain_ms": times["K1"][1]},
        {"name": "wave_render (K2)", "route": "cuda",
         "source": "sfvp_tpu_torch/csrc/wave_render.cu",
         "replaces": "sfvp_tpu/kernels/megakernel.py:366",
         "launches": launches["K2"], "max_abs_err": worst["K2"],
         "ms": times["K2"][0], "plain_ms": times["K2"][1]},
    ]}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
