"""The readings a cell's frozen numbers are set from; never run by the
benchmark's own runs. From the root of a checkout, on the card:

    python3 portbench/readings.py --workload <cell> --count 65536
        the plain reference's segments and shadow rays a camera sample
        over that many pixels drawn from --seeds' first seed, one step
        each: the cell's rays_per_sample and shadow_rays_per_sample;

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --frames <n>
        the control: the reference computed in bfloat16 put in the
        program's place, compared as a run compares the program, at the
        cell's own pixels and a window of n steps, for each seed;

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --frames <n> --fault half_batch
        the fault of half of each pixel's samples left out and the mean
        taken over the rest, planted in the reference put in the
        program's place (the reference at half the cell's samples a
        step), compared in the same way.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def counts(cell, cfg, seed: int, pixels: int, device):
    import torch

    from portbench import harness

    py, px = harness.check_pixels(seed, cfg.height, cfg.width, pixels)
    stats = {}
    harness.reference_accum(cell, cfg, px, py,
                            harness.first_frame(seed, cell.traffic[
                                "first_frame_below"]), 1, device,
                            torch.float32, stats)
    return (stats["segments"] / stats["samples"],
            stats["shadow_rays"] / stats["samples"])


def planted(cell, cfg, seed: int, frames: int, device, planted_cfg,
            planted_dtype, pixels=None):
    """(rel_rmse of the reference at ``planted_cfg`` in ``planted_dtype``,
    put in the program's place, against the float32 reference at ``cfg``,
    compared as a run compares the program; the seconds each took)."""
    import torch

    from portbench import harness

    py, px = harness.check_pixels(seed, cfg.height, cfg.width,
                                  pixels or cell.frozen["check_pixels"])
    frame0 = harness.first_frame(seed, cell.traffic["first_frame_below"])
    out = []
    for c, dtype in ((cfg, torch.float32), (planted_cfg, planted_dtype)):
        t0 = time.perf_counter()
        acc = harness.reference_accum(cell, c, px, py, frame0, frames,
                                      device, dtype)
        out.append((acc.float().cpu().numpy(), time.perf_counter() - t0))
    return harness.compare(out[1][0], out[0][0]), out[0][1], out[1][1]


def control(cell, cfg, seed: int, frames: int, device, pixels=None):
    """The reference computed in bfloat16."""
    import torch

    return planted(cell, cfg, seed, frames, device, cfg, torch.bfloat16,
                   pixels)


def half_batch(cell, cfg, seed: int, frames: int, device, pixels=None):
    """The reference at half the cell's samples a step, the mean taken
    over them."""
    import dataclasses

    import torch

    half = dataclasses.replace(cfg, spp_per_step=cfg.spp_per_step // 2)
    return planted(cell, cfg, seed, frames, device, half, torch.float32,
                   pixels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--count", type=int, default=0)
    ap.add_argument("--fault", choices=("half_batch",), default=None)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cell = spec.cell(args.workload)
    cfg = harness.render_config(cell.config, cell.traffic, {})
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.count:
        rays, shadow = counts(cell, cfg, seeds[0], args.count, dev)
        print(f"{args.workload} counts over {args.count} pixels (seed "
              f"{seeds[0]}): rays_per_sample {rays!r} "
              f"shadow_rays_per_sample {shadow!r}", flush=True)
    if args.frames and args.fault == "half_batch":
        for seed in seeds:
            rel, t_all, t_half = half_batch(cell, cfg, seed, args.frames,
                                            dev)
            print(f"{args.workload} half_batch seed {seed}: rel_rmse "
                  f"{rel!r} ({args.frames} frames; all samples "
                  f"{t_all:.2f} s, half {t_half:.2f} s)", flush=True)
    elif args.frames:
        for seed in seeds:
            rel, t32, t16 = control(cell, cfg, seed, args.frames, dev)
            print(f"{args.workload} control seed {seed}: rel_rmse {rel!r} "
                  f"({args.frames} frames; float32 {t32:.2f} s, bfloat16 "
                  f"{t16:.2f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())
