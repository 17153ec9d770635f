"""Time two checkouts of the port against each other on one GPU.

    python3 chip_ab.py A_DIR B_DIR [--rounds N]

A_DIR and B_DIR are roots of checkouts of this repository (each with its
chip_smoke.py and sfvp_tpu_torch/; each builds its kernels in its own
build/). The script runs them in the order A B B A (N rounds of it), each
run a fresh process that sets up the Cornell Box, the 100k sphere of
``--scene sphere --scene-tris 100000``, the city of ``--scene city
--scene-tris 100000``, the lit 220k instanced field and the 500k sphere of
``--scene sphere --scene-tris 500000`` (streamed: K6) through that
checkout's chip_smoke.py, then times, by CUDA events, 3 readings of 5
steps or launches each:

  K1cornell  K1's step on the Cornell Box at 1024x1024, 32 spp, depth 8,
             parity (chip_smoke.py phase 6's shape);
  K5sphere   K5's step on the sphere at 1024x1024, 8 spp, depth 8,
             cosine + RR (phase 10's);
  K5city     K5's step on the city, the same shape with NEE + MIS (phase
             16's);
  K9lit      K9's step on the lit field, the same estimator (phase 20's).
  K6first, K6third_unsorted, K6third, K6adaptive
             K6's launch on the 500k sphere's waves at 1024x1024, 1 spp
             (phase 24's): the first bounce, the third bounce unsorted and
             sorted, and a wave of a quarter of the 16x16 tiles after two
             uniform steps;
  K6step, K6step_unsorted
             the wavefront step over K6 on the 500k sphere at 1024x1024, 8
             spp, depth 8, cosine + RR (phase 23's renderer_k6), with its
             bounce rays sorted (the streamed route's default) and not.

One line per run, ``AB <label> K5city=<ms> K9lit=<ms> ...``, then the
card's name and power limit. It needs one card; compare two versions only
within one run of this script.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

READINGS, REPS = 3, 5


def child(root: str) -> None:
    """One run on the checkout at ``root``: its kernels, its scenes."""
    sys.path[0] = root
    os.chdir(root)
    import chip_smoke as C
    from sfvp_tpu_torch import RenderConfig, init_state
    from sfvp_tpu_torch.dispatch import select_render_step
    from sfvp_tpu_torch.kernels import bvh_packet2
    from sfvp_tpu_torch.kernels.megakernel import scene_table
    from sfvp_tpu_torch.kernels.megakernel_bvh import (
        bvh_regen_render, tlas_regen_render)
    from sfvp_tpu_torch.kernels.megakernel_regen import regen_render

    with open(os.devnull, "w") as quiet:
        stdout, sys.stdout = sys.stdout, quiet
        try:
            cornell = C.cornell_buffers(C.DEVICE)
            sphere = C.scene_setup("sphere", C.SPHERE_TRIS)
            city = C.scene_setup("city", C.CITY_TRIS, **C.NEE_FLAGS)
            _, lit = C.field_setup()
            big = C.scene_setup("sphere", C.BIG_TRIS)
            waves = k6_waves(C, big)
        finally:
            sys.stdout = stdout
    table = scene_table(cornell)
    main = RenderConfig(width=C.MAIN_W, height=C.MAIN_H,
                        spp_per_step=C.MAIN_SPP, max_depth=C.MAIN_DEPTH)
    shape = dict(global_shape=(C.BVH_H, C.BVH_W), npix=C.BVH_W * C.BVH_H,
                 has_mirrors=False)
    runs = (
        ("K1cornell", lambda: regen_render(
            table, 1, 0, cfg=main, num_tris=cornell.num_tris,
            global_shape=(C.MAIN_H, C.MAIN_W), npix=C.MAIN_W * C.MAIN_H,
            has_mirrors=False)),
        ("K5sphere", lambda: bvh_regen_render(
            sphere["dw"], 1, 0, cfg=sphere["cfg"], **shape)),
        ("K5city", lambda: bvh_regen_render(
            city["dw"], 1, 0, cfg=city["cfg"], lights=city["lights"],
            **shape)),
        ("K9lit", lambda: tlas_regen_render(
            lit["dt"], 1, 0, cfg=lit["cfg"], lights=lit["lights"], **shape)),
        *((name, lambda rays=rays: bvh_packet2.packet_trace2(
            big["dw"], big["cfg"].t_min, rays))
          for name, rays in waves.items()),
    )
    # the streamed Renderer step: megakernel_regen=False over K6
    loop = dataclasses.replace(big["cfg"], megakernel_regen=False)
    for name, cfg in (("K6step", loop), ("K6step_unsorted",
                                         dataclasses.replace(
                                             loop, sort_bounce_rays=False))):
        step = select_render_step(cfg, big["buffers"], wide=big["wide"])
        state = init_state(cfg.height, cfg.width, C.DEVICE)
        runs += ((name, lambda step=step, state=state: step(state)),)
    out = []
    for _ in range(READINGS):
        for name, fn in runs:
            out.append(f"{name}={C.cuda_ms(fn, REPS)[0]:.3f}")
    print(" ".join(out), flush=True)


def k6_waves(C, big):
    """K6's four waves on the 500k sphere, as chip_smoke.py phase 24
    captures them, through functions the parent's chip_smoke.py has too."""
    from sfvp_tpu_torch.integrate.adaptive import (
        init_adaptive_state, make_adaptive_steps)
    from sfvp_tpu_torch.kernels import bvh_packet2

    cfg = big["cfg"]
    one = dataclasses.replace(cfg, width=C.BVH_W, height=C.BVH_H,
                              spp_per_step=1, megakernel_regen=False)
    first, third = C.capture_waves(one, big, (0, 2))
    third_unsorted = C.capture_waves(dataclasses.replace(
        one, sort_bounce_rays=False), big, (2,))[0]
    uni, ada = make_adaptive_steps(one, big["buffers"], frac=C.ADAPT_FRAC,
                                   tile=C.ADAPT_TILE, wide=big["wide"])
    st = uni(uni(init_adaptive_state(C.BVH_H, C.BVH_W, C.DEVICE)))
    adaptive = C.capture(bvh_packet2, "ray_planes", (0,), lambda: ada(st),
                         lambda a, out: out)[0]
    return {"K6first": first, "K6third_unsorted": third_unsorted,
            "K6third": third, "K6adaptive": adaptive}


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        child(os.path.abspath(argv[1]))
        return 0
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--rounds", type=int, default=1)
    args = p.parse_args(argv)
    me = os.path.abspath(__file__)
    order = [("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)]
    for _ in range(args.rounds):
        for label, root in order:
            res = subprocess.run([sys.executable, me, "--child", root],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                sys.stderr.write(res.stdout + res.stderr)
                raise SystemExit(f"the run on {root} failed")
            print(f"AB {label} {res.stdout.strip()}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
