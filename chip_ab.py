"""Time two checkouts of the port against each other on one GPU.

    python3 chip_ab.py A_DIR B_DIR [--rounds N] [--only PREFIX[,PREFIX...]]

A_DIR and B_DIR are roots of checkouts of this repository (each with its
chip_smoke.py and sfvp_tpu_torch/; each builds its kernels in its own
build/). The script runs them in the order A B B A (N rounds of it), each
run a fresh process that sets up, through that checkout's chip_smoke.py,
the scenes its labels need: the Cornell Box, the 100k sphere of
``--scene sphere --scene-tris 100000``, the city of ``--scene city
--scene-tris 100000``, the 220k instanced field and the lit field (with
the lamp), the glossy lit field, and the 500k sphere of ``--scene sphere
--scene-tris 500000`` (streamed: K6). Then it times, by CUDA events, 3
readings of 5 steps or launches each:

  K1cornell  K1's step on the Cornell Box at 1024x1024, 32 spp, depth 8,
             parity (chip_smoke.py phase 6's shape);
  K5sphere   K5's step on the sphere at 1024x1024, 8 spp, depth 8,
             cosine + RR (phase 10's);
  K5city     K5's step on the city, the same shape with NEE + MIS (phase
             16's);
  K9field    K9's step on the instanced field at 1024x1024, 8 spp, depth
             8, cosine (phase 20's);
  K9lit      K9's step on the lit field, cosine + RR + NEE + MIS (phase
             20's);
  K9glossy   K9's step on the glossy lit field (a GGX and a glass ball
             mesh), the lit field's shape and estimator (phase 31's);
  K7first, K7third
             K7's launch on the field's 1M-ray first- and third-bounce
             waves at 1024x1024, 1 spp (phase 20's);
  K8first    K8's launch on the lit field's first-bounce shadow wave
             (phase 20's);
  K6first, K6third_unsorted, K6third, K6adaptive
             K6's launch on the 500k sphere's waves at 1024x1024, 1 spp
             (phase 24's): the first bounce, the third bounce unsorted and
             sorted, and a wave of a quarter of the 16x16 tiles after two
             uniform steps;
  K6step, K6step_unsorted
             the wavefront step over K6 on the 500k sphere at 1024x1024, 8
             spp, depth 8, cosine + RR (phase 23's renderer_k6), with its
             bounce rays sorted (the streamed route's default) and not.

``--only K9,K7`` times only the labels that start with one of the given
prefixes and sets up only their scenes (here the fields, not the 500k
sphere), e.g. ``python3 chip_ab.py out/parent . --only K9,K7``.

Each run calls only chip_smoke.py functions that older checkouts have
too (cornell_buffers, scene_setup, field_setup, glossy_field_setup,
capture_waves, capture, cuda_ms), so an older checkout compares with a
newer one. One line per run, ``AB
<label> K5city=<ms> K9lit=<ms> ...``, then the card's name and power
limit. It needs one card; compare two versions only within one run of
this script.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

READINGS, REPS = 3, 5
# each label's scene (the key of ``scenes`` in child)
SCENE_OF = {
    "K1cornell": "cornell", "K5sphere": "sphere", "K5city": "city",
    "K9field": "fields", "K9lit": "fields", "K9glossy": "glossy",
    "K7first": "fields", "K7third": "fields", "K8first": "fields",
    "K6first": "big", "K6third_unsorted": "big", "K6third": "big",
    "K6adaptive": "big", "K6step": "big", "K6step_unsorted": "big",
}


def selected(only):
    """The labels, in SCENE_OF's order, that start with one of the
    comma-separated prefixes of ``only`` (all labels for None); raises if
    a prefix matches none."""
    if only is None:
        return list(SCENE_OF)
    prefixes = [p for p in only.split(",") if p]
    for p in prefixes:
        if not any(label.startswith(p) for label in SCENE_OF):
            raise SystemExit(f"--only {p}: no label starts with it")
    return [label for label in SCENE_OF
            if any(label.startswith(p) for p in prefixes)]


def child(root: str, labels) -> None:
    """One run on the checkout at ``root``: its kernels, its scenes."""
    sys.path[0] = root
    os.chdir(root)
    import chip_smoke as C

    scenes = {SCENE_OF[label] for label in labels}
    with open(os.devnull, "w") as quiet:
        stdout, sys.stdout = sys.stdout, quiet
        try:
            runs = {}
            for key, setup in SETUPS.items():
                if key in scenes:
                    runs.update(setup(C))
        finally:
            sys.stdout = stdout
    out = []
    for _ in range(READINGS):
        for name in labels:
            out.append(f"{name}={C.cuda_ms(runs[name], REPS)[0]:.3f}")
    print(" ".join(out), flush=True)


def cornell_runs(C):
    from sfvp_tpu_torch import RenderConfig
    from sfvp_tpu_torch.kernels.megakernel import scene_table
    from sfvp_tpu_torch.kernels.megakernel_regen import regen_render

    cornell = C.cornell_buffers(C.DEVICE)
    table = scene_table(cornell)
    main = RenderConfig(width=C.MAIN_W, height=C.MAIN_H,
                        spp_per_step=C.MAIN_SPP, max_depth=C.MAIN_DEPTH)
    return {"K1cornell": lambda: regen_render(
        table, 1, 0, cfg=main, num_tris=cornell.num_tris,
        global_shape=(C.MAIN_H, C.MAIN_W), npix=C.MAIN_W * C.MAIN_H,
        has_mirrors=False)}


def shape(C):
    return dict(global_shape=(C.BVH_H, C.BVH_W), npix=C.BVH_W * C.BVH_H,
                has_mirrors=False)


def k5_runs(C, name, label, **cfg_kw):
    from sfvp_tpu_torch.kernels.megakernel_bvh import bvh_regen_render

    s = C.scene_setup(name, C.SPHERE_TRIS if name == "sphere"
                      else C.CITY_TRIS, **cfg_kw)
    lights = s["lights"] if cfg_kw else None
    return {label: lambda: bvh_regen_render(
        s["dw"], 1, 0, cfg=s["cfg"], lights=lights, **shape(C))}


def field_runs(C):
    """K9 on the field and the lit field, K7 on the field's first- and
    third-bounce waves and K8 on the lit field's first shadow wave, as
    chip_smoke.py phase 20 captures and times them."""
    from sfvp_tpu_torch.kernels.bvh_tlas import (
        two_level_occlusion, two_level_trace)
    from sfvp_tpu_torch.kernels.megakernel_bvh import tlas_regen_render

    field, lit = C.field_setup()
    one = dict(spp_per_step=1)
    first, third = C.capture_waves(
        dataclasses.replace(field["cfg"], **one), field, (0, 2))
    shadow = C.capture_waves(dataclasses.replace(lit["cfg"], **one), lit,
                             (0,), shadow=True)[0]
    t_min = field["cfg"].t_min

    def k9(s):
        return lambda: tlas_regen_render(s["dt"], 1, 0, cfg=s["cfg"],
                                         lights=s["lights"], **shape(C))

    return {
        "K9field": k9(field), "K9lit": k9(lit),
        "K7first": lambda: two_level_trace(field["dt"], t_min, first),
        "K7third": lambda: two_level_trace(field["dt"], t_min, third),
        "K8first": lambda: two_level_occlusion(lit["dt"], t_min, shadow),
    }


def glossy_runs(C):
    """K9 on the glossy lit field at the main path's shape (phase 31)."""
    from sfvp_tpu_torch.integrate.wavefront import material_flags
    from sfvp_tpu_torch.kernels.megakernel_bvh import tlas_regen_render

    g = C.glossy_field_setup()
    mats = material_flags(g["flat"])
    return {"K9glossy": lambda: tlas_regen_render(
        g["dt"], 1, 0, cfg=g["cfg"], lights=g["lights"], **shape(C),
        **mats)}


def big_runs(C):
    """K6 on the 500k sphere's four waves and the streamed Renderer step
    over K6, sorted and not (megakernel_regen=False)."""
    from sfvp_tpu_torch import init_state
    from sfvp_tpu_torch.dispatch import select_render_step
    from sfvp_tpu_torch.kernels import bvh_packet2

    big = C.scene_setup("sphere", C.BIG_TRIS)
    runs = {name: (lambda rays=rays: bvh_packet2.packet_trace2(
        big["dw"], big["cfg"].t_min, rays))
        for name, rays in k6_waves(C, big).items()}
    loop = dataclasses.replace(big["cfg"], megakernel_regen=False)
    for name, cfg in (("K6step", loop), ("K6step_unsorted",
                                         dataclasses.replace(
                                             loop, sort_bounce_rays=False))):
        step = select_render_step(cfg, big["buffers"], wide=big["wide"])
        state = init_state(cfg.height, cfg.width, C.DEVICE)
        runs[name] = lambda step=step, state=state: step(state)
    return runs


SETUPS = {
    "cornell": cornell_runs,
    "sphere": lambda C: k5_runs(C, "sphere", "K5sphere"),
    "city": lambda C: k5_runs(C, "city", "K5city", **C.NEE_FLAGS),
    "fields": field_runs,
    "glossy": glossy_runs,
    "big": big_runs,
}


def k6_waves(C, big):
    """K6's four waves on the 500k sphere, as chip_smoke.py phase 24
    captures them."""
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
        child(os.path.abspath(argv[1]), argv[2].split(","))
        return 0
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--only", default=None,
                   help="comma-separated label prefixes, e.g. K9,K7")
    args = p.parse_args(argv)
    labels = ",".join(selected(args.only))
    me = os.path.abspath(__file__)
    order = [("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)]
    for _ in range(args.rounds):
        for label, root in order:
            res = subprocess.run([sys.executable, me, "--child", root, labels],
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
