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
  K1nee      K1's step on the Cornell Box, the same shape with cosine + RR
             + NEE + MIS (phase 16's);
  K1skynee   K1's step on the Cornell Box under the 64 x 32 sky map, cosine
             + RR + NEE + MIS (phase 28's);
  K1glass    K1's step on the Cornell Box with a glass short box through
             the thin lens, parity (phase 31's);
  K2cornell  K2's step on the Cornell Box, 32 one-sample launches and
             their adds, parity (phase 6's);
  K5sphere   K5's step on the sphere at 1024x1024, 8 spp, depth 8,
             cosine + RR (phase 10's);
  K3first    K3's launch on the sphere's 1M-ray first-bounce wave at
             1024x1024, 1 spp (phase 10's);
  K5city     K5's step on the city, the same shape with NEE + MIS (phase
             16's);
  K4city     K4's launch on the city's first-bounce shadow wave at
             1024x1024, 1 spp (phase 16's);
  K5ggx2048  K5's step on bench.py's GGX city at its city_sorted_2048
             shape, 2048x2048, 4 spp, cosine + RR + NEE (phase 31's);
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
glossy_city_setup, glass_setup, env_maps, env_buffers, k1_images,
capture_waves, capture, cuda_ms), so an older checkout compares with a
newer one. One line per run, ``AB <side> K5city=<ms> K9lit=<ms> ...``,
and a line of digests of each label's last output, ``OUT <side>
K5city=<sha256 prefix> ...``; at the end, for each label, whether the
outputs of all runs of both sides were the same bytes, then the card's
name and power limit. It needs one card; compare two versions only
within one run of this script.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import subprocess
import sys

READINGS, REPS = 3, 5
# each label's scene (the key of ``scenes`` in child)
SCENE_OF = {
    "K1cornell": "cornell", "K1nee": "cornell", "K1skynee": "sky",
    "K1glass": "glass", "K2cornell": "cornell", "K5sphere": "sphere",
    "K3first": "sphere", "K5city": "city", "K4city": "city",
    "K5ggx2048": "ggx2048",
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
    out, last = [], {}
    for _ in range(READINGS):
        for name in labels:
            ms, last[name] = C.cuda_ms(runs[name], REPS)
            out.append(f"{name}={ms:.3f}")
    print(" ".join(out))
    print(" ".join(f"{name}={digest(last[name])}" for name in labels),
          flush=True)


def digest(out) -> str:
    """The first 16 hex digits of the SHA-256 of a run's output: the
    bytes of its tensors and the repr of anything else, in order."""
    import torch

    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, torch.Tensor):
            h.update(x.detach().cpu().contiguous().numpy().tobytes())
        elif isinstance(x, (tuple, list)):
            for y in x:
                feed(y)
        else:
            h.update(repr(x).encode())

    feed(out)
    return h.hexdigest()[:16]


def main_cfg(C, **kw):
    from sfvp_tpu_torch import RenderConfig

    return RenderConfig(width=C.MAIN_W, height=C.MAIN_H,
                        spp_per_step=C.MAIN_SPP, max_depth=C.MAIN_DEPTH, **kw)


def k1_run(C, buffers, cfg):
    """K1's step on ``buffers`` under ``cfg`` at the main path's shape."""
    from sfvp_tpu_torch.integrate.wavefront import material_flags
    from sfvp_tpu_torch.kernels.megakernel_regen import regen_render

    table, imgs = C.k1_images(buffers, cfg)
    return lambda: regen_render(
        table, 1, 0, cfg=cfg, global_shape=(C.MAIN_H, C.MAIN_W),
        npix=C.MAIN_W * C.MAIN_H, **imgs, **material_flags(buffers))


def cornell_runs(C):
    """K1 on the Cornell Box, parity and under NEE + MIS; K2's step of
    one-sample launches and their adds, as chip_smoke.py phase 6 times
    it."""
    from sfvp_tpu_torch.kernels.megakernel import scene_table, wave_render

    cornell = C.cornell_buffers(C.DEVICE)
    main = main_cfg(C)
    table = scene_table(cornell)
    args = dict(cfg=main, num_tris=cornell.num_tris,
                global_shape=(C.MAIN_H, C.MAIN_W), npix=C.MAIN_W * C.MAIN_H,
                has_mirrors=False)

    def k2_step():
        total = wave_render(table, 1, 0, 0, **args)
        for c in range(1, C.MAIN_SPP):
            total = [a + b for a, b in
                     zip(total, wave_render(table, 1, c, 0, **args))]
        return total

    return {"K1cornell": k1_run(C, cornell, main),
            "K1nee": k1_run(C, cornell, main_cfg(C, **C.NEE_FLAGS)),
            "K2cornell": k2_step}


def sky_runs(C):
    """K1 on the Cornell Box under the sky map with NEE + MIS (phase
    28's "K1 env nee")."""
    import tempfile

    maps = C.env_maps(tempfile.mkdtemp())
    buffers = C.env_buffers(C.cornell_buffers(C.DEVICE), maps["sky"])
    return {"K1skynee": k1_run(C, buffers, main_cfg(C, **C.NEE_FLAGS))}


def glass_runs(C):
    """K1 on the glass Cornell Box through the thin lens (phase 31's)."""
    import tempfile

    g = C.glass_setup(tempfile.mkdtemp())
    return {"K1glass": k1_run(C, g["buffers"], g["cfg"])}


def shape(C):
    return dict(global_shape=(C.BVH_H, C.BVH_W), npix=C.BVH_W * C.BVH_H,
                has_mirrors=False)


def k5_runs(C, name, label, wave_label, **cfg_kw):
    """K5's step on the sphere or the city and, on its first-bounce wave
    at 1 spp, K3 (the sphere's payload wave) or K4 (the city's shadow
    wave), as chip_smoke.py phases 10 and 16 capture them."""
    from sfvp_tpu_torch.kernels.bvh_packet import (
        packet_occlusion, packet_trace)
    from sfvp_tpu_torch.kernels.megakernel_bvh import bvh_regen_render

    s = C.scene_setup(name, C.SPHERE_TRIS if name == "sphere"
                      else C.CITY_TRIS, **cfg_kw)
    lights = s["lights"] if cfg_kw else None
    cfg = s["cfg"]
    shadow = bool(cfg_kw)
    wave = C.capture_waves(dataclasses.replace(cfg, spp_per_step=1), s,
                           (0,), shadow=shadow)[0]
    trace = packet_occlusion if shadow else packet_trace
    return {label: lambda: bvh_regen_render(
        s["dw"], 1, 0, cfg=cfg, lights=lights, **shape(C)),
        wave_label: lambda: trace(s["dw"], cfg.t_min, wave)}


def ggx_runs(C):
    """K5 on bench.py's GGX city at its city_sorted_2048 shape (phase
    31's)."""
    from sfvp_tpu_torch.integrate.wavefront import material_flags
    from sfvp_tpu_torch.kernels.megakernel_bvh import bvh_regen_render

    s = C.glossy_city_setup(C.CITY2048_FRAC, C.CITY2048_W)
    cfg = s["cfg"]
    return {"K5ggx2048": lambda: bvh_regen_render(
        s["dw"], 1, 0, cfg=cfg, global_shape=(cfg.height, cfg.width),
        npix=cfg.width * cfg.height, has_mirrors=False, lights=s["lights"],
        **material_flags(s["buffers"]))}


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
    "sky": sky_runs,
    "glass": glass_runs,
    "sphere": lambda C: k5_runs(C, "sphere", "K5sphere", "K3first"),
    "city": lambda C: k5_runs(C, "city", "K5city", "K4city",
                              **C.NEE_FLAGS),
    "ggx2048": ggx_runs,
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
    digests = {}
    for _ in range(args.rounds):
        for side, root in order:
            res = subprocess.run([sys.executable, me, "--child", root, labels],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                sys.stderr.write(res.stdout + res.stderr)
                raise SystemExit(f"the run on {root} failed")
            times, outs = res.stdout.strip().splitlines()[-2:]
            print(f"AB {side} {times}")
            print(f"OUT {side} {outs}", flush=True)
            for item in outs.split():
                name, d = item.split("=")
                digests.setdefault(name, {}).setdefault(side, set()).add(d)
    for name, sides in digests.items():
        seen = sides["A"] | sides["B"]
        verdict = ("the same bytes in every run" if len(seen) == 1 else
                   "A and B apart" if sides["A"].isdisjoint(sides["B"])
                   and len(sides["A"]) == len(sides["B"]) == 1 else
                   "not repeatable")
        print(f"SAME {name}: {verdict}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
