"""Command-line entry point — the analog of the reference's ``main()``
(ref main.cpp:457-690), with the flags of sfvp_tpu.cli whose features are
ported (defaults = reference values).

Example:
    python -m sfvp_tpu_torch.cli --device cuda --steps 32 --out cornell.png
    python -m sfvp_tpu_torch.cli --scene sphere --scene-tris 100000 \
        --sampling cosine --rr --spp 8 --steps 4 --out sphere.png

    python -m sfvp_tpu_torch.cli --sampling cosine --rr --nee --mis \
        --steps 8 --out cornell_nee.png
    python -m sfvp_tpu_torch.cli --scene instanced --scene-tris 220000 \
        --sampling cosine --spp 8 --steps 4 --out field.png
    python -m sfvp_tpu_torch.cli --scene sphere --scene-tris 500000 \
        --sampling cosine --rr --spp 8 --adaptive 0.25 --steps 6
    python -m sfvp_tpu_torch.cli --scene sphere --scene-tris 100000 \
        --sampling cosine --rr --nee --mis --env-map sky.hdr --spp 8
    python -m sfvp_tpu_torch.cli --obj glass.obj --lens-radius 0.05 \
        --focus-dist 5 --sampling cosine --rr --out dof.png

An OBJ with ``vt`` and ``map_Kd`` renders textured; an MTL's ``Pr`` with a
nonzero ``Ks`` makes a GGX glossy face, ``illum`` 4 or more with ``Ni`` > 1
a smooth dielectric, ``illum`` 3 with a nonzero ``Ks`` a mirror. --dist,
not ported yet, raises NotImplementedError; --env-map with --scene
instanced raises ValueError, as in sfvp_tpu. With --adaptive, --log writes one JSONL record
a step (integrate/adaptive.py AdaptiveRenderer.run) and --frame-every is
ignored, as in sfvp_tpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

from .config import CameraConfig, RenderConfig
from .render.driver import Renderer
from .scene import cornell_box_path, load_obj


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sfvp_tpu_torch", description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu "
                        "their plain PyTorch twins")
    p.add_argument("--obj", default=None, help="OBJ scene path (default: bundled Cornell Box)")
    p.add_argument("--scene",
                   choices=["cornell", "sphere", "terrain", "city",
                            "instanced"],
                   default="cornell",
                   help="test scene when --obj is not given (instanced: "
                        "49 instances of two meshes over a ground slab, "
                        "traced through a two-level BVH)")
    p.add_argument("--scene-tris", type=int, default=100_000,
                   help="approximate triangle count for procedural scenes")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--steps", type=int, default=32, help="progressive steps to run")
    p.add_argument("--spp", type=int, default=32, help="samples per step")
    p.add_argument("--max-depth", type=int, default=8)
    p.add_argument("--spp-chunk", type=int, default=1)
    p.add_argument("--sampling", choices=["uniform", "cosine"], default="uniform")
    p.add_argument("--rr", action="store_true", help="enable Russian roulette")
    p.add_argument("--traversal", choices=["auto", "brute", "bvh"],
                   default="auto")
    p.add_argument("--out", default="render.png")
    p.add_argument("--srgb", action="store_true", help="sRGB-encode the PNG (default: unorm clamp like the reference swapchain)")
    p.add_argument("--frame-every", type=int, default=0, help="write intermediate PNG every N steps")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log", default=None, help="JSONL metrics sink")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--nee", action="store_true",
                   help="enable next-event estimation")
    p.add_argument("--mis", action="store_true",
                   help="balance-heuristic MIS between NEE and BSDF "
                        "sampling (implies --nee)")
    p.add_argument("--adaptive", type=float, default=None, metavar="FRAC",
                   help="variance-driven adaptive sampling: after warmup, "
                        "each step renders only the noisiest FRAC of tiles")
    p.add_argument("--adaptive-tile", type=int, default=16)
    p.add_argument("--adaptive-warmup", type=int, default=2)
    p.add_argument("--env-map", default=None,
                   help="equirect environment map (PNG/PPM/HDR) used as the "
                        "sky instead of the constant miss color")
    p.add_argument("--lens-radius", type=float, default=0.0,
                   help="thin-lens aperture radius (0 = pinhole)")
    p.add_argument("--focus-dist", type=float, default=0.0,
                   help="distance of the focal plane along the view axis "
                        "(default with an open lens: the camera target)")
    # not ported yet: raises NotImplementedError when used
    p.add_argument("--dist", action="store_true")
    return p


_NOT_PORTED = {
    "dist": "multi-device rendering (ROADMAP.md A.17)",
}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.obj is None and args.scene == "instanced" and args.env_map:
        raise ValueError(
            "--scene instanced is not combinable with --env-map (set "
            "env_map on a member Scene or flatten the instances)")
    for flag, what in _NOT_PORTED.items():
        if getattr(args, flag) not in (None, False, 0.0):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: {what} is not ported to "
                "sfvp_tpu_torch yet")
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        spp_per_step=args.spp,
        max_depth=args.max_depth,
        spp_chunk=args.spp_chunk,
        sampling=args.sampling,
        use_rr=args.rr,
        use_nee=args.nee or args.mis,
        use_mis=args.mis,
        traversal=args.traversal,
        camera=CameraConfig(),
    )
    if args.obj or args.scene == "cornell":
        scene = load_obj(args.obj or cornell_box_path())
    else:
        scene, cfg = procedural_scene(args.scene, args.scene_tris, cfg)
    if args.env_map:
        scene.env_map = args.env_map
    if args.lens_radius > 0:
        cfg = with_lens(cfg, args.lens_radius, args.focus_dist)
    if args.adaptive is not None:
        from .integrate.adaptive import AdaptiveRenderer

        r = AdaptiveRenderer(cfg, scene, args.device, frac=args.adaptive,
                             tile=args.adaptive_tile,
                             warmup=args.adaptive_warmup)
    else:
        r = Renderer(cfg, scene, args.device)
    if not args.quiet and r.wide is not None:
        print(f"set-up: wide BVH of {scene.num_triangles} triangles "
              f"({r.wide.nodes.shape[0]} nodes, {r.wide.tris.shape[0]} leaf "
              f"rows) built in {r.bvh_build_s:.3f} s", flush=True)
    elif not args.quiet and r.tl is not None:
        print(f"set-up: two-level BVH of {r.tl.num_instances} instances "
              f"({r.buffers.num_tris} triangles flattened, "
              f"{r.tl.nodes.shape[0]} nodes, {r.tl.tris.shape[0]} leaf rows, "
              f"max_stack {r.tl.max_stack}) built in {r.bvh_build_s:.3f} s",
              flush=True)
    if args.resume and args.checkpoint:
        r.resume(args.checkpoint)
    if args.adaptive is not None:
        r.run(steps=args.steps, out=args.out, srgb=args.srgb,
              progress=not args.quiet, checkpoint_path=args.checkpoint,
              checkpoint_every=args.checkpoint_every, log_path=args.log)
        return 0
    r.run(
        steps=args.steps,
        out=args.out,
        frame_every=args.frame_every,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        log_path=args.log,
        srgb=args.srgb,
        progress=not args.quiet,
    )
    return 0


def with_lens(cfg: RenderConfig, lens_radius: float,
              focus_dist: float) -> RenderConfig:
    """``cfg`` with an open thin lens, applied after the scene's own view
    as sfvp_tpu's CLI does (cli.py:148-170): a focal distance <= 0 means
    the plane of the camera's target."""
    focus = focus_dist
    if focus <= 0.0:
        focus = math.dist(cfg.camera.origin, cfg.camera.center)
        print(f"--lens-radius given without --focus-dist; focusing at the "
              f"camera target plane ({focus:.3g})", flush=True)
    return dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, lens_radius=lens_radius, focus_dist=focus))


def procedural_scene(name: str, n_tris: int, cfg: RenderConfig):
    """The procedural scene ``name`` of about ``n_tris`` triangles (for
    "instanced", a list of Instances of about that many triangles
    flattened), with sfvp_tpu's CLI sizing (cli.py:100-118), and ``cfg``
    with its default view and sky when the camera is the reference's
    (cli.py:119-139): procedural scenes are y-up and the reference camera
    does not frame them."""
    from .scene.procedural import (
        city_mesh, instanced_field, sphere_mesh, terrain_mesh)

    if name == "sphere":
        n = max(16, int(math.sqrt(n_tris / 2)))
        scene = sphere_mesh(n_lat=n, n_lon=n, bump=0.3)
    elif name == "instanced":
        scene = instanced_field(n_tris=n_tris)
    elif name == "city":
        # ~12 subdivided faces per building; solve for the count
        sub = 9
        scene = city_mesh(n_buildings=max(4, n_tris // (12 * sub * sub)),
                          subdiv=sub)
    elif name == "terrain":
        scene = terrain_mesh(n=max(16, int(math.sqrt(n_tris / 2)) + 1))
    else:
        raise ValueError(f"unknown procedural scene {name!r}")
    if cfg.camera == CameraConfig():
        if name == "city":
            cam = CameraConfig.look_at(
                origin=(13.0, 9.0, 13.0), target=(0.0, 0.8, 0.0),
                fov_y_deg=55.0)
        elif name == "instanced":
            cam = CameraConfig.look_at(
                origin=(10.5, 7.5, 10.5), target=(0.0, 0.6, 0.0),
                fov_y_deg=50.0)
        else:
            cam = CameraConfig.look_at(
                origin=(0.0, 2.2, 5.0), target=(0.0, 0.0, 0.0),
                fov_y_deg=50.0)
        cfg = dataclasses.replace(cfg, camera=cam,
                                  sky_emission=(0.8, 0.85, 1.0))
    return scene, cfg


if __name__ == "__main__":
    raise SystemExit(main())
