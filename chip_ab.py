"""Time two checkouts of the port against each other on one GPU.

    python3 chip_ab.py A_DIR B_DIR [--rounds N]

A_DIR and B_DIR are roots of checkouts of this repository (each with its
chip_smoke.py and sfvp_tpu_torch/; each builds its kernels in its own
build/). The script runs them in the order A B B A (N rounds of it), each
run a fresh process that sets up the city of ``--scene city --scene-tris
100000`` and the lit 220k instanced field through that checkout's
chip_smoke.py, then times, by CUDA events, 3 readings of 5 steps each:

  K5city  K5's step on the city at 1024x1024, 8 spp, depth 8, cosine + RR
          + NEE + MIS (chip_smoke.py phase 16's shape);
  K9lit   K9's step on the lit field, the same estimator (phase 20's).

One line per run, ``AB <label> K5city=<ms> K9lit=<ms> ...``, then the
card's name and power limit. It needs one card; compare two versions only
within one run of this script.
"""

from __future__ import annotations

import os
import subprocess
import sys

READINGS, REPS = 3, 5


def child(root: str) -> None:
    """One run on the checkout at ``root``: its kernels, its scenes."""
    sys.path[0] = root
    os.chdir(root)
    import chip_smoke as C
    from sfvp_tpu_torch.kernels.megakernel_bvh import (
        bvh_regen_render, tlas_regen_render)

    with open(os.devnull, "w") as quiet:
        stdout, sys.stdout = sys.stdout, quiet
        try:
            city = C.scene_setup("city", C.CITY_TRIS, **C.NEE_FLAGS)
            _, lit = C.field_setup()
        finally:
            sys.stdout = stdout
    shape = dict(global_shape=(C.BVH_H, C.BVH_W), npix=C.BVH_W * C.BVH_H,
                 has_mirrors=False)
    runs = (
        ("K5city", lambda: bvh_regen_render(
            city["dw"], 1, 0, cfg=city["cfg"], lights=city["lights"],
            **shape)),
        ("K9lit", lambda: tlas_regen_render(
            lit["dt"], 1, 0, cfg=lit["cfg"], lights=lit["lights"], **shape)),
    )
    out = []
    for _ in range(READINGS):
        for name, fn in runs:
            out.append(f"{name}={C.cuda_ms(fn, REPS)[0]:.3f}")
    print(" ".join(out), flush=True)


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
