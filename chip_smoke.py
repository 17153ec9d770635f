"""Smoke test of the PyTorch / CUDA port (sfvp_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1, no result line) on failure:
  1. device   a CUDA device of compute capability 9.0 (Hopper), and the
              card's name and power limit from nvidia-smi;
  2. build    nvcc builds the kernels K1-K9 and P1-P6 from
              sfvp_tpu_torch/csrc/, one nvcc per source in parallel,
              while the host builds the wide BVHs of the 100k sphere
              and the city (phases 7-16);
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
              all 32 one-sample launches of a step); ptxas's registers,
              spills and stack frame of every entry of K1-K5 (the build's
              log), which the kernels line carries too.

The large-scene path (slice 2: the wide BVH, kernels K3 and K5), over the
100k-triangle bumpy sphere of ``--scene sphere --scene-tris 100000``:
  7. bvh twins   K3 against its twin on a 256x256 camera wave, a bounce
                 wave and a wave of random rays: at least 99.99% of rays
                 on the same triangle, every payload plane equal there;
                 K5 against its twin at 128x128, 1 spp, depth 8, cosine +
                 RR, on the sphere and on the mirror Cornell Box with
                 traversal="bvh";
  8. bvh oracle  K5 on the Cornell Box (traversal="bvh") at 128x128,
                 32 spp x 32 steps against the numpy oracle; K5 against K1
                 at 256x256, 8 spp;
  9. bvh main    the CLI on the 100k sphere at 1024x1024, 8 spp, depth 8,
                 cosine + RR (K5, K1 not launched); the Renderer with
                 megakernel_regen=False (the wavefront loop over K3); the
                 500k sphere at 512x512 (K5); each with its set-up
                 seconds, step times and image mean;
 10. bvh times   K5 per step and K3 per launch (first-bounce and a later
                 bounce wave) at the main path's shape, CUDA events, each
                 beside its twin, and K5 held to its twin there;
 11. bvh 500k    K5 against its twin on the 500k sphere's tree at
                 256x256, 1 spp, depth 8, cosine + RR, and K5's time per
                 pixel on the 500k and 100k trees at 512x512, 8 spp, and
                 per segment at 256x256, 1 spp; the 500k tree's set-up
                 seconds on the native SAH builder (since slice 7; the
                 NumPy LBVH before), its bytes past the streaming
                 threshold and its max_stack within K6's packet stack;
 12. ray sort    the wavefront step over K3 at the main path's shape with
                 the per-bounce ray sort on and off: times, same image.

Next-event estimation with MIS (slice 3: NEE inside K1 and K5, the any-hit
kernel K4), cosine + RR, on the Cornell Box and on the city of ``--scene
city --scene-tris 100000`` (82,782 triangles, 1,134 of them emissive):
 13. nee twins   K1 against its twin at 256x256, 8 spp, depth 8, NEE and
                 NEE + MIS, on the Cornell Box and the mirror Cornell; K5
                 against its twin at 128x128, 1 spp on the city and on the
                 Cornell Box with traversal="bvh"; K4 against its twin on
                 the shadow waves of one wavefront step on the city and on
                 a random wave: every ray equal;
 14. nee oracle  K1 with NEE + MIS at 128x128, 32 spp x 32 steps: its mean
                 within 1% of the numpy oracle's, and a lower relative
                 RMSE against it than K1 cosine without NEE; K5 with
                 traversal="bvh" against K1 at 256x256, 8 spp, NEE + MIS;
 15. nee main    the CLI on the Cornell Box at 1024x1024, 32 spp, depth 8,
                 8 steps, --nee --mis --rr (K1 only); the CLI on the city
                 at 1024x1024, 8 spp (K5 only, with its set-up seconds);
                 one Renderer step on the city with megakernel_regen=False
                 (K3 and K4, 64 launches each);
 16. nee times   K1 per NEE Cornell step, K5 per NEE city step and K4 per
                 launch on the city's first-bounce shadow wave, CUDA
                 events, each beside its twin and its bound; K1 and K5 held
                 to their twins at these shapes.

Instanced scenes (slice 4: the two-level BVH, kernels K7, K8 and K9), on
the field of ``--scene instanced --scene-tris 220000`` (50 instances of
three meshes, 211,878 triangles flattened) and the lit field (the same
and a lamp instance, cosine + RR + NEE + MIS):
 17. tlas twins  K7 against its twin on a 256x256 camera wave, a bounce
                 wave and a random wave (at least 99.99% of rays on the
                 same triangle, every plane equal there), on the field
                 and on a stress field of 200 small overlapping
                 instances; K8 on every ray of the lit field's first two
                 shadow waves, a random wave, a random wave with 90% of
                 its rays inactive, and the stress field's first shadow
                 wave and a random wave; K9 at 128x128, 1 spp, depth 8 on
                 the field, the lit field and the stress field;
 18. tlas cross  K9 against the wavefront loop over K7 at 256x256, 8 spp
                 (relative RMSE <= 1e-5, equal segments); K9 on the
                 instances against K5 on the flattened scene (image means
                 within 1e-5, < 0.2% of pixels apart by more than 1e-3,
                 relative RMSE < 5e-3);
 19. tlas main   the CLI command of the instanced scene at 1024x1024, 8
                 spp, depth 8, cosine, 4 steps (K9 only, with the two-level
                 set-up seconds); one Renderer step with megakernel_regen=
                 False (K7 only, 64 launches); the lit field: 4 Renderer
                 steps (K9), 1 with megakernel_regen=False (K7 and K8, 64
                 launches each); in both wavefront steps every K7 and K8
                 call between CUDA events, their sum beside the step;
 20. tlas times  K9 per step on both fields, K7 per launch on the first-
                 and third-bounce waves, K8 on the lit field's first-bounce
                 shadow wave, CUDA events, each beside its twin and its
                 bound (K8's also beside the pops of the same walk with
                 its children pushed nearest first); K9 held to its twin
                 at 1024x1024 x 8 spp on both.

Each kernel's bound is the larger of the bytes it must move over 3.35
TB/s and the FP32 operations it must do over 67 TFLOP/s (the H100 SXM's
data-sheet rates); for the traversal kernels the operations are counted
from the box and triangle tests (and instance pops) the twins do on the
same inputs, and for K1's shadow rays from the tests its early-exit scan
takes on them.

Adaptive sampling and the streamed-scene trace (slice 5: the packet trace
K6 with its leaf queue), on the 500k sphere of ``--scene sphere
--scene-tris 500000`` (its 57.8 MB wide BVH is past sfvp_tpu's 13 MiB
streaming threshold, so the wavefront loop traces it through K6) and on
the city with ``stream_tris=True``:
 21. k6 twins    K6 against its twin on every plane of every ray: the
                 swizzled 64x64 camera wave, a bounce wave, a random
                 wave, the camera wave with a partial last packet and
                 with an active mask, the camera wave with a 2-entry leaf
                 queue (the spill path), and the shadow wave of one NEE step on
                 the city; K6 and K3 on the same triangle on at least
                 99.99% of the rays of 128x128 camera and bounce waves;
 22. adaptive    at 256x256, 8 spp, depth 8, cosine + RR: the adaptive
     cross       sampler's uniform step over K6 against the Renderer's
                 wavefront step over K3; an adaptive step over K6 and one
                 over K3 from one state (the same tiles); the city with NEE
                 + MIS, uniform step, K6 for payload and shadows against K3
                 + K4; each pair held to the kernel-vs-twin image bounds;
 23. adaptive    the CLI command ``--scene sphere --scene-tris 500000
     main        --sampling cosine --rr --spp 8 --adaptive 0.25 --steps 6``
                 at 1024x1024 (2 warmup and 4 adaptive steps, 64 K6
                 launches each, no K3, K4 or K5), with its set-up seconds,
                 step times and Mrays/s; one Renderer step with
                 megakernel_regen=False (64 K6 launches, each call between
                 CUDA events) and one with stream_tris=False too (64 K3
                 launches: the route of that step before K6 was ported);
                 two AdaptiveRenderer steps on the city with
                 NEE + MIS + RR and stream_tris=True (K6 for payload and
                 shadow rays, no K4);
 24. k6 times    K6 per launch on the 500k sphere's swizzled 1M-ray
                 first-bounce wave, its third-bounce wave and a 262,144-ray
                 adaptive wave (1024 tiles of 16x16), CUDA events, each
                 beside K3 on the same wave and K6's twin; both held to
                 the bound of the closest-hit work, from K3's twin's
                 per-ray pops, with the bound of K6's own union walk
                 printed beside it; K6 held to its twin on every ray.
The streamed route sorts its bounce rays by default since slice 6
(integrate/wavefront.py sort_rays), so phase 23 also takes the Renderer's
K6 step unsorted, and phase 24 times the third-bounce wave sorted beside
the unsorted one (K6 and K3; the twin runs on the unsorted wave, as in
slice 5). Cut in slice 6 to keep the script's time (a twin walks in
passes, so its time follows its samples and its longest walk more than
its pixels):
  - phase 21's twin waves are 64x64 (K6_TWIN_SIZE; 256x256 before), its
    K6-vs-K3 waves 128x128 (K3_SAME_SIZE), and its 2-entry leaf queue
    runs on the camera wave (on the bounce wave before);
  - phase 11's twins are 256x256 at 1 spp (BIG_TWIN_SIZE; 512x512 at 8
    spp before);
  - phase 12 takes one round (SORT_ROUNDS; two before);
  - the kernels build while the 100k sphere's and the city's BVHs do
    (phase 2; one after the other before);
  - phases 7, 13 and 17 hold K5 and K9 to their twins at 1 spp
    (EARLY_TWIN_SPP; 4 before);
  - phase 23's steps without the sort and over K3 reuse the wide BVH of
    its Renderer step over K6 (each built its own before);
  - phase 24 runs no twin on the sorted third-bounce wave (its ~37 live
    packets took the twin 20-30 s).

Environment maps and map_Kd textures (slice 6: env sky, env NEE and
textures in K1 and K5, the texture planes of K3 and K6, the fetch kernels
P3 and P4, K1 and K2 past 480 triangles), on the Cornell Box with a 64 x
32 sky or bench.py's sun map, a Cornell Box OBJ written with vt and
map_Kd on its back wall, and the 100k sphere with bench.py's checker (its
wide tree collapsed again from the sphere's binary tree with the vt rows),
its sun map and its two 2048 x 1024 maps:
 25. env twins   K1 at 256x256, 8 spp, depth 8 with the sky, with the sun
                 under NEE + MIS + RR and textured; K5 at 128x128, 4 spp
                 with the checker, the sun under NEE + MIS + RR and the
                 2048 x 1024 sun (the pooled proposal); K3 and K6 on every
                 plane of a textured 256x256 camera and bounce wave; P3 on
                 1M directions at 32 x 64, 128 x 256, 256 x 512 and
                 2048 x 1024 (max abs < 3e-5 x the largest texel,
                 probe_envfetch.py:106) and P4's four variants at 32 x 64
                 and 2048 x 1024 (full bitwise P3, half within 1e-3 of it);
                 K1 and K2 at 128x128 on spheres of 2,964 triangles (the
                 table in opted-in shared memory) and 5,100 (in tiles);
 26. env main    the CLI with --env-map on the Cornell Box at 1024x1024,
                 32 spp, depth 8, 4 steps, with and without --nee --mis
                 --rr (K1 only); the CLI --scene sphere --scene-tris 100000
                 --sampling cosine --rr --nee --mis --env-map at 1024x1024,
                 8 spp (K5 only, with its set-up seconds); bench.py's rows
                 tex_100k_512, env_nee_100k_512, env_big2048_100k_512 and
                 env_big2048_nee_100k_512 at 512x512, 8 spp, depth 8, its
                 camera and sky, through select_render_step over the
                 prebuilt trees, the Renderer's route (K5 only): one
                 warm-up and 3 timed steps each, step ms and Mrays/s;
 27. env wave-   one step at 1024x1024, 8 spp with megakernel_regen=False:
     front       the textured sphere over K3 (64 launches) and over K6,
                 the sun under NEE + MIS over K3 and K4 (64 each), each
                 within relative RMSE 1e-5 of K5's step, equal segments;
 28. env times   K1 per env Cornell step (with and without NEE), K5 per
                 step of each bench row, K3 per textured first-bounce
                 launch, P3 per 1M-direction launch at each map size and P4
                 per variant at 32 x 64 and 2048 x 1024 (queued behind a
                 sleeping kernel, so that the host's time per call does
                 not pace them; P3 also a call at the host's pace), CUDA
                 events, each beside its twin (held to it) and its bound;
                 P3's bound the larger of (24 n + 12 H W) bytes over 3.35
                 TB/s and n x ENV_FETCH_OPS over 67 TFLOP/s.

Materials and the thin lens (slice 7: GGX glossy and the smooth
dielectric in K1, K5 and K9 and the loop over K3 + K4, the thin lens in
K1 and K5; compiled only into the kernels of scenes that have them) and
the leaf-row probes P2 and P5:
 29. mat twins   K5 against its twin at 256x256, 4 spp on bench.py's
                 glossy city (city_mesh(96, 9, glossy_ground=True,
                 emissive_frac=0.03), its camera and sky, cosine + RR +
                 NEE); K1 at 256x256, 8 spp and K5 at 128x128, 4 spp on
                 the Cornell Box with a glass short box (an MTL the script
                 writes, Ni 1.5 illum 7) through a thin lens focused on its
                 back wall, parity and cosine + RR + NEE + MIS; K1 at
                 128x128, 4 spp on spheres of 2,964 (opt-in shared
                 memory) and 5,100 (tiled) triangles of all four
                 materials through the lens; K9 at 128x128, 1 spp on the
                 lit 220k field with GGX and glass balls;
 30. mat main    the CLI --obj glass.obj --lens-radius 0.05 --focus-dist
                 <back wall> at 1024x1024, 32 spp, depth 8, 2 steps (K1
                 only); the Renderer on the glossy city at bench.py's
                 city_648lights shape (1024x1024, 4 spp) and its
                 city_sorted_2048 shape (emissive_frac 0.06, 2048x2048, 4
                 spp), 2 steps each (K5 only); on the glossy field (K9
                 only); the glossy city with megakernel_regen=False at
                 256x256 (K3 and K4 only), its image equal to K5's step;
 31. mat times   K5 per glossy-city step at both shapes and K1 per glass +
                 lens Cornell step, each held to its twin at that shape; K9
                 per glossy lit-field step at 1024x1024, 8 spp, that
                 step held to the loop over K7 + K8 at the same shape and
                 seed, and K9 to its twin at 512x512, 2 spp; CUDA events,
                 each beside its bound (the GGX, dielectric and lens work
                 counted from the twins' material hits, GGX_* and
                 DIEL_OPS; K9's from its twin's counts, scaled 16x);
 32. probes      P2's five modes (base, extract, smemdma, smemload,
                 dmaonly) over an (8192, 128) table bitwise against their
                 twins over 2,000 iterations (base and dmaonly over 1, 5
                 and 15, where their accumulator is finite; it overflows
                 past 17) and timed over 20,000 queued
                 behind a sleeping kernel (ns per iteration, each less
                 base); P5 against its twin and the probe's exact want.
The native builder (slice 7): the 100k sphere's, the city's and the 500k
sphere's wide BVHs are built by the package's C++ SAH builder, which the
build phase compiles with g++ beside the kernels (phase 11 prints the
500k tree's set-up seconds).

The probes P1 and P6 and the measurement utilities (slice 8); phase 1
also runs the CLI's --devices (utils/diagnostics.py) and checks that it
reports the card:
 33. p1          P1's six variants (stripped, packed, packed_center,
                 pushall_center, no_sortnet, no_leaf) bitwise against their
                 twins, planes and per-packet pop counts, on phase 21's
                 64x64 camera and bounce waves of the 500k sphere, and
                 stripped on phase 24's 1M-ray first-bounce wave; every
                 variant timed (CUDA events) on phase 24's four waves
                 (first bounce, third bounce unsorted and sorted, adaptive)
                 beside K6 and K3, with its pops (sum, longest packet), ns
                 an iteration of the longest packet, and the differences
                 that split K6: K6 - stripped (the leaf queue), stripped -
                 no_sortnet (thread 0's network), stripped - packed_center
                 (the key's block minimum), stripped / K3; stripped's
                 (t, u, v) equal to K3's on at least K3_SAME_TRI of the
                 rays of each wave, the rays where t is apart counted;
 34. p6          P6's ten variants (the probe's v0-v8 and the tenth branch
                 of its body, v9) over the probe's (16384, 128) normal
                 table bitwise (NaN for NaN) against their twins at 1, 5,
                 15 and 2,000 iterations from the zero state and a nonzero
                 one, then timed over 20,000 iterations queued behind a
                 sleeping kernel: ns an iteration beside P2's base;
 35. profiler    torch.profiler (utils/profiling.py profile_trace) around
                 one steady Renderer wavefront step over K6 (the 500k
                 sphere, phase 23's Renderer) and one over K3 (the 100k
                 sphere): the kernels that took the card's time, by name,
                 and the card's busy and idle share of the traced window
                 (the union of its kernel and copy intervals in the Chrome
                 trace over the host's time of the step), beside an
                 unprofiled step.

The line before the last is the kernel report as one JSON object; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
DEVICE = "cuda"
MAIN_W = MAIN_H = 1024
MAIN_SPP, MAIN_DEPTH, MAIN_STEPS, K2_STEPS = 32, 8, 8, 2
# kernel vs twin on the card (a few of ~0.5M paths may diverge after a
# 1-ulp hit/miss flip, each moving one pixel by up to ~0.1)
TWIN_REL_RMSE, TWIN_OFF_FRAC, TWIN_OFF_ABS, SEGS_REL = 1e-4, 1e-3, 1e-4, 1e-4
ORACLE_REL_RMSE = 1e-4
# the large-scene path
SPHERE_TRIS, BIG_TRIS = 100_000, 500_000
BVH_W = BVH_H = 1024
BVH_SPP, BVH_DEPTH, BVH_STEPS, K3_STEPS, BIG_STEPS = 8, 8, 4, 1, 2
BIG_W = BIG_H = 512
# phase 11's twins, cut in slice 6 to keep the script's time (512x512
# before)
BIG_TWIN_SIZE = 256
BVH_TWIN_SIZE, BVH_TWIN_SPP, K5_K1_SIZE = 128, 4, 256
# phases 7, 13 and 17 hold K5 and K9 to their twins at BVH_TWIN_SIZE^2 and
# EARLY_TWIN_SPP spp, phase 11 at BIG_TWIN_SIZE^2: 1 spp since slice 6
# (BVH_TWIN_SPP and 8 before; phase 25 keeps BVH_TWIN_SPP), to keep the
# script's time: the twins walk one wave a sample, so their time follows
# spp, not pixels; phases 10, 16 and 20 hold the kernels at the main
# path's 8 spp
EARLY_TWIN_SPP = 1
# phase 12: one round since slice 6 (two before), to keep the script's time
SORT_ROUNDS, SORT_STEPS = 1, 2
K3_SAME_TRI = 0.9999
K5_TWIN_REL_RMSE, K5_K1_REL_RMSE = 1e-5, 1e-5
# bounds: the H100 SXM data sheet's HBM rate and FP32 (non-tensor) peak
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
# FP32 operations a test takes, counted from the CUDA sources: a
# Moller-Trumbore test with precomputed edges (common.cuh closest_hit) or
# with its edges from the vertices (wide_bvh.cuh); one slab test of a
# child box (6 sub, 6 mul, 12 min/max, 1 compare), and per node pop the
# 19 compares of the sorting network; the shading of one segment (camera
# ray or scatter, roulette, accumulation), rounded down
TRI_OPS_TABLE, TRI_OPS_ROWS, BOX_OPS, SORT_OPS, SHADE_OPS = 55, 61, 25, 19, 80
# next-event estimation: the shading of one shadow ray (three draws, the
# light pick, the point on the light, geometry term, MIS weight, the
# colour), rounded down
NEE_OPS = 60
# the NEE path: the city of --scene city --scene-tris 100000, its CLI view
CITY_TRIS, CITY_STEPS = 100_000, 4
NEE_FLAGS = dict(sampling="cosine", use_rr=True, use_nee=True, use_mis=True)
NEE_CLI = ["--sampling", "cosine", "--rr", "--nee", "--mis"]
NEE_ORACLE_MEAN = 0.01
NEE_TWIN_SIZE, NEE_TWIN_SPP = 256, 8
# the instanced path: --scene instanced --scene-tris 220000 (the JAX
# bench's bench_instanced_tlas scene and estimator, bench.py:317-346), and
# the lit field: the same instances and the lamp of tests/test_tlas.py:
# 131-143 under cosine + RR + NEE + MIS
FIELD_TRIS, FIELD_STEPS, LIT_STEPS = 220_000, 4, 4
FIELD_CLI = ["--sampling", "cosine"]
LIT_FLAGS = dict(NEE_FLAGS, sky_emission=(0.05, 0.05, 0.05))
TLAS_CROSS_SIZE, TLAS_CROSS_SPP = 256, 8
# phase 17's stress field: STRESS_INST small instances of the field's two
# ball meshes with overlapping boxes, the ground and the lamp
# (stress_instances), from STRESS_SEED
STRESS_INST, STRESS_SEED = 200, 5
# phase 17's K8 wave of mostly inactive rays: the share of rays with no
# window (the lit field's first-bounce shadow wave has ~43%)
K8_IDLE = 0.9
# K9 on the instances against K5 on the flattened scene: the two differ by
# object-space rounding (tests/test_tlas.py:82), which moves a few paths:
# image means within K9_K5_MEAN (relative), fewer than K9_K5_OFF_FRAC of
# the pixels apart by more than K9_K5_OFF_ABS, relative RMSE below
# K9_K5_REL_RMSE. An NVIDIA H100 80GB HBM3 (700 W) read 1.1e-6, 0.0214%
# and 7.8e-4 at 256x256, 8 spp; the limits leave ~10x room, so a walk
# that lost a small instance's triangles fails
K9_K5_MEAN, K9_K5_OFF_FRAC, K9_K5_OFF_ABS = 1e-5, 2e-3, 1e-3
K9_K5_REL_RMSE = 5e-3
# the two-level walks beside the single-level ones: an instance pop
# re-derives the ray in the instance's space (o' 9 mul + 9 add, d' 9 mul +
# 6 add, three safe reciprocals of 4 ops each), and a hit's 3 vertices go
# to world space (3 x (9 mul + 9 add)), counted from csrc/two_level.cuh
INST_OPS, WORLD_OPS = 45, 54
# slice 5: the adaptive sampler (the CLI's defaults, tile 16, warmup 2) and
# K6 on the 500k sphere, whose wide BVH sfvp_tpu streams; the cross-checks
# at CROSS_SIZE^2 with BVH_SPP spp
ADAPT_FRAC, ADAPT_TILE, ADAPT_WARMUP, ADAPT_STEPS = 0.25, 16, 2, 6
CROSS_SIZE, CITY_ADAPT_STEPS = 256, 2
# phase 21's twin waves: 64x64 since slice 6 (256x256 in slice 5), to
# keep the script's time as its phases grow: the twin walks all packets of
# a wave in one loop, as many passes as its longest packet walk needs, 4
# packets of 1,024 rays here, the last one partial in one case; K6 and K3
# are held on the same triangle on K3_SAME_SIZE^2 waves, where one ray
# apart is below the 1e-4 share K3_SAME_TRI allows
K6_TWIN_SIZE, K3_SAME_SIZE = 64, 128
# K6's leaf ring at its extremes on phase 21's camera and bounce waves: one
# slot refilled every iteration, spilled leaves re-enqueued and fetched
# late, the default, and the largest ring (128 KB of shared memory)
K6_LEAF_QS = (1, 2, 64, 256)
ADAPT_CLI = ["--scene", "sphere", "--scene-tris", str(BIG_TRIS),
             "--sampling", "cosine", "--rr", "--spp", str(BVH_SPP),
             "--adaptive", str(ADAPT_FRAC), "--steps", str(ADAPT_STEPS)]
# slice 6, environment maps and textures: K1's twins at ENV_TWIN_SIZE^2 with
# ENV_TWIN_SPP spp; the CLI's env renders ENV_MAIN_STEPS steps; bench.py's
# four env/texture rows at BENCH_SIZE^2, 8 spp, BENCH_STEPS timed steps
# after one warm-up; P3 on FETCH_N directions at each of FETCH_SIZES, P4 at
# ABLATE_SIZES; K1 and K2 past 480 triangles on spheres of BRUTE_LATS
# rings (2,964 and 5,100 triangles: the table in opted-in shared memory,
# past 1,024, and in tiles, past 4,842) at BRUTE_SIZE^2, BRUTE_SPP spp
ENV_TWIN_SIZE, ENV_TWIN_SPP, ENV_MAIN_STEPS = 256, 8, 4
BENCH_SIZE, BENCH_STEPS = 512, 3
FETCH_N = 1 << 20
FETCH_SIZES = ((32, 64), (128, 256), (256, 512), (1024, 2048))
ABLATE_SIZES = ((32, 64), (1024, 2048))
BRUTE_LATS, BRUTE_SIZE, BRUTE_SPP = (39, 51), 128, 4
# a wavefront step against K5's step of the same seed: the same streams,
# the NEE terms summed in two float orders
WF_K5_REL_RMSE = 1e-5
# FP32 operations of one environment fetch, counted from csrc/common.cuh
# env_lookup: u, v and the band clamp (12), the taps and weights (27), the
# three channel blends (21), atan2f and acosf as 20 and 15; of P4's trig
# variant (the fetch's u and v, u + v) and of noread (the fetch with the
# blends replaced by the weights' sum); rounded down
ENV_FETCH_OPS, ENV_TRIG_OPS, ENV_NOREAD_OPS = 90, 45, 75
# P3 and P4 take less time on the card than their wrapper on the host, so
# they are timed queued behind torch.cuda._sleep of this many cycles
# (~50 ms at the H100's clock; queued_ms)
QUEUE_SLEEP_CYCLES = 100_000_000

# slice 7, materials and the thin lens: the reference suite's glossy city
# (bench.py's city_mesh(n_buildings=96, subdiv=9, glossy_ground=True), its
# camera and sky, cosine + RR + NEE, bench.py:136-195) at the
# city_648lights shape (emissive_frac 0.03, MAT_W^2, MAT_SPP spp) and the
# city_sorted_2048 shape (0.06, CITY2048_W^2); the loop over K3 + K4 at
# MAT_LOOP_SIZE^2; the Cornell Box with a glass short box (an MTL the
# script writes: Ni 1.5, illum 7) through a thin lens focused on the back
# wall at the main path's shape; the glossy field's K9 twin at
# FIELD_MAT_TWIN^2 with FIELD_MAT_TWIN_SPP spp
CITY_VIEW = dict(origin=(13.0, 9.0, 13.0), target=(0.0, 0.8, 0.0),
                 fov_y_deg=55.0)
GLOSSY_CITY = dict(n_buildings=96, subdiv=9, glossy_ground=True)
CITY648_FRAC, CITY2048_FRAC = 0.03, 0.06
MAT_W, MAT_SPP, CITY2048_W, MAT_LOOP_SIZE = 1024, 4, 2048, 256
MAT_FLAGS = dict(sampling="cosine", use_rr=True, use_nee=True)
GLASS_LENS_RADIUS = 0.05
GLASS_MTL = "Kd 0 0 0\nKs 0 0 0\nNi 1.5\nillum 7\n"
FIELD_MAT_TWIN, FIELD_MAT_TWIN_SPP = 512, 2
# FP32 operations, counted from csrc/common.cuh and rounded down: the GGX
# frame of a hit (ggx_frame: the flipped normal, its basis, the view
# direction in it, alpha and Lambda), a GGX light evaluation (ggx_eval: the
# half vector, D, G2, Fresnel, f_r, the VNDF pdf), a GGX bounce
# (ggx_bounce: the VNDF sample with its sin and cos, the reflection to
# world space, G2 / G1, the pdf), a dielectric bounce (dielectric_dir) and
# the thin lens of a camera ray (camera_path<DOF>)
GGX_FRAME_OPS, GGX_EVAL_OPS, GGX_BOUNCE_OPS = 70, 110, 170
DIEL_OPS, LENS_OPS = 45, 40
# P2 and P5, the leaf-row probes: P2 over an (P2_ROWS, 128) table (4 MiB,
# the TPU probe's default), held to its twin over P2_CHECK_ITERS
# iterations, timed over P2_ITERS (queued behind a sleeping kernel, as
# P3); P5 on its (16, 128) table. base's and dmaonly's accumulator grows
# ~129x an iteration and is inf past 17, where any chain agrees: they are
# held to their twins at P2_FINITE_ITERS, where it is finite
P2_ROWS, P2_CHECK_ITERS, P2_ITERS, P2_REPS = 8192, 2000, 20_000, 3
P2_FINITE_ITERS, P2_CHAIN_MODES = (1, 5, 15), ("base", "dmaonly")
# slice 8: P1 timed P1_REPS launches a wave after a warm-up, P1_SLOW
# (pushall_center pops every row of the tree in every packet: ~0.1 M pops
# a packet on the 500k sphere, ~2.5 s a 1M-ray wave) one launch, no
# warm-up; P6 over the probe's (8 x P6_ROWS, 128) table, held to its twin
# at P6_CHECK_ITERS, timed over P6_ITERS (queued); the profiler over
# PROFILE_STEPS steps, its PROFILE_TOP largest kernels printed
P1_REPS, P1_SLOW = 3, ("pushall_center",)
P6_ROWS, P6_CHECK_ITERS, P6_ITERS, P6_REPS = 2048, (1, 5, 15, 2000), 20_000, 3
PROFILE_STEPS, PROFILE_TOP = 1, 12


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T0:.0f} s)", flush=True)


def rel_rmse(a, b):
    """utils/metrics.py relative_rmse of two tensors (float64, on the
    host); an all-zero reference raises, as it has no relative error."""
    from sfvp_tpu_torch.utils.metrics import relative_rmse

    ref = b.detach().double().cpu().numpy()
    check(bool(np.any(ref)), "relative RMSE against an all-zero reference")
    return relative_rmse(a.detach().double().cpu().numpy(), ref)


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events, after
    one warm-up run unless ``warm`` is off; and the last run's result."""
    if warm:
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


def queued_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` runs, by CUDA
    events, for a kernel shorter than its wrapper's host time: the runs
    are queued behind a sleeping kernel, so the card runs them back to
    back instead of at the pace the host issues them (cuda_ms)."""
    fn()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    marks[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    marks[2].record()
    torch.cuda.synchronize()
    slept = marks[0].elapsed_time(marks[1])
    check(host_ms < slept, f"the host queued {reps} runs in {host_ms:.3f} ms, "
                           f"past the {slept:.3f} ms sleep")
    return marks[1].elapsed_time(marks[2]) / reps


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
    # the CLI's device report (utils/diagnostics.py)
    from sfvp_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["--devices"])
    print(f"  cli --devices: {out.getvalue().strip()}")
    check(rc == 0 and "'platform': 'gpu'" in out.getvalue()
          and torch.cuda.get_device_name(0) in out.getvalue(),
          f"cli --devices printed {out.getvalue()!r}")
    return card


def build_phase():
    """nvcc builds the kernels while the host builds the wide BVHs of the
    100k sphere and the city, which need no kernel; returns their
    set-ups (scene_setup)."""
    from concurrent.futures import ThreadPoolExecutor

    from sfvp_tpu_torch.kernels import build

    phase(f"build, and meanwhile the {SPHERE_TRIS // 1000}k sphere's and the "
          "city's wide BVHs")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        lib = pool.submit(build.build)
        sphere = scene_setup("sphere", SPHERE_TRIS)
        city = scene_setup("city", CITY_TRIS, **NEE_FLAGS)
        lib = lib.result()
    build.library()
    print(f"built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    log = lib.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "stack frame")):
                print("  ptxas:", line.strip())
    return sphere, city


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


def compare(label, got, exp, spp, rel_bound=TWIN_REL_RMSE):
    """Hold a kernel's (colr, colg, colb, segs) per-pixel totals over
    ``spp`` samples against its twin's with the card bounds (relative
    RMSE below ``rel_bound``); print the measured values and return the
    largest absolute pixel difference."""
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
    check(rel < rel_bound and off < TWIN_OFF_FRAC and seg_rel <= SEGS_REL,
          f"{label} disagrees with its twin: rel_rmse {rel}, pixels off "
          f"{off}, segment rel diff {seg_rel}")
    return mx


def oracle_phase(bvh):
    """K1, or K5 with traversal="bvh" (``bvh``), on the Cornell Box at
    128x128 against the numpy oracle."""
    from sfvp_tpu_torch import RenderConfig, init_state
    from sfvp_tpu_torch.accel.wide import build_wide_from_buffers
    from sfvp_tpu_torch.kernels.bvh_packet import device_wide
    from sfvp_tpu_torch.kernels.megakernel_bvh import make_bvh_regen_render_step
    from sfvp_tpu_torch.kernels.megakernel_regen import make_regen_render_step

    name = "K5 (traversal='bvh')" if bvh else "K1"
    phase(f"oracle: {name} at 128x128, 32 spp x 32 steps vs the numpy oracle")
    with np.load(os.path.join(ROOT, "tests", "golden",
                              "oracle_128_1024spp.npz")) as z:
        ref = torch.from_numpy(z["accum"]).to(DEVICE)
        frames, spp = int(z["frames"]), int(z["spp"])
    cfg = RenderConfig(width=128, height=128, spp_per_step=spp, max_depth=8,
                       traversal="bvh" if bvh else "auto")
    buffers = cornell_buffers(DEVICE)
    if bvh:
        step = make_bvh_regen_render_step(cfg, buffers, device_wide(
            build_wide_from_buffers(buffers), DEVICE))
    else:
        step = make_regen_render_step(cfg, buffers)
    st = init_state(128, 128, DEVICE)
    for _ in range(frames):
        st = step(st)
    rel = rel_rmse(st.accum, ref)
    off = float(((st.accum - ref).abs().amax(-1) > 1e-4).float().mean())
    print(f"  relative RMSE vs oracle: {rel:.3e} (bound {ORACLE_REL_RMSE}); "
          f"{off:.3%} of pixels off by > 1e-4, max abs "
          f"{float((st.accum - ref).abs().max()):.3e}")
    check(rel <= ORACLE_REL_RMSE, f"{name} vs oracle relative RMSE {rel}")


def main_path_phase(tmp):
    from sfvp_tpu_torch import RenderConfig, Renderer, cli, load_obj

    phase(f"main path: cli at {MAIN_W}x{MAIN_H}, {MAIN_SPP} spp, depth "
          f"{MAIN_DEPTH}, {MAIN_STEPS} steps (K1); Renderer with "
          f"megakernel_regen=False, {K2_STEPS} steps (K2)")
    out, log = os.path.join(tmp, "cornell.png"), os.path.join(tmp, "run.jsonl")
    reset_counts()
    rc = cli.main(["--device", DEVICE, "--width", str(MAIN_W), "--height",
                   str(MAIN_H), "--spp", str(MAIN_SPP), "--max-depth",
                   str(MAIN_DEPTH), "--steps", str(MAIN_STEPS), "--out", out,
                   "--log", log, "--quiet"])
    k2 = Renderer(RenderConfig(width=MAIN_W, height=MAIN_H,
                               spp_per_step=MAIN_SPP, max_depth=MAIN_DEPTH,
                               megakernel_regen=False), load_obj(), DEVICE)
    k2_img = k2.run(K2_STEPS, progress=False)
    launches = read_counts()
    print(f"  launches during the main path: {launches}")
    check(launches["K3"] == launches["K4"] == launches["K5"] == 0,
          f"BVH kernels launched on the Cornell path: {launches}")
    check(rc == 0, f"cli returned {rc}")
    check(launches["K1"] == MAIN_STEPS,
          f"K1 launched {launches['K1']} times, expected {MAIN_STEPS}")
    check(launches["K2"] == K2_STEPS * MAIN_SPP,
          f"K2 launched {launches['K2']} times, expected "
          f"{K2_STEPS * MAIN_SPP}")
    check(os.path.getsize(out) > 0, "no PNG written")
    recs = [json.loads(x) for x in open(log).read().splitlines()]
    check(len(recs) == MAIN_STEPS, f"{len(recs)} log records")
    print_steps(recs)
    for name, img in (("K1", _read_png(out)), ("K2", k2_img)):
        check_image(name, img, MAIN_H, MAIN_W)
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
        # every segment tests all triangles; bytes: the table once, the
        # per-pixel outputs (K2: per ray, 32 launches) once
        segs = int(got[3].sum(dtype=torch.int64))
        ops = segs * (buffers.num_tris * TRI_OPS_TABLE + SHADE_OPS)
        n_out = MAIN_W * MAIN_H * (1 if k == "K1" else MAIN_SPP)
        nbytes = table.numel() * 4 + n_out * 16
        times[k] = (ms, plain) + bound(ops, nbytes)
        print(f"  {k}: {segs} segments, bound {times[k][2]:.3f} ms "
              f"({times[k][3]})")
    return times, worst


def tree_nbytes(wide):
    """Distinct bytes of the tree: the 64 used lanes of a node row, the 128
    lanes of a leaf row."""
    return (wide.nodes.shape[0] * 64 + wide.tris.shape[0] * 128) * 4


def walk_ops(node_pops, leaf_pops, sort=True):
    """FP32 operations of a BVH walk's pops: the closest-hit walk sorts the
    children it pushes (``sort``), the any-hit walk does not."""
    return (node_pops * (8 * BOX_OPS + (SORT_OPS if sort else 0))
            + leaf_pops * 8 * TRI_OPS_ROWS)


def traversal_ops(counts, prefix="", sort=True):
    """FP32 operations of the pops a twin counted (``prefix`` "shadow_":
    those of its shadow walks), instance pops included."""
    return (walk_ops(counts[prefix + "node_pops"],
                     counts[prefix + "leaf_pops"], sort)
            + counts.get(prefix + "inst_pops", 0) * INST_OPS)


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the two least times."""
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def scene_setup(name, tris, **cfg_kw):
    """The CLI's procedural scene ``name`` (the bumpy sphere, or the city)
    of about ``tris`` triangles with its view and sky, cosine + RR, on the
    card, with its wide BVH built once, and its light table."""
    from sfvp_tpu_torch import RenderConfig, upload
    from sfvp_tpu_torch.accel.wide import binary_bvh, build_wide, materials_array
    from sfvp_tpu_torch.cli import procedural_scene
    from sfvp_tpu_torch.integrate.lights import build_light_table_from_buffers
    from sfvp_tpu_torch.kernels.bvh_packet import device_wide

    kw = dict(width=BVH_W, height=BVH_H, spp_per_step=BVH_SPP,
              max_depth=BVH_DEPTH, sampling="cosine", use_rr=True)
    kw.update(cfg_kw)
    scene, cfg = procedural_scene(name, tris, RenderConfig(**kw))
    buffers = upload(scene, device=DEVICE)
    t0 = time.perf_counter()
    # the binary tree is kept: the textured sphere of slice 6 collapses it
    # again with its vt rows (textured_setup)
    binary = binary_bvh(buffers)
    wide = build_wide(binary, materials_array(buffers))
    lights = build_light_table_from_buffers(buffers)
    print(f"  {name}: {buffers.num_tris} triangles "
          f"({lights.num if lights else 0} emissive), wide BVH "
          f"{wide.nodes.shape[0]} nodes + {wide.tris.shape[0]} leaf rows, "
          f"max_stack {wide.max_stack}, built in "
          f"{time.perf_counter() - t0:.2f} s")
    return dict(scene=scene, cfg=cfg, buffers=buffers, wide=wide,
                dw=device_wide(wide, DEVICE), lights=lights, binary=binary)


@contextlib.contextmanager
def spying(module, name, spy):
    """Put ``spy`` in place of ``module.name`` for the block. A wrapper
    counts its launches on the module's function, so the count carries
    over the spy and back."""
    real = getattr(module, name)
    spy.launches = getattr(real, "launches", 0)
    setattr(module, name, spy)
    try:
        yield real
    finally:
        setattr(module, name, real)
        if hasattr(real, "launches"):
            real.launches = spy.launches


def capture(module, name, calls, run, planes):
    """The (7, N) ray planes seen at the given calls (0, 1, ...) of
    ``module.name`` while ``run()`` renders one step; ``planes(args,
    result)`` picks them out of a call."""
    seen = {"n": 0}

    def spy(*args, **kw):
        out = real(*args, **kw)
        if seen["n"] in calls:
            seen[seen["n"]] = planes(args, out).clone()
        seen["n"] += 1
        return out

    with spying(module, name, spy) as real:
        run()
    return [seen[c] for c in calls]


def timed_calls(module, names, run):
    """Run ``run()`` with CUDA events recorded before and after every call
    of ``module``'s functions ``names``; returns the summed milliseconds
    of each function's calls and ``run()``'s result. An event pair holds
    the call's kernel and whatever host time the card waits on inside the
    wrapper."""
    events = {name: [] for name in names}

    def spy_of(name, real):
        def spy(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args, **kw)
            end.record()
            events[name].append((start, end))
            return out
        return spy

    with contextlib.ExitStack() as stack:
        for name in names:
            real = getattr(module, name)
            stack.enter_context(spying(module, name, spy_of(name, real)))
        out = run()
    torch.cuda.synchronize()
    return {name: sum(a.elapsed_time(b) for a, b in ev)
            for name, ev in events.items()}, out


def capture_waves(cfg, s, calls, shadow=False):
    """The (7, N) ray planes that the payload trace (K3, K6 on a streamed
    scene, or K7 for an instanced scene ``s``) or, with ``shadow``, the
    shadow trace (K4, K8, or K6 itself) receives at the given calls of one
    wavefront step of ``cfg`` (call c = bounce c of the first sample)."""
    from sfvp_tpu_torch import init_state
    from sfvp_tpu_torch.dispatch import (
        select_instanced_render_step, select_render_step, stream_tris)
    from sfvp_tpu_torch.kernels import bvh_packet, bvh_packet2, bvh_tlas

    cfg = dataclasses.replace(cfg, megakernel_regen=False)
    if "tl" in s:
        module, occlusion = bvh_tlas, "two_level_occlusion"
        step = select_instanced_render_step(cfg, s["flat"], s["tl"])
    else:
        module, occlusion = bvh_packet, "packet_occlusion"
        step = select_render_step(cfg, s["buffers"], wide=s["wide"])

    def run():
        step(init_state(cfg.height, cfg.width, DEVICE))

    if "tl" not in s and stream_tris(cfg, s["wide"]):
        # K6 traces both through its ray_planes: under NEE call 2c is
        # bounce c's payload trace and call 2c + 1 its shadow trace
        if cfg.use_nee:
            calls = tuple(2 * c + int(shadow) for c in calls)
        return capture(bvh_packet2, "ray_planes", calls, run,
                       lambda a, out: out)
    # the trace builds each call's planes with ray_planes: record those;
    # the occlusion hook passes its planes to the occlusion wrapper
    if shadow:
        return capture(module, occlusion, calls, run, lambda a, out: a[2])
    return capture(module, "ray_planes", calls, run, lambda a, out: out)


def kernel_fns(kernel):
    """The wrapper and the plain twin of a payload trace (K3, K7) or an
    occlusion kernel (K4, K8)."""
    from sfvp_tpu_torch.kernels import bvh_packet as p
    from sfvp_tpu_torch.kernels import bvh_tlas as t

    return {"K3": (p.packet_trace, p.packet_trace_plain),
            "K4": (p.packet_occlusion, p.packet_occlusion_plain),
            "K7": (t.two_level_trace, t.two_level_trace_plain),
            "K8": (t.two_level_occlusion, t.two_level_occlusion_plain)}[kernel]


def compare_trace(kernel, label, tree, t_min, rays, got=None, exp=None):
    """Hold a payload trace's planes (K3 over a wide BVH, K7 over a
    two-level one) against its twin's: at least K3_SAME_TRI of the rays on
    the same triangle (or both missing), every plane equal there. Returns
    the largest absolute difference on those rays."""
    trace, plain = kernel_fns(kernel)
    if got is None:
        got = trace(tree, t_min, rays)
    if exp is None:
        exp = plain(tree, t_min, rays)
    miss_g, miss_e = torch.isinf(got[0]), torch.isinf(exp[0])
    same = (miss_g & miss_e) | (~miss_g & ~miss_e
                                & (got[3:] == exp[3:]).all(0))
    frac = float(same.float().mean())
    hit = same & ~miss_e
    diff = (got[:, hit] - exp[:, hit]).abs()
    mx = float(diff.max()) if hit.any() else 0.0
    equal = bool((got[:, hit] == exp[:, hit]).all())
    print(f"  {kernel} {label:14s} {rays.shape[1]} rays, {int(hit.sum())} "
          f"hits, same triangle {frac:.6f}, planes equal there: {equal}, "
          f"max abs {mx:.3e}")
    check(frac >= K3_SAME_TRI and equal,
          f"{kernel} {label} disagrees with its twin: same triangle on "
          f"{frac}, planes equal {equal}")
    return mx


def bvh_twin_phase(sphere):
    from sfvp_tpu_torch import RenderConfig
    from sfvp_tpu_torch.accel.wide import build_wide_from_buffers
    from sfvp_tpu_torch.kernels.bvh_packet import device_wide, ray_planes
    from sfvp_tpu_torch.kernels.megakernel_bvh import (
        bvh_regen_render, bvh_regen_render_plain)

    phase(f"bvh twins: K3 on {BVH_TWIN_SIZE * 2}^2-ray waves, K5 at "
          f"{BVH_TWIN_SIZE}x{BVH_TWIN_SIZE}, {EARLY_TWIN_SPP} spp, depth "
          f"{BVH_DEPTH}, cosine + RR")
    cfg, dw = sphere["cfg"], sphere["dw"]
    size = 2 * BVH_TWIN_SIZE
    camera, bounce = capture_waves(dataclasses.replace(
        cfg, width=size, height=size, spp_per_step=1), sphere, (0, 1))
    g = np.random.default_rng(0)
    o = torch.tensor(g.uniform(-1.5, 1.5, (3, size * size)),
                     dtype=torch.float32, device=DEVICE)
    d = torch.tensor(g.normal(size=(3, size * size)), dtype=torch.float32,
                     device=DEVICE)
    d = d / d.norm(dim=0)
    random = ray_planes(tuple(o), tuple(d), cfg.t_max)
    worst = {"K3": max(compare_trace("K3", label, dw, cfg.t_min, rays)
                       for label, rays
                       in (("camera", camera), ("bounce", bounce),
                           ("random", random)))}
    n = BVH_TWIN_SIZE
    mirror = cornell_buffers(DEVICE, mirrors=True)
    cases = {
        "sphere": (dw, False, dataclasses.replace(
            cfg, width=n, height=n, spp_per_step=EARLY_TWIN_SPP)),
        "cornell_mirror": (
            device_wide(build_wide_from_buffers(mirror), DEVICE), True,
            RenderConfig(width=n, height=n, spp_per_step=EARLY_TWIN_SPP,
                         max_depth=BVH_DEPTH, sampling="cosine",
                         use_rr=True, traversal="bvh")),
    }
    worst["K5"] = 0.0
    for case, (w, mirrors, c) in cases.items():
        args = dict(cfg=c, global_shape=(n, n), npix=n * n,
                    has_mirrors=mirrors)
        got = bvh_regen_render(w, 3, 0, **args)
        exp = bvh_regen_render_plain(w, 3, 0, **args)
        worst["K5"] = max(worst["K5"], compare(
            f"K5 {case}", got, exp, EARLY_TWIN_SPP, K5_TWIN_REL_RMSE))
    return worst


def k5_vs_k1_phase(nee=False):
    """K5 with traversal="bvh" against K1 on the Cornell Box, parity or
    (``nee``) cosine + RR with NEE + MIS."""
    from sfvp_tpu_torch import RenderConfig
    from sfvp_tpu_torch.accel.wide import build_wide_from_buffers
    from sfvp_tpu_torch.integrate.lights import build_light_table_from_buffers
    from sfvp_tpu_torch.kernels.bvh_packet import device_wide
    from sfvp_tpu_torch.kernels.megakernel import scene_table
    from sfvp_tpu_torch.kernels.megakernel_bvh import bvh_regen_render
    from sfvp_tpu_torch.kernels.megakernel_regen import regen_render

    n, spp = K5_K1_SIZE, 8
    what = "cosine + RR, NEE + MIS" if nee else "parity"
    phase(f"K5 (traversal='bvh') against K1 on the Cornell Box at {n}x{n}, "
          f"{spp} spp, depth 8, {what}: the same streams")
    for mirrors in (False, True):
        buffers = cornell_buffers(DEVICE, mirrors)
        cfg = RenderConfig(width=n, height=n, spp_per_step=spp, max_depth=8,
                           **(NEE_FLAGS if nee else {}))
        args = dict(global_shape=(n, n), npix=n * n, has_mirrors=mirrors,
                    lights=build_light_table_from_buffers(buffers))
        k1 = regen_render(scene_table(buffers), 2, 0, cfg=cfg,
                          num_tris=buffers.num_tris, **args)
        k5 = bvh_regen_render(
            device_wide(build_wide_from_buffers(buffers), DEVICE), 2, 0,
            cfg=dataclasses.replace(cfg, traversal="bvh"), **args)
        compare("K5 vs K1" + (" nee" if nee else "")
                + (" mirror" if mirrors else ""), k5, k1, spp, K5_K1_REL_RMSE)


def counters():
    from sfvp_tpu_torch.kernels.bvh_packet import packet_occlusion, packet_trace
    from sfvp_tpu_torch.kernels.bvh_packet2 import packet_trace2
    from sfvp_tpu_torch.kernels.bvh_tlas import (
        two_level_occlusion, two_level_trace)
    from sfvp_tpu_torch.kernels.envfetch import env_fetch, env_fetch_ablate
    from sfvp_tpu_torch.kernels.itercost import iter_cost
    from sfvp_tpu_torch.kernels.leafprobe import leaf_probe, smem_dma
    from sfvp_tpu_torch.kernels.megakernel import wave_render
    from sfvp_tpu_torch.kernels.megakernel_bvh import (
        bvh_regen_render, tlas_regen_render)
    from sfvp_tpu_torch.kernels.megakernel_regen import regen_render
    from sfvp_tpu_torch.kernels.stripped_trace import stripped_trace

    return {"K1": regen_render, "K2": wave_render, "K3": packet_trace,
            "K4": packet_occlusion, "K5": bvh_regen_render,
            "K6": packet_trace2, "K7": two_level_trace,
            "K8": two_level_occlusion,
            "K9": tlas_regen_render, "P3": env_fetch, "P4": env_fetch_ablate,
            "P2": leaf_probe, "P5": smem_dma, "P1": stripped_trace,
            "P6": iter_cost}


def only(**launched):
    """The launch counts of a run in which only the named kernels ran."""
    return {k: launched.get(k, 0) for k in counters()}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def check_image(name, img, h, w):
    img = np.asarray(img, np.float32)
    check(img.shape[:2] == (h, w), f"{name} image {img.shape}")
    check(np.isfinite(img).all(), f"{name} image has non-finite values")
    check(img.max() > 0, f"{name} image is all zero")
    sat = float((img >= 1.0).all(-1).mean())
    check(sat < 0.5, f"{name} image saturated ({sat:.1%} white)")
    print(f"  {name} image mean {img.mean():.4f}, {sat:.2%} white")


def print_steps(recs):
    for rec in recs:
        print(f"  step {rec['step']}: step_s {rec['step_s']}, "
              f"{rec['mrays_per_s']} Mrays/s, avg path {rec['avg_path_len']}")


def run_cli(tmp, name, argv):
    """Run the CLI as a user would; returns its set-up seconds (the
    wide-BVH build it reports), its JSONL records and its PNG."""
    import io
    import re

    from sfvp_tpu_torch import cli

    out, log = os.path.join(tmp, f"{name}.png"), os.path.join(tmp,
                                                              f"{name}.jsonl")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--device", DEVICE, *argv, "--out", out, "--log", log])
    text = buf.getvalue()
    check(rc == 0, f"cli returned {rc}")
    m = re.search(r"set-up: (.*) built in ([0-9.]+) s", text)
    check(m is not None, f"no set-up line in the cli's output:\n{text}")
    print(f"  set-up: {m.group(1)} in {m.group(2)} s")
    recs = [json.loads(x) for x in open(log).read().splitlines()]
    return float(m.group(2)), recs, _read_png(out)


def bvh_main_path_phase(tmp):
    from sfvp_tpu_torch import Renderer
    from sfvp_tpu_torch.cli import procedural_scene

    phase(f"bvh main path: cli --scene sphere --scene-tris {SPHERE_TRIS} at "
          f"{BVH_W}x{BVH_H}, {BVH_SPP} spp, depth {BVH_DEPTH}, cosine + RR, "
          f"{BVH_STEPS} steps (K5); Renderer with megakernel_regen=False, "
          f"{K3_STEPS} step (K3); {BIG_TRIS} triangles at {BIG_W}x{BIG_H}, "
          f"{BIG_STEPS} steps (K5)")
    common = ["--scene", "sphere", "--sampling", "cosine", "--rr",
              "--spp", str(BVH_SPP), "--max-depth", str(BVH_DEPTH)]
    runs = {}

    reset_counts()
    setup, recs, img = run_cli(tmp, "sphere", [
        *common, "--scene-tris", str(SPHERE_TRIS), "--width", str(BVH_W),
        "--height", str(BVH_H), "--steps", str(BVH_STEPS)])
    runs["cli_100k"] = read_counts()
    print(f"  launches: {runs['cli_100k']}")
    check(runs["cli_100k"] == only(K5=BVH_STEPS),
          f"cli sphere launches {runs['cli_100k']}")
    check(len(recs) == BVH_STEPS, f"{len(recs)} log records")
    print_steps(recs)
    check_image("K5 sphere", img, BVH_H, BVH_W)

    from sfvp_tpu_torch import RenderConfig

    scene, cfg = procedural_scene("sphere", SPHERE_TRIS, RenderConfig(
        width=BVH_W, height=BVH_H, spp_per_step=BVH_SPP,
        max_depth=BVH_DEPTH, sampling="cosine", use_rr=True,
        megakernel_regen=False))
    log = os.path.join(tmp, "k3.jsonl")
    reset_counts()
    r = Renderer(cfg, scene, DEVICE)
    img = r.run(K3_STEPS, log_path=log, progress=False)
    runs["renderer_k3"] = read_counts()
    per_step = BVH_SPP * BVH_DEPTH
    print(f"  launches: {runs['renderer_k3']}; set-up: wide BVH built in "
          f"{r.bvh_build_s:.2f} s")
    check(runs["renderer_k3"] == only(K3=K3_STEPS * per_step),
          f"wavefront launches {runs['renderer_k3']}")
    print_steps([json.loads(x) for x in open(log).read().splitlines()])
    check_image("K3 wavefront sphere", img, BVH_H, BVH_W)

    reset_counts()
    big_setup, recs, img = run_cli(tmp, "sphere_big", [
        *common, "--scene-tris", str(BIG_TRIS), "--width", str(BIG_W),
        "--height", str(BIG_H), "--steps", str(BIG_STEPS)])
    runs["cli_500k"] = read_counts()
    print(f"  launches: {runs['cli_500k']}")
    check(runs["cli_500k"] == only(K5=BIG_STEPS),
          f"cli 500k sphere launches {runs['cli_500k']}")
    print_steps(recs)
    check_image("K5 500k sphere", img, BIG_H, BIG_W)
    return runs


def bvh_timing_phase(sphere):
    from sfvp_tpu_torch.kernels.bvh_packet import packet_trace, packet_trace_plain
    from sfvp_tpu_torch.kernels.megakernel_bvh import (
        bvh_regen_render, bvh_regen_render_plain)

    phase(f"bvh times and twin check at the main path's shape ({BVH_W}x"
          f"{BVH_H}, {BVH_SPP} spp, depth {BVH_DEPTH}, cosine + RR), CUDA "
          "events")
    cfg, dw, wide = sphere["cfg"], sphere["dw"], sphere["wide"]
    npix = BVH_W * BVH_H
    tree_bytes = tree_nbytes(wide)
    args = dict(cfg=cfg, global_shape=(BVH_H, BVH_W), npix=npix,
                has_mirrors=False)
    ms, got = cuda_ms(lambda: bvh_regen_render(dw, 1, 0, **args), 5)
    counts = {}
    plain, exp = cuda_ms(lambda: bvh_regen_render_plain(
        dw, 1, 0, counts=counts, **args), 1, warm=False)
    print(f"  K5: kernel {ms:.3f} ms/step, plain twin {plain:.1f} ms/step; "
          f"twin pops {counts}")
    worst = {"K5": compare("K5 main", got, exp, BVH_SPP, K5_TWIN_REL_RMSE)}
    segs = int(exp[3].sum(dtype=torch.int64))
    times = {"K5": (ms, plain) + bound(
        traversal_ops(counts) + segs * SHADE_OPS, tree_bytes + npix * 16)}
    print(f"  K5: {segs} segments, bound {times['K5'][2]:.3f} ms "
          f"({times['K5'][3]})")

    first, later = capture_waves(dataclasses.replace(cfg, spp_per_step=1),
                                 sphere, (0, 2))
    worst["K3"] = 0.0
    for label, rays in (("first bounce", first), ("third bounce", later)):
        ms, got = cuda_ms(lambda: packet_trace(dw, cfg.t_min, rays), 20)
        counts = {}
        plain, exp = cuda_ms(lambda: packet_trace_plain(
            dw, cfg.t_min, rays, counts), 1, warm=False)
        active = int((rays[6] > cfg.t_min).sum())
        worst["K3"] = max(worst["K3"], compare_trace(
            "K3", label, dw, cfg.t_min, rays, got=got, exp=exp))
        b = bound(traversal_ops(counts),
                  tree_bytes + rays.shape[1] * (7 + 19) * 4)
        print(f"  K3 {label}: {active} active rays, kernel {ms:.3f} "
              f"ms/launch, plain twin {plain:.1f} ms; pops {counts}; bound "
              f"{b[0]:.3f} ms ({b[1]})")
        times.setdefault("K3", (ms, plain) + b)
    return times, worst


def big_sphere_phase(sphere):
    """K5 on the 500k sphere's tree (the native SAH since slice 7, as
    sfvp_tpu's builder="auto" with its library; LBVH before) at the size
    the main path renders it, held against its twin; and K5 per pixel and
    per segment on the 500k and the 100k trees at that size, beside each
    tree's pops per segment. The tree's set-up seconds, and checks that it
    stays past the streaming threshold (so the wavefront loop traces it
    through K6) within K6's packet stack. Returns K5's largest absolute
    difference on the 500k tree, and the 500k sphere's set-up
    (scene_setup), which slice 5's phases trace through K6."""
    from sfvp_tpu_torch import native
    from sfvp_tpu_torch.dispatch import STREAM_SCENE_BYTES, stream_tris
    from sfvp_tpu_torch.kernels import build
    from sfvp_tpu_torch.kernels.bvh_packet2 import LEAF_Q
    from sfvp_tpu_torch.kernels.megakernel_bvh import (
        bvh_regen_render, bvh_regen_render_plain)

    n, spp = BIG_TWIN_SIZE, EARLY_TWIN_SPP
    phase(f"bvh 500k: K5 on the {BIG_TRIS}-triangle sphere and the 100k "
          f"sphere at {BIG_W}x{BIG_H}, {BVH_SPP} spp, depth {BVH_DEPTH}, "
          f"cosine + RR, CUDA events; each vs its twin at {n}x{n}, {spp} "
          "spp")
    check(native.sah_available(), "the native SAH builder did not build")
    big = scene_setup("sphere", BIG_TRIS, width=BIG_W, height=BIG_H)
    wide = big["wide"]
    nbytes = wide.nodes.nbytes + wide.tris.nbytes
    print(f"  500k tree: native SAH, {nbytes} bytes (streamed past "
          f"{STREAM_SCENE_BYTES}), max_stack {wide.max_stack} + leaf_q "
          f"{LEAF_Q} of K6's {build.MAX_PACKET_STACK}")
    check(stream_tris(big["cfg"], wide), "the 500k sphere no longer streams")
    check(wide.max_stack + LEAF_Q <= build.MAX_PACKET_STACK,
          f"max_stack {wide.max_stack} past K6's packet stack")
    worst = 0.0
    for name, s in (("500k", big), ("100k", sphere)):
        dw = s["dw"]
        for w, k in ((BIG_W, BVH_SPP), (n, spp)):
            args = dict(cfg=dataclasses.replace(s["cfg"], width=w, height=w,
                                                spp_per_step=k),
                        global_shape=(w, w), npix=w * w, has_mirrors=False)
            ms, got = cuda_ms(lambda: bvh_regen_render(dw, 1, 0, **args), 10)
            if w == BIG_W:
                print(f"  K5 {name} tree: {ms:.3f} ms/step at {w}x{w} "
                      f"({ms * 1e6 / (w * w):.2f} ns/pixel)")
        counts = {}
        plain, exp = cuda_ms(lambda: bvh_regen_render_plain(
            dw, 1, 0, counts=counts, **args), 1, warm=False)
        mx = compare(f"K5 {name}", got, exp, spp, K5_TWIN_REL_RMSE)
        worst = mx if name == "500k" else worst
        segs = int(exp[3].sum(dtype=torch.int64))
        print(f"  K5 {name} tree at {n}x{n}, {spp} spp: {ms:.3f} ms/step "
              f"({ms * 1e6 / segs:.3f} ns/segment), twin {plain:.1f} ms; "
              f"{segs} segments, {counts['node_pops'] / segs:.3f} node and "
              f"{counts['leaf_pops'] / segs:.3f} leaf pops per segment")
    return worst, big


def sort_phase(sphere):
    """The wavefront step over K3 at the main path's shape with the
    per-bounce ray sort on and off (sort_bounce_rays), in alternating
    rounds: CUDA-event times per step, and the same image either way."""
    from sfvp_tpu_torch import init_state
    from sfvp_tpu_torch.dispatch import select_render_step

    phase(f"ray sort: the wavefront step over K3 at {BVH_W}x{BVH_H}, "
          f"{BVH_SPP} spp, with sort_bounce_rays on and off, "
          f"{SORT_ROUNDS} rounds of {SORT_STEPS} steps, CUDA events")
    steps, images, ms = {}, {}, {True: [], False: []}
    for sort in (True, False):
        cfg = dataclasses.replace(sphere["cfg"], megakernel_regen=False,
                                  sort_bounce_rays=sort)
        steps[sort] = select_render_step(cfg, sphere["buffers"],
                                         wide=sphere["wide"])
        images[sort] = steps[sort](init_state(BVH_H, BVH_W, DEVICE)).accum
    check(torch.equal(images[True], images[False]),
          "the ray sort changed the image")
    for _ in range(SORT_ROUNDS):
        for sort in (True, False):
            st = init_state(BVH_H, BVH_W, DEVICE)
            step = steps[sort]
            ms[sort].append(cuda_ms(lambda: step(st), SORT_STEPS,
                                    warm=False)[0])
    for sort in (True, False):
        print(f"  sort_bounce_rays={sort}: "
              f"{', '.join(f'{t:.3f}' for t in ms[sort])} ms/step")
    print("  images equal with the sort on and off: True")
    return ms


def compare_occlusion(kernel, label, tree, t_min, rays, got=None,
                      exp=None):
    """Hold an occlusion kernel's answers (K4, K8) against its twin's:
    equal on every ray."""
    occluded, plain = kernel_fns(kernel)
    if got is None:
        got = occluded(tree, t_min, rays)
    if exp is None:
        exp = plain(tree, t_min, rays)
    same = float((got == exp).float().mean())
    print(f"  {kernel} {label:14s} {rays.shape[1]} rays, "
          f"{int((rays[6] > t_min).sum())} with a window, "
          f"{int(exp.sum())} occluded; equal on {same:.6f} of rays")
    check(same == 1.0, f"{kernel} {label} disagrees with its twin on "
                       f"{1.0 - same} of rays")
    return float((got.float() - exp.float()).abs().max())


def nearest_first_pops(dt, t_min, rays):
    """The answers and pops of the two-level any-hit walk with each node's
    children pushed nearest first (the closest hit's order) in place of
    slot order: K8's twin's walk with the ordered child network. The
    answer of an any-hit walk does not depend on its order; its pops do."""
    from sfvp_tpu_torch.kernels import bvh_tlas
    from sfvp_tpu_torch.kernels.bvh_packet import _leaf_tests, _node_children
    from sfvp_tpu_torch.utils.vec import f32

    t_min = f32(t_min)
    n = rays.shape[1]
    inf = torch.full((n,), float("inf"), device=rays.device)
    occ = torch.zeros(n, dtype=torch.bool, device=rays.device)
    counts = {}

    def leaf(li, lrow, ray, ctx):
        hit = li[torch.isfinite(_leaf_tests(dt.tris, lrow, ray, inf[li])[1])]
        occ[hit] = True
        return hit

    def node(ni, node_row, ray):
        return _node_children(dt.nodes, node_row, ray, inf[ni], t_min)

    bvh_tlas._walk(dt, t_min, rays, counts, leaf, node)
    return occ, counts


def nee_twin_phase(city):
    from sfvp_tpu_torch import RenderConfig
    from sfvp_tpu_torch.accel.wide import build_wide_from_buffers
    from sfvp_tpu_torch.integrate.lights import build_light_table_from_buffers
    from sfvp_tpu_torch.kernels.bvh_packet import device_wide, ray_planes
    from sfvp_tpu_torch.kernels.megakernel import scene_table
    from sfvp_tpu_torch.kernels.megakernel_bvh import (
        bvh_regen_render, bvh_regen_render_plain)
    from sfvp_tpu_torch.kernels.megakernel_regen import (
        regen_render, regen_render_plain)

    n, spp = NEE_TWIN_SIZE, NEE_TWIN_SPP
    phase(f"nee twins: K1 at {n}x{n}, {spp} spp, K5 at {BVH_TWIN_SIZE}x"
          f"{BVH_TWIN_SIZE}, {EARLY_TWIN_SPP} spp, depth 8, cosine + RR, NEE "
          f"and NEE + MIS; K4 on {2 * BVH_TWIN_SIZE}^2-ray shadow waves")
    worst = {"K1": 0.0, "K4": 0.0, "K5": 0.0}
    for mirrors in (False, True):
        buffers = cornell_buffers(DEVICE, mirrors)
        table = scene_table(buffers)
        lights = build_light_table_from_buffers(buffers)
        for mis in (False, True):
            cfg = RenderConfig(width=n, height=n, spp_per_step=spp,
                               max_depth=8, **dict(NEE_FLAGS, use_mis=mis))
            args = dict(cfg=cfg, num_tris=buffers.num_tris,
                        global_shape=(n, n), npix=n * n, has_mirrors=mirrors,
                        lights=lights)
            got = regen_render(table, 3, 0, **args)
            exp = regen_render_plain(table, 3, 0, **args)
            label = ("K1 nee" + ("+mis" if mis else "")
                     + (" mirror" if mirrors else ""))
            worst["K1"] = max(worst["K1"], compare(label, got, exp, spp))

    n = BVH_TWIN_SIZE
    cornell = cornell_buffers(DEVICE)
    cases = {
        "city": (city["dw"], city["lights"], dataclasses.replace(
            city["cfg"], width=n, height=n, spp_per_step=EARLY_TWIN_SPP)),
        "cornell": (
            device_wide(build_wide_from_buffers(cornell), DEVICE),
            build_light_table_from_buffers(cornell),
            RenderConfig(width=n, height=n, spp_per_step=EARLY_TWIN_SPP,
                         max_depth=BVH_DEPTH, traversal="bvh", **NEE_FLAGS)),
    }
    for case, (dw, lights, cfg) in cases.items():
        args = dict(cfg=cfg, global_shape=(n, n), npix=n * n,
                    has_mirrors=False, lights=lights)
        got = bvh_regen_render(dw, 3, 0, **args)
        exp = bvh_regen_render_plain(dw, 3, 0, **args)
        worst["K5"] = max(worst["K5"], compare(
            f"K5 nee {case}", got, exp, EARLY_TWIN_SPP, K5_TWIN_REL_RMSE))

    cfg, dw = city["cfg"], city["dw"]
    size = 2 * BVH_TWIN_SIZE
    first, second = capture_waves(dataclasses.replace(
        cfg, width=size, height=size, spp_per_step=1), city, (0, 1),
        shadow=True)
    g = np.random.default_rng(0)
    m = size * size
    o = torch.tensor(g.uniform(-10.0, 10.0, (3, m)), dtype=torch.float32,
                     device=DEVICE)
    o[1] = o[1].abs() * 0.4
    d = torch.tensor(g.normal(size=(3, m)), dtype=torch.float32,
                     device=DEVICE)
    d = d / d.norm(dim=0)
    tmax = torch.tensor(g.uniform(0.0, 25.0, m), dtype=torch.float32,
                        device=DEVICE)
    active = torch.tensor(g.uniform(size=m) > 0.1, device=DEVICE)
    random = ray_planes(tuple(o), tuple(d), tmax, active)
    worst["K4"] = max(compare_occlusion("K4", label, dw, cfg.t_min, rays)
                      for label, rays in (("first bounce", first),
                                          ("second bounce", second),
                                          ("random", random)))
    return worst


def nee_oracle_phase():
    """K1 with NEE + MIS against the numpy oracle of the reference's own
    estimator: the same expectation, less noise than K1 cosine alone."""
    from sfvp_tpu_torch import RenderConfig, init_state
    from sfvp_tpu_torch.kernels.megakernel_regen import make_regen_render_step

    phase("nee oracle: K1 cosine with and without NEE + MIS at 128x128, "
          "32 spp x 32 steps vs the numpy oracle")
    with np.load(os.path.join(ROOT, "tests", "golden",
                              "oracle_128_1024spp.npz")) as z:
        ref = torch.from_numpy(z["accum"]).to(DEVICE)
        frames, spp = int(z["frames"]), int(z["spp"])
    buffers = cornell_buffers(DEVICE)
    res = {}
    for name, kw in (("cosine", {}),
                     ("cosine+nee+mis", dict(use_nee=True, use_mis=True))):
        cfg = RenderConfig(width=128, height=128, spp_per_step=spp,
                           max_depth=8, sampling="cosine", **kw)
        step = make_regen_render_step(cfg, buffers)
        st = init_state(128, 128, DEVICE)
        for _ in range(frames):
            st = step(st)
        mean = float(st.accum.mean())
        res[name] = (rel_rmse(st.accum, ref),
                     abs(mean - float(ref.mean())) / float(ref.mean()))
        print(f"  K1 {name:15s} mean {mean:.5f} (oracle "
              f"{float(ref.mean()):.5f}, rel diff {res[name][1]:.3e}); "
              f"relative RMSE vs oracle {res[name][0]:.3e}")
    rel, mean_rel = res["cosine+nee+mis"]
    check(mean_rel < NEE_ORACLE_MEAN,
          f"K1 NEE + MIS mean {mean_rel} off the oracle's")
    check(rel < res["cosine"][0],
          f"K1 NEE + MIS relative RMSE {rel} not below cosine's "
          f"{res['cosine'][0]}")


def nee_main_path_phase(tmp):
    from sfvp_tpu_torch import Renderer, cli
    from sfvp_tpu_torch.cli import procedural_scene

    phase(f"nee main path: cli {' '.join(NEE_CLI)} on the Cornell Box at "
          f"{MAIN_W}x{MAIN_H}, {MAIN_SPP} spp, {MAIN_STEPS} steps (K1); on "
          f"the city ({CITY_TRIS} triangles) at {BVH_W}x{BVH_H}, {BVH_SPP} "
          f"spp, {CITY_STEPS} steps (K5); Renderer with "
          f"megakernel_regen=False, 1 step (K3 + K4)")
    runs = {}
    out = os.path.join(tmp, "cornell_nee.png")
    log = os.path.join(tmp, "cornell_nee.jsonl")
    reset_counts()
    rc = cli.main(["--device", DEVICE, "--width", str(MAIN_W), "--height",
                   str(MAIN_H), "--spp", str(MAIN_SPP), "--max-depth",
                   str(MAIN_DEPTH), "--steps", str(MAIN_STEPS), *NEE_CLI,
                   "--out", out, "--log", log, "--quiet"])
    runs["cli_cornell"] = read_counts()
    print(f"  launches: {runs['cli_cornell']}")
    check(rc == 0, f"cli returned {rc}")
    check(runs["cli_cornell"] == only(K1=MAIN_STEPS),
          f"cli Cornell NEE launches {runs['cli_cornell']}")
    recs = [json.loads(x) for x in open(log).read().splitlines()]
    check(len(recs) == MAIN_STEPS, f"{len(recs)} log records")
    print_steps(recs)
    check_image("K1 nee", _read_png(out), MAIN_H, MAIN_W)

    reset_counts()
    setup, recs, img = run_cli(tmp, "city", [
        "--scene", "city", "--scene-tris", str(CITY_TRIS), *NEE_CLI,
        "--width", str(BVH_W), "--height", str(BVH_H), "--spp",
        str(BVH_SPP), "--max-depth", str(BVH_DEPTH), "--steps",
        str(CITY_STEPS)])
    runs["cli_city"] = read_counts()
    print(f"  launches: {runs['cli_city']}")
    check(runs["cli_city"] == only(K5=CITY_STEPS),
          f"cli city launches {runs['cli_city']}")
    check(len(recs) == CITY_STEPS, f"{len(recs)} log records")
    print_steps(recs)
    check_image("K5 nee city", img, BVH_H, BVH_W)

    from sfvp_tpu_torch import RenderConfig

    scene, cfg = procedural_scene("city", CITY_TRIS, RenderConfig(
        width=BVH_W, height=BVH_H, spp_per_step=BVH_SPP,
        max_depth=BVH_DEPTH, megakernel_regen=False, **NEE_FLAGS))
    log = os.path.join(tmp, "k3k4.jsonl")
    reset_counts()
    r = Renderer(cfg, scene, DEVICE)
    img = r.run(1, log_path=log, progress=False)
    runs["renderer_k3k4"] = read_counts()
    per_step = BVH_SPP * BVH_DEPTH
    print(f"  launches: {runs['renderer_k3k4']}; set-up: wide BVH built in "
          f"{r.bvh_build_s:.2f} s")
    check(runs["renderer_k3k4"] == only(K3=per_step, K4=per_step),
          f"wavefront NEE launches {runs['renderer_k3k4']}")
    print_steps([json.loads(x) for x in open(log).read().splitlines()])
    check_image("K3 + K4 wavefront city", img, BVH_H, BVH_W)
    return runs


def nee_timing_phase(city):
    from sfvp_tpu_torch import RenderConfig
    from sfvp_tpu_torch.integrate.lights import build_light_table_from_buffers
    from sfvp_tpu_torch.kernels.bvh_packet import (
        packet_occlusion, packet_occlusion_plain)
    from sfvp_tpu_torch.kernels.megakernel import scene_table
    from sfvp_tpu_torch.kernels.megakernel_bvh import (
        bvh_regen_render, bvh_regen_render_plain)
    from sfvp_tpu_torch.kernels.megakernel_regen import (
        regen_render, regen_render_plain)

    phase(f"nee times and twin check at the main paths' shapes (Cornell "
          f"{MAIN_W}x{MAIN_H}, {MAIN_SPP} spp; city {BVH_W}x{BVH_H}, "
          f"{BVH_SPP} spp; depth 8, cosine + RR + NEE + MIS), CUDA events")
    times, worst = {}, {}

    buffers = cornell_buffers(DEVICE)
    table = scene_table(buffers)
    lights = build_light_table_from_buffers(buffers)
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, spp_per_step=MAIN_SPP,
                       max_depth=MAIN_DEPTH, **NEE_FLAGS)
    args = dict(cfg=cfg, num_tris=buffers.num_tris,
                global_shape=(MAIN_H, MAIN_W), npix=MAIN_W * MAIN_H,
                has_mirrors=False, lights=lights)
    ms, got = cuda_ms(lambda: regen_render(table, 1, 0, **args), 10)
    counts = {}
    plain, exp = cuda_ms(lambda: regen_render_plain(
        table, 1, 0, counts=counts, **args), 1, warm=False)
    print(f"  K1 nee: kernel {ms:.3f} ms/step, plain twin {plain:.1f} "
          f"ms/step; {counts}")
    worst["K1"] = compare("K1 nee main", got, exp, MAIN_SPP)
    segs = int(exp[3].sum(dtype=torch.int64))
    # every segment tests all triangles, every shadow ray until its first
    # hit; bytes: the table and the light table once, the outputs once
    ops = (segs * (buffers.num_tris * TRI_OPS_TABLE + SHADE_OPS)
           + counts["shadow_tests"] * TRI_OPS_TABLE
           + counts["shadow_rays"] * NEE_OPS)
    nbytes = (table.numel() + lights.rows.numel()) * 4 + MAIN_W * MAIN_H * 16
    times["K1"] = (ms, plain) + bound(ops, nbytes)
    print(f"  K1 nee: {segs} segments, bound {times['K1'][2]:.3f} ms "
          f"({times['K1'][3]})")

    cfg, dw, wide = city["cfg"], city["dw"], city["wide"]
    npix = BVH_W * BVH_H
    args = dict(cfg=cfg, global_shape=(BVH_H, BVH_W), npix=npix,
                has_mirrors=False, lights=city["lights"])
    ms, got = cuda_ms(lambda: bvh_regen_render(dw, 1, 0, **args), 5)
    counts = {}
    plain, exp = cuda_ms(lambda: bvh_regen_render_plain(
        dw, 1, 0, counts=counts, **args), 1, warm=False)
    print(f"  K5 nee city: kernel {ms:.3f} ms/step, plain twin {plain:.1f} "
          f"ms/step; twin pops {counts}")
    worst["K5"] = compare("K5 nee city", got, exp, BVH_SPP, K5_TWIN_REL_RMSE)
    segs = int(exp[3].sum(dtype=torch.int64))
    ops = (traversal_ops(counts) + segs * SHADE_OPS
           + walk_ops(counts["shadow_node_pops"], counts["shadow_leaf_pops"],
                      sort=False)
           + counts["shadow_rays"] * NEE_OPS)
    nbytes = (tree_nbytes(wide) + city["lights"].rows.numel() * 4
              + npix * 16)
    times["K5"] = (ms, plain) + bound(ops, nbytes)
    print(f"  K5 nee city: {segs} segments, bound {times['K5'][2]:.3f} ms "
          f"({times['K5'][3]})")

    rays = capture_waves(dataclasses.replace(cfg, spp_per_step=1), city,
                         (0,), shadow=True)[0]
    ms, got = cuda_ms(lambda: packet_occlusion(dw, cfg.t_min, rays), 20)
    counts = {}
    plain, exp = cuda_ms(lambda: packet_occlusion_plain(
        dw, cfg.t_min, rays, counts), 1, warm=False)
    worst["K4"] = compare_occlusion("K4", "first bounce", dw, cfg.t_min,
                                    rays, got=got, exp=exp)
    b = bound(walk_ops(counts["node_pops"], counts["leaf_pops"], sort=False),
              tree_nbytes(wide) + rays.shape[1] * (7 * 4 + 1))
    times["K4"] = (ms, plain) + b
    print(f"  K4 first bounce: kernel {ms:.3f} ms/launch, plain twin "
          f"{plain:.1f} ms; pops {counts}; bound {b[0]:.3f} ms ({b[1]})")
    return times, worst


def lamp_scene():
    """The lit field's lamp, tests/test_tlas.py:131-143: two triangles at
    y = 4 of emission 9."""
    from sfvp_tpu_torch.scene.objload import Scene

    return Scene(
        vertices=np.asarray([
            [-1.2, 4.0, -1.2], [1.2, 4.0, -1.2], [1.2, 4.0, 1.2],
            [-1.2, 4.0, -1.2], [1.2, 4.0, 1.2], [-1.2, 4.0, 1.2],
        ], np.float32),
        indices=np.arange(6, dtype=np.uint32),
        face_diffuse=np.zeros((2, 3), np.float32),
        face_emission=np.full((2, 3), 9.0, np.float32))


def field_setup():
    """The instanced field of ``--scene instanced --scene-tris
    FIELD_TRIS`` with the CLI's view and sky, cosine, and the lit field
    (the same instances and the lamp, LIT_FLAGS): each with its flattened
    buffers (materials, light table) and its two-level BVH on the card."""
    from sfvp_tpu_torch import RenderConfig
    from sfvp_tpu_torch.accel.instances import Instance
    from sfvp_tpu_torch.cli import procedural_scene

    insts, cfg = procedural_scene("instanced", FIELD_TRIS, RenderConfig(
        width=BVH_W, height=BVH_H, spp_per_step=BVH_SPP, max_depth=BVH_DEPTH,
        sampling="cosine"))
    return [two_level_setup("field", insts, cfg),
            two_level_setup("lit field", insts + [Instance(scene=lamp_scene())],
                            dataclasses.replace(cfg, **LIT_FLAGS))]


def two_level_setup(name, insts, cfg):
    """An instanced scene on the card: its flattened buffers, light table
    and two-level BVH."""
    from sfvp_tpu_torch import upload
    from sfvp_tpu_torch.accel.instances import flatten_instances
    from sfvp_tpu_torch.accel.tlas import build_two_level
    from sfvp_tpu_torch.integrate.lights import build_light_table_from_buffers
    from sfvp_tpu_torch.kernels.bvh_tlas import device_two_level

    t0 = time.perf_counter()
    tl = build_two_level(insts)
    secs = time.perf_counter() - t0
    flat = upload(flatten_instances(insts), device=DEVICE)
    lights = build_light_table_from_buffers(flat)
    print(f"  {name}: {len(insts)} instances, {flat.num_tris} triangles "
          f"flattened ({lights.num if lights else 0} emissive), "
          f"two-level BVH {tl.nodes.shape[0]} nodes + {tl.tris.shape[0]} "
          f"leaf + {tl.inst.shape[0]} instance rows, max_stack "
          f"{tl.max_stack}, built in {secs:.3f} s")
    return dict(insts=insts, cfg=cfg, tl=tl, flat=flat, lights=lights,
                dt=device_two_level(tl, DEVICE))


def stress_instances(insts, lamp, n, seed):
    """The stress field's instances: the ground of the field ``insts``,
    ``n`` small instances of its two ball meshes in turn, randomly turned
    and scaled 0.15-0.6 and packed into a 3 x 2.3 x 3 box over the
    ground, so that their boxes overlap, and the lamp. Walks there enter
    one instance's BLAS after another at every depth of the stack, with
    world entries above and below where each BLAS root was pushed."""
    from sfvp_tpu_torch.accel.instances import Instance

    balls = [insts[1].scene, insts[2].scene]
    g = np.random.default_rng(seed)
    out = [insts[0]]
    for i in range(n):
        a, b = g.uniform(0.0, 2.0 * np.pi), g.uniform(-0.7, 0.7)
        ry = np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                         [-np.sin(a), 0, np.cos(a)]])
        rx = np.asarray([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                         [0, np.sin(b), np.cos(b)]])
        rot = ry @ rx * g.uniform(0.15, 0.6)
        tr = g.uniform((-1.5, 0.2, -1.5), (1.5, 2.5, 1.5))
        out.append(Instance(scene=balls[i % 2], transform=np.hstack(
            [rot, tr[:, None]]).astype(np.float32)))
    return out + [Instance(scene=lamp)]


def stress_setup(field):
    """Phase 17's stress field: stress_instances over the field's meshes,
    under the lit field's estimator."""
    return two_level_setup(
        "stress field", stress_instances(field["insts"], lamp_scene(),
                                         STRESS_INST, STRESS_SEED),
        dataclasses.replace(field["cfg"], **LIT_FLAGS))


def two_level_nbytes(tl):
    """Distinct bytes of a two-level tree: the 64 used lanes of a node row,
    the 128 of a leaf row, the 25 of an instance row."""
    return (tl.nodes.shape[0] * 64 + tl.tris.shape[0] * 128
            + tl.inst.shape[0] * 25) * 4


def random_rays(m, seed, shadow=False, idle=0.1):
    """(7, m) planes of random rays over the field (origins above the
    ground); with ``shadow``, random windows and a share ``idle`` of
    inactive rays."""
    from sfvp_tpu_torch.kernels.bvh_packet import ray_planes

    g = np.random.default_rng(seed)
    o = torch.tensor(g.uniform(-8.0, 8.0, (3, m)), dtype=torch.float32,
                     device=DEVICE)
    o[1] = o[1].abs() * 0.5 + 0.1
    d = torch.tensor(g.normal(size=(3, m)), dtype=torch.float32,
                     device=DEVICE)
    d = d / d.norm(dim=0)
    if not shadow:
        return ray_planes(tuple(o), tuple(d), 1e4)
    tmax = torch.tensor(g.uniform(0.0, 12.0, m), dtype=torch.float32,
                        device=DEVICE)
    active = torch.tensor(g.uniform(size=m) > idle, device=DEVICE)
    return ray_planes(tuple(o), tuple(d), tmax, active)


def stress_rays(m, seed):
    """(7, m) planes of rays from the box [-6, 6] x [0.1, 6] x [-6, 6]
    toward random points of the stress field's cluster of instances."""
    from sfvp_tpu_torch.kernels.bvh_packet import ray_planes

    g = np.random.default_rng(seed)
    o = g.uniform((-6.0, 0.1, -6.0), (6.0, 6.0, 6.0), (m, 3))
    d = g.uniform((-1.5, 0.2, -1.5), (1.5, 2.5, 1.5), (m, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return ray_planes(*(tuple(torch.tensor(a.T, dtype=torch.float32,
                                           device=DEVICE)) for a in (o, d)),
                      1e4)


def tlas_twin_phase(field, lit):
    from sfvp_tpu_torch.kernels.megakernel_bvh import (
        bvh_regen_render_plain, tlas_regen_render)

    size, n = 2 * BVH_TWIN_SIZE, BVH_TWIN_SIZE
    phase(f"tlas twins: K7 on {size}^2-ray waves of the {FIELD_TRIS // 1000}k "
          f"instanced field and the stress field, K8 on the lit field's "
          f"shadow waves, K9 at {n}x{n}, {EARLY_TWIN_SPP} spp, depth "
          f"{BVH_DEPTH}: cosine, and cosine + RR + NEE + MIS on the lit and "
          "the stress field")
    stress = stress_setup(field)
    wave = dict(width=size, height=size, spp_per_step=1)
    t_min = field["cfg"].t_min
    worst = {"K7": 0.0}
    for name, s, rand in (
            ("", field, lambda: random_rays(size * size, 0)),
            ("stress ", stress, lambda: stress_rays(size * size, 2))):
        camera, bounce = capture_waves(dataclasses.replace(s["cfg"], **wave),
                                       s, (0, 1))
        worst["K7"] = max([worst["K7"]] + [
            compare_trace("K7", name + label, s["dt"], t_min, rays)
            for label, rays in (("camera", camera), ("bounce", bounce),
                                ("random", rand()))])
    first, second = capture_waves(dataclasses.replace(lit["cfg"], **wave),
                                  lit, (0, 1), shadow=True)
    stress_first = capture_waves(dataclasses.replace(stress["cfg"], **wave),
                                 stress, (0,), shadow=True)[0]
    worst["K8"] = max(compare_occlusion("K8", label, s["dt"], t_min, rays)
                      for label, s, rays in (
                          ("first bounce", lit, first),
                          ("second bounce", lit, second),
                          ("random", lit, random_rays(size * size, 1, True)),
                          ("mostly idle", lit, random_rays(
                              size * size, 3, True, idle=K8_IDLE)),
                          ("stress first", stress, stress_first),
                          ("stress random", stress,
                           stress_rays(size * size, 4))))
    worst["K9"] = 0.0
    for case, s in (("field", field), ("lit field", lit),
                    ("stress field", stress)):
        args = dict(cfg=dataclasses.replace(s["cfg"], width=n, height=n,
                                            spp_per_step=EARLY_TWIN_SPP),
                    global_shape=(n, n), npix=n * n, has_mirrors=False,
                    lights=s["lights"])
        got = tlas_regen_render(s["dt"], 3, 0, **args)
        exp = bvh_regen_render_plain(s["dt"], 3, 0, **args)
        worst["K9"] = max(worst["K9"], compare(
            f"K9 {case}", got, exp, EARLY_TWIN_SPP, K5_TWIN_REL_RMSE))
    return worst


def tlas_cross_phase(field):
    """K9 against the wavefront loop over K7 (the same estimator in two
    float orders), and K9 on the instances against K5 on the flattened
    scene (object-space against world-space rounding)."""
    from sfvp_tpu_torch import init_state
    from sfvp_tpu_torch.accel.wide import build_wide_from_buffers
    from sfvp_tpu_torch.dispatch import select_instanced_render_step
    from sfvp_tpu_torch.kernels.bvh_packet import device_wide
    from sfvp_tpu_torch.kernels.megakernel_bvh import make_bvh_regen_render_step

    n, spp = TLAS_CROSS_SIZE, TLAS_CROSS_SPP
    phase(f"tlas cross-checks at {n}x{n}, {spp} spp, depth {BVH_DEPTH}, "
          "cosine: K9 vs the wavefront loop over K7; K9 on the instances vs "
          "K5 on the flattened scene")
    cfg = dataclasses.replace(field["cfg"], width=n, height=n,
                              spp_per_step=spp)
    flat = field["flat"]

    def render(step):
        return step(init_state(n, n, DEVICE))

    k9 = render(make_bvh_regen_render_step(cfg, flat, tl=field["dt"]))
    wf = render(select_instanced_render_step(
        dataclasses.replace(cfg, megakernel_regen=False), flat, field["tl"]))
    rel = rel_rmse(k9.accum, wf.accum)
    segs = [round(float(s.mrays) * 1e6) for s in (k9, wf)]
    print(f"  K9 vs wavefront over K7: rel_rmse={rel:.3e} max_abs="
          f"{float((k9.accum - wf.accum).abs().max()):.3e} segs={segs[0]} vs "
          f"{segs[1]}")
    check(rel <= K5_TWIN_REL_RMSE and float(k9.mrays) == float(wf.mrays),
          f"K9 disagrees with the wavefront loop over K7: rel_rmse {rel}, "
          f"segments {segs}")

    t0 = time.perf_counter()
    wide = build_wide_from_buffers(flat)
    print(f"  flattened scene: wide BVH {wide.nodes.shape[0]} nodes + "
          f"{wide.tris.shape[0]} leaf rows, built in "
          f"{time.perf_counter() - t0:.2f} s")
    k5 = render(make_bvh_regen_render_step(cfg, flat, device_wide(wide,
                                                                   DEVICE)))
    mean9, mean5 = float(k9.accum.mean()), float(k5.accum.mean())
    mean_rel = abs(mean9 / mean5 - 1.0)
    off = float(((k9.accum - k5.accum).abs().amax(-1) > K9_K5_OFF_ABS)
                .float().mean())
    rel5 = rel_rmse(k9.accum, k5.accum)
    print(f"  K9 on instances vs K5 on the flattened scene: means {mean9:.6f} "
          f"vs {mean5:.6f} (rel {mean_rel:.3e}, bound {K9_K5_MEAN}); "
          f"{off:.4%} of pixels apart by > {K9_K5_OFF_ABS} (bound "
          f"{K9_K5_OFF_FRAC:.1%}); rel_rmse {rel5:.3e} (bound "
          f"{K9_K5_REL_RMSE})")
    check(mean_rel < K9_K5_MEAN and off < K9_K5_OFF_FRAC
          and rel5 < K9_K5_REL_RMSE,
          f"K9 on the instances and K5 on the flattened scene differ: mean "
          f"rel {mean_rel}, pixels apart {off}, rel_rmse {rel5}")


def tlas_main_path_phase(tmp, field, lit):
    from sfvp_tpu_torch import Renderer
    from sfvp_tpu_torch.kernels import bvh_tlas

    per_step = BVH_SPP * BVH_DEPTH
    phase(f"tlas main path: cli --scene instanced --scene-tris {FIELD_TRIS} "
          f"at {BVH_W}x{BVH_H}, {BVH_SPP} spp, depth {BVH_DEPTH}, cosine, "
          f"{FIELD_STEPS} steps (K9); Renderer with megakernel_regen=False, "
          f"1 step (K7); the lit field, cosine + RR + NEE + MIS: {LIT_STEPS} "
          "Renderer steps (K9), 1 with megakernel_regen=False (K7 + K8)")
    runs = {}
    reset_counts()
    setup, recs, img = run_cli(tmp, "field", [
        "--scene", "instanced", "--scene-tris", str(FIELD_TRIS), *FIELD_CLI,
        "--spp", str(BVH_SPP), "--max-depth", str(BVH_DEPTH), "--width",
        str(BVH_W), "--height", str(BVH_H), "--steps", str(FIELD_STEPS)])
    runs["cli_field"] = read_counts()
    print(f"  launches: {runs['cli_field']}")
    check(runs["cli_field"] == only(K9=FIELD_STEPS),
          f"cli instanced launches {runs['cli_field']}")
    check(len(recs) == FIELD_STEPS, f"{len(recs)} log records")
    print_steps(recs)
    check_image("K9 field", img, BVH_H, BVH_W)

    wrappers = {"K7": "two_level_trace", "K8": "two_level_occlusion"}
    for name, s, steps, kernels in (
            ("renderer_k7", field, 1, dict(K7=per_step)),
            ("renderer_lit_k9", lit, LIT_STEPS, dict(K9=LIT_STEPS)),
            ("renderer_k7k8", lit, 1, dict(K7=per_step, K8=per_step))):
        cfg = s["cfg"]
        if "K9" not in kernels:
            cfg = dataclasses.replace(cfg, megakernel_regen=False)
        log = os.path.join(tmp, f"{name}.jsonl")
        reset_counts()
        r = Renderer(cfg, s["insts"], DEVICE)
        # the wavefront steps: every K7 and K8 call between CUDA events,
        # their sum beside the step's host time
        names = [wrappers[k] for k in kernels if k in wrappers]
        in_kernels, img = timed_calls(
            bvh_tlas, names, lambda: r.run(steps, log_path=log,
                                           progress=False))
        runs[name] = read_counts()
        print(f"  {name}: launches {runs[name]}; set-up: two-level BVH built "
              f"in {r.bvh_build_s:.3f} s")
        check(runs[name] == only(**kernels), f"{name} launches {runs[name]}")
        recs = [json.loads(x) for x in open(log).read().splitlines()]
        check(len(recs) == steps, f"{len(recs)} log records")
        print_steps(recs)
        if names:
            step_ms = recs[0]["step_s"] * 1e3
            total = sum(in_kernels.values())
            print(f"  {name}: in the kernels' calls (CUDA events) " + ", ".join(
                f"{k} {ms:.3f} ms" for k, ms in in_kernels.items())
                + f"; {total:.3f} ms of the step's {step_ms:.2f} ms (host), "
                f"{total / step_ms:.1%}")
        check_image(name, img, BVH_H, BVH_W)
    return runs


def tlas_timing_phase(field, lit):
    from sfvp_tpu_torch.kernels.megakernel_bvh import (
        bvh_regen_render_plain, tlas_regen_render)

    phase(f"tlas times and twin check at the main path's shape ({BVH_W}x"
          f"{BVH_H}, {BVH_SPP} spp, depth {BVH_DEPTH}; cosine on the field, "
          "cosine + RR + NEE + MIS on the lit field), CUDA events; ptxas's "
          "report on the two-level walks' kernels")
    two_level_ptxas()
    npix = BVH_W * BVH_H
    times, worst = {}, {"K9": 0.0}
    for case, s in (("field", field), ("lit field", lit)):
        dt = s["dt"]
        args = dict(cfg=s["cfg"], global_shape=(BVH_H, BVH_W), npix=npix,
                    has_mirrors=False, lights=s["lights"])
        ms, got = cuda_ms(lambda: tlas_regen_render(dt, 1, 0, **args), 5)
        counts = {}
        plain, exp = cuda_ms(lambda: bvh_regen_render_plain(
            dt, 1, 0, counts=counts, **args), 1, warm=False)
        print(f"  K9 {case}: kernel {ms:.3f} ms/step, plain twin {plain:.1f} "
              f"ms/step; twin counts {counts}")
        worst["K9"] = max(worst["K9"], compare(
            f"K9 {case} main", got, exp, BVH_SPP, K5_TWIN_REL_RMSE))
        segs = int(exp[3].sum(dtype=torch.int64))
        ops = (traversal_ops(counts) + counts["hits"] * WORLD_OPS
               + segs * SHADE_OPS)
        nbytes = two_level_nbytes(s["tl"]) + npix * 16
        if s["cfg"].use_nee:
            ops += (traversal_ops(counts, "shadow_", sort=False)
                    + counts["shadow_rays"] * NEE_OPS)
            nbytes += s["lights"].rows.numel() * 4
        times[f"K9 {case}"] = (ms, plain) + bound(ops, nbytes)
        print(f"  K9 {case}: {segs} segments ({ms * 1e6 / segs:.3f} "
              f"ns/segment), {counts['node_pops'] / segs:.3f} node, "
              f"{counts['leaf_pops'] / segs:.3f} leaf and "
              f"{counts['inst_pops'] / segs:.3f} instance pops per segment; "
              f"bound {times[f'K9 {case}'][2]:.3f} ms "
              f"({times[f'K9 {case}'][3]})")

    t_min = field["cfg"].t_min
    one = dict(spp_per_step=1)
    first, later = capture_waves(dataclasses.replace(field["cfg"], **one),
                                 field, (0, 2))
    shadow = capture_waves(dataclasses.replace(lit["cfg"], **one), lit, (0,),
                           shadow=True)[0]
    for kernel, label, s, rays in (
            ("K7", "first bounce", field, first),
            ("K7", "third bounce", field, later),
            ("K8", "first bounce", lit, shadow)):
        dt = s["dt"]
        fn, plain_fn = kernel_fns(kernel)
        ms, got = cuda_ms(lambda: fn(dt, t_min, rays), 20)
        counts = {}
        plain, exp = cuda_ms(lambda: plain_fn(dt, t_min, rays, counts), 1,
                             warm=False)
        if kernel == "K7":
            mx = compare_trace(kernel, label, dt, t_min, rays, got=got,
                               exp=exp)
            ops = (traversal_ops(counts)
                   + int(torch.isfinite(exp[0]).sum()) * WORLD_OPS)
            per_ray = (7 + 19) * 4
        else:
            mx = compare_occlusion(kernel, label, dt, t_min, rays, got=got,
                                   exp=exp)
            ops, per_ray = traversal_ops(counts, sort=False), 7 * 4 + 1
            occ, near = nearest_first_pops(dt, t_min, rays)
            check(torch.equal(occ, exp), "the nearest-first any-hit walk "
                                         "disagrees with K8's twin")
            print(f"  {kernel} {label}: pushed nearest first, the same "
                  f"answers and pops {near}")
        worst[kernel] = max(worst.get(kernel, 0.0), mx)
        b = bound(ops, two_level_nbytes(s["tl"]) + rays.shape[1] * per_ray)
        print(f"  {kernel} {label}: {int((rays[6] > t_min).sum())} active "
              f"rays, kernel {ms:.3f} ms/launch, plain twin {plain:.1f} ms; "
              f"pops {counts}; bound {b[0]:.4f} ms ({b[1]})")
        times.setdefault(kernel, (ms, plain) + b)
    return times, worst


def same_triangle(a, b):
    """The share of rays whose two payloads name the same triangle (or
    both miss)."""
    miss_a, miss_b = torch.isinf(a[0]), torch.isinf(b[0])
    same = (miss_a & miss_b) | (~miss_a & ~miss_b & (a[3:] == b[3:]).all(0))
    return float(same.float().mean())


def host_copy(dw):
    """A DeviceWide's tables on the host CPU, for a twin of a small wave:
    its passes are many small ops, which the host runs faster than it
    issues them to the card (the same bits)."""
    return dw._replace(nodes=dw.nodes.cpu(), tris=dw.tris.cpu(),
                       tris_aux=None if dw.tris_aux is None
                       else dw.tris_aux.cpu())


def compare_k6(label, dw, t_min, rays, leaf_q=64, got=None, exp=None,
               host=None):
    """Hold K6's planes against its twin's: equal on every plane of every
    ray; ``host``: the tree's ``host_copy``, where the twin runs. Returns
    the largest absolute difference (0)."""
    from sfvp_tpu_torch.kernels.bvh_packet2 import (
        packet_trace2, packet_trace2_plain)

    if got is None:
        got = packet_trace2(dw, t_min, rays, leaf_q)
    walk = ""
    if exp is None:
        counts = {}
        t0 = time.perf_counter()
        exp = packet_trace2_plain(host or dw, t_min,
                                  rays if host is None else rays.cpu(),
                                  leaf_q, counts).to(got.device)
        walk = (f", packets' iterations "
                f"{counts['per_packet_iterations']}, twin "
                f"{(time.perf_counter() - t0) * 1e3:.0f} ms (host clock, "
                f"{'card' if host is None else 'host CPU'})")
    apart = int((got != exp).any(0).sum())
    print(f"  K6 {label:14s} {rays.shape[1]} rays, "
          f"{int(torch.isfinite(exp[0]).sum())} hits, leaf_q {leaf_q}: "
          f"{apart} rays with a plane apart{walk}")
    check(apart == 0, f"K6 {label} disagrees with its twin on {apart} rays")
    return 0.0


def compare_images(label, a, b, mrays_a, mrays_b):
    """Hold two renders of one estimator over K6 and over K3 (+ K4), which
    may take another triangle at an exact tie in t, to the kernel-vs-twin
    bounds: relative RMSE below TWIN_REL_RMSE, fewer than TWIN_OFF_FRAC of
    the pixels apart by more than TWIN_OFF_ABS, segments within SEGS_REL."""
    diff = (a - b).abs()
    rel = rel_rmse(a, b)
    off = float((diff.amax(-1) > TWIN_OFF_ABS).float().mean())
    seg_a, seg_b = (round(float(x) * 1e6) for x in (mrays_a, mrays_b))
    seg_rel = abs(seg_a - seg_b) / seg_b
    print(f"  {label}: rel_rmse={rel:.3e} pixels_off={off:.3e} "
          f"max_abs={float(diff.max()):.3e} segs={seg_a} vs {seg_b} (rel "
          f"{seg_rel:.3e})")
    check(rel < TWIN_REL_RMSE and off < TWIN_OFF_FRAC and seg_rel <= SEGS_REL,
          f"{label}: rel_rmse {rel}, pixels off {off}, segment rel diff "
          f"{seg_rel}")


def k6_twin_phase(big, city):
    from sfvp_tpu_torch.dispatch import stream_tris
    from sfvp_tpu_torch.kernels.bvh_packet import packet_trace, ray_planes
    from sfvp_tpu_torch.kernels.bvh_packet2 import packet_trace2

    size = K6_TWIN_SIZE
    phase(f"k6 twins: K6 vs its twin on {size}^2-ray waves of the "
          f"{BIG_TRIS // 1000}k sphere (camera and bounce with leaf_q "
          f"{', '.join(map(str, K6_LEAF_QS))}; random, partial, active) and "
          "the city's NEE shadow wave (stream_tris="
          f"True); K6 and K3 on the same triangle on {K3_SAME_SIZE}^2-ray "
          "camera and bounce waves")
    cfg, dw, wide = big["cfg"], big["dw"], big["wide"]
    nbytes = wide.nodes.nbytes + wide.tris.nbytes
    print(f"  {BIG_TRIS // 1000}k sphere: wide BVH of {nbytes} bytes, "
          f"streamed (K6): {stream_tris(cfg, wide)}")
    check(stream_tris(cfg, wide), "the 500k sphere is not on K6's route")
    wave = dict(width=size, height=size, spp_per_step=1)
    camera, bounce = capture_waves(dataclasses.replace(cfg, **wave), big,
                                   (0, 1))
    g = np.random.default_rng(0)
    m = size * size
    o = torch.tensor(g.uniform(-1.5, 1.5, (3, m)), dtype=torch.float32,
                     device=DEVICE)
    d = torch.tensor(g.normal(size=(3, m)), dtype=torch.float32,
                     device=DEVICE)
    d = d / d.norm(dim=0)
    random = ray_planes(tuple(o), tuple(d), cfg.t_max)
    # the camera wave with 30% of its rays inactive, and cut so that its
    # last packet holds 524 rays, its center ray then a padding ray
    active = camera.clone()
    active[6, torch.tensor(g.uniform(size=m) < 0.3, device=DEVICE)] = (
        float("-inf"))
    partial = camera[:, :m - 500].contiguous()
    shadow = capture_waves(dataclasses.replace(city["cfg"], **wave,
                                               stream_tris=True),
                           city, (0,), shadow=True)[0]
    worst = 0.0
    # the twins walk these small waves on the host CPU (host_copy)
    host, city_host = host_copy(dw), host_copy(city["dw"])
    for label, tree, rays, leaf_q in (
            *(("camera", dw, camera, q) for q in K6_LEAF_QS),
            *(("bounce", dw, bounce, q) for q in K6_LEAF_QS),
            ("random", dw, random, 64), ("partial", dw, partial, 64),
            ("active", dw, active, 64),
            ("city shadow", city["dw"], shadow, 64)):
        worst = max(worst, compare_k6(
            label, tree, cfg.t_min, rays, leaf_q,
            host=city_host if tree is city["dw"] else host))
    wave = dict(width=K3_SAME_SIZE, height=K3_SAME_SIZE, spp_per_step=1)
    whole = capture_waves(dataclasses.replace(cfg, **wave), big, (0, 1))
    for label, rays in zip(("camera", "bounce"), whole):
        frac = same_triangle(packet_trace2(dw, cfg.t_min, rays),
                             packet_trace(dw, cfg.t_min, rays))
        print(f"  K6 vs K3 {label}: the same triangle on {frac:.6f} of "
              f"{rays.shape[1]} rays")
        check(frac >= K3_SAME_TRI, f"K6 and K3 {label}: same triangle on "
                                   f"{frac}")
    return worst, {"camera": camera, "bounce": bounce}


def adaptive_cross_phase(big, city):
    """The adaptive sampler over K6 against the Renderer and the adaptive
    sampler over K3 (+ K4), at CROSS_SIZE^2."""
    from sfvp_tpu_torch import init_state
    from sfvp_tpu_torch.dispatch import select_render_step
    from sfvp_tpu_torch.integrate.adaptive import (
        adaptive_image, init_adaptive_state, make_adaptive_steps)

    n, per_step = CROSS_SIZE, BVH_SPP * BVH_DEPTH
    phase(f"adaptive cross-checks at {n}x{n}, {BVH_SPP} spp, depth "
          f"{BVH_DEPTH}, cosine + RR: the uniform step over K6 vs the "
          "Renderer over K3; adaptive steps over K6 and K3 from one state; "
          "the city with NEE + MIS over K6 vs K3 + K4")
    size = dict(width=n, height=n, megakernel_regen=False)
    cfg = dataclasses.replace(big["cfg"], **size, spp_per_step=BVH_SPP)

    def steps(s, c, stream):
        return make_adaptive_steps(
            dataclasses.replace(c, stream_tris=stream), s["buffers"],
            frac=ADAPT_FRAC, tile=ADAPT_TILE, wide=s["wide"])

    (uni6, ada6), (_, ada3) = steps(big, cfg, True), steps(big, cfg, False)
    reset_counts()
    k6 = uni6(init_adaptive_state(n, n, DEVICE))
    k3 = select_render_step(dataclasses.replace(cfg, stream_tris=False),
                            big["buffers"], wide=big["wide"])(
        init_state(n, n, DEVICE))
    launches = read_counts()
    check(launches == only(K6=per_step, K3=per_step),
          f"uniform step and Renderer step launches {launches}")
    compare_images("uniform step over K6 vs Renderer over K3",
                   adaptive_image(k6), k3.accum, k6.mrays, k3.mrays)
    a6, a3 = ada6(k6), ada3(k6)
    same = torch.equal(a6.count, a3.count)
    print(f"  adaptive steps over K6 and K3 from one state: the same tiles "
          f"{same} ({int((a6.count > k6.count).sum())} pixels each)")
    check(same, "the adaptive steps over K6 and K3 picked other tiles")
    compare_images("adaptive step over K6 vs over K3", adaptive_image(a6),
                   adaptive_image(a3), a6.mrays - k6.mrays,
                   a3.mrays - k6.mrays)

    ccfg = dataclasses.replace(city["cfg"], **size)
    out = {}
    for stream, want in ((True, only(K6=2 * per_step)),
                         (False, only(K3=per_step, K4=per_step))):
        reset_counts()
        out[stream] = steps(city, ccfg, stream)[0](
            init_adaptive_state(n, n, DEVICE))
        launches = read_counts()
        check(launches == want, f"city uniform step (stream_tris={stream}) "
                                f"launches {launches}")
    compare_images("city NEE + MIS uniform step, K6 vs K3 + K4",
                   adaptive_image(out[True]), adaptive_image(out[False]),
                   out[True].mrays, out[False].mrays)


def adaptive_main_path_phase(tmp, city):
    from sfvp_tpu_torch import RenderConfig, Renderer
    from sfvp_tpu_torch.cli import procedural_scene
    from sfvp_tpu_torch.integrate.adaptive import AdaptiveRenderer
    from sfvp_tpu_torch.kernels import bvh_packet, bvh_packet2

    per_step = BVH_SPP * BVH_DEPTH
    phase(f"adaptive main path: cli {' '.join(ADAPT_CLI)} at {BVH_W}x"
          f"{BVH_H} (K6); Renderer with megakernel_regen=False, 1 step (K6), "
          f"and with stream_tris=False as well, 1 step (K3, the route before "
          f"K6 was ported); AdaptiveRenderer on the city, NEE + MIS + RR, stream_tris=True, "
          f"{CITY_ADAPT_STEPS} steps (K6)")
    runs = {}
    reset_counts()
    setup, recs, img = run_cli(tmp, "adaptive", [
        *ADAPT_CLI, "--width", str(BVH_W), "--height", str(BVH_H)])
    runs["cli_adaptive"] = read_counts()
    print(f"  launches: {runs['cli_adaptive']} "
          f"({runs['cli_adaptive']['K6'] / ADAPT_STEPS:.0f} a step)")
    check(runs["cli_adaptive"] == only(K6=ADAPT_STEPS * per_step),
          f"cli adaptive launches {runs['cli_adaptive']}")
    k = int(np.ceil(ADAPT_FRAC * (BVH_W // ADAPT_TILE) * (BVH_H // ADAPT_TILE)))
    pixels = ([BVH_W * BVH_H] * ADAPT_WARMUP
              + [k * ADAPT_TILE ** 2] * (ADAPT_STEPS - ADAPT_WARMUP))
    check([r["pixels"] for r in recs] == pixels, f"adaptive records {recs}")
    for rec in recs:
        print(f"  step {rec['step']}: {rec['pixels']} pixels, step_s "
              f"{rec['step_s']}, {rec['mrays_step']} Mrays, "
              f"{rec['mrays_per_s']} Mrays/s, mean spp {rec['mean_spp']}")
    check_image(f"K6 adaptive {BIG_TRIS // 1000}k sphere", img, BVH_H, BVH_W)

    scene, cfg = procedural_scene("sphere", BIG_TRIS, RenderConfig(
        width=BVH_W, height=BVH_H, spp_per_step=BVH_SPP,
        max_depth=BVH_DEPTH, sampling="cosine", use_rr=True,
        megakernel_regen=False))
    k3_cfg = dataclasses.replace(cfg, stream_tris=False)
    # the streamed route sorts its bounce rays by default (sort_rays); the
    # step is taken both ways, and over K3, on the first Renderer's tree
    unsorted = dataclasses.replace(cfg, sort_bounce_rays=False)
    first = {}

    def renderer():
        first["r"] = Renderer(cfg, scene, DEVICE)
        return first["r"]

    for name, make, steps, kernels, (module, fn) in (
            ("renderer_k6", renderer, 1,
             dict(K6=per_step), (bvh_packet2, "packet_trace2")),
            ("renderer_k6_unsorted", lambda: same_tree(first["r"], unsorted),
             1, dict(K6=per_step), (bvh_packet2, "packet_trace2")),
            ("renderer_k3", lambda: same_tree(first["r"], k3_cfg), 1,
             dict(K3=per_step), (bvh_packet, "packet_trace")),
            ("adaptive_city", lambda: AdaptiveRenderer(
                dataclasses.replace(city["cfg"], stream_tris=True),
                city["scene"], DEVICE, frac=ADAPT_FRAC, tile=ADAPT_TILE,
                warmup=ADAPT_WARMUP), CITY_ADAPT_STEPS,
             dict(K6=2 * per_step * CITY_ADAPT_STEPS),
             (bvh_packet2, "packet_trace2"))):
        log = os.path.join(tmp, f"{name}.jsonl")
        reset_counts()
        r = make()
        # every payload-trace call between CUDA events, their sum beside
        # the steps' host time
        in_k, img = timed_calls(module, [fn], lambda: r.run(
            steps, log_path=log, progress=False))
        runs[name] = read_counts()
        built = ("reused" if r is not first["r"] and r.wide is first["r"].wide
                 else f"built in {r.bvh_build_s:.2f} s")
        print(f"  {name}: launches {runs[name]}; set-up: wide BVH {built}")
        check(runs[name] == only(**kernels), f"{name} launches {runs[name]}")
        recs = [json.loads(x) for x in open(log).read().splitlines()]
        check(len(recs) == steps, f"{len(recs)} log records")
        step_ms = sum(rec["step_s"] for rec in recs) * 1e3
        for rec in recs:
            print(f"  step {rec['step']}: step_s {rec['step_s']}, "
                  f"{rec['mrays_per_s']} Mrays/s")
        k = next(iter(kernels))
        print(f"  {name}: {k}'s {runs[name][k]} calls {in_k[fn]:.3f} ms "
              f"(CUDA events) of {step_ms:.2f} ms (host), "
              f"{in_k[fn] / step_ms:.1%}")
        check_image(name, img, BVH_H, BVH_W)
    return runs, first["r"]


def same_tree(r, cfg):
    """A copy of the Renderer ``r`` that renders ``cfg`` over r's scene
    buffers and wide BVH, without building them again: its own step (the
    route dispatch picks for ``cfg``) and its own state."""
    import copy

    from sfvp_tpu_torch import init_state
    from sfvp_tpu_torch.dispatch import select_render_step

    v = copy.copy(r)
    v.cfg = cfg
    v._step = select_render_step(cfg, r.buffers, wide=r.wide)
    v.state = init_state(cfg.height, cfg.width, r.device)
    return v


def packet_ops(counts):
    """FP32 operations of K6's own union walk, as its twin counted its
    pops: per node pop of a packet, 1024 rays x 8 slab tests and the
    network; per leaf pop, 1024 x 8 triangle tests. A diagnostic of the
    design, not K6's bound: the function (closest hit) needs only what
    K3's per-ray walk pops on the same rays."""
    return (counts["node_pops"] * (1024 * 8 * BOX_OPS + SORT_OPS)
            + counts["leaf_pops"] * 1024 * 8 * TRI_OPS_ROWS)


def ptxas_entries(*names):
    """ptxas's report from the build's log on every kernel entry whose
    mangled name holds one of ``names``: {mangled name: the lines after
    its "Compiling entry" line (its stack frame and spills, registers,
    shared memory), up to the next entry}."""
    from sfvp_tpu_torch.kernels import build

    log = build.library_path().with_suffix(".log")
    lines = log.read_text().splitlines() if log.exists() else []
    out, entry = {}, None
    for line in lines:
        if "Compiling entry" in line:
            entry = line.split("'")[1]
            entry = entry if any(n in entry for n in names) else None
            if entry:
                out[entry] = []
        elif line.startswith("#"):
            entry = None
        elif entry:
            out[entry].append(line.strip())
    return out


def k6_ptxas():
    """ptxas's report on K6 (csrc/packet_trace2.cu) from the build's log:
    its registers, spills and static shared memory, one line each."""
    return next(iter(ptxas_entries("packet_trace2_kernel").values()), [])[:3]


def ptxas_numbers(lines):
    """(registers, spill store bytes, spill load bytes, stack frame bytes)
    of one entry's ptxas lines."""
    text = " ".join(lines)

    def num(pattern):
        m = re.search(pattern, text)
        return int(m.group(1)) if m else -1

    return (num(r"Used (\d+) registers"), num(r"(\d+) bytes spill stores"),
            num(r"(\d+) bytes spill loads"), num(r"(\d+) bytes stack frame"))


def two_level_ptxas():
    """ptxas's registers, spills and stack frame of K7, K8 and every K9
    entry (regen_walk_kernel over TwoLevelWalk, by its template flags), one
    line each; checks that each was found."""
    flags = ("mirrors", "nee", "img", "mat", "dof")
    found = ptxas_entries("tlas_trace_kernel", "tlas_occlusion_kernel",
                          "TwoLevelWalk")
    rows = []
    for entry, lines in found.items():
        if "TwoLevelWalk" in entry:
            bits = re.findall(r"Lb([01])", entry)
            name = "K9 " + " ".join(f"{f}={b}" for f, b in zip(flags, bits))
        else:
            name = "K7" if "tlas_trace" in entry else "K8"
        rows.append((name,) + ptxas_numbers(lines))
    for name, regs, st, ld, frame in sorted(rows):
        print(f"  ptxas {name}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B, stack frame {frame} B")
    check(sum(r[0].startswith("K9") for r in rows) == 10
          and {"K7", "K8"} <= {r[0] for r in rows},
          f"ptxas report on K7, K8 and K9's 10 entries not found: {rows}")
    return rows


# the entries of K1-K5 in ptxas's report: (label, a part of the kernel's
# name as it is mangled that no other kernel's holds: the name with its
# length, so that "12regen_kernel" is not found in regen_walk_kernel's,
# or K5's walk type; the kernel's bool template flags in order; the
# entries the library holds)
SINGLE_LEVEL_ENTRIES = (
    ("K1", "12regen_kernel", ("mirrors", "nee", "img", "mat", "dof"), 20),
    ("K1 tiled", "18regen_tiled_kernel", ("mirrors", "nee", "img", "mat",
                                          "dof"), 20),
    ("K2", "11wave_kernel", ("mirrors",), 2),
    ("K2 tiled", "17wave_tiled_kernel", ("mirrors",), 2),
    ("K3", "16bvh_trace_kernel", (), 1),
    ("K4", "20bvh_occlusion_kernel", (), 1),
    ("K5", "NS_8WideWalkE", ("mirrors", "nee", "img", "mat", "dof"),
     20),
)


def single_level_ptxas():
    """ptxas's registers, spills and stack frame of every entry of K1-K5
    (the brute-force kernels and the single-level walks), one line each;
    checks that each kernel has all its entries. Returns {kernel: {entry:
    [registers, spill store B, spill load B, stack frame B]}}."""
    out = {}
    for label, key, flags, n in SINGLE_LEVEL_ENTRIES:
        rows = {}
        for entry, lines in ptxas_entries(key).items():
            bits = re.findall(r"Lb([01])", entry)
            name = " ".join(f"{f}={b}" for f, b in zip(flags, bits))
            rows[name or "-"] = list(ptxas_numbers(lines))
        for name, (regs, st, ld, frame) in sorted(rows.items()):
            print(f"  ptxas {label} {name}: {regs} registers, spill stores "
                  f"{st} B, spill loads {ld} B, stack frame {frame} B")
        check(len(rows) == n, f"ptxas report on {label}: {len(rows)} of "
                              f"its {n} entries found")
        out[label] = rows
    return out


def k6_timing_phase(big):
    from sfvp_tpu_torch.integrate.adaptive import (
        init_adaptive_state, make_adaptive_steps)
    from sfvp_tpu_torch.kernels import build, bvh_packet2
    from sfvp_tpu_torch.kernels.bvh_packet import packet_trace, packet_trace_plain
    from sfvp_tpu_torch.kernels.bvh_packet2 import (
        LEAF_Q, packet_trace2, packet_trace2_plain)

    phase(f"k6 times and twin check on the {BIG_TRIS // 1000}k sphere: the "
          f"swizzled {BVH_W}x{BVH_H} first- and third-bounce waves (sorted "
          f"and not) and an adaptive wave ({ADAPT_FRAC} of the "
          f"{ADAPT_TILE}^2 tiles), K6 beside K3, CUDA events; ns an "
          "iteration of K6's longest packet (its twin's count)")
    ptxas = k6_ptxas()
    smem = build.packet_smem_plan(LEAF_Q)
    print(f"  K6 ptxas: {' | '.join(ptxas)}; dynamic shared memory {smem} "
          f"bytes at leaf_q {LEAF_Q} ({build.packet_smem_plan(build.MAX_LEAF_Q)}"
          f" at {build.MAX_LEAF_Q})")
    check(bool(ptxas), "no ptxas report on packet_trace2_kernel in the "
                       "build's log")
    cfg, dw, wide = big["cfg"], big["dw"], big["wide"]
    one = dataclasses.replace(cfg, width=BVH_W, height=BVH_H, spp_per_step=1,
                              megakernel_regen=False)
    # the streamed route sorts its bounce rays by default (sort_rays); the
    # third-bounce wave is taken both ways
    first, third = capture_waves(one, big, (0, 2))
    third_unsorted = capture_waves(dataclasses.replace(
        one, sort_bounce_rays=False), big, (2,))[0]
    uni, ada = make_adaptive_steps(one, big["buffers"], frac=ADAPT_FRAC,
                                   tile=ADAPT_TILE, wide=wide)
    st = uni(uni(init_adaptive_state(BVH_H, BVH_W, DEVICE)))
    adaptive = capture(bvh_packet2, "ray_planes", (0,), lambda: ada(st),
                       lambda a, out: out)[0]
    check(adaptive.shape[1] == ada.pixels, f"adaptive wave {adaptive.shape}")
    nbytes_tree = tree_nbytes(wide)
    times, worst = {}, 0.0
    for label, rays in (("first bounce", first),
                        ("third bounce unsorted", third_unsorted),
                        ("adaptive", adaptive)):
        ms, got = cuda_ms(lambda: packet_trace2(dw, cfg.t_min, rays), 10)
        counts = {}
        plain, exp = cuda_ms(lambda: packet_trace2_plain(
            dw, cfg.t_min, rays, counts=counts), 1, warm=False)
        longest = max(counts.pop("per_packet_iterations"))
        worst = max(worst, compare_k6(label, dw, cfg.t_min, rays, got=got,
                                      exp=exp))
        ms3, got3 = cuda_ms(lambda: packet_trace(dw, cfg.t_min, rays), 10)
        counts3 = {}
        plain3, _ = cuda_ms(lambda: packet_trace_plain(
            dw, cfg.t_min, rays, counts3), 1, warm=False)
        nbytes = nbytes_tree + rays.shape[1] * (7 + 19) * 4
        # K6 computes K3's function (they differ only at exact ties), so
        # both are held to the bound of its work: K3's per-ray pops
        b3, union = bound(traversal_ops(counts3), nbytes), bound(
            packet_ops(counts), nbytes)
        same = same_triangle(got, got3)
        t_apart = int((got[0] != got3[0]).sum())
        print(f"  {label}: {rays.shape[1]} rays, "
              f"{int((rays[6] > cfg.t_min).sum())} active; bound {b3[0]:.4f} "
              f"ms ({b3[1]}, K3's pops {counts3}); K6 {ms:.3f} ms/launch "
              f"(twin {plain:.1f} ms; {ms / b3[0]:.1f}x the bound; union-walk "
              f"pops {counts}, their own bound {union[0]:.4f} ms, {union[1]}"
              f"; longest packet {longest} iterations, "
              f"{ms * 1e6 / longest:.1f} ns an iteration); K3 {ms3:.3f} "
              f"ms/launch (twin {plain3:.1f} ms; {ms3 / b3[0]:.1f}x the "
              f"bound); K6/K3 {ms / ms3:.2f}; same triangle {same:.6f}, t "
              f"apart from K3's on {t_apart} rays")
        check(same >= K3_SAME_TRI, f"K6 and K3 {label}: same triangle on "
                                   f"{same}")
        times[label] = {"K6": (ms, plain) + b3, "K3": (ms3, plain3) + b3,
                        "K6 union walk": union, "K6 longest packet": longest,
                        "K6 t apart from K3": t_apart}
    # the same rays sorted, as the streamed route traces them: K6 and K3,
    # and K6's twin (~20 s: the sorted wave's ~37 live packets walk long,
    # one after another in the twin's passes)
    rays = third
    ms, got = cuda_ms(lambda: packet_trace2(dw, cfg.t_min, rays), 10)
    counts = {}
    plain, exp = cuda_ms(lambda: packet_trace2_plain(
        dw, cfg.t_min, rays, counts=counts), 1, warm=False)
    longest = max(counts.pop("per_packet_iterations"))
    worst = max(worst, compare_k6("third bounce sorted", dw, cfg.t_min, rays,
                                  got=got, exp=exp))
    ms3, got3 = cuda_ms(lambda: packet_trace(dw, cfg.t_min, rays), 10)
    same = same_triangle(got, got3)
    t_apart = int((got[0] != got3[0]).sum())
    b3 = times["third bounce unsorted"]["K3"][2:]
    union = bound(packet_ops(counts),
                  nbytes_tree + rays.shape[1] * (7 + 19) * 4)
    print(f"  third bounce sorted: the same {rays.shape[1]} rays sorted; "
          f"K6 {ms:.3f} ms/launch (twin {plain:.1f} ms; {ms / b3[0]:.1f}x "
          f"the bound; union-walk pops {counts}, their own bound "
          f"{union[0]:.4f} ms, {union[1]}; longest packet {longest} "
          f"iterations, {ms * 1e6 / longest:.1f} ns an iteration), K3 "
          f"{ms3:.3f} ms/launch; K6/K3 {ms / ms3:.2f}; sorted/unsorted K6 "
          f"{ms / times['third bounce unsorted']['K6'][0]:.2f}; same "
          f"triangle {same:.6f}, t apart from K3's on {t_apart} rays")
    check(same >= K3_SAME_TRI, f"K6 and K3 sorted: same triangle on {same}")
    times["third bounce"] = {"K6": (ms, plain) + b3, "K3": (ms3, None) + b3,
                             "K6 union walk": union,
                             "K6 longest packet": longest,
                             "K6 t apart from K3": t_apart}
    for row in times.values():
        row["K6 ns per iteration"] = row["K6"][0] * 1e6 / row[
            "K6 longest packet"]
    times["ptxas"], times["smem"] = ptxas, smem
    waves = {"first bounce": first, "third bounce unsorted": third_unsorted,
             "third bounce": third, "adaptive": adaptive}
    return times, worst, waves


# ---- slice 6: environment maps and map_Kd textures ----

def sun_png(path, h=32, w=64):
    """bench.py's sun map (bench_env_nee_100k): a dim sky, a 3 x 4 sun."""
    from sfvp_tpu_torch.render.png import encode_png

    img = np.full((h, w, 3), 6, np.uint8)
    img[6:9, 40:44] = 255
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


def sky_png(path, h=32, w=64):
    """A 64 x 32 sky: a bright zenith over a darker horizon, tinted by
    longitude, with a soft warm sun."""
    from sfvp_tpu_torch.render.png import encode_png

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    sun = 200.0 * np.exp(-((yy - 8) ** 2 + (xx - 20) ** 2) / 6.0)
    img = np.stack([230 - 4 * yy + sun, 150 + xx + sun, 250 - 5 * yy], -1)
    with open(path, "wb") as f:
        f.write(encode_png(np.clip(img, 0, 255).astype(np.uint8)))
    return path


def checker_png(path, n=64, cell=8):
    """bench.py's checker (bench_textured_100k): red and white cells."""
    from sfvp_tpu_torch.render.png import encode_png

    yy, xx = np.mgrid[0:n, 0:n]
    cells = ((xx // cell + yy // cell) % 2).astype(np.uint8)
    img = np.where(cells[..., None] > 0, [255, 255, 255],
                   [230, 40, 40]).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


def big_env(kind):
    """bench.py's 2048 x 1024 maps on the card: "ramp", the sky of
    env_big2048_100k_512 (bench_env_big_100k), or "sun", that of
    env_big2048_nee_100k_512 (bench_env_big_nee_100k)."""
    from sfvp_tpu_torch.scene.textures import table_from_arrays

    h, w = 1024, 2048
    if kind == "ramp":
        yy = np.repeat(np.linspace(0.0, 1.5, h, dtype=np.float32), w)
        planes = (yy, yy * 0.8 + 0.1, 1.5 - yy)
    else:
        sky = np.tile(np.linspace(0.05, 0.4, h, dtype=np.float32)[:, None],
                      (1, w))
        sky[180:196, 1400:1416] = 200.0
        flat = sky.reshape(-1)
        planes = (flat, flat * 0.9 + 0.02, flat * 0.7 + 0.05)
    return table_from_arrays(*planes, [0], [w], [h], device=DEVICE)


def textured_cornell(tmp):
    """The Cornell Box as an OBJ with vt and map_Kd: its back wall wears
    the checker (four repeats a side), the rest as bundled."""
    from sfvp_tpu_torch import cornell_box_path

    src = cornell_box_path()
    obj = open(src).read()
    mtl = open(src[:-3] + "mtl").read()
    check("f 9 10 11 12" in obj and "newmtl backWall" in mtl,
          "the bundled Cornell Box changed")
    obj = obj.replace("mtllib CornellBox-Original.mtl", "mtllib tex.mtl")
    obj = obj.replace("f 9 10 11 12", "vt 0 0\nvt 4 0\nvt 4 4\nvt 0 4\n"
                                      "f 9/1 10/2 11/3 12/4")
    mtl = mtl.replace("newmtl backWall", "newmtl backWall\nmap_Kd check.png")
    checker_png(os.path.join(tmp, "check.png"))
    with open(os.path.join(tmp, "tex.mtl"), "w") as f:
        f.write(mtl)
    path = os.path.join(tmp, "cornell_tex.obj")
    with open(path, "w") as f:
        f.write(obj)
    return path


def textured_setup(sphere, tmp):
    """The 100k sphere with bench.py's checker (bench_textured_100k: vt
    from x and z, every face textured), on the card; its wide tree
    collapsed from the sphere's own binary tree with the vt rows."""
    from sfvp_tpu_torch import upload
    from sfvp_tpu_torch.accel.wide import build_wide, materials_array, uv_array
    from sfvp_tpu_torch.kernels.bvh_packet import device_wide

    scene = sphere["scene"]
    t = scene.num_triangles
    tri = scene.triangles()
    scene = dataclasses.replace(
        scene, face_uv=np.stack([tri[..., 0] * 0.5 + 0.5,
                                 tri[..., 2] * 0.5 + 0.5],
                                axis=-1).astype(np.float32),
        face_tex=np.zeros((t,), np.int32),
        texture_paths=[checker_png(os.path.join(tmp, "check.png"))])
    buffers = upload(scene, device=DEVICE)
    t0 = time.perf_counter()
    wide = build_wide(sphere["binary"], materials_array(buffers),
                      aux=uv_array(buffers))
    print(f"  textured sphere: tris_aux {wide.tris_aux.nbytes} bytes beside "
          f"{wide.nodes.nbytes + wide.tris.nbytes}; wide tree collapsed "
          f"again in {time.perf_counter() - t0:.2f} s")
    return dict(scene=scene, cfg=sphere["cfg"], buffers=buffers, wide=wide,
                dw=device_wide(wide, DEVICE), lights=None)


def env_buffers(buffers, env):
    """Scene buffers with environment map ``env`` (a TextureTable)."""
    return buffers._replace(env=env)


def k1_images(buffers, cfg):
    """K1's arguments for ``buffers`` under ``cfg``: its table, lights and
    images."""
    from sfvp_tpu_torch.integrate.lights import (
        build_light_table_from_buffers, env_distribution_for)
    from sfvp_tpu_torch.kernels.megakernel import scene_table

    return scene_table(buffers), dict(
        num_tris=buffers.num_tris, has_mirrors=False,
        lights=(build_light_table_from_buffers(buffers) if cfg.use_nee
                else None),
        env=buffers.env, env_dist=(env_distribution_for(buffers.env)
                                   if cfg.use_nee and buffers.env is not None
                                   else None),
        textures=buffers.textures)


def k5_images(buffers, cfg, dw):
    """K5's arguments for ``buffers`` under ``cfg`` over the device tree
    ``dw``: lights and images."""
    from sfvp_tpu_torch.integrate.lights import (
        build_light_table_from_buffers, env_distribution_for)

    return dict(has_mirrors=False,
                lights=(build_light_table_from_buffers(buffers)
                        if cfg.use_nee else None),
                env=buffers.env,
                env_dist=(env_distribution_for(buffers.env)
                          if cfg.use_nee and buffers.env is not None
                          else None),
                textures=buffers.textures if dw.tris_aux is not None
                else None)


def random_dirs(n, seed):
    g = np.random.default_rng(seed)
    d = torch.tensor(g.normal(size=(3, n)), dtype=torch.float32,
                     device=DEVICE)
    return (d / d.norm(dim=0)).contiguous()


def random_env(h, w, seed):
    """A map of texels uniform in [0, 9), P3's probe's (probe_envfetch.py
    make_env scale)."""
    from sfvp_tpu_torch.scene.textures import table_from_arrays

    g = np.random.default_rng(seed)
    return table_from_arrays(
        *(g.uniform(0, 9, h * w).astype(np.float32) for _ in range(3)),
        [0], [w], [h], device=DEVICE)


def env_maps(tmp):
    """The 64 x 32 sky and bench.py's sun map, written as PNGs into
    ``tmp`` and loaded onto the card as the CLI loads them: their paths
    and tables."""
    from sfvp_tpu_torch.scene.textures import build_texture_table

    paths = {"sky": sky_png(os.path.join(tmp, "sky.png")),
             "sun": sun_png(os.path.join(tmp, "sun.png"))}
    maps = {k: build_texture_table([p], DEVICE) for k, p in paths.items()}
    maps.update({f"{k}_path": p for k, p in paths.items()})
    return maps


def env_twin_phase(sphere, tex, maps, tmp):
    """Phase 25: K1, K5, K3, K6 with environment maps and textures, P3 and
    P4, and K1/K2 past 480 triangles, each against its twin."""
    from sfvp_tpu_torch import RenderConfig, load_obj, upload
    from sfvp_tpu_torch.kernels import envfetch
    from sfvp_tpu_torch.kernels.megakernel import (
        scene_table, wave_render, wave_render_plain)
    from sfvp_tpu_torch.kernels.megakernel_bvh import (
        bvh_regen_render, bvh_regen_render_plain)
    from sfvp_tpu_torch.kernels.megakernel_regen import (
        regen_render, regen_render_plain)
    from sfvp_tpu_torch.kernels import build
    from sfvp_tpu_torch.scene.procedural import sphere_mesh

    n1, spp1 = ENV_TWIN_SIZE, ENV_TWIN_SPP
    phase(f"env/tex twins: K1 at {n1}x{n1}, {spp1} spp (sky, sun + NEE + MIS "
          f"+ RR, textured back wall); K5 at {BVH_TWIN_SIZE}x{BVH_TWIN_SIZE}"
          f", {BVH_TWIN_SPP} spp on the {SPHERE_TRIS // 1000}k sphere "
          "(checker, sun + NEE, 2048x1024 sun + NEE); K3 and K6 on a "
          "textured wave; P3 and P4; K1 and K2 past 480 triangles")
    worst = {k: 0.0 for k in ("K1", "K2", "K3", "K5", "K6", "P3", "P4")}
    sky, sun = maps["sky"], maps["sun"]
    cornell = cornell_buffers(DEVICE)
    cases = {
        "sky": (env_buffers(cornell, sky), {}),
        "sun nee": (env_buffers(cornell, sun), NEE_FLAGS),
        "textured": (upload(load_obj(textured_cornell(tmp)), device=DEVICE),
                     {}),
    }
    for case, (buffers, kw) in cases.items():
        cfg = RenderConfig(width=n1, height=n1, spp_per_step=spp1,
                           max_depth=8, **kw)
        table, imgs = k1_images(buffers, cfg)
        args = dict(cfg=cfg, global_shape=(n1, n1), npix=n1 * n1, **imgs)
        got = regen_render(table, 3, 0, **args)
        exp = regen_render_plain(table, 3, 0, **args)
        worst["K1"] = max(worst["K1"], compare(f"K1 {case}", got, exp, spp1))

    n5 = BVH_TWIN_SIZE
    cfg5 = dataclasses.replace(sphere["cfg"], width=n5, height=n5,
                               spp_per_step=BVH_TWIN_SPP)
    cases = {
        "checker": (tex["buffers"], tex["dw"], cfg5),
        "sun nee": (env_buffers(sphere["buffers"], sun), sphere["dw"],
                    dataclasses.replace(cfg5, **NEE_FLAGS)),
        "sun 2048 nee": (env_buffers(sphere["buffers"], big_env("sun")),
                         sphere["dw"], dataclasses.replace(cfg5, **NEE_FLAGS)),
    }
    for case, (buffers, dw, cfg) in cases.items():
        args = dict(cfg=cfg, global_shape=(n5, n5), npix=n5 * n5,
                    **k5_images(buffers, cfg, dw))
        got = bvh_regen_render(dw, 3, 0, **args)
        exp = bvh_regen_render_plain(dw, 3, 0, **args)
        worst["K5"] = max(worst["K5"], compare(
            f"K5 {case}", got, exp, BVH_TWIN_SPP, K5_TWIN_REL_RMSE))

    size = CROSS_SIZE
    one = dataclasses.replace(tex["cfg"], width=size, height=size,
                              spp_per_step=1, stream_tris=False)
    camera, bounce = capture_waves(one, tex, (0, 1))
    for label, rays in (("tex camera", camera), ("tex bounce", bounce)):
        check(rays.shape == (7, size * size), f"wave {rays.shape}")
        worst["K3"] = max(worst["K3"], compare_trace(
            "K3", label, tex["dw"], one.t_min, rays))
        worst["K6"] = max(worst["K6"], compare_k6(label, tex["dw"], one.t_min,
                                                  rays))

    for h, w in FETCH_SIZES:
        env = random_env(h, w, seed=h)
        d = random_dirs(FETCH_N, seed=w)
        got = envfetch.env_fetch(env, d)
        exp = envfetch.env_fetch_plain(env, d)
        err = float((got - exp).abs().max())
        limit = 3e-5 * float(env.tr.max())
        eq = float((got == exp).all(0).float().mean())
        print(f"  P3 {h}x{w}: {FETCH_N} directions, max abs {err:.3e} "
              f"(limit {limit:.3e}), bitwise equal on {eq:.6f}")
        check(err < limit, f"P3 {h}x{w} max abs {err} past {limit}")
        worst["P3"] = max(worst["P3"], err)
        if (h, w) in ABLATE_SIZES:
            half = envfetch.half_map(env)
            for mode in envfetch.ABLATIONS:
                g_m = envfetch.env_fetch_ablate(env, d, mode, half)
                e_m = envfetch.env_fetch_plain(env, d, mode, half)
                err_m = float((g_m - e_m).abs().max())
                eq_m = float((g_m == e_m).all(0).float().mean())
                print(f"  P4 {mode:6s} {h}x{w}: max abs {err_m:.3e}, bitwise "
                      f"equal on {eq_m:.6f}")
                check(err_m < limit, f"P4 {mode} {h}x{w} max abs {err_m}")
                worst["P4"] = max(worst["P4"], err_m)
                if mode == "full":
                    check(torch.equal(g_m, got), "P4 full is not P3")
                if mode == "half":
                    rel = float(((g_m - got).abs() / got.abs().clamp_min(
                        1e-6)).max())
                    print(f"  P4 half vs full: max relative {rel:.3e}")
                    check(rel < 1e-3, f"P4 half off full by {rel}")

    for n_lat in BRUTE_LATS:
        buffers = upload(sphere_mesh(n_lat=n_lat, n_lon=n_lat, bump=0.3),
                         device=DEVICE)
        nb = BRUTE_SIZE
        cfg = dataclasses.replace(sphere["cfg"], width=nb, height=nb,
                                  spp_per_step=BRUTE_SPP,
                                  spp_chunk=BRUTE_SPP)
        table = scene_table(buffers)
        args = dict(cfg=cfg, num_tris=buffers.num_tris, global_shape=(nb, nb),
                    npix=nb * nb, has_mirrors=False)
        tile = build.table_plan(buffers.num_tris)[0]
        label = f"{buffers.num_tris} tris ({'tiled' if tile else 'opt-in'})"
        worst["K1"] = max(worst["K1"], compare(
            f"K1 {label}", regen_render(table, 3, 0, **args),
            regen_render_plain(table, 3, 0, **args), BRUTE_SPP))
        got = [c.reshape(BRUTE_SPP, -1).sum(0)
               for c in wave_render(table, 3, 0, 0, **args)]
        exp = [c.reshape(BRUTE_SPP, -1).sum(0)
               for c in wave_render_plain(table, 3, 0, 0, **args)]
        worst["K2"] = max(worst["K2"], compare(f"K2 {label}", got, exp,
                                               BRUTE_SPP))
    return worst


def env_main_path_phase(tmp, sphere, tex, maps):
    """Phase 26: the CLI with --env-map on the Cornell Box (K1) and on the
    100k sphere (K5), and bench.py's four env/texture rows at their own
    shape (K5)."""
    from sfvp_tpu_torch import RenderConfig, cli, init_state
    from sfvp_tpu_torch.config import CameraConfig
    from sfvp_tpu_torch.dispatch import select_render_step

    phase(f"env/tex main path: cli --env-map on the Cornell Box at {MAIN_W}x"
          f"{MAIN_H}, {MAIN_SPP} spp, {ENV_MAIN_STEPS} steps, with and "
          f"without --nee --mis --rr (K1); cli --scene sphere --scene-tris "
          f"{SPHERE_TRIS} --nee --mis --env-map at {BVH_W}x{BVH_H}, {BVH_SPP} "
          f"spp (K5); bench.py's tex/env rows at {BENCH_SIZE}x{BENCH_SIZE}, "
          f"8 spp (K5)")
    sky, sun = maps["sky_path"], maps["sun_path"]
    runs = {}
    for name, extra in (("cli_env", []),
                        ("cli_env_nee", ["--nee", "--mis", "--rr"])):
        reset_counts()
        out, log = os.path.join(tmp, f"{name}.png"), os.path.join(
            tmp, f"{name}.jsonl")
        rc = cli.main(["--device", DEVICE, "--width", str(MAIN_W), "--height",
                       str(MAIN_H), "--spp", str(MAIN_SPP), "--max-depth",
                       str(MAIN_DEPTH), "--steps", str(ENV_MAIN_STEPS),
                       "--env-map", sky, *extra, "--out", out, "--log", log,
                       "--quiet"])
        runs[name] = read_counts()
        check(rc == 0, f"cli returned {rc}")
        print(f"  {name}: launches {runs[name]}")
        check(runs[name] == only(K1=ENV_MAIN_STEPS),
              f"{name} launches {runs[name]}")
        recs = [json.loads(x) for x in open(log).read().splitlines()]
        check(len(recs) == ENV_MAIN_STEPS, f"{len(recs)} log records")
        print_steps(recs)
        check_image(name, _read_png(out), MAIN_H, MAIN_W)

    reset_counts()
    setup, recs, img = run_cli(tmp, "sphere_env", [
        "--scene", "sphere", "--scene-tris", str(SPHERE_TRIS), *NEE_CLI,
        "--env-map", sun, "--spp", str(BVH_SPP), "--width", str(BVH_W),
        "--height", str(BVH_H), "--steps", str(ENV_MAIN_STEPS)])
    runs["cli_sphere_env"] = read_counts()
    print(f"  launches: {runs['cli_sphere_env']}")
    check(runs["cli_sphere_env"] == only(K5=ENV_MAIN_STEPS),
          f"cli sphere env launches {runs['cli_sphere_env']}")
    print_steps(recs)
    check_image("K5 sphere env", img, BVH_H, BVH_W)

    cam = CameraConfig.look_at(origin=(0.0, 2.2, 5.0), target=(0.0, 0.0, 0.0),
                               fov_y_deg=50.0)
    gi = dict(width=BENCH_SIZE, height=BENCH_SIZE, spp_per_step=8,
              max_depth=8, sampling="cosine", camera=cam,
              sky_emission=(0.8, 0.85, 1.0))
    nee = dict(use_nee=True, use_mis=True, use_rr=True)
    sun_table = maps["sun"]
    rows = {
        "tex_100k_512": (tex, tex["buffers"], RenderConfig(**gi,
                                                           spp_chunk=8)),
        "env_nee_100k_512": (sphere, env_buffers(sphere["buffers"],
                                                 sun_table),
                             RenderConfig(**gi, **nee)),
        "env_big2048_100k_512": (sphere, env_buffers(sphere["buffers"],
                                                     big_env("ramp")),
                                 RenderConfig(**gi)),
        "env_big2048_nee_100k_512": (sphere, env_buffers(
            sphere["buffers"], big_env("sun")), RenderConfig(**gi, **nee)),
    }
    bench = {}
    for name, (s, buffers, cfg) in rows.items():
        step = select_render_step(cfg, buffers, wide=s["wide"])
        reset_counts()
        st = step(init_state(BENCH_SIZE, BENCH_SIZE, DEVICE))  # warm-up
        times = []
        for _ in range(BENCH_STEPS):
            m0 = float(st.mrays)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = step(st)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0, float(st.mrays) - m0))
        runs[name] = read_counts()
        check(runs[name] == only(K5=BENCH_STEPS + 1),
              f"{name} launches {runs[name]}")
        check_image(name, st.accum.cpu().numpy(), BENCH_SIZE, BENCH_SIZE)
        bench[name] = [(dt * 1e3, mr / dt) for dt, mr in times]
        print(f"  {name}: launches {runs[name]}; steps "
              + ", ".join(f"{ms:.3f} ms ({mr:.2f} Mrays/s)"
                          for ms, mr in bench[name]))
    return runs, bench, rows


def env_wavefront_phase(sphere, tex, maps):
    """Phase 27: one wavefront step over K3 (and K4) with textures and with
    the sun under NEE + MIS, held to K5's image of the same step; and the
    textured sphere's own route, K6 (its tree with the vt rows is past
    sfvp_tpu's streaming threshold)."""
    from sfvp_tpu_torch import init_state
    from sfvp_tpu_torch.dispatch import select_render_step, stream_tris

    per_step = BVH_SPP * BVH_DEPTH
    phase(f"env/tex wavefront: one step at {BVH_W}x{BVH_H}, {BVH_SPP} spp, "
          f"depth {BVH_DEPTH}, megakernel_regen=False, over K3 (textured; "
          f"sun + NEE + MIS with K4) and K6 (textured, streamed), each "
          f"against K5's step")
    runs = {}
    cases = {
        "wavefront_tex_k3": (tex, tex["buffers"], dict(stream_tris=False),
                             dict(K3=per_step)),
        "wavefront_tex_k6": (tex, tex["buffers"], dict(stream_tris=True),
                             dict(K6=per_step)),
        "wavefront_sun_k3k4": (sphere, env_buffers(
            sphere["buffers"], maps["sun"]), dict(NEE_FLAGS),
            dict(K3=per_step, K4=per_step)),
    }
    print(f"  textured sphere streamed by default: "
          f"{stream_tris(tex['cfg'], tex['wide'])}")
    for name, (s, buffers, kw, kernels) in cases.items():
        cfg = dataclasses.replace(s["cfg"], **kw)
        wf = select_render_step(dataclasses.replace(
            cfg, megakernel_regen=False), buffers, wide=s["wide"])
        k5 = select_render_step(cfg, buffers, wide=s["wide"])
        reset_counts()
        a = wf(init_state(BVH_H, BVH_W, DEVICE))
        torch.cuda.synchronize()
        runs[name] = read_counts()
        check(runs[name] == only(**kernels), f"{name} launches {runs[name]}")
        b = k5(init_state(BVH_H, BVH_W, DEVICE))
        rel = rel_rmse(a.accum, b.accum)
        seg_a, seg_b = (round(float(x) * 1e6) for x in (a.mrays, b.mrays))
        print(f"  {name}: launches {runs[name]}; against K5: rel_rmse "
              f"{rel:.3e}, segments {seg_a} vs {seg_b}")
        check(rel <= WF_K5_REL_RMSE and seg_a == seg_b,
              f"{name} against K5: rel_rmse {rel}, segments {seg_a} vs "
              f"{seg_b}")
    return runs


def env_timing_phase(sphere, tex, rows, maps):
    """Phase 28: K1 per env Cornell step (with and without NEE), K5 per
    step of each bench row, K3 per textured first-bounce launch, P3 per
    1M-direction launch and P4 per variant, CUDA events, each beside its
    twin and its bound."""
    from sfvp_tpu_torch import RenderConfig
    from sfvp_tpu_torch.kernels import envfetch
    from sfvp_tpu_torch.kernels.bvh_packet import packet_trace, packet_trace_plain
    from sfvp_tpu_torch.kernels.megakernel_bvh import (
        bvh_regen_render, bvh_regen_render_plain)
    from sfvp_tpu_torch.kernels.megakernel_regen import (
        regen_render, regen_render_plain)

    phase(f"env/tex times and twin checks: K1 per env Cornell step "
          f"({MAIN_W}x{MAIN_H}, {MAIN_SPP} spp), K5 per bench row step, K3 "
          f"per textured first-bounce launch, P3 per {FETCH_N}-direction "
          "launch, P4 per variant, CUDA events")
    times, worst = {}, {"K1": 0.0, "K5": 0.0, "K3": 0.0}
    sky = maps["sky"]
    for name, kw in (("K1 env", {}), ("K1 env nee", NEE_FLAGS)):
        buffers = env_buffers(cornell_buffers(DEVICE), sky)
        cfg = RenderConfig(width=MAIN_W, height=MAIN_H, spp_per_step=MAIN_SPP,
                           max_depth=MAIN_DEPTH, **kw)
        table, imgs = k1_images(buffers, cfg)
        args = dict(cfg=cfg, global_shape=(MAIN_H, MAIN_W),
                    npix=MAIN_W * MAIN_H, **imgs)
        ms, got = cuda_ms(lambda: regen_render(table, 1, 0, **args), 5)
        counts = {}
        plain, exp = cuda_ms(lambda: regen_render_plain(
            table, 1, 0, counts=counts, **args), 1, warm=False)
        worst["K1"] = max(worst["K1"], compare(name, got, exp, MAIN_SPP))
        segs = int(exp[3].sum(dtype=torch.int64))
        # every segment tests all triangles, every shadow ray until its
        # first hit; the env fetch is left out of the count (a lower
        # bound); bytes: the tables and the map once, the outputs once
        ops = (segs * (buffers.num_tris * TRI_OPS_TABLE + SHADE_OPS)
               + counts.get("shadow_tests", 0) * TRI_OPS_TABLE
               + counts.get("shadow_rays", 0) * NEE_OPS)
        nbytes = (table.numel() * 4 + env_nbytes(imgs)
                  + MAIN_W * MAIN_H * 16)
        times[name] = (ms, plain) + bound(ops, nbytes)
        print(f"  {name}: kernel {ms:.3f} ms/step, twin {plain:.1f} ms; "
              f"{segs} segments, {counts}; bound {times[name][2]:.3f} ms "
              f"({times[name][3]})")

    npix = BENCH_SIZE * BENCH_SIZE
    for name, (s, buffers, cfg) in rows.items():
        dw = s["dw"]
        args = dict(cfg=cfg, global_shape=(BENCH_SIZE, BENCH_SIZE),
                    npix=npix, **k5_images(buffers, cfg, dw))
        ms, got = cuda_ms(lambda: bvh_regen_render(dw, 1, 0, **args), 5)
        counts = {}
        plain, exp = cuda_ms(lambda: bvh_regen_render_plain(
            dw, 1, 0, counts=counts, **args), 1, warm=False)
        worst["K5"] = max(worst["K5"], compare(
            f"K5 {name}", got, exp, 8, K5_TWIN_REL_RMSE))
        segs = int(exp[3].sum(dtype=torch.int64))
        ops = traversal_ops(counts) + segs * SHADE_OPS
        if "shadow_node_pops" in counts:
            ops += (walk_ops(counts["shadow_node_pops"],
                             counts["shadow_leaf_pops"], sort=False)
                    + counts["shadow_rays"] * NEE_OPS)
        # misses read the map (segments that did not hit), env NEE samples
        # do (shadow rays of the env sample are among the shadow rays)
        ops += (segs - counts["hits"]) * ENV_FETCH_OPS
        nbytes = tree_nbytes(s["wide"]) + env_nbytes(args) + npix * 16
        if s["wide"].tris_aux is not None:
            nbytes += s["wide"].tris_aux.nbytes
        times[name] = (ms, plain) + bound(ops, nbytes)
        print(f"  K5 {name}: kernel {ms:.3f} ms/step, twin {plain:.1f} ms; "
              f"{segs} segments; bound {times[name][2]:.3f} ms "
              f"({times[name][3]})")

    one = dataclasses.replace(tex["cfg"], spp_per_step=1, stream_tris=False)
    first = capture_waves(one, tex, (0,))[0]
    dw = tex["dw"]
    ms, got = cuda_ms(lambda: packet_trace(dw, one.t_min, first), 20)
    counts = {}
    plain, exp = cuda_ms(lambda: packet_trace_plain(dw, one.t_min, first,
                                                    counts), 1, warm=False)
    worst["K3"] = compare_trace("K3", "tex first", dw, one.t_min, first,
                                got=got, exp=exp)
    b = bound(traversal_ops(counts),
              tree_nbytes(tex["wide"]) + tex["wide"].tris_aux.nbytes
              + first.shape[1] * (7 + 22) * 4)
    times["K3 tex"] = (ms, plain) + b
    print(f"  K3 textured first bounce: kernel {ms:.3f} ms/launch, twin "
          f"{plain:.1f} ms; bound {b[0]:.3f} ms ({b[1]})")

    for h, w in FETCH_SIZES:
        env = random_env(h, w, seed=h)
        d = random_dirs(FETCH_N, seed=w)
        call, _ = cuda_ms(lambda: envfetch.env_fetch(env, d), 20)
        ms = queued_ms(lambda: envfetch.env_fetch(env, d), 20)
        plain, _ = cuda_ms(lambda: envfetch.env_fetch_plain(env, d), 3)
        b = bound(FETCH_N * ENV_FETCH_OPS, 24 * FETCH_N + 12 * h * w)
        times[f"P3 {h}x{w}"] = (ms, plain) + b
        print(f"  P3 {h}x{w}: kernel {ms:.4f} ms/launch queued, {call:.4f} "
              f"ms a call at the host's pace; twin {plain:.3f} ms; bound "
              f"{b[0]:.4f} ms ({b[1]})")
        if (h, w) in ABLATE_SIZES:
            half = envfetch.half_map(env)
            for mode, ops, texel_bytes in (
                    ("trig", ENV_TRIG_OPS, 0), ("noread", ENV_NOREAD_OPS, 0),
                    ("half", ENV_FETCH_OPS, 6 * h * w),
                    ("full", ENV_FETCH_OPS, 12 * h * w)):
                ms = queued_ms(lambda: envfetch.env_fetch_ablate(
                    env, d, mode, half), 20)
                plain, _ = cuda_ms(lambda: envfetch.env_fetch_plain(
                    env, d, mode, half), 3)
                b = bound(FETCH_N * ops, 24 * FETCH_N + texel_bytes)
                times[f"P4 {mode} {h}x{w}"] = (ms, plain) + b
                print(f"  P4 {mode:6s} {h}x{w}: kernel {ms:.4f} ms/launch "
                      f"queued, twin {plain:.3f} ms; bound {b[0]:.4f} ms "
                      f"({b[1]})")
    return times, worst

def material_ops(counts, cfg, npix):
    """FP32 operations of the material and lens work a twin counted: a GGX
    hit builds its frame, bounces, and evaluates its brdf once a light
    sample (area lights, and the environment under env NEE); a dielectric
    hit bounces; with an open lens every camera ray passes it."""
    samples = int(cfg.use_nee)
    ops = (counts.get("glossy_hits", 0)
           * (GGX_FRAME_OPS + GGX_BOUNCE_OPS
              + samples * (GGX_FRAME_OPS + GGX_EVAL_OPS))
           + counts.get("diel_hits", 0) * DIEL_OPS)
    if cfg.camera.lens_radius > 0:
        ops += npix * cfg.spp_per_step * LENS_OPS
    return ops


def glossy_city_setup(frac, width):
    """bench.py's glossy city at emissive fraction ``frac``, its camera and
    sky, cosine + RR + NEE, ``width``^2 at MAT_SPP spp, on the card with
    its wide BVH (the native SAH) and light table."""
    from sfvp_tpu_torch import CameraConfig, RenderConfig, upload
    from sfvp_tpu_torch.accel.wide import build_wide_from_buffers
    from sfvp_tpu_torch.integrate.lights import build_light_table_from_buffers
    from sfvp_tpu_torch.kernels.bvh_packet import device_wide
    from sfvp_tpu_torch.scene.procedural import city_mesh

    scene = city_mesh(**GLOSSY_CITY, emissive_frac=frac)
    cfg = RenderConfig(width=width, height=width, spp_per_step=MAT_SPP,
                       max_depth=BVH_DEPTH, camera=CameraConfig.look_at(
                           **CITY_VIEW), sky_emission=(0.8, 0.85, 1.0),
                       **MAT_FLAGS)
    buffers = upload(scene, device=DEVICE)
    t0 = time.perf_counter()
    wide = build_wide_from_buffers(buffers)
    lights = build_light_table_from_buffers(buffers)
    glossy = int((buffers.mtype == 2).sum())
    print(f"  glossy city (emissive_frac {frac}): {buffers.num_tris} "
          f"triangles ({glossy} GGX, {lights.num} emissive), wide BVH "
          f"{wide.nodes.shape[0]} nodes + {wide.tris.shape[0]} leaf rows, "
          f"built in {time.perf_counter() - t0:.2f} s")
    return dict(scene=scene, cfg=cfg, buffers=buffers, wide=wide,
                dw=device_wide(wide, DEVICE), lights=lights)


def glass_cornell(tmp):
    """The Cornell Box as an OBJ whose short box is glass (GLASS_MTL), and
    the focal distance of its back wall along the reference camera's
    view axis."""
    from sfvp_tpu_torch import CameraConfig, cornell_box_path, load_obj

    src = cornell_box_path()
    mtl = open(src[:-3] + "mtl").read()
    head = "newmtl shortBox\n"
    check(head in mtl, "the bundled Cornell Box changed")
    i = mtl.index(head) + len(head)
    j = mtl.index("newmtl", i)
    with open(os.path.join(tmp, "CornellBox-Original.mtl"), "w") as f:
        f.write(mtl[:i] + GLASS_MTL + "\n" + mtl[j:])
    path = os.path.join(tmp, "glass.obj")
    with open(path, "w") as f:
        f.write(open(src).read())
    s = load_obj(path)
    names = [s.material_names[k] for k in s.face_material_id]
    back = np.asarray([n == "backWall" for n in names])
    cam = CameraConfig()
    fwd = np.subtract(cam.center, cam.origin)
    fwd = fwd / np.linalg.norm(fwd)
    depth = float(((s.triangles()[back].reshape(-1, 3) - cam.origin)
                   @ fwd).mean())
    check(int((s.face_mat_type == 3).sum()) > 0, "no glass face")
    print(f"  glass Cornell: {int((s.face_mat_type == 3).sum())} glass "
          f"faces, the back wall {depth:.4f} along the view axis")
    return path, depth


def glass_setup(tmp):
    from sfvp_tpu_torch import CameraConfig, RenderConfig, load_obj, upload

    path, focus = glass_cornell(tmp)
    cam = dataclasses.replace(CameraConfig(), lens_radius=GLASS_LENS_RADIUS,
                              focus_dist=focus)
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, spp_per_step=MAIN_SPP,
                       max_depth=MAIN_DEPTH, camera=cam)
    return dict(path=path, focus=focus, cfg=cfg,
                buffers=upload(load_obj(path), device=DEVICE))


def glossy_field_setup():
    """The instanced field of FIELD_TRIS with its first ball mesh GGX
    (roughness 0.3, Ks 0.85) and its second glass (IOR 1.5), and the lamp
    of the lit field, cosine + RR + NEE + MIS (LIT_FLAGS)."""
    from sfvp_tpu_torch import RenderConfig
    from sfvp_tpu_torch.accel.instances import Instance
    from sfvp_tpu_torch.cli import procedural_scene

    insts, cfg = procedural_scene("instanced", FIELD_TRIS, RenderConfig(
        width=BVH_W, height=BVH_H, spp_per_step=BVH_SPP, max_depth=BVH_DEPTH,
        **LIT_FLAGS))
    meshes = {}
    for inst in insts[1:]:
        s = inst.scene
        if id(s) not in meshes:
            t, glass = s.num_triangles, len(meshes) == 1
            meshes[id(s)] = dataclasses.replace(
                s, face_mat_type=np.full(t, 3 if glass else 2, np.int32),
                face_rough=np.full(t, 0.125 if glass else 0.3, np.float32),
                face_specular=np.full((t, 3), 1.0 if glass else 0.85,
                                      np.float32))
    insts = ([insts[0]] + [dataclasses.replace(i, scene=meshes[id(i.scene)])
                           for i in insts[1:]] + [Instance(scene=lamp_scene())])
    g = two_level_setup("glossy field", insts, cfg)
    print(f"  glossy field: {int((g['flat'].mtype == 2).sum())} GGX and "
          f"{int((g['flat'].mtype == 3).sum())} glass triangles")
    return g


def mat_twin_phase(city, glass, field):
    """Phase 29: K5 on the glossy city, K1 on the glass Cornell through
    the thin lens (and K5 on it with traversal="bvh"), K9 on the glossy lit
    field, each against its twin on the card, the material and lens code
    running."""
    from sfvp_tpu_torch.accel.wide import build_wide_from_buffers
    from sfvp_tpu_torch.integrate.lights import build_light_table_from_buffers
    from sfvp_tpu_torch.integrate.wavefront import material_flags
    from sfvp_tpu_torch.kernels.bvh_packet import device_wide
    from sfvp_tpu_torch.kernels.megakernel import scene_table
    from sfvp_tpu_torch.kernels.megakernel_bvh import (
        bvh_regen_render, bvh_regen_render_plain, tlas_regen_render)
    from sfvp_tpu_torch.kernels.megakernel_regen import (
        regen_render, regen_render_plain)

    n, m = NEE_TWIN_SIZE, BVH_TWIN_SIZE
    phase(f"mat twins: K5 on the glossy city at {n}x{n}, {MAT_SPP} spp; K1 "
          f"on the glass Cornell through the lens at {n}x{n}, {NEE_TWIN_SPP} "
          f"spp, parity and cosine + RR + NEE + MIS, K5 on it at {m}x{m}; "
          f"K9 on the glossy field at {m}x{m}, {EARLY_TWIN_SPP} spp")
    worst = {"K1": 0.0, "K5": 0.0, "K9": 0.0}
    args = dict(cfg=dataclasses.replace(city["cfg"], width=n, height=n),
                global_shape=(n, n), npix=n * n, has_mirrors=False,
                lights=city["lights"], **material_flags(city["buffers"]))
    worst["K5"] = compare("K5 glossy city", bvh_regen_render(
        city["dw"], 3, 0, **args), bvh_regen_render_plain(
        city["dw"], 3, 0, **args), MAT_SPP, K5_TWIN_REL_RMSE)

    buffers = glass["buffers"]
    table = scene_table(buffers)
    mats = material_flags(buffers)
    lights = build_light_table_from_buffers(buffers)
    dw = device_wide(build_wide_from_buffers(buffers), DEVICE)
    for case, kw in (("parity", {}), ("nee", NEE_FLAGS)):
        cfg = dataclasses.replace(glass["cfg"], **kw)
        for kernel, w, spp in (("K1", n, NEE_TWIN_SPP), ("K5", m, BVH_TWIN_SPP)):
            args = dict(cfg=dataclasses.replace(cfg, width=w, height=w,
                                                spp_per_step=spp),
                        global_shape=(w, w), npix=w * w, has_mirrors=False,
                        lights=lights if cfg.use_nee else None, **mats)
            if kernel == "K1":
                args["num_tris"] = buffers.num_tris
                got = regen_render(table, 3, 0, **args)
                exp = regen_render_plain(table, 3, 0, **args)
            else:
                got = bvh_regen_render(dw, 3, 0, **args)
                exp = bvh_regen_render_plain(dw, 3, 0, **args)
            worst[kernel] = max(worst[kernel], compare(
                f"{kernel} glass DOF {case}", got, exp, spp,
                K5_TWIN_REL_RMSE))

    worst["K1"] = max(worst["K1"], brute_material_twins())

    args = dict(cfg=dataclasses.replace(field["cfg"], width=m, height=m,
                                        spp_per_step=EARLY_TWIN_SPP),
                global_shape=(m, m), npix=m * m, has_mirrors=False,
                lights=field["lights"], **material_flags(field["flat"]))
    worst["K9"] = compare("K9 glossy field", tlas_regen_render(
        field["dt"], 3, 0, **args), bvh_regen_render_plain(
        field["dt"], 3, 0, **args), EARLY_TWIN_SPP, K5_TWIN_REL_RMSE)
    return worst


def brute_material_twins():
    """K1 past 480 triangles with materials and the lens: spheres of
    BRUTE_LATS rings (2,964 triangles, the table in opted-in shared
    memory; 5,100, in tiles) whose faces are in turn diffuse, GGX
    (roughness 0.3), glass and mirror, through a lens focused on the
    sphere, at BRUTE_SIZE^2, BRUTE_SPP spp; returns the largest absolute
    difference."""
    from sfvp_tpu_torch import CameraConfig, RenderConfig
    from sfvp_tpu_torch.kernels import build
    from sfvp_tpu_torch.kernels.megakernel import scene_table
    from sfvp_tpu_torch.kernels.megakernel_regen import (
        regen_render, regen_render_plain)
    from sfvp_tpu_torch.scene import from_arrays
    from sfvp_tpu_torch.scene.procedural import sphere_mesh

    worst, nb = 0.0, BRUTE_SIZE
    cam = dataclasses.replace(CameraConfig.look_at(
        origin=(0.0, 2.2, 5.0), target=(0.0, 0.0, 0.0), fov_y_deg=50.0),
        lens_radius=GLASS_LENS_RADIUS, focus_dist=float(np.hypot(2.2, 5.0)))
    cfg = RenderConfig(width=nb, height=nb, spp_per_step=BRUTE_SPP,
                       max_depth=BVH_DEPTH, sampling="cosine", use_rr=True,
                       camera=cam, sky_emission=(0.8, 0.85, 1.0))
    for n_lat in BRUTE_LATS:
        s = sphere_mesh(n_lat=n_lat, n_lon=n_lat, bump=0.3)
        t = s.num_triangles
        mt = (np.arange(t) % 4).astype(np.int32)
        rough = np.where(mt == 2, 0.3, np.where(mt == 3, 0.125, 0.0))
        spec = np.repeat(np.where(mt > 0, 0.9, 0.0)[:, None], 3,
                         axis=1).astype(np.float32)
        buffers = from_arrays(s.triangles(), s.face_diffuse, s.face_emission,
                              spec, mt, rough.astype(np.float32),
                              device=DEVICE)
        table = scene_table(buffers)
        args = dict(cfg=cfg, num_tris=t, global_shape=(nb, nb), npix=nb * nb,
                    has_mirrors=True, has_glossy=True, has_diel=True)
        tile = build.table_plan(t)[0]
        worst = max(worst, compare(
            f"K1 materials + lens, {t} tris ({'tiled' if tile else 'opt-in'})",
            regen_render(table, 3, 0, **args),
            regen_render_plain(table, 3, 0, **args), BRUTE_SPP))
    return worst


def mat_main_path_phase(tmp, city, city2048, glass, field):
    """Phase 30: the entry points a user calls with materials and the
    lens, each between zeroed and read launch counts: the CLI on the glass
    Cornell through the lens (K1 only); the Renderer on the glossy city at
    both of bench.py's shapes (K5 only), on the glossy field (K9 only),
    and with megakernel_regen=False on the glossy city at MAT_LOOP_SIZE^2
    (K3 and K4 only; its image equal to K5's step there)."""
    from sfvp_tpu_torch import Renderer, cli, init_state
    from sfvp_tpu_torch.dispatch import select_render_step

    phase(f"mat main path: cli --obj glass.obj --lens-radius "
          f"{GLASS_LENS_RADIUS} --focus-dist <back wall> at {MAIN_W}x"
          f"{MAIN_H}, {MAIN_SPP} spp (K1); the glossy city at {MAT_W}x{MAT_W} "
          f"and {CITY2048_W}x{CITY2048_W}, {MAT_SPP} spp, cosine + RR + NEE "
          f"(K5), the loop over K3 + K4 at {MAT_LOOP_SIZE}x{MAT_LOOP_SIZE}; "
          f"the glossy field at {BVH_W}x{BVH_H}, {BVH_SPP} spp (K9)")
    runs = {}
    reset_counts()
    argv = ["--obj", glass["path"], "--lens-radius", str(GLASS_LENS_RADIUS),
            "--focus-dist", repr(glass["focus"]), "--width", str(MAIN_W),
            "--height", str(MAIN_H), "--spp", str(MAIN_SPP),
            "--max-depth", str(MAIN_DEPTH), "--steps", "2", "--quiet"]
    out, log = os.path.join(tmp, "glass.png"), os.path.join(tmp,
                                                            "glass.jsonl")
    check(cli.main(["--device", DEVICE, *argv, "--out", out,
                    "--log", log]) == 0, "the glass cli run failed")
    torch.cuda.synchronize()
    runs["cli_glass"] = read_counts()
    check(runs["cli_glass"] == only(K1=2), f"cli glass launches "
                                           f"{runs['cli_glass']}")
    print_steps([json.loads(x) for x in open(log).read().splitlines()])
    check_image("glass Cornell", _read_png(out), MAIN_H, MAIN_W)

    for name, s, kernels in (
            ("renderer_city648", city, dict(K5=2)),
            ("renderer_city2048", city2048, dict(K5=2)),
            ("renderer_glossy_field", field, dict(K9=2))):
        scene = s["insts"] if "insts" in s else s["scene"]
        r = Renderer(s["cfg"], scene, DEVICE)
        reset_counts()
        recs = []
        for _ in range(2):
            t0 = time.perf_counter()
            r.step(1)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            recs.append(ms)
        runs[name] = read_counts()
        check(runs[name] == only(**kernels), f"{name} launches {runs[name]}")
        h, w = s["cfg"].height, s["cfg"].width
        segs = float(r.state.mrays) * 1e6 / 2
        print(f"  {name}: set-up {r.bvh_build_s:.3f} s; step ms "
              + ", ".join(f"{x:.3f}" for x in recs)
              + f"; {segs / (recs[-1] * 1e3):.1f} Mrays/s")
        img = r.state.accum.cpu().numpy()
        check_image(name, np.clip(img, 0.0, 1.0), h, w)
        del r

    n = MAT_LOOP_SIZE
    cfg = dataclasses.replace(city["cfg"], width=n, height=n)
    wf = select_render_step(dataclasses.replace(cfg, megakernel_regen=False),
                            city["buffers"], wide=city["wide"])
    k5 = select_render_step(cfg, city["buffers"], wide=city["wide"])
    reset_counts()
    a = wf(init_state(n, n, DEVICE))
    torch.cuda.synchronize()
    runs["renderer_city_k3k4"] = read_counts()
    per_step = MAT_SPP * BVH_DEPTH
    check(runs["renderer_city_k3k4"] == only(K3=per_step, K4=per_step),
          f"glossy city loop launches {runs['renderer_city_k3k4']}")
    b = k5(init_state(n, n, DEVICE))
    rel = rel_rmse(a.accum, b.accum)
    seg_a, seg_b = (round(float(x) * 1e6) for x in (a.mrays, b.mrays))
    print(f"  glossy city loop over K3 + K4 against K5's step: rel_rmse "
          f"{rel:.3e}, segments {seg_a} vs {seg_b}")
    check(rel <= WF_K5_REL_RMSE and seg_a == seg_b,
          f"the glossy city loop against K5: rel_rmse {rel}, segments "
          f"{seg_a} vs {seg_b}")
    return runs


def mat_timing_phase(city, city2048, glass, field):
    """Phase 31: K5 per glossy-city step at both shapes, K1 per glass +
    lens Cornell step, K9 per glossy lit-field step, CUDA events, each
    held to its twin (K9's at FIELD_MAT_TWIN^2, FIELD_MAT_TWIN_SPP spp;
    its timed step at the full shape to the loop over K7 + K8, within the
    twin bounds) and beside its bound (K9's from its twin's counts,
    scaled to the full step)."""
    from sfvp_tpu_torch import init_state
    from sfvp_tpu_torch.dispatch import select_instanced_render_step
    from sfvp_tpu_torch.integrate.lights import build_light_table_from_buffers
    from sfvp_tpu_torch.integrate.wavefront import accumulate, material_flags
    from sfvp_tpu_torch.kernels.megakernel import scene_table
    from sfvp_tpu_torch.kernels.megakernel_bvh import (
        bvh_regen_render, bvh_regen_render_plain, tlas_regen_render)
    from sfvp_tpu_torch.kernels.megakernel_regen import (
        regen_render, regen_render_plain)

    phase("mat times and twin checks (the glossy city at both shapes, the "
          "glass Cornell through the lens at the main path's, the glossy "
          f"lit field at {FIELD_MAT_TWIN}x{FIELD_MAT_TWIN}), CUDA events")
    times, worst = {}, {"K1": 0.0, "K5": 0.0, "K9": 0.0}
    for name, s in (("glossy city 648", city), ("glossy city 2048",
                                                city2048)):
        cfg = s["cfg"]
        npix = cfg.width * cfg.height
        args = dict(cfg=cfg, global_shape=(cfg.height, cfg.width), npix=npix,
                    has_mirrors=False, lights=s["lights"],
                    **material_flags(s["buffers"]))
        ms, got = cuda_ms(lambda: bvh_regen_render(s["dw"], 1, 0, **args), 5)
        counts = {}
        plain, exp = cuda_ms(lambda: bvh_regen_render_plain(
            s["dw"], 1, 0, counts=counts, **args), 1, warm=False)
        worst["K5"] = max(worst["K5"], compare(
            f"K5 {name}", got, exp, MAT_SPP, K5_TWIN_REL_RMSE))
        segs = int(exp[3].sum(dtype=torch.int64))
        ops = (traversal_ops(counts) + segs * SHADE_OPS
               + traversal_ops(counts, "shadow_", sort=False)
               + counts["shadow_rays"] * NEE_OPS
               + material_ops(counts, cfg, npix))
        nbytes = tree_nbytes(s["wide"]) + s["lights"].rows.numel() * 4 + (
            npix * 16)
        times[f"K5 {name}"] = (ms, plain) + bound(ops, nbytes)
        print(f"  K5 {name}: kernel {ms:.3f} ms/step, twin {plain:.1f} ms; "
              f"{segs} segments ({segs / (ms * 1e3):.1f} Mrays/s), "
              f"{counts['glossy_hits']} on the GGX ground, "
              f"{counts['shadow_rays']} shadow rays; bound "
              f"{times[f'K5 {name}'][2]:.3f} ms ({times[f'K5 {name}'][3]})")

    buffers = glass["buffers"]
    table = scene_table(buffers)
    cfg = glass["cfg"]
    npix = MAIN_W * MAIN_H
    args = dict(cfg=cfg, num_tris=buffers.num_tris,
                global_shape=(MAIN_H, MAIN_W), npix=npix, has_mirrors=False,
                **material_flags(buffers))
    ms, got = cuda_ms(lambda: regen_render(table, 1, 0, **args), 5)
    counts = {}
    plain, exp = cuda_ms(lambda: regen_render_plain(
        table, 1, 0, counts=counts, **args), 1, warm=False)
    worst["K1"] = compare("K1 glass DOF main", got, exp, MAIN_SPP)
    segs = int(exp[3].sum(dtype=torch.int64))
    ops = (segs * (buffers.num_tris * TRI_OPS_TABLE + SHADE_OPS)
           + material_ops(counts, cfg, npix))
    times["K1 glass dof"] = (ms, plain) + bound(
        ops, table.numel() * 4 + npix * 16)
    print(f"  K1 glass + lens: kernel {ms:.3f} ms/step, twin {plain:.1f} ms; "
          f"{segs} segments ({segs / (ms * 1e3):.1f} Mrays/s), "
          f"{counts['diel_hits']} on glass; bound "
          f"{times['K1 glass dof'][2]:.3f} ms ({times['K1 glass dof'][3]})")

    cfg = field["cfg"]
    npix = BVH_W * BVH_H
    mats = material_flags(field["flat"])
    args = dict(cfg=cfg, global_shape=(BVH_H, BVH_W), npix=npix,
                has_mirrors=False, lights=field["lights"], **mats)
    ms, full = cuda_ms(lambda: tlas_regen_render(field["dt"], 1, 0, **args),
                       5)
    # the timed step's own output against the loop over K7 + K8 at the same
    # shape and seed (the twin's 16x the work would take minutes)
    def first_step():
        return init_state(BVH_H, BVH_W, DEVICE)._replace(frame=1)

    k9 = accumulate(first_step(), full[:-1],
                    full[-1].sum(dtype=torch.int64), cfg.spp_per_step)
    wf = select_instanced_render_step(
        dataclasses.replace(cfg, megakernel_regen=False), field["flat"],
        field["tl"])(first_step())
    compare_images(f"K9 glossy field at {BVH_W}x{BVH_H}, {BVH_SPP} spp vs "
                   "the loop over K7 + K8", k9.accum, wf.accum, k9.mrays,
                   wf.mrays)
    del k9, wf, full
    n, spp = FIELD_MAT_TWIN, FIELD_MAT_TWIN_SPP
    small = dict(args, cfg=dataclasses.replace(cfg, width=n, height=n,
                                               spp_per_step=spp),
                 global_shape=(n, n), npix=n * n)
    got = tlas_regen_render(field["dt"], 1, 0, **small)
    counts = {}
    plain, exp = cuda_ms(lambda: bvh_regen_render_plain(
        field["dt"], 1, 0, counts=counts, **small), 1, warm=False)
    worst["K9"] = compare("K9 glossy field", got, exp, spp, K5_TWIN_REL_RMSE)
    # the bound of the full step from the twin's counts at n^2, spp: the
    # counts scale with the paths traced, (BVH_W / n)^2 * BVH_SPP / spp
    scale = npix * BVH_SPP / (n * n * spp)
    segs = int(exp[3].sum(dtype=torch.int64))
    ops = scale * (traversal_ops(counts) + counts["hits"] * WORLD_OPS
                   + segs * SHADE_OPS
                   + traversal_ops(counts, "shadow_", sort=False)
                   + counts["shadow_rays"] * NEE_OPS
                   + material_ops(counts, small["cfg"], n * n))
    nbytes = (two_level_nbytes(field["tl"]) + field["lights"].rows.numel() * 4
              + npix * 16)
    times["K9 glossy field"] = (ms, plain) + bound(ops, nbytes)
    print(f"  K9 glossy lit field: kernel {ms:.3f} ms/step; twin {plain:.1f} "
          f"ms at {n}x{n}, {spp} spp; {counts['glossy_hits']} GGX and "
          f"{counts['diel_hits']} glass hits there; bound "
          f"{times['K9 glossy field'][2]:.3f} ms "
          f"({times['K9 glossy field'][3]}, the counts scaled by {scale:g})")
    return times, worst


def probe_phase():
    """Phase 32: P2's five modes over an (P2_ROWS, 128) table and P5, each
    held bitwise to its twin, then timed queued behind a sleeping kernel
    (one thread's serial chain: a latency probe); ns per iteration and
    each mode less base."""
    from sfvp_tpu_torch.kernels import leafprobe

    phase(f"leaf-row probes: P2 over a ({P2_ROWS}, 128) table, bitwise over "
          f"{P2_CHECK_ITERS} iterations ({', '.join(P2_CHAIN_MODES)}: over "
          f"{P2_FINITE_ITERS}), timed over {P2_ITERS}; P5")
    rows_cpu = torch.from_numpy(
        np.random.default_rng(7).random((P2_ROWS, 128), np.float32))
    rows = rows_cpu.to(DEVICE)
    times, worst, ns, checked = {}, {}, {}, {}
    for mode in leafprobe.MODES:
        worst[mode], plain = 0.0, 0.0
        checked[mode] = (P2_FINITE_ITERS if mode in P2_CHAIN_MODES
                         else (P2_CHECK_ITERS,))
        for iters in checked[mode]:
            got = leafprobe.leaf_probe(rows, iters, mode).cpu()
            t0 = time.perf_counter()
            exp = leafprobe.leaf_probe_plain(rows_cpu, iters, mode)
            plain = (time.perf_counter() - t0) * 1e3
            check(bool(torch.isfinite(exp).all()),
                  f"P2 {mode} over {iters}: the twin's result is not finite")
            check(torch.equal(got, exp), f"P2 {mode} over {iters} disagrees "
                                         f"with its twin: {float(got[0, 0])} "
                                         f"vs {float(exp[0, 0])}")
            worst[mode] = max(worst[mode],
                              float((got - exp).abs().max()))
        ms = queued_ms(lambda: leafprobe.leaf_probe(rows, P2_ITERS, mode),
                       P2_REPS)
        ns[mode] = ms * 1e6 / P2_ITERS
        # bytes: the rows the loop reads (none in base; two staged rows in
        # smemload), the (8, 128) output; operations: 127 adds a row, and
        # base's and dmaonly's 128 constant adds
        reads = {"base": 0, "smemload": 2 * 512}.get(mode, P2_ITERS * 512)
        ops = P2_ITERS * (255 if mode in ("base", "dmaonly") else 128)
        times[mode] = (ms, plain) + bound(ops, reads + 8 * 128 * 4)
        print(f"  P2 {mode}: bitwise over {checked[mode]} iterations (max "
              f"abs {worst[mode]}); {ms:.4f} ms a launch of {P2_ITERS} "
              f"iterations, {ns[mode]:.2f} ns/iteration; twin {plain:.1f} ms "
              f"over {checked[mode][-1]}; bound {times[mode][2]:.5f} ms "
              f"({times[mode][3]})")
    for mode in leafprobe.MODES[1:]:
        print(f"  P2 {mode} - base: {ns[mode] - ns['base']:.2f} ns/iteration")
    x_cpu = torch.arange(16 * 128, dtype=torch.float32).reshape(16, 128)
    x = x_cpu.to(DEVICE)
    got = leafprobe.smem_dma(x).cpu()
    t0 = time.perf_counter()
    exp = leafprobe.smem_dma_plain(x_cpu)
    plain = (time.perf_counter() - t0) * 1e3
    want = float((np.arange(128, dtype=np.float32) + 128.0)[
        np.arange(8) * 16].sum())
    check(torch.equal(got, exp) and float(got[0, 0]) == want,
          f"P5 read {float(got[0, 0])}, want {want}")
    worst["P5"] = float((got - exp).abs().max())
    ms = queued_ms(lambda: leafprobe.smem_dma(x), P2_REPS)
    times["P5"] = (ms, plain) + bound(8 * 16, 512 + 8 * 128 * 4)
    print(f"  P5: {float(got[0, 0])} == {want}; {ms:.4f} ms a launch; "
          f"bound {times['P5'][2]:.6f} ms ({times['P5'][3]})")
    return times, worst, ns


# ---- slice 8: the probes P1 and P6, the profiler ----

def check_variant(label, variant, out, cnt, s_out, s_cnt, k3):
    """Hold a P1 variant's run on a full wave, which has no twin run, to
    stripped's on the same wave and to K3's: packed pushes what stripped
    pushes in the same order (the same bits and counts); packed_center,
    pushall_center and no_sortnet walk in another order to the same hits
    (hit or miss as stripped, t as K3's on K3_SAME_TRI of the rays);
    no_leaf tests no triangle (t inf everywhere) and prunes nothing (no
    packet pops fewer rows than stripped's)."""
    if variant == "packed":
        ok = (torch.equal(out.view(torch.int32), s_out.view(torch.int32))
              and torch.equal(cnt, s_cnt))
        what = "the same (t, u, v) bits and counts as stripped"
    elif variant == "no_leaf":
        finite, short = int(torch.isfinite(out[0]).sum()), int(
            (cnt < s_cnt).sum())
        ok = finite == 0 and short == 0
        what = (f"t finite on {finite} rays, {short} packets popping fewer "
                "rows than stripped's")
    else:
        apart = int((torch.isinf(out[0]) != torch.isinf(s_out[0])).sum())
        same_t = float(((out[0] == k3[0]) | (torch.isinf(out[0])
                                             & torch.isinf(k3[0])))
                       .float().mean())
        ok = apart == 0 and same_t >= K3_SAME_TRI
        what = (f"hit or miss apart from stripped's on {apart} rays, t as "
                f"K3's on {same_t:.6f} of the rays")
    print(f"  P1 {variant} {label}: {what}")
    check(ok, f"P1 {variant} on the {label} wave: {what}")


def stripped_phase(big, twin_waves, waves, k6_times):
    """Phase 33: P1's six variants held bitwise (planes and per-packet
    counts) to their twins on phase 21's 64x64 camera and bounce waves,
    stripped also on the 1M-ray first-bounce wave; stripped's hits held to
    K3's on the four full waves of phase 24, and each other variant to
    stripped's and K3's there (``check_variant``); every variant timed on
    those waves beside K6 and K3 (CUDA events), and K6 split by their
    differences."""
    from sfvp_tpu_torch.kernels.bvh_packet import packet_trace
    from sfvp_tpu_torch.kernels.bvh_packet2 import packet_trace2
    from sfvp_tpu_torch.kernels.stripped_trace import (
        VARIANTS, stripped_trace, stripped_trace_plain)

    phase(f"p1: the stripped packet walk's {len(VARIANTS)} variants against "
          f"their twins on {K6_TWIN_SIZE}^2-ray camera and bounce waves of "
          f"the {BIG_TRIS // 1000}k sphere, stripped on its {BVH_W}x{BVH_H} "
          "first-bounce wave; each timed on phase 24's four waves beside K6 "
          "and K3")
    cfg, dw = big["cfg"], big["dw"]
    t_min = cfg.t_min
    plain, worst = {}, 0.0
    # the twins walk the 64x64 waves faster on the host CPU (equal bits),
    # but for pushall_center's whole-tree test of every row (on the card)
    dw_cpu = host_copy(dw)

    def abs_err(got, exp):
        return float(torch.where(got == exp, 0.0, (got - exp).abs()).max())

    for variant in VARIANTS:
        for label, rays in twin_waves.items():
            got, cnt = stripped_trace(dw, t_min, rays, variant)
            on_card = variant in P1_SLOW
            t0 = time.perf_counter()
            exp, ecnt = stripped_trace_plain(
                dw if on_card else dw_cpu, t_min,
                rays if on_card else rays.cpu(), variant)
            exp, ecnt = exp.to(got.device), ecnt.to(got.device)
            ms = (time.perf_counter() - t0) * 1e3
            plain[f"{variant} {label}"] = ms
            apart = int((got != exp).any(0).sum())
            worst = max(worst, abs_err(got, exp))
            print(f"  P1 {variant} {label}: {rays.shape[1]} rays, "
                  f"{int(torch.isfinite(exp[0]).sum())} hits, pops "
                  f"{ecnt.tolist()}; {apart} rays apart, counts equal "
                  f"{torch.equal(cnt, ecnt)}; twin {ms:.1f} ms (host "
                  f"clock, {'card' if on_card else 'host CPU'})")
            check(apart == 0 and torch.equal(cnt, ecnt),
                  f"P1 {variant} {label} disagrees with its twin: {apart} "
                  f"rays, counts {cnt.tolist()} vs {ecnt.tolist()}")
    rays = waves["first bounce"]
    got, cnt = stripped_trace(dw, t_min, rays)
    counts = {}
    plain_first, (exp, ecnt) = cuda_ms(lambda: stripped_trace_plain(
        dw, t_min, rays, counts=counts), 1, warm=False)
    apart = int((got != exp).any(0).sum())
    worst = max(worst, abs_err(got, exp))
    print(f"  P1 stripped first bounce: {rays.shape[1]} rays, {apart} rays "
          f"apart from the twin, counts equal {torch.equal(cnt, ecnt)}; "
          f"twin {plain_first:.1f} ms, pops {counts}")
    check(apart == 0 and torch.equal(cnt, ecnt),
          f"P1 stripped on the first-bounce wave disagrees with its twin: "
          f"{apart} rays")
    nbytes = tree_nbytes(big["wide"]) + rays.shape[1] * (7 + 3) * 4
    union = bound(packet_ops(counts), nbytes)
    times, report = {}, {}
    for label, rays in waves.items():
        k6_ms, _ = cuda_ms(lambda: packet_trace2(dw, t_min, rays), P1_REPS)
        k3_ms, k3 = cuda_ms(lambda: packet_trace(dw, t_min, rays), P1_REPS)
        b3 = k6_times[label if label != "third bounce"
                      else "third bounce unsorted"]["K3"][2:4]
        k6_longest = k6_times[label]["K6 longest packet"]
        row = {"K6_ms": k6_ms, "K3_ms": k3_ms, "bound_ms": b3[0],
               "K6_longest_packet": k6_longest,
               "K6_ns_per_iteration": k6_ms * 1e6 / k6_longest}
        for variant in VARIANTS:
            slow = variant in P1_SLOW
            ms, (out, cnt) = cuda_ms(lambda: stripped_trace(
                dw, t_min, rays, variant), 1 if slow else P1_REPS,
                warm=not slow)
            pops = cnt.to(torch.int64)
            longest = int(pops.max())
            row[variant] = {"ms": ms, "pops_sum": int(pops.sum()),
                            "pops_max": longest,
                            "ns_per_iteration": ms * 1e6 / longest}
            print(f"  P1 {label:21s} {variant:14s} {ms:9.3f} ms; pops sum "
                  f"{int(pops.sum())}, longest packet {longest}: "
                  f"{ms * 1e6 / longest:.1f} ns an iteration")
            if variant != "stripped":
                check_variant(label, variant, out, cnt, s_out, s_cnt, k3)
                continue
            s_out, s_cnt = out, cnt
            # K3's t, u, v are the same bits where the triangle is the same
            t_apart = torch.nonzero(out[0] != k3[0]).squeeze(1)
            miss = torch.isinf(out[0]) & torch.isinf(k3[0])
            same = float((miss | (out == k3[:3]).all(0)).float().mean())
            row["t_apart_from_K3"] = int(t_apart.numel())
            row["same_hit_as_K3"] = same
            shown = [(int(i), float(out[0, i]), float(k3[0, i]))
                     for i in t_apart[:5]]
            print(f"  P1 stripped {label}: t apart from K3's on "
                  f"{t_apart.numel()} rays (ray, t, K3's t: {shown}); the "
                  f"same (t, u, v) as K3 on {same:.6f} of the rays")
            check(same >= K3_SAME_TRI, f"P1 stripped and K3 {label}: the "
                                       f"same hit on {same}")
            times[label] = (ms, plain_first if label == "first bounce"
                            else None) + tuple(b3)
        s = row["stripped"]["ms"]
        print(f"  P1 {label}: ns an iteration of the longest packet: K6 "
              f"{row['K6_ns_per_iteration']:.1f} ({k6_longest} iterations), "
              f"stripped {row['stripped']['ns_per_iteration']:.1f} "
              f"({row['stripped']['pops_max']} pops)")
        row["split"] = {
            "K6 - stripped (the leaf queue, rows in shared memory)":
                k6_ms - s,
            "stripped - no_sortnet (thread 0's network)":
                s - row["no_sortnet"]["ms"],
            "stripped - packed_center (the key's block minimum)":
                s - row["packed_center"]["ms"],
            "stripped / K3 (packet against per-ray)": s / k3_ms}
        print(f"  P1 {label}: K6 {k6_ms:.3f} ms, K3 {k3_ms:.3f} ms, bound "
              f"{b3[0]:.4f} ms; " + "; ".join(
                  f"{k} {v:.3f}" for k, v in row["split"].items()))
        report[label] = row
    return times, worst, {"per_wave": report,
                          "union_walk_bound_ms": union[0],
                          "plain_ms_64x64": plain}


def iter_cost_phase(p2_ns):
    """Phase 34: P6's ten variants held to their twins (bit for bit, NaN
    for NaN) at 1, 5, 15 and 2,000 iterations from the probe's zero state
    and from a nonzero one, over the probe's (16384, 128) normal table;
    timed over 20,000 iterations queued behind a sleeping kernel; ns per
    iteration beside P2's base."""
    from sfvp_tpu_torch.kernels import itercost

    phase(f"p6: the walk-loop iteration probe's {len(itercost.VARIANTS)} "
          f"variants, held to their twins at {P6_CHECK_ITERS} iterations "
          f"from a zero and a nonzero state, timed over {P6_ITERS} (queued)")
    table_cpu = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8 * P6_ROWS, 128)).astype(np.float32))
    acc_cpu = torch.from_numpy(np.random.default_rng(5).normal(
        size=(8, 128)).astype(np.float32))
    table, acc = table_cpu.to(DEVICE), acc_cpu.to(DEVICE)
    times, ns, worst = {}, {}, 0.0
    for variant in itercost.VARIANTS:
        plain = 0.0
        for iters in P6_CHECK_ITERS:
            for a_dev, a_cpu in ((None, None), (acc, acc_cpu)):
                got = itercost.iter_cost(table, variant, iters, a_dev).cpu()
                t0 = time.perf_counter()
                exp = itercost.iter_cost_plain(table_cpu, variant, iters,
                                               a_cpu)
                if a_cpu is None:
                    plain = (time.perf_counter() - t0) * 1e3
                nan = torch.isnan(exp)
                check(torch.equal(torch.isnan(got), nan) and torch.equal(
                    got[~nan].view(torch.int32), exp[~nan].view(torch.int32)),
                    f"P6 {variant} over {iters} iterations "
                    f"({'zero' if a_cpu is None else 'nonzero'} state) "
                    "disagrees with its twin")
                same = (got == exp) | (nan & torch.isnan(got))
                worst = max(worst, float(torch.where(
                    same, 0.0, (got - exp).abs()).max()))
        ms = queued_ms(lambda: itercost.iter_cost(table, variant, P6_ITERS),
                       P6_REPS)
        ns[variant] = ms * 1e6 / P6_ITERS
        ops, nbytes = iter_cost_work(variant, P6_ITERS, P6_ROWS)
        times[variant] = (ms, plain) + bound(ops, nbytes)
        print(f"  P6 {variant:15s} equal to its twin; {ms:.4f} ms a launch "
              f"of {P6_ITERS}, {ns[variant]:.2f} ns an iteration (P2 base "
              f"{p2_ns['base']:.2f}, extract {p2_ns['extract']:.2f}); twin "
              f"{plain:.1f} ms over {P6_CHECK_ITERS[-1]}; bound "
              f"{times[variant][2]:.6f} ms ({times[variant][3]}: {ops} "
              f"operations, {nbytes} bytes)")
    return times, ns, worst


# P6's lanes of a row that each body reads (csrc/iter_cost.cu): v4 reads
# lanes 0..5 of 8 rows, the others lanes 0..n-1 of one row
P6_LANES = {"v0_loop": 128, "v1_scalars48": 48, "v2_scalars128": 128,
            "v3_slice_bcast": 48, "v4_rowslice8": 8 * 6, "v5_cond": 128,
            "v6_reduce16": 128, "v7_when8": 8, "v8_sortnet": 16, "v9": 128}
# FP32 operations of an iteration on the (8, 128) state (E elements):
# what the function needs once, not the kernel's repeats (v1's sum in
# every thread, v6's 8 equal reductions)
P6_OPS = {"v0_loop": (1, 0), "v1_scalars48": (1, 48),
          "v2_scalars128": (1, 128), "v3_slice_bcast": (2 * 48, 0),
          # the state's max; 3 slab pairs of 2 subtracts, 2 multiplies, a
          # min, a max and 3 for tf; the test and select; a row min and sum;
          # two adds
          "v4_rowslice8": (1 + 3 * 9 + 2 + 2 + 2, 0),
          "v5_cond": (2, 0),
          # multiply, test, select; one min and one any; the add; 8 x 2
          # scalar adds
          "v6_reduce16": (6, 16),
          # 8 tests and 8 adds of thread 0, the add
          "v7_when8": (1, 16),
          # 19 comparators of a test and 4 selects, 16 adds; two adds
          "v8_sortnet": (2, 19 * 5 + 16),
          # multiply, test, select, a row min and max, two adds
          "v9": (7, 0)}


def iter_cost_work(variant, iters, m):
    """(FP32 operations, bytes) of P6's ``variant`` over ``iters``
    iterations of an (8 m, 128) table: the lanes its body reads of the
    distinct rows the run pops (row max(i % m, 0) of i = iters .. 1), each
    read once; the initial state read, the state written, and the output
    buffer v4 reads as its rays."""
    rows = len({max(i % m, 0) for i in range(1, iters + 1)})
    state = 8 * 128 * 4
    nbytes = rows * P6_LANES[variant] * 4 + 2 * state
    if variant == "v4_rowslice8":
        nbytes += state
    per_elem, scalar = P6_OPS[variant]
    return iters * (per_elem * 8 * 128 + scalar), nbytes


def device_activity(trace_path):
    """The card's activity in a Chrome trace: its busy microseconds (the
    union of its kernel, copy and set intervals), their number, each
    name's (microseconds, count), largest first, and the spans left out,
    by category. A span counts only if the card ran it: a kernel, copy or
    set category, a stream and a launch's correlation id in its args, and
    no operator's name (``aten::``), so no operator's span that wraps its
    kernels is counted beside them."""
    kept, dropped = [], {}
    with open(trace_path) as f:
        for e in json.load(f)["traceEvents"]:
            if "dur" not in e:
                continue
            args = e.get("args") or {}
            if (e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                    and "stream" in args and "correlation" in args
                    and not e["name"].startswith("aten::")):
                kept.append(e)
            else:
                cat = str(e.get("cat"))
                dropped[cat] = dropped.get(cat, 0) + 1
    events = kept
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        us, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (us + e["dur"], n + 1)
    return (busy, len(events),
            sorted(by_name.items(), key=lambda kv: -kv[1][0]), dropped)


def profiler_phase(tmp, r500, sphere):
    """Phase 35: torch.profiler (utils/profiling.py profile_trace) around
    steady wavefront steps: the Renderer's over K6 on the 500k sphere and
    over K3 on the 100k sphere; the kernels that took the card's time, by
    name, and the card's busy and idle share of the traced window (host
    clock), all read from the Chrome trace the profiler writes."""
    from sfvp_tpu_torch import Renderer
    from sfvp_tpu_torch.utils.profiling import profile_trace

    phase(f"profiler: torch.profiler around {PROFILE_STEPS} steady "
          f"wavefront steps over K6 ({BIG_TRIS // 1000}k sphere) and over "
          f"K3 ({SPHERE_TRIS // 1000}k sphere) at {BVH_W}x{BVH_H}, "
          f"{BVH_SPP} spp")
    cfg = dataclasses.replace(sphere["cfg"], megakernel_regen=False)
    report = {}
    for name, r in (("K6 route, 500k sphere", r500),
                    ("K3 route, 100k sphere", Renderer(cfg, sphere["scene"],
                                                       DEVICE))):
        r.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) * 1e3
        log_dir = os.path.join(tmp, name.split(",")[0].replace(" ", "_"))
        t_trace = time.perf_counter()
        with profile_trace(log_dir):
            t0 = time.perf_counter()
            r.step(PROFILE_STEPS)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        t_trace = time.perf_counter() - t_trace
        busy_us, n_spans, by_name, dropped = device_activity(
            os.path.join(log_dir, "trace.json"))
        device_us = sum(us for us, _ in dict(by_name).values())
        check(busy_us > 0, f"{name}: torch.profiler recorded no device time")
        print(f"  {name}: spans left out of the card's time, by category: "
              f"{dict(sorted(dropped.items()))}")
        top = [(key, n, us / 1e3) for key, (us, n) in by_name[:PROFILE_TOP]]
        report[name] = {
            "step_ms_unprofiled": bare_ms, "steps": PROFILE_STEPS,
            "window_ms": window_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / window_us,
            "device_idle_share": 1.0 - busy_us / window_us,
            "device_kernels_ms": device_us / 1e3, "device_spans": n_spans,
            "spans_left_out": dropped,
            "trace_s": t_trace, "top_device_ops": top}
        print(f"  {name}: an unprofiled step {bare_ms:.2f} ms; "
              f"{PROFILE_STEPS} profiled steps {window_us / 1e3:.2f} ms, the "
              f"card busy {busy_us / 1e3:.2f} ms of it "
              f"({busy_us / window_us:.1%}, idle "
              f"{1.0 - busy_us / window_us:.1%}) in {n_spans} kernels and "
              f"copies; the trace and its export took {t_trace:.1f} s; top "
              "kernels and copies (ms, calls, name):")
        for key, count, ms in top:
            print(f"    {ms:10.3f} ms {count:6d}x {key[:100]}")
    return report


def env_nbytes(args):
    """Bytes of a render's environment map, its distribution and its
    texture pool, each read once."""
    n = 0
    for t in (args.get("env"), args.get("textures")):
        if t is not None:
            n += sum(a.numel() * 4 for a in t.tensors)
    dist = args.get("env_dist")
    if dist is not None:
        n += (dist.cdf.numel() + dist.pdf_flat.numel()) * 4
    return n


def sub_entry(per, launches, worst, times):
    """A further run of a kernel in the report: (per, launches, worst,
    times) as a dict."""
    ms, plain, bound_ms, bound_by = times
    return {"per": per, "launches": launches, "max_abs_err": worst,
            "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by}


def kernel_entry(name, source, replaces, per, launches, worst, times,
                 nee=None, **more):
    """One kernel of the report; ``nee``: (per, launches, worst, times) of
    its run under next-event estimation, where it has one; ``more``: other
    runs by name, as (per, launches, worst, times) too."""
    ms, plain, bound_ms, bound_by = times
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches, "max_abs_err": worst,
             "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None, "per": per}
    if nee is not None:
        entry["nee"] = sub_entry(*nee)
    for key, run in more.items():
        entry[key] = run if isinstance(run, dict) else sub_entry(*run)
    return entry


def main() -> int:
    card = device_phase()
    sphere, city = build_phase()
    worst = twin_phase()
    oracle_phase(False)
    with tempfile.TemporaryDirectory() as tmp:
        launches, _ = main_path_phase(tmp)
    times, worst_main = timing_phase()
    worst = {k: max(worst[k], worst_main[k]) for k in worst}
    ptxas = single_level_ptxas()

    worst.update(bvh_twin_phase(sphere))
    oracle_phase(True)
    k5_vs_k1_phase()
    with tempfile.TemporaryDirectory() as tmp:
        bvh_runs = bvh_main_path_phase(tmp)
    bvh_times, bvh_worst = bvh_timing_phase(sphere)
    times.update(bvh_times)
    worst = {k: max(worst[k], bvh_worst.get(k, 0.0)) for k in worst}
    big_worst, big = big_sphere_phase(sphere)
    worst["K5"] = max(worst["K5"], big_worst)
    sort_phase(sphere)

    check(city["lights"] is not None, "the city has no emissive triangle")
    nee_worst = nee_twin_phase(city)
    nee_oracle_phase()
    k5_vs_k1_phase(nee=True)
    with tempfile.TemporaryDirectory() as tmp:
        nee_runs = nee_main_path_phase(tmp)
    nee_times, nee_main_worst = nee_timing_phase(city)
    nee_worst = {k: max(v, nee_main_worst[k]) for k, v in nee_worst.items()}

    phase(f"tlas set-up: the {FIELD_TRIS // 1000}k instanced field and the "
          "lit field")
    field, lit = field_setup()
    tlas_worst = tlas_twin_phase(field, lit)
    tlas_cross_phase(field)
    with tempfile.TemporaryDirectory() as tmp:
        tlas_runs = tlas_main_path_phase(tmp, field, lit)
    tlas_times, tlas_main_worst = tlas_timing_phase(field, lit)
    tlas_worst = {k: max(v, tlas_main_worst[k]) for k, v in tlas_worst.items()}
    del field, lit

    k6_worst, k6_twin_waves = k6_twin_phase(big, city)
    adaptive_cross_phase(big, city)
    with tempfile.TemporaryDirectory() as tmp:
        k6_runs, r500 = adaptive_main_path_phase(tmp, city)
    k6_times, k6_time_worst, k6_waves = k6_timing_phase(big)
    p1_times, p1_worst, p1_report = stripped_phase(big, k6_twin_waves,
                                                   k6_waves, k6_times)
    del k6_twin_waves, k6_waves
    with tempfile.TemporaryDirectory() as tmp:
        profile_report = profiler_phase(tmp, r500, sphere)
    del big, city, r500

    with tempfile.TemporaryDirectory() as tmp:
        phase("env/tex set-up: the sky and sun maps, the textured "
              f"{SPHERE_TRIS // 1000}k sphere")
        maps = env_maps(tmp)
        tex = textured_setup(sphere, tmp)
        env_worst = env_twin_phase(sphere, tex, maps, tmp)
        env_runs, bench, rows = env_main_path_phase(tmp, sphere, tex, maps)
        env_runs.update(env_wavefront_phase(sphere, tex, maps))
        env_times, env_time_worst = env_timing_phase(sphere, tex, rows, maps)
    for k, v in env_time_worst.items():
        env_worst[k] = max(env_worst[k], v)
    worst = {k: max(v, env_worst.get(k, 0.0)) for k, v in worst.items()}
    for name, steps in bench.items():
        print(f"  bench row {name}: step ms "
              + ", ".join(f"{ms:.3f}" for ms, _ in steps) + "; Mrays/s "
              + ", ".join(f"{mr:.3f}" for _, mr in steps))

    with tempfile.TemporaryDirectory() as tmp:
        phase("mat set-up: bench.py's glossy city at both emissive "
              "fractions, the glass Cornell, the glossy field")
        city = glossy_city_setup(CITY648_FRAC, MAT_W)
        city2048 = glossy_city_setup(CITY2048_FRAC, CITY2048_W)
        glass = glass_setup(tmp)
        gfield = glossy_field_setup()
        mat_worst = mat_twin_phase(city, glass, gfield)
        mat_runs = mat_main_path_phase(tmp, city, city2048, glass, gfield)
        mat_times, mat_time_worst = mat_timing_phase(city, city2048, glass,
                                                     gfield)
        del city, city2048, glass, gfield
    mat_worst = {k: max(v, mat_time_worst[k]) for k, v in mat_worst.items()}
    probe_times, probe_worst, probe_ns = probe_phase()
    probe_launches = {k: sum(r[k] for r in mat_runs.values())
                      for k in ("P2", "P5")}
    p6_times, p6_ns, p6_worst = iter_cost_phase(probe_ns)
    # P1 and P6 run on no render path: their launches over every run of the
    # main paths, which only() holds to 0
    every_run = [launches, *bvh_runs.values(), *nee_runs.values(),
                 *tlas_runs.values(), *k6_runs.values(), *env_runs.values(),
                 *mat_runs.values()]
    probe_launches.update({k: sum(r[k] for r in every_run)
                           for k in ("P1", "P6")})

    env_launches = {k: sum(env_runs[r][k] for r in (
        "cli_env", "cli_env_nee", "cli_sphere_env", *rows)) for k in (
        "P3", "P4")}
    step = f"step ({MAIN_W}x{MAIN_H}, {MAIN_SPP} spp, Cornell)"
    city_step = (f"step ({BVH_W}x{BVH_H}, {BVH_SPP} spp, city, cosine + RR "
                 "+ NEE + MIS)")
    field_step = (f"step ({BVH_W}x{BVH_H}, {BVH_SPP} spp, "
                  f"{FIELD_TRIS // 1000}k instanced field, cosine)")
    lit_step = (f"step ({BVH_W}x{BVH_H}, {BVH_SPP} spp, lit "
                f"{FIELD_TRIS // 1000}k instanced field, cosine + RR + NEE + "
                "MIS)")
    field_wave = f"launch on the {BVH_W}x{BVH_H} first-bounce"
    report = {"kernels": [
        kernel_entry("regen_render (K1)", "sfvp_tpu_torch/csrc/regen_render.cu",
                     "sfvp_tpu/kernels/megakernel_regen.py:1137", step,
                     launches["K1"], worst["K1"], times["K1"],
                     nee=(f"{step[:-1]}, cosine + RR + NEE + MIS)",
                          nee_runs["cli_cornell"]["K1"], nee_worst["K1"],
                          nee_times["K1"]),
                     env=(f"{step[:-1]}, sky map)",
                          env_runs["cli_env"]["K1"], env_worst["K1"],
                          env_times["K1 env"]),
                     env_nee=(f"{step[:-1]}, sky map, cosine + RR + NEE + "
                              "MIS)", env_runs["cli_env_nee"]["K1"],
                              env_worst["K1"], env_times["K1 env nee"]),
                     glass_dof=(f"{step[:-1]}, glass short box, thin lens "
                                f"{GLASS_LENS_RADIUS})",
                                mat_runs["cli_glass"]["K1"],
                                mat_worst["K1"], mat_times["K1 glass dof"]),
                     ptxas={**ptxas["K1"], **{
                         f"tiled {k}": v
                         for k, v in ptxas["K1 tiled"].items()}}),
        kernel_entry("wave_render (K2)", "sfvp_tpu_torch/csrc/wave_render.cu",
                     "sfvp_tpu/kernels/megakernel.py:366",
                     f"{step}: {MAIN_SPP} launches",
                     launches["K2"], worst["K2"], times["K2"],
                     ptxas={**ptxas["K2"], **{
                         f"tiled {k}": v
                         for k, v in ptxas["K2 tiled"].items()}}),
        kernel_entry("bvh_trace (K3)", "sfvp_tpu_torch/csrc/bvh_trace.cu",
                     "sfvp_tpu/kernels/bvh_packet.py:394",
                     f"launch on the {BVH_W}x{BVH_H} first-bounce wave "
                     f"({SPHERE_TRIS // 1000}k sphere)",
                     bvh_runs["renderer_k3"]["K3"], worst["K3"], times["K3"],
                     textured=(f"launch on the {BVH_W}x{BVH_H} first-bounce "
                               "wave (textured sphere, 22 planes)",
                               env_runs["wavefront_tex_k3"]["K3"],
                               env_worst["K3"], env_times["K3 tex"]),
                     ptxas=ptxas["K3"]),
        kernel_entry("bvh_occlusion (K4)",
                     "sfvp_tpu_torch/csrc/bvh_occlusion.cu",
                     "sfvp_tpu/kernels/bvh_packet.py:635",
                     f"launch on the {BVH_W}x{BVH_H} first-bounce shadow "
                     "wave (city)",
                     nee_runs["renderer_k3k4"]["K4"], nee_worst["K4"],
                     nee_times["K4"], ptxas=ptxas["K4"]),
        kernel_entry("bvh_regen_render (K5)",
                     "sfvp_tpu_torch/csrc/bvh_regen_render.cu",
                     "sfvp_tpu/kernels/megakernel_bvh.py:2326",
                     f"step ({BVH_W}x{BVH_H}, {BVH_SPP} spp, "
                     f"{SPHERE_TRIS // 1000}k sphere)",
                     bvh_runs["cli_100k"]["K5"], worst["K5"], times["K5"],
                     nee=(city_step, nee_runs["cli_city"]["K5"],
                          nee_worst["K5"], nee_times["K5"]),
                     **{name: (f"step ({BENCH_SIZE}x{BENCH_SIZE}, 8 spp, "
                               f"bench.py's {name})", env_runs[name]["K5"]
                               // (BENCH_STEPS + 1),
                               env_worst["K5"], env_times[name])
                        for name in rows},
                     glossy_city_648=(
                         f"step ({MAT_W}x{MAT_W}, {MAT_SPP} spp, bench.py's "
                         "city_648lights: GGX ground, cosine + RR + NEE)",
                         mat_runs["renderer_city648"]["K5"], mat_worst["K5"],
                         mat_times["K5 glossy city 648"]),
                     glossy_city_2048=(
                         f"step ({CITY2048_W}x{CITY2048_W}, {MAT_SPP} spp, "
                         "bench.py's city_sorted_2048)",
                         mat_runs["renderer_city2048"]["K5"],
                         mat_worst["K5"], mat_times["K5 glossy city 2048"]),
                     ptxas=ptxas["K5"]),
        dict(kernel_entry("packet_trace2 (K6)",
                     "sfvp_tpu_torch/csrc/packet_trace2.cu",
                     "sfvp_tpu/kernels/bvh_packet2.py:512",
                     f"launch on the {BVH_W}x{BVH_H} first-bounce wave "
                     f"({BIG_TRIS // 1000}k sphere)",
                     k6_runs["cli_adaptive"]["K6"],
                     max(k6_worst, k6_time_worst, env_worst["K6"]),
                     k6_times["first bounce"]["K6"],
                     third_sorted=(f"launch on the {BVH_W}x{BVH_H} sorted "
                                   "third-bounce wave",
                                   k6_runs["renderer_k6"]["K6"],
                                   k6_time_worst,
                                   k6_times["third bounce"]["K6"]),
                     third_unsorted=(f"launch on the {BVH_W}x{BVH_H} "
                                     "unsorted third-bounce wave",
                                     k6_runs["renderer_k6_unsorted"]["K6"],
                                     k6_time_worst,
                                     k6_times["third bounce unsorted"]["K6"]),
                     adaptive=(f"launch on a {ADAPT_FRAC} adaptive wave "
                               f"({BVH_W}x{BVH_H}, {ADAPT_TILE}^2 tiles)",
                               k6_runs["cli_adaptive"]["K6"], k6_time_worst,
                               k6_times["adaptive"]["K6"])),
             union_walk_bound_ms=k6_times["first bounce"]["K6 union walk"][0],
             ptxas=k6_times["ptxas"], dynamic_smem_bytes=k6_times["smem"],
             **{key: {label.replace(" ", "_"): k6_times[label][name]
                      for label in ("first bounce", "third bounce unsorted",
                                    "third bounce", "adaptive")}
                for key, name in (
                    ("union_walk_bound_ms_by_wave", "K6 union walk"),
                    ("longest_packet_iterations", "K6 longest packet"),
                    ("ns_per_iteration", "K6 ns per iteration"),
                    ("t_apart_from_K3", "K6 t apart from K3"))}),
        kernel_entry("tlas_trace (K7)", "sfvp_tpu_torch/csrc/tlas_trace.cu",
                     "sfvp_tpu/kernels/bvh_tlas.py:403",
                     f"{field_wave} wave (instanced field)",
                     tlas_runs["renderer_k7"]["K7"], tlas_worst["K7"],
                     tlas_times["K7"]),
        kernel_entry("tlas_occlusion (K8)",
                     "sfvp_tpu_torch/csrc/tlas_occlusion.cu",
                     "sfvp_tpu/kernels/bvh_tlas.py:666",
                     f"{field_wave} shadow wave (lit field)",
                     tlas_runs["renderer_k7k8"]["K8"], tlas_worst["K8"],
                     tlas_times["K8"]),
        kernel_entry("tlas_regen_render (K9)",
                     "sfvp_tpu_torch/csrc/bvh_regen_render.cu",
                     "sfvp_tpu/kernels/megakernel_bvh.py:2326", field_step,
                     tlas_runs["cli_field"]["K9"], tlas_worst["K9"],
                     tlas_times["K9 field"],
                     nee=(lit_step, tlas_runs["renderer_lit_k9"]["K9"],
                          tlas_worst["K9"], tlas_times["K9 lit field"]),
                     glossy_field=(
                         f"{lit_step[:-1]}, GGX and glass balls; twin at "
                         f"{FIELD_MAT_TWIN}x{FIELD_MAT_TWIN}, "
                         f"{FIELD_MAT_TWIN_SPP} spp, the step against the "
                         "loop over K7 + K8; bound from the twin's counts "
                         "scaled to the step)",
                         mat_runs["renderer_glossy_field"]["K9"],
                         mat_worst["K9"], mat_times["K9 glossy field"])),
        # the fetch runs inside K1 and K5 on the main path (common.cuh
        # env_lookup): P3's and P4's launches in phase 26's runs, which
        # only() holds to 0
        kernel_entry("env_fetch (P3)", "sfvp_tpu_torch/csrc/env_fetch.cu",
                     "benchmarks/probe_envfetch.py:66",
                     f"launch on {FETCH_N} directions, 2048x1024 map",
                     env_launches["P3"], env_worst["P3"],
                     env_times["P3 1024x2048"],
                     **{f"map_{h}x{w}": (f"launch on {FETCH_N} directions, "
                                         f"{w}x{h} map", env_launches["P3"],
                                         env_worst["P3"],
                                         env_times[f"P3 {h}x{w}"])
                        for h, w in FETCH_SIZES[:-1]}),
        kernel_entry("env_fetch_ablate (P4)",
                     "sfvp_tpu_torch/csrc/env_fetch.cu",
                     "benchmarks/probe_envfetch_ablate.py:111",
                     f"full variant, launch on {FETCH_N} directions, "
                     "2048x1024 map", env_launches["P4"], env_worst["P4"],
                     env_times["P4 full 1024x2048"],
                     **{f"{mode}_{w}x{h}": (
                         f"{mode} variant, {FETCH_N} directions, {w}x{h} "
                         "map", env_launches["P4"], env_worst["P4"],
                         env_times[f"P4 {mode} {h}x{w}"])
                        for h, w in ABLATE_SIZES
                        for mode in ("trig", "noread", "half", "full")
                        if (mode, h) != ("full", 1024)}),
        # the leaf-row probes run on no render path: their launches in
        # phase 30's runs, which only() holds to 0; one thread's serial
        # chain, a latency probe
        dict(kernel_entry(
            "leaf_probe (P2)", "sfvp_tpu_torch/csrc/leaf_probe.cu",
            "benchmarks/micro_leaf_cost.py:98",
            f"extract mode, launch of {P2_ITERS} iterations over a "
            f"({P2_ROWS}, 128) table, one thread (latency probe)",
            probe_launches["P2"], probe_worst["extract"],
            probe_times["extract"],
            **{mode: (f"{mode} mode, launch of {P2_ITERS} iterations",
                      probe_launches["P2"], probe_worst[mode],
                      probe_times[mode])
               for mode in ("base", "smemdma", "smemload", "dmaonly")}),
            plain_per=(f"twin over {P2_CHECK_ITERS} iterations ("
                       f"{' and '.join(P2_CHAIN_MODES)}: over "
                       f"{P2_FINITE_ITERS[-1]}), host CPU"),
            ns_per_iteration=probe_ns,
            minus_base_ns={m: probe_ns[m] - probe_ns["base"]
                           for m in probe_ns if m != "base"}),
        dict(kernel_entry("smem_dma (P5)",
                          "sfvp_tpu_torch/csrc/leaf_probe.cu",
                          "benchmarks/micro_smem_dma.py:38",
                          "launch on a (16, 128) table, one thread",
                          probe_launches["P5"], probe_worst["P5"],
                          probe_times["P5"]),
             plain_per="twin on the host CPU"),
        # P1 runs on no render path; its bound is K3's on the same rays (it
        # computes K3's function), its own union walk's a diagnostic
        dict(kernel_entry(
            "stripped_trace (P1)", "sfvp_tpu_torch/csrc/stripped_trace.cu",
            "benchmarks/probe_carry.py:242",
            f"stripped variant, launch on the {BVH_W}x{BVH_H} first-bounce "
            f"wave ({BIG_TRIS // 1000}k sphere)", probe_launches["P1"],
            p1_worst, p1_times["first bounce"],
            **{label.replace(" ", "_"): (
                f"stripped variant, launch on the {label} wave (no twin "
                "run on it)",
                probe_launches["P1"], p1_worst, times)
               for label, times in p1_times.items()
               if label != "first bounce"}),
            plain_per=f"twin on the {BVH_W}x{BVH_H} first-bounce wave, on "
                      "the card",
            **p1_report),
        dict(kernel_entry(
            "iter_cost (P6)", "sfvp_tpu_torch/csrc/iter_cost.cu",
            "benchmarks/probe_iter_cost.py:142",
            f"v0_loop, launch of {P6_ITERS} iterations, one block (latency "
            "probe)", probe_launches["P6"], p6_worst, p6_times["v0_loop"],
            **{v: (f"{v}, launch of {P6_ITERS} iterations",
                   probe_launches["P6"], p6_worst, p6_times[v])
               for v in p6_times if v != "v0_loop"}),
            plain_per=f"twin over {P6_CHECK_ITERS[-1]} iterations, host CPU",
            ns_per_iteration=p6_ns),
    ], "profiler": profile_report}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
