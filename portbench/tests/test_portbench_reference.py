"""The plain reference against the program's CPU path (the plain twins of
K1 and K5), cell by cell at 24 x 24 and a few samples: a wrong reference
shows here before chip time is spent on it."""

import numpy as np
import pytest
import torch

from portbench import harness, spec
from portbench.reference import tracer
from portbench.tests import small


@pytest.mark.parametrize("cell", small.CELLS)
def test_reference_matches_program(cell):
    result, _ = small.run(cell)
    assert result["correct"]
    assert result["checks"]["rel_rmse"]["value"] <= 1e-6
    assert result["checks"]["frames_missing"]["value"] == 0
    assert result["attempted"] == 3


@pytest.mark.parametrize("cell", small.CELLS)
def test_reference_is_not_trivial(cell):
    """The compared pixels carry light: a reference of zeros would pass
    nothing."""
    c = spec.cell(cell)
    ov = small.overrides(cell)
    if "n_lat" in ov:
        c.config["scene"].update(n_lat=ov["n_lat"], n_lon=ov["n_lon"])
    cfg = harness.render_config(c.config, c.traffic, ov)
    py, px = harness.check_pixels(5, cfg.height, cfg.width, 64)
    acc = harness.reference_accum(c, cfg, px, py, 0, 2, "cpu",
                                  torch.float32).numpy()
    assert np.isfinite(acc).all() and acc.mean() > 1e-3


def test_pcg_matches_the_glsl_recipe():
    """One PCG step and the seed of pixel (3, 5), sample 2, frame 7 at 32
    spp, worked by hand from common.glsl in Python integers."""
    def pcg(s):
        prev = (s * 747796405 + 2891336453) % 2**32
        word = (((prev >> ((prev >> 28) + 4)) ^ prev) * 277803737) % 2**32
        return (word >> 22) ^ word, prev

    s = torch.tensor([123456789], dtype=torch.long)
    assert [int(x) for x in tracer.pcg(s)] == list(pcg(123456789))
    m = 2 + 32 * 7 + 1
    vx, vy = 3 * m, 5 * m
    k, c = 1664525, 1013904223
    vx, vy = (vx * k + c) % 2**32, (vy * k + c) % 2**32
    vx = (vx + vy * k) % 2**32
    vy = (vy + vx * k) % 2**32
    vx, vy = vx ^ (vx >> 16), vy ^ (vy >> 16)
    vx = (vx + vy * k) % 2**32
    vy = (vy + vx * k) % 2**32
    vx, vy = vx ^ (vx >> 16), vy ^ (vy >> 16)
    seed = tracer.sample_seed(torch.tensor([3]), torch.tensor([5]), 2,
                              torch.tensor([7]), 32)
    assert int(seed) == (vx + vy) % 2**32


def test_clustered_closest_hit_equals_every_triangle():
    """The cluster cull changes no answer: closest hits and shadow rays
    over a 1,104-triangle sphere against the same rays over its triangles
    one by one (the dense path)."""
    from portbench import scenes

    tris, kd, ke = scenes.sphere_mesh(24, 24, bump=0.3)
    clustered = tracer.RefScene(tris, kd, ke, "cpu")
    assert clustered.members is not None
    g = torch.Generator().manual_seed(3)
    o = tuple(torch.rand(2000, generator=g) * 6 - 3 for _ in range(3))
    d = tracer.normalize(tuple(torch.randn(2000, generator=g)
                               for _ in range(3)))
    got = clustered.closest_hit(o, d, 0.001, 1e4)
    tm = torch.full((2000,), 2.5)
    occ = clustered.occluded(o, d, 0.001, tm)
    clustered.members = None  # every pair
    want = clustered.closest_hit(o, d, 0.001, 1e4)
    assert (got[0] >= 0).sum() > 100
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(occ, clustered.occluded(o, d, 0.001, tm))
