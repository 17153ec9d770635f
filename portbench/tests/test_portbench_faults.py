"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a one-chip render cell can have, and when the control
(the plain reference in bfloat16) or the half batch takes the program's
place."""

import dataclasses

import pytest
import torch

from portbench import harness, readings, spec
from portbench.tests import small


def unchanged(r):
    """A step that returns its state unchanged."""
    r._step = lambda state, row0=0: state


def half_batch(r):
    """Half of each pixel's samples left out, the mean taken over the
    rest."""
    from sfvp_tpu_torch.dispatch import select_render_step

    cfg = dataclasses.replace(r.cfg, spp_per_step=r.cfg.spp_per_step // 2)
    r._step = select_render_step(cfg, r.buffers, wide=r.wide)


def altered_answer(monkeypatch):
    """Every pixel's red total 1% off where the fused kernel (its twin
    here) produces it."""
    from sfvp_tpu_torch.kernels import megakernel_bvh, megakernel_regen

    for mod, name in ((megakernel_regen, "regen_render"),
                      (megakernel_bvh, "bvh_regen_render")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, **kw):
            r, g, b, segs = _fn(*a, **kw)
            return r * 1.01, g, b, segs

        monkeypatch.setattr(mod, name, wrapped)


@pytest.mark.parametrize("cell", small.CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "altered_answer"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    hook = None
    if fault == "altered_answer":
        altered_answer(monkeypatch)
    else:
        hook = {"unchanged": unchanged, "half_batch": half_batch}[fault]
    result, lines = small.run(cell, fault=hook)
    assert result["correct"] is False, lines


@pytest.mark.parametrize("cell", small.CELLS)
@pytest.mark.parametrize("reading", ["control", "half_batch"])
def test_control_fails_the_limit(cell, reading):
    """The readings the limits are set from, planted in the reference put
    in the program's place, fail them: the control and the half batch."""
    c = spec.cell(cell)
    ov = small.overrides(cell)
    if "n_lat" in ov:
        c.config["scene"].update(n_lat=ov["n_lat"], n_lon=ov["n_lon"])
    cfg = harness.render_config(c.config, c.traffic, ov)
    rel, _, _ = getattr(readings, reading)(c, cfg, 4242, 3,
                                           torch.device("cpu"),
                                           pixels=ov["check_pixels"])
    assert rel > c.frozen["limits"]["rel_rmse"]
