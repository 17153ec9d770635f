"""Adaptive sampling of the port (integrate/adaptive.py) against
tests/test_adaptive.py case by case (the warmup equals the Renderer, K
tiles a step, consistency, the packet path on the bvh route, an
indivisible tile raises, checkpoint resume and refusal), and against
sfvp_tpu's integrate/adaptive.py on the same states: the tile priorities
(within rtol 1e-5: the two frameworks sum the tile means in other orders)
and the tiles they select (exactly, but for a near-tie at the K-th place),
a step of each package from one state (the same pixels, sums within the
framework bound of ROADMAP.md §C), and checkpoints across packages. Then
the instanced adaptive sampler over K7's twin and the CLI's ``--adaptive``
on the CPU.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.integrate import adaptive as ja  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch import cli  # noqa: E402
from sfvp_tpu_torch.accel.wide import build_wide_from_buffers  # noqa: E402
from sfvp_tpu_torch.dispatch import select_wavefront_kwargs  # noqa: E402
from sfvp_tpu_torch.integrate.adaptive import (  # noqa: E402
    AdaptiveRenderer,
    AdaptiveState,
    adaptive_image,
    init_adaptive_state,
    make_adaptive_steps,
    select_tiles,
    tile_pixels,
    tile_priorities,
)

from test_torch_integrator import assert_close  # noqa: E402


@pytest.fixture(scope="module")
def cornell():
    return T.upload(T.load_obj(), device="cpu")


@pytest.fixture(scope="module")
def j_cornell():
    return J.upload(J.load_obj(native="never"))


def _run(step, st, n):
    for _ in range(n):
        st = step(st)
    return st


def test_warmup_matches_uniform_renderer(cornell):
    """Two uniform adaptive steps == two plain render steps (same seeds,
    same running mean, same segments)."""
    cfg = T.RenderConfig(width=32, height=32, spp_per_step=2, max_depth=3)
    uni, _ = make_adaptive_steps(cfg, cornell, tile=16)
    st = _run(uni, init_adaptive_state(32, 32, "cpu"), 2)
    ref = _run(T.make_render_step(cfg, cornell), T.init_state(32, 32, "cpu"),
               2)
    torch.testing.assert_close(adaptive_image(st), ref.accum, rtol=1e-6,
                               atol=1e-7)
    assert float(st.mrays) == float(ref.mrays) > 0
    assert st.frame == 2 and (st.count == 2).all()


def test_adaptive_targets_noisy_tiles(cornell):
    """After the warmup every adaptive step renders exactly K tiles, and
    the count map becomes nonuniform."""
    cfg = T.RenderConfig(width=32, height=32, spp_per_step=2, max_depth=4)
    uni, ada = make_adaptive_steps(cfg, cornell, frac=0.25, tile=8)
    st = _run(uni, init_adaptive_state(32, 32, "cpu"), 2)
    st = _run(ada, st, 4)
    count = st.count.numpy()
    assert count.min() == 2 and count.max() >= 3
    # 16 tiles, K = 4 a step: 4 steps x 4 tiles x 64 pixels added
    assert count.sum() - 2 * 32 * 32 == 4 * 4 * 64
    assert ada.pixels == 4 * 64 and uni.pixels == 32 * 32


def test_adaptive_estimate_consistent():
    """The adaptive image agrees with the uniform one to Monte-Carlo noise
    (a loose bound on a tiny render)."""
    cfg = T.RenderConfig(width=16, height=16, spp_per_step=8, max_depth=3,
                         sampling="cosine")
    img_a = AdaptiveRenderer(cfg, T.load_obj(), "cpu", frac=0.5, tile=8,
                             warmup=2).run(steps=8, progress=False)
    st = _run(T.make_render_step(cfg, T.upload(T.load_obj(), device="cpu")),
              T.init_state(16, 16, "cpu"), 8)
    img_u = st.accum.numpy()
    assert np.isfinite(img_a).all()
    assert abs(img_a.mean() - img_u.mean()) / img_u.mean() < 0.1


def test_adaptive_uses_packet_path_on_bvh(cornell):
    """The adaptive sampler shares the full-frame loop's trace: on the bvh
    route the payload trace (K3's twin here), whose estimate equals the
    brute-force one's on equal steps."""
    cfg = T.RenderConfig(width=32, height=32, spp_per_step=1, max_depth=2,
                         traversal="bvh")
    wide = build_wide_from_buffers(cornell)
    kw = select_wavefront_kwargs(cfg, cornell, wide)
    assert callable(kw["trace_payload_fn"]) and kw["occlusion_fn"] is None
    with pytest.raises(ValueError, match="wide BVH"):
        make_adaptive_steps(cfg, cornell, tile=16)
    imgs = []
    for c, w in ((cfg, wide),
                 (dataclasses.replace(cfg, traversal="brute"), None)):
        uni, ada = make_adaptive_steps(c, cornell, tile=16, wide=w)
        imgs.append(adaptive_image(ada(uni(init_adaptive_state(32, 32,
                                                               "cpu")))))
    assert torch.isfinite(imgs[0]).all()
    torch.testing.assert_close(imgs[0], imgs[1], rtol=1e-4, atol=1e-6)


def test_indivisible_tile_raises(cornell):
    cfg = T.RenderConfig(width=20, height=20, spp_per_step=1)
    with pytest.raises(ValueError, match="not divisible"):
        make_adaptive_steps(cfg, cornell, tile=16)


def test_adaptive_checkpoint_resume(tmp_path):
    """Resume continues the estimator exactly (the same counts and image
    as an uninterrupted run); another config, other knobs or another kind
    of checkpoint are refused."""
    cfg = T.RenderConfig(width=16, height=16, spp_per_step=2, max_depth=2)
    p = str(tmp_path / "ada.npz")
    r1 = AdaptiveRenderer(cfg, T.load_obj(), "cpu", frac=0.5, tile=8)
    r1.run(steps=3, checkpoint_path=p, progress=False)
    r2 = AdaptiveRenderer(cfg, T.load_obj(), "cpu", frac=0.5, tile=8)
    r2.resume(p)
    assert r2.state.frame == 3
    img_resumed = r2.run(steps=2, progress=False)
    r3 = AdaptiveRenderer(cfg, T.load_obj(), "cpu", frac=0.5, tile=8)
    img_straight = r3.run(steps=5, progress=False)
    np.testing.assert_array_equal(img_resumed, img_straight)
    assert torch.equal(r2.state.count, r3.state.count)

    bad = dataclasses.replace(cfg, spp_per_step=4)
    with pytest.raises(ValueError, match="refusing"):
        AdaptiveRenderer(bad, T.load_obj(), "cpu", frac=0.5, tile=8).resume(p)
    with pytest.raises(ValueError, match="refusing to change the sampling"):
        AdaptiveRenderer(cfg, T.load_obj(), "cpu", frac=0.25,
                         tile=8).resume(p)
    other = str(tmp_path / "plain.npz")
    np.savez(other, config_hash=np.bytes_(cfg.config_hash().encode()),
             kind=np.bytes_(b"render"))
    with pytest.raises(ValueError, match="not an adaptive"):
        r3.resume(other)


# -- against sfvp_tpu ----------------------------------------------------

CFG = dict(width=32, height=32, spp_per_step=1, max_depth=2)


def _to_jax(st):
    return ja.AdaptiveState(
        s1=jnp.asarray(st.s1.numpy()), s2=jnp.asarray(st.s2.numpy()),
        count=jnp.asarray(st.count.numpy()), frame=jnp.int32(st.frame),
        mrays=jnp.float32(float(st.mrays)))


def _synthetic_state(seed, tie_tiles=()):
    """A 32x32 state with random sums and counts 2..5, and count < 2 (the
    tied priority 1e30) on the 8x8 tiles ``tie_tiles``."""
    g = np.random.default_rng(seed)
    count = g.integers(2, 6, (32, 32)).astype(np.int32)
    for t in tie_tiles:
        ty, tx = divmod(t, 4)
        count[ty * 8:ty * 8 + 8, tx * 8:tx * 8 + 8] = g.integers(0, 2, (8, 8))
    s1 = (g.uniform(0.0, 1.0, (32, 32, 3)) * count[..., None]).astype(
        np.float32)
    s2 = (s1 * s1 / np.maximum(count, 1)[..., None]
          * g.uniform(1.0, 1.5, (32, 32, 3))).astype(np.float32)
    return AdaptiveState(s1=torch.from_numpy(s1), s2=torch.from_numpy(s2),
                         count=torch.from_numpy(count), frame=5,
                         mrays=torch.tensor(0.25))


def _jax_priorities(st, tile):
    """sfvp_tpu's priority expression (adaptive.py:117-127), evaluated by
    XLA on the same state."""
    n = jnp.maximum(st.count, 1).astype(jnp.float32)
    mean = st.s1 / n[..., None]
    var = jnp.maximum(st.s2 / n[..., None] - mean * mean, 0.0) * (
        n / jnp.maximum(n - 1.0, 1.0))[..., None]
    luma = mean.sum(axis=-1)
    rel = (var.sum(axis=-1) / n) / (luma * luma + 1e-4)
    rel = jnp.where(st.count < 2, jnp.float32(1e30), rel)
    h, w = rel.shape
    return np.asarray(rel.reshape(h // tile, tile, w // tile, tile)
                      .mean(axis=(1, 3)))


def _selected_tiles(before, after, tile):
    """The tiles a step rendered: where the per-pixel count rose."""
    rose = (np.asarray(after.count) - np.asarray(before.count)) > 0
    tiles = rose.reshape(32 // tile, tile, 32 // tile, tile).any(axis=(1, 3))
    return set(np.flatnonzero(tiles).tolist())


@pytest.mark.parametrize("ties", [(), (1, 5, 6, 9, 14)],
                         ids=["distinct", "tied"])
def test_priorities_and_tiles_match_jax(ties, cornell, j_cornell):
    """One state fed to both packages: the port's priorities within rtol
    1e-5 of sfvp_tpu's, and the tiles its step renders those sfvp_tpu's
    renders, exactly, unless the K-th and the next priority are within
    that rounding; with tied tiles (count < 2) the lower ids win in both."""
    st = _synthetic_state(3, ties)
    want = _jax_priorities(_to_jax(st), 8)
    got = tile_priorities(st, 8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    k = 4
    _, j_ada = ja.make_adaptive_steps(J.RenderConfig(**CFG), j_cornell,
                                      frac=k / 16, tile=8)
    jst = _to_jax(st)
    j_sel = _selected_tiles(jst, jax.jit(j_ada)(jst), 8)
    _, ada = make_adaptive_steps(T.RenderConfig(**CFG), cornell,
                                 frac=k / 16, tile=8)
    sel = _selected_tiles(st, ada(st), 8)
    assert sel == set(select_tiles(tile_priorities(st, 8), k).tolist())
    order = np.sort(want.reshape(-1))[::-1]
    near_tie = abs(order[k - 1] - order[k]) <= 1e-5 * abs(order[k])
    if ties:
        assert sel == j_sel == set(sorted(ties)[:k])
    elif not near_tie:
        assert sel == j_sel
    assert len(sel) == len(j_sel) == k


def test_tile_decode_is_sfvp_tpus_wave_order():
    """Tile t's pixels, row-major inside the tile, tile after tile (the
    wave order that makes K6's packets)."""
    px, py = tile_pixels(torch.tensor([5, 0]), 4, tiles_per_row=3)
    assert px[:5].tolist() == [8, 9, 10, 11, 8]
    assert py[:5].tolist() == [4, 4, 4, 4, 5]
    assert (px[16], py[16]) == (0, 0)


def test_steps_match_jax_from_the_same_state(cornell, j_cornell):
    """A uniform step and then an adaptive step of each package from one
    state: the same pixels rendered, and the sums within the framework
    bound; the segment counters equal."""
    st = _synthetic_state(7)
    j_uni, j_ada = ja.make_adaptive_steps(J.RenderConfig(**CFG), j_cornell,
                                          frac=0.25, tile=8)
    uni, ada = make_adaptive_steps(T.RenderConfig(**CFG), cornell,
                                   frac=0.25, tile=8)
    jst, tst = _to_jax(st), st
    for j_step, t_step in ((j_uni, uni), (j_ada, ada)):
        jst, tst = jax.jit(j_step)(jst), t_step(tst)
        np.testing.assert_array_equal(tst.count.numpy(), np.asarray(jst.count))
        assert tst.frame == int(jst.frame)
        for f in ("s1", "s2"):
            assert_close(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)),
                         f"{f} after the step")
        assert float(tst.mrays) == float(jst.mrays)


def test_checkpoints_resume_across_packages(tmp_path):
    """A checkpoint of sfvp_tpu's AdaptiveRenderer resumes in the port's,
    and the port's in sfvp_tpu's; the next step agrees."""
    jcfg, tcfg = J.RenderConfig(**CFG), T.RenderConfig(**CFG)
    assert jcfg.config_hash() == tcfg.config_hash()
    knobs = dict(frac=0.25, tile=8, warmup=1)
    jr = ja.AdaptiveRenderer(jcfg, J.load_obj(native="never"), **knobs)
    tr = AdaptiveRenderer(tcfg, T.load_obj(), "cpu", **knobs)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jr.run(steps=2, checkpoint_path=pj, progress=False)
    tr.run(steps=2, checkpoint_path=pt, progress=False)
    j2 = ja.AdaptiveRenderer(jcfg, J.load_obj(native="never"), **knobs)
    t2 = AdaptiveRenderer(tcfg, T.load_obj(), "cpu", **knobs)
    j2.resume(pt)
    t2.resume(pj)
    assert int(j2.state.frame) == t2.state.frame == 2
    np.testing.assert_array_equal(np.asarray(j2.state.count),
                                  t2.state.count.numpy())
    assert_close(np.asarray(j2.image()), t2.image(), "resumed states")
    assert_close(np.asarray(j2.run(1, progress=False)),
                 t2.run(1, progress=False), "one step after the resume")
    np.testing.assert_array_equal(np.asarray(j2.state.count),
                                  t2.state.count.numpy())


def test_instanced_adaptive_over_k7_twin():
    """An instanced scene: the adaptive sampler traces through K7's twin
    (dispatch.instanced_wavefront_kwargs) and builds its two-level BVH
    once; its warmup equals the Renderer's wavefront step over K7."""
    from test_torch_instances import VIEW, both_scenes

    insts = both_scenes("field")[1]
    cfg = T.RenderConfig(width=16, height=16, spp_per_step=2, max_depth=3,
                         sampling="cosine", camera=VIEW,
                         megakernel_regen=False)
    r = AdaptiveRenderer(cfg, insts, "cpu", frac=0.5, tile=8, warmup=1)
    assert r.tl is not None and r.wide is None and r.bvh_build_s > 0
    r.step(1)
    ref = T.Renderer(cfg, insts, "cpu")
    ref.step(1)
    torch.testing.assert_close(adaptive_image(r.state), ref.state.accum,
                               rtol=1e-6, atol=1e-7)
    assert float(r.state.mrays) == float(ref.state.mrays) > 0
    r.step(2)
    assert int(r.state.count.sum()) == 16 * 16 + 2 * 2 * 64


def test_cli_adaptive_on_the_cpu(tmp_path, capsys):
    """``--adaptive`` on ``--device cpu``: the progress line, a PNG, one
    JSONL record a step, a checkpoint that resumes; on a BVH scene the
    set-up line; an indivisible tile raises."""
    out, log = tmp_path / "a.png", tmp_path / "a.jsonl"
    ck = tmp_path / "a.npz"
    args = ["--device", "cpu", "--adaptive", "0.5", "--adaptive-tile", "8",
            "--width", "16", "--height", "16", "--spp", "2", "--max-depth",
            "3", "--steps", "3", "--out", str(out), "--log", str(log),
            "--checkpoint", str(ck)]
    assert cli.main(args) == 0
    text = capsys.readouterr().out
    assert text.count("mean spp") == 3 and "step     3" in text
    assert os.path.getsize(out) > 0
    recs = [json.loads(x) for x in open(log).read().splitlines()]
    assert [r["pixels"] for r in recs] == [256, 256, 128]
    assert cli.main(args + ["--resume", "--steps", "1", "--quiet"]) == 0
    with np.load(ck) as z:
        assert bytes(z["kind"]) == b"adaptive" and int(z["frame"]) == 4
    assert cli.main(["--device", "cpu", "--scene", "sphere", "--scene-tris",
                     "2000", "--adaptive", "0.5", "--adaptive-tile", "8",
                     "--width", "16", "--height", "16", "--spp", "1",
                     "--max-depth", "2", "--steps", "1",
                     "--out", str(out)]) == 0
    assert "set-up: wide BVH" in capsys.readouterr().out
    with pytest.raises(ValueError, match="not divisible"):
        cli.main(args[:4] + ["--adaptive-tile", "5", *args[6:]])


def test_checkpoint_of_an_inexact_frac_resumes(tmp_path):
    """frac is stored as float32 and compared as stored: a frac of 0.1
    resumes (sfvp_tpu compares its float32 with the float64 it holds and
    refuses its own checkpoint of such a frac; ROADMAP.md §C)."""
    cfg = T.RenderConfig(width=16, height=16, spp_per_step=1, max_depth=1)
    p = str(tmp_path / "f.npz")
    AdaptiveRenderer(cfg, T.load_obj(), "cpu", frac=0.1, tile=8).run(
        1, checkpoint_path=p, progress=False)
    r = AdaptiveRenderer(cfg, T.load_obj(), "cpu", frac=0.1, tile=8)
    r.resume(p)
    assert r.state.frame == 1
    with pytest.raises(ValueError, match="refusing to change the sampling"):
        AdaptiveRenderer(cfg, T.load_obj(), "cpu", frac=0.11, tile=8).resume(p)
