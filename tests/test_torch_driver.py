"""Render driver, checkpoints and CLI of the PyTorch port on the CPU,
including checkpoints carried across packages in both directions.
Image tolerances as in test_torch_integrator.py."""

import dataclasses
import json
import os
import struct
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.render.checkpoint import (  # noqa: E402
    load_checkpoint as j_load,
    save_checkpoint as j_save,
)

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch import cli  # noqa: E402
from sfvp_tpu_torch.integrate.wavefront import make_render_step  # noqa: E402
from sfvp_tpu_torch.render.checkpoint import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
)

from test_torch_integrator import assert_close  # noqa: E402

KW = dict(width=16, height=8, spp_per_step=3, max_depth=3)


def _png_size(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    raw = zlib.decompress(idat)
    assert len(raw) == h * (1 + 3 * w)
    return w, h


def test_renderer_two_steps_on_cpu(tmp_path):
    cfg = T.RenderConfig(**KW)
    r = T.Renderer(cfg, T.load_obj(), "cpu")
    log = tmp_path / "log.jsonl"
    img = r.run(2, out=str(tmp_path / "out.png"), log_path=str(log),
                progress=False)
    assert r.state.frame == 2 and img.shape == (8, 16, 3)
    assert np.isfinite(img).all() and img.max() > 0
    ref = make_render_step(cfg, T.upload(T.load_obj(), device="cpu"))
    st = ref(ref(T.init_state(8, 16, "cpu")))
    # K1's twin sums each sample straight into the pixel total; the
    # wavefront sums per chunk: equal up to f32 summation order
    assert_close(img, st.accum.numpy(), "Renderer (K1 twin) vs wavefront")
    assert float(r.state.mrays) == float(st.mrays)
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [rec["step"] for rec in recs] == [1, 2]
    assert set(recs[0]) == {"step", "spp", "step_s", "mrays_step",
                            "mrays_per_s", "avg_path_len"}
    assert _png_size(tmp_path / "out.png") == (16, 8)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    jcfg = J.RenderConfig(**KW)
    jb = J.upload(J.load_obj(native="never"))
    jstep = jax.jit(J.make_render_step(jcfg, jb))
    one = jstep(J.init_state(8, 16))
    two = jstep(one)
    path = str(tmp_path / "jax.npz")
    j_save(path, one, jcfg.config_hash())

    r = T.Renderer(T.RenderConfig(megakernel_regen=False, **KW),
                   T.load_obj(), "cpu")
    r.resume(path)
    assert r.state.frame == 1
    r.step()
    assert_close(r.image(), np.asarray(two.accum), "jax step 1 + port step 2")
    assert float(r.state.mrays) == float(two.mrays)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    cfg = T.RenderConfig(**KW)
    step = make_render_step(cfg, T.upload(T.load_obj(), device="cpu"))
    one = step(T.init_state(8, 16, "cpu"))
    path = str(tmp_path / "torch.npz")
    save_checkpoint(path, one, cfg.config_hash())
    one_np = one.accum.numpy().copy()
    two = step(one)

    jcfg = J.RenderConfig(**KW)
    state, got = j_load(path, jcfg.config_hash())
    assert got == cfg.config_hash() and int(state.frame) == 1
    np.testing.assert_array_equal(np.asarray(state.accum), one_np)
    jnext = jax.jit(J.make_render_step(
        jcfg, J.upload(J.load_obj(native="never"))))(state)
    assert_close(two.accum.numpy(), np.asarray(jnext.accum),
                 "port step 1 + jax step 2")


def test_checkpoint_round_trip_and_hash_refusal(tmp_path):
    cfg = T.RenderConfig(**KW)
    st = make_render_step(cfg, T.upload(T.load_obj(), device="cpu"))(
        T.init_state(8, 16, "cpu"))
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, st, cfg.config_hash())
    back, h = load_checkpoint(path, cfg.config_hash(), device="cpu")
    assert h == cfg.config_hash() and back.frame == 1
    assert back.accum.equal(st.accum) and back.mrays.equal(st.mrays)
    other = T.RenderConfig(**dict(KW, max_depth=4)).config_hash()
    with pytest.raises(ValueError, match="refusing"):
        load_checkpoint(path, other, device="cpu")


def test_cli_writes_png(tmp_path):
    out = tmp_path / "c.png"
    ck = tmp_path / "c.npz"
    args = ["--device", "cpu", "--width", "16", "--height", "16", "--spp",
            "2", "--max-depth", "4", "--steps", "2", "--out", str(out),
            "--checkpoint", str(ck), "--quiet"]
    assert cli.main(args) == 0
    assert _png_size(out) == (16, 16)
    assert cli.main(args + ["--resume", "--steps", "1"]) == 0
    state, _ = load_checkpoint(str(ck), device="cpu")
    assert state.frame == 3


@pytest.mark.parametrize("flags", [
    # --nee and --mis render now (tests/test_torch_nee.py); with an
    # unported feature beside them the CLI still raises
    ["--lens-radius", "0.1", "--nee"],
    # --env-map renders now (tests/test_torch_envmap.py); beside an
    # unported feature the CLI still raises, before it reads the map
    ["--env-map", "sky.hdr", "--lens-radius", "0.1", "--mis"],
    ["--lens-radius", "0.2", "--env-map", "sky.hdr"], ["--lens-radius", "0.1"],
    ["--focus-dist", "3.0"], ["--dist"],
    # --adaptive renders now (tests/test_torch_adaptive.py); with an
    # unported feature beside it the CLI still raises
    ["--lens-radius", "0.1", "--adaptive", "0.5"],
    # procedural scenes render now; an unported feature on one still raises
    ["--nee", "--lens-radius", "0.1", "--scene", "sphere"],
    # and so does the instanced scene (tests/test_torch_instances.py)
    ["--lens-radius", "0.1", "--scene", "instanced"]],
    ids=lambda f: f[-1] if len(f) > 1 else f[0])
def test_cli_out_of_slice_flags_raise(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(["--device", "cpu", "--width", "8", "--height", "8",
                  "--steps", "1", "--out", str(tmp_path / "x.png"),
                  "--quiet", *flags])
    assert not os.path.exists(tmp_path / "x.png")


def test_renderer_refuses_instances():
    """Instances render now (tests/test_torch_instances.py); the Renderer
    takes no trace_fn, and refuses a feature not ported yet on them."""
    from sfvp_tpu_torch.accel.instances import Instance
    from sfvp_tpu_torch.kernels.intersect import trace_brute

    insts = [Instance(scene=T.load_obj())]
    with pytest.raises(TypeError, match="trace_fn"):
        T.Renderer(T.RenderConfig(**KW), insts, "cpu", trace_fn=trace_brute)
    dof = dataclasses.replace(T.CameraConfig(), lens_radius=0.1)
    with pytest.raises(NotImplementedError, match="A.12"):
        T.Renderer(T.RenderConfig(**KW, camera=dof), insts, "cpu")
