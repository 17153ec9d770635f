"""The thin-lens camera (depth of field) in the port against sfvp_tpu: the
lens on seeded rays, its refusal of a focal plane at distance <= 0, the
config hash, tests/test_render.py::test_thin_lens_dof on the port, images
of the eager loop against sfvp_tpu's jnp integrator with the lens open
(on the Cornell Box with glass), the fused kernels' twins (K1, K5, K9)
against the eager loop with it, the CLI's --lens-radius / --focus-dist and
the routes.

Tolerances as tests/test_torch_materials.py: rays within 1e-6 (torch-CPU
and XLA-CPU round sqrt, rsqrt, sin and cos apart by an ulp), images within
relative RMSE 1e-5 with fewer than 0.1% of pixels apart by more than
1e-4, traced segments equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.camera import apply_thin_lens_soa as j_lens  # noqa: E402
from sfvp_tpu.integrate.wavefront import make_render_step as j_make  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch import cli  # noqa: E402
from sfvp_tpu_torch.accel.wide import build_wide_from_buffers  # noqa: E402
from sfvp_tpu_torch.camera import apply_thin_lens_soa, lens_frame  # noqa: E402
from sfvp_tpu_torch.dispatch import select_render_step  # noqa: E402
from sfvp_tpu_torch.integrate.wavefront import make_render_step  # noqa: E402
from sfvp_tpu_torch.kernels.bvh_packet import device_wide  # noqa: E402
from sfvp_tpu_torch.kernels.megakernel_bvh import (  # noqa: E402
    make_bvh_regen_render_step)
from sfvp_tpu_torch.kernels.megakernel_regen import (  # noqa: E402
    make_regen_render_step)
from sfvp_tpu_torch.scene.objload import Scene  # noqa: E402

from test_torch_materials import (  # noqa: E402
    assert_image, cornell_pair, glossy_field, kernel_and_twin)

# the reference camera looks down -z from (0, -1, 5): the Cornell Box's
# back wall lies ~6 away, its boxes ~4.5
FOCUS = 4.5
LENS = dict(lens_radius=0.05, focus_dist=FOCUS)


def lens_cam(mod, **kw):
    return dataclasses.replace(mod.CameraConfig(), **{**LENS, **kw})


def _rays(n=2048, seed=3):
    g = np.random.default_rng(seed)
    d = g.normal(size=(3, n)).astype(np.float32)
    d[2] = -np.abs(d[2]) - 0.5
    d /= np.linalg.norm(d, axis=0)
    o = g.normal(size=(3, n)).astype(np.float32)
    return o, d, g.random(n, np.float32), g.random(n, np.float32)


@pytest.mark.parametrize("cam", [
    dict(), dict(lens_radius=0.3, focus_dist=2.0),
    dict(right=(0.7, 0.1, 0.0), up=(0.0, 1.2, 0.3))],
    ids=["reference", "wide_open", "skewed_frame"])
def test_torch_thin_lens_matches_jax(cam):
    o, d, r1, r2 = _rays()
    jc, tc = lens_cam(J, **cam), lens_cam(T, **cam)
    jo, jd = j_lens(tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d)),
                    jnp.asarray(r1), jnp.asarray(r2), jc)
    to, td = apply_thin_lens_soa(tuple(map(torch.from_numpy, o)),
                                 tuple(map(torch.from_numpy, d)),
                                 torch.from_numpy(r1), torch.from_numpy(r2),
                                 tc)
    for a, b in zip((*to, *td), (*jo, *jd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("focus", [0.0, -1.0])
def test_torch_lens_refuses_focus_at_or_behind_it(focus):
    cam = lens_cam(T, focus_dist=focus)
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="focus_dist"):
        apply_thin_lens_soa((z, z, z), (z, z, z - 1), z, z, cam)
    with pytest.raises(ValueError, match="focus_dist"):
        lens_frame(cam)
    _, tb = cornell_pair_cpu()
    with pytest.raises(ValueError, match="focus_dist"):
        make_regen_render_step(T.RenderConfig(camera=cam), tb)


def cornell_pair_cpu():
    jb = J.upload(J.load_obj(native="never"))
    return jb, T.upload(T.load_obj(), device="cpu")


def test_torch_lens_config_hash_equals_jax():
    """Pinhole hashes do not move with the lens fields; an open lens hashes
    as sfvp_tpu's."""
    base = dict(width=32, height=16, spp_per_step=4)
    assert (T.RenderConfig(**base).config_hash()
            == T.RenderConfig(**base, camera=T.CameraConfig(
                lens_radius=0.0)).config_hash())
    jh = J.RenderConfig(**base, camera=lens_cam(J)).config_hash()
    th = T.RenderConfig(**base, camera=lens_cam(T)).config_hash()
    assert jh == th != T.RenderConfig(**base).config_hash()


def split_wall(z):
    """A vertical red | green colour edge at x = 0 in the plane z
    (tests/test_render.py:205-222)."""
    tris = [
        [[-50.0, -50, z], [0, -50, z], [0, 50, z]],
        [[-50.0, -50, z], [0, 50, z], [-50, 50, z]],
        [[0.0, -50, z], [50, -50, z], [50, 50, z]],
        [[0.0, -50, z], [50, 50, z], [0, 50, z]],
    ]
    return Scene(
        vertices=np.asarray(tris, np.float32).reshape(-1, 3),
        indices=np.arange(12, dtype=np.uint32),
        face_diffuse=np.asarray([[0.9, 0.05, 0.05]] * 2
                                + [[0.05, 0.9, 0.05]] * 2, np.float32),
        face_emission=np.zeros((4, 3), np.float32),
        face_specular=np.zeros((4, 3), np.float32),
        face_mat_type=np.zeros((4,), np.int32))


@pytest.mark.parametrize("z", [2.0, -2.0], ids=["in_focus", "out_of_focus"])
def test_torch_thin_lens_dof(z):
    """tests/test_render.py::test_thin_lens_dof on the port: a colour edge
    on the focal plane (z = 2, 3 in front of the camera) stays as sharp as
    through the pinhole; off it, it blurs."""
    base = T.RenderConfig(width=32, height=16, spp_per_step=64, max_depth=2,
                          sampling="cosine")
    open_lens = dataclasses.replace(base, camera=T.CameraConfig(
        lens_radius=0.25, focus_dist=3.0))

    def sharpness(cfg):
        step = make_render_step(cfg, T.upload(split_wall(z), device="cpu"))
        st = step(step(T.init_state(16, 32, "cpu")))
        img = st.accum.numpy()
        prof = (img[..., 0] - img[..., 1]).mean(axis=0)
        return float(np.abs(np.diff(prof)).max())

    pin, lens = sharpness(base), sharpness(open_lens)
    if z == 2.0:
        assert lens > 0.75 * pin, (pin, lens)
    else:
        assert lens < 0.55 * pin, (pin, lens)


def test_torch_closed_lens_keeps_pinhole_streams():
    """A closed lens draws no numbers: the image is the pinhole's, bit for
    bit."""
    _, tb = cornell_pair_cpu()
    cfg = T.RenderConfig(width=16, height=16, spp_per_step=2, max_depth=3)
    a = make_render_step(cfg, tb)(T.init_state(16, 16, "cpu")).accum
    closed = dataclasses.replace(cfg, camera=T.CameraConfig(focus_dist=3.0))
    b = make_render_step(closed, tb)(T.init_state(16, 16, "cpu")).accum
    assert torch.equal(a, b)


DOF_CASES = {
    "parity": dict(),
    "nee_mis_rr": dict(sampling="cosine", use_nee=True, use_mis=True,
                       use_rr=True, rr_start_depth=1),
}


@pytest.mark.parametrize("case", sorted(DOF_CASES))
def test_torch_eager_dof_matches_jax(case, tmp_path):
    """The Cornell Box with a GGX floor, a glass and a mirror box through
    an open lens: the port's eager loop against sfvp_tpu's jnp
    integrator."""
    jb, tb = cornell_pair(tmp_path)
    kw = dict(DOF_CASES[case], width=32, height=32, spp_per_step=2,
              max_depth=4)
    st = jax.jit(j_make(J.RenderConfig(**kw, camera=lens_cam(J)), jb))(
        J.init_state(32, 32))
    got = make_render_step(T.RenderConfig(**kw, camera=lens_cam(T)), tb)(
        T.init_state(32, 32, "cpu"))
    assert_image(got.accum.numpy(), np.asarray(st.accum),
                 f"eager loop with DOF vs jax ({case})")
    assert float(got.mrays) == float(st.mrays), "traced segments differ"


@pytest.mark.parametrize("case", sorted(DOF_CASES))
def test_torch_k1_k5_twins_dof_match_eager(case, tmp_path):
    """K1's and K5's twins with the lens open, against the eager loop (as
    tests/test_megakernel.py:320-362 and test_megakernel_bvh.py:361 hold
    sfvp_tpu's)."""
    _, tb = cornell_pair(tmp_path)
    cfg = T.RenderConfig(**DOF_CASES[case], width=16, height=16,
                         spp_per_step=2, max_depth=4, camera=lens_cam(T))
    ref = make_render_step(cfg, tb)(T.init_state(16, 16, "cpu"))
    k1 = make_regen_render_step(cfg, tb)(T.init_state(16, 16, "cpu"))
    dw = device_wide(build_wide_from_buffers(tb), "cpu")
    k5 = make_bvh_regen_render_step(cfg, tb, dw)(T.init_state(16, 16, "cpu"))
    for name, st in (("K1", k1), ("K5", k5)):
        assert_image(st.accum.numpy(), ref.accum.numpy(),
                     f"{name} twin with DOF ({case})")
        assert float(st.mrays) == float(ref.mrays)


def test_torch_k9_twin_dof_matches_wavefront():
    """K9's twin on the glossy and glass field with the lens open, against
    the wavefront loop over K7's twin."""
    from sfvp_tpu_torch.render.driver import Renderer

    view = T.CameraConfig.look_at(origin=(10.5, 7.5, 10.5),
                                  target=(0.0, 0.6, 0.0), fov_y_deg=50.0)
    cam = dataclasses.replace(view, lens_radius=0.3, focus_dist=12.0)
    kw = dict(width=16, height=16, spp_per_step=2, max_depth=4,
              sampling="cosine", camera=cam, sky_emission=(0.8, 0.85, 1.0))
    insts = glossy_field()
    a = Renderer(T.RenderConfig(**kw), insts, "cpu")
    b = Renderer(T.RenderConfig(**kw, megakernel_regen=False), insts, "cpu")
    a.step(1)
    b.step(1)
    assert_image(a.state.accum.numpy(), b.state.accum.numpy(),
                 "K9 twin vs wavefront with DOF")


def test_torch_cli_lens_flags_render(tmp_path, capsys, monkeypatch):
    """--lens-radius with --focus-dist renders on the CPU (K1's twin); with
    no --focus-dist the CLI focuses on the camera target's plane, as
    sfvp_tpu's CLI does (cli.py:148-170)."""
    monkeypatch.setenv("SFVP_DISPATCH_DEBUG", "1")
    out = tmp_path / "dof.png"
    base = ["--device", "cpu", "--width", "8", "--height", "8", "--spp", "2",
            "--steps", "1", "--max-depth", "3", "--out", str(out), "--quiet"]
    assert cli.main(base + ["--lens-radius", "0.05", "--focus-dist",
                            str(FOCUS)]) == 0
    assert out.stat().st_size > 0
    assert "megakernel_regen(brute)" in capsys.readouterr().err
    assert cli.main(base + ["--lens-radius", "0.05"]) == 0
    assert "focusing at the camera target plane (3)" in capsys.readouterr().out
    cfg = cli.with_lens(T.RenderConfig(), 0.05, 0.0)
    assert cfg.camera.focus_dist == pytest.approx(3.0)


def test_torch_dof_routes(capfd, monkeypatch):
    """Brute force with megakernel_regen=False and an open lens takes the
    eager loop (K2 has no lens, sfvp_tpu dispatch.py:242-256)."""
    from sfvp_tpu_torch.kernels.megakernel import make_wave_render_step

    monkeypatch.setenv("SFVP_DISPATCH_DEBUG", "1")
    _, tb = cornell_pair_cpu()
    cfg = T.RenderConfig(width=8, height=8, spp_per_step=1, max_depth=2,
                         camera=lens_cam(T), megakernel_regen=False)
    st = select_render_step(cfg, tb)(T.init_state(8, 8, "cpu"))
    assert "wavefront(brute)" in capfd.readouterr().err
    assert float(st.accum.max()) > 0
    with pytest.raises(ValueError, match="thin lens"):
        make_wave_render_step(cfg, tb)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DOF_CASES))
def test_cuda_k1_k5_dof_match_twins(case, tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    _, tb = cornell_pair(tmp_path)
    cfg = T.RenderConfig(**DOF_CASES[case], width=64, height=48,
                         spp_per_step=2, max_depth=8, camera=lens_cam(T))
    gpu_tb = T.scene.to_device(tb, "cuda")
    dw = device_wide(build_wide_from_buffers(tb), "cuda")
    for name, render in (
            ("K1", lambda: make_regen_render_step(cfg, gpu_tb)(
                T.init_state(48, 64, "cuda"))),
            ("K5", lambda: make_bvh_regen_render_step(cfg, gpu_tb, dw)(
                T.init_state(48, 64, "cuda")))):
        got, exp = kernel_and_twin(monkeypatch, render)
        assert torch.equal(got.accum, exp.accum), f"{name} ({case})"
