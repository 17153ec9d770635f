"""The large-scene routes of the port against sfvp_tpu's: K5's plain twin
(kernels/megakernel_bvh.py) against the JAX K5 Pallas kernel in interpret
mode (as tests/test_megakernel_bvh.py runs it), and the port's wavefront
loop over K3's twin against the JAX wavefront loop over its K3 kernel
(make_render_step(trace_payload_fn=make_packet_trace(...,
interpret=True))), with the per-bounce ray sort on and off. Both packages
trace the same wide-BVH arrays, built with the builder named on both
sides (``native="never"`` on the JAX side).

Bounds: relative RMSE < 1e-5 and max abs < 1e-4 (the framework bound of
ROADMAP.md §C), traced segments equal. K5's twin against K1's twin on the
Cornell Box, where both take each sample's streams from the same pixel
coordinates: relative RMSE and max abs <= 1e-6.

The ``cuda`` test holds the CUDA kernel against its twin and skips without
a card; chip_smoke.py runs the same comparison on the H100.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.accel.sah import sah_bvh_from_arrays as j_sah  # noqa: E402
from sfvp_tpu.accel.wide import build_wide as j_build_wide  # noqa: E402
from sfvp_tpu.accel.wide import materials_array as j_materials  # noqa: E402
from sfvp_tpu.integrate.wavefront import make_render_step as j_make  # noqa: E402
from sfvp_tpu.kernels.bvh_packet import make_packet_trace as j_packet  # noqa: E402
from sfvp_tpu.kernels.megakernel_bvh import (  # noqa: E402
    make_bvh_regen_render_step as j_k5,
)
from sfvp_tpu.scene import procedural as j_proc  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch import cli  # noqa: E402
from sfvp_tpu_torch.accel import wide as t_wide  # noqa: E402
from sfvp_tpu_torch.accel.wide import build_wide_from_buffers  # noqa: E402
from sfvp_tpu_torch.dispatch import select_render_step  # noqa: E402
from sfvp_tpu_torch.kernels.bvh_packet import DeviceWide, device_wide  # noqa: E402
from sfvp_tpu_torch.kernels.megakernel_bvh import (  # noqa: E402
    bvh_regen_render,
    bvh_regen_render_plain,
    make_bvh_regen_render_step,
)
from sfvp_tpu_torch.kernels.megakernel_regen import make_regen_render_step  # noqa: E402
from sfvp_tpu_torch.scene import procedural as t_proc  # noqa: E402
from sfvp_tpu_torch.scene.buffers import FIELDS, from_numpy  # noqa: E402

from test_torch_integrator import assert_close, mirror_scene_arrays  # noqa: E402

H, W = 8, 16
BASE = dict(width=W, height=H, spp_per_step=2, max_depth=3)
COSINE_RR = dict(sampling="cosine", use_rr=True, rr_start_depth=1)
SPHERE_VIEW = dict(origin=(0.0, 2.2, 5.0), target=(0.0, 0.0, 0.0),
                   fov_y_deg=50.0)
CITY_VIEW = dict(origin=(13.0, 9.0, 13.0), target=(0.0, 0.8, 0.0),
                 fov_y_deg=55.0)


def _jax_scene(name):
    """(JAX buffers, camera look_at kwargs or None) of a test scene."""
    if name == "cornell":
        return J.upload(J.load_obj(native="never")), None
    if name == "mirror":
        return J.scene.buffers.from_arrays(*mirror_scene_arrays()), None
    if name == "sphere":
        return J.upload(j_proc.sphere_mesh(12, 12, bump=0.3)), SPHERE_VIEW
    return J.upload(j_proc.city_mesh(3, 3)), CITY_VIEW


_CACHE = {}


def scene(name):
    """Both packages' buffers and wide BVHs of scene ``name`` (SAH, the
    JAX side on its NumPy builder), built once per module."""
    if name not in _CACHE:
        jb, view = _jax_scene(name)
        tb = from_numpy({k: np.asarray(getattr(jb, k)) for k in FIELDS},
                        jb.num_tris, "cpu")
        tris = np.stack([np.stack([np.asarray(getattr(jb, f"v{c}{a}"))
                                   [: jb.num_tris] for a in "xyz"], -1)
                         for c in range(3)], 1)
        jw = j_build_wide(j_sah(tris, leaf_size=8, native="never"),
                          j_materials(jb))
        tw = build_wide_from_buffers(tb, builder="sah")
        _CACHE[name] = (jb, tb, jw, tw, view)
    return _CACHE[name]


def configs(kw, view):
    """The same RenderConfig in both packages (traversal="bvh"; the sky of
    the CLI's procedural scenes when there is a view)."""
    kw = dict(BASE, traversal="bvh", **kw)
    out = []
    for mod in (J, T):
        extra = {}
        if view is not None:
            extra = dict(camera=mod.CameraConfig.look_at(**view),
                         sky_emission=(0.8, 0.85, 1.0))
        out.append(mod.RenderConfig(**kw, **extra))
    return out


def _port_run(step, steps=1):
    st = T.init_state(H, W, "cpu")
    for _ in range(steps):
        st = step(st)
    return st


@pytest.mark.parametrize("name,kw", [
    ("cornell", {}), ("sphere", {}), ("city", {}),
    ("sphere", COSINE_RR), ("mirror", COSINE_RR)],
    ids=["cornell", "sphere", "city", "sphere-cosine_rr",
         "mirror-cosine_rr"])
def test_k5_twin_matches_jax_k5(name, kw):
    jb, tb, jw, tw, view = scene(name)
    jcfg, tcfg = configs(kw, view)
    want = jax.jit(j_k5(jcfg, jb, wide=jw, interpret=True))(J.init_state(H, W))
    got = _port_run(make_bvh_regen_render_step(tcfg, tb, device_wide(tw, "cpu")))
    assert_close(got.accum.numpy(), np.asarray(want.accum),
                 f"K5 twin vs jax K5 ({name})")
    assert float(got.mrays) == float(want.mrays), "traced segments differ"
    assert float(got.accum.max()) > 0


@pytest.mark.parametrize("name,kw", [("sphere", COSINE_RR), ("mirror", {})],
                         ids=["sphere-cosine_rr", "mirror"])
def test_wavefront_payload_route_matches_jax(name, kw):
    """The port's wavefront loop over K3's twin, with the ray sort on and
    off, against sfvp_tpu's over its K3 kernel; the sort never changes a
    bit of the image."""
    jb, tb, jw, tw, view = scene(name)
    jcfg, tcfg = configs(dict(kw, megakernel_regen=False), view)
    trace = j_packet(jw, t_min=jcfg.t_min, interpret=True)
    want = jax.jit(j_make(jcfg, jb, trace_payload_fn=trace))(J.init_state(H, W))
    got = {}
    for sort in (True, False):
        cfg = dataclasses.replace(tcfg, sort_bounce_rays=sort)
        got[sort] = _port_run(select_render_step(cfg, tb, wide=tw))
        assert_close(got[sort].accum.numpy(), np.asarray(want.accum),
                     f"wavefront payload route vs jax ({name}, sort={sort})")
        assert float(got[sort].mrays) == float(want.mrays)
    assert torch.equal(got[True].accum, got[False].accum)


@pytest.mark.parametrize("case", ["parity", "mirror"])
def test_k5_twin_matches_k1_twin(case):
    """K5 on the Cornell Box with traversal="bvh" against K1 on the same
    scene by brute force: the same streams, the same closest hits."""
    name = "cornell" if case == "parity" else "mirror"
    _, tb, _, tw, _ = scene(name)
    cfg = T.RenderConfig(**dict(BASE, spp_per_step=3, max_depth=4))
    k1 = _port_run(make_regen_render_step(cfg, tb), steps=2)
    k5 = _port_run(make_bvh_regen_render_step(
        dataclasses.replace(cfg, traversal="bvh"), tb, device_wide(tw, "cpu")),
        steps=2)
    assert_close(k5.accum.numpy(), k1.accum.numpy(), f"K5 vs K1 ({case})",
                 rel=1e-6, max_abs=1e-6)
    assert float(k5.mrays) == float(k1.mrays)


def test_k5_row_offset_band():
    """row0 + global_shape: rows [4, 8) rendered as a band equal, bitwise,
    rows 4-7 of the full render."""
    _, tb, _, tw, view = scene("sphere")
    _, cfg = configs(COSINE_RR, view)
    dw = device_wide(tw, "cpu")
    full = make_bvh_regen_render_step(cfg, tb, dw)(
        T.init_state(H, W, "cpu")).accum
    band = make_bvh_regen_render_step(cfg, tb, dw, global_shape=(H, W))(
        T.init_state(4, W, "cpu"), row0=4).accum
    assert torch.equal(band, full[4:])


def test_cpu_k5_runs_twin_and_counts_no_launch():
    _, tb, _, tw, view = scene("sphere")
    _, cfg = configs({}, view)
    dw = device_wide(tw, "cpu")
    kw = dict(cfg=cfg, global_shape=(H, W), npix=H * W, has_mirrors=False)
    before = bvh_regen_render.launches
    a = bvh_regen_render(dw, 2, 0, **kw)
    b = bvh_regen_render_plain(dw, 2, 0, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert bvh_regen_render.launches == before


def test_k5_refuses_non_cuda_device_and_oversized_stack():
    cfg = T.RenderConfig(**BASE)
    kw = dict(cfg=cfg, global_shape=(H, W), npix=H * W, has_mirrors=False)

    def meta(max_stack):
        return DeviceWide(nodes=torch.empty((4, 128), device="meta"),
                          tris=torch.empty((4, 128), device="meta"),
                          max_stack=max_stack)

    with pytest.raises(ValueError, match="CUDA tensor"):
        bvh_regen_render(meta(26), 0, 0, **kw)
    with pytest.raises(ValueError, match="max_stack"):
        bvh_regen_render(meta(10_000), 0, 0, **kw)


def test_k5_two_level_raises():
    """The step traces one tree: the wide BVH (K5) or, since the two-level
    kernel K9 renders (tests/test_torch_tlas.py), the two-level one; both
    or neither raises."""
    _, tb, _, tw, _ = scene("cornell")
    with pytest.raises(ValueError, match="one tree"):
        make_bvh_regen_render_step(T.RenderConfig(**BASE), tb,
                                   device_wide(tw, "cpu"), tl=object())
    with pytest.raises(ValueError, match="one tree"):
        make_bvh_regen_render_step(T.RenderConfig(**BASE), tb)


@pytest.mark.parametrize("kw,route", [
    (dict(), "megakernel_regen(brute)"),
    (dict(megakernel_regen=False), "megakernel(chunked parity)"),
    (dict(traversal="bvh"), "megakernel_bvh(fused regen)"),
    (dict(traversal="bvh", megakernel_regen=False),
     "wavefront(packet kernels)"),
    (dict(brute_force_max_tris=8), "megakernel_bvh(fused regen)"),
])
def test_dispatch_routes(kw, route, capsys, monkeypatch):
    """SFVP_DISPATCH_DEBUG names the route: "auto" takes the BVH above
    brute_force_max_tris (36 Cornell triangles > 8)."""
    monkeypatch.setenv("SFVP_DISPATCH_DEBUG", "1")
    _, tb, _, tw, _ = scene("cornell")
    select_render_step(T.RenderConfig(**BASE, **kw), tb, wide=tw)
    err = capsys.readouterr().err
    assert f"[sfvp_tpu_torch dispatch] {route}" in err, err


@pytest.mark.parametrize("kw", [dict(), dict(megakernel_regen=False)],
                         ids=["k5", "wavefront"])
def test_dispatch_bvh_route_needs_the_tree(kw):
    """The Renderer is the one layer that builds the wide BVH: dispatch
    refuses the bvh route without it, and runs it with it."""
    _, tb, _, tw, _ = scene("cornell")
    cfg = T.RenderConfig(**BASE, traversal="bvh", **kw)
    with pytest.raises(ValueError, match="wide BVH"):
        select_render_step(cfg, tb)
    step = select_render_step(cfg, tb, wide=tw)
    assert float(_port_run(step).accum.max()) > 0


_DOF = dataclasses.replace(T.CameraConfig(), lens_radius=0.1)


# The case ids are kept from when NEE (A.11) and then depth of field (A.12)
# were refused here: both render on this route now
# (tests/test_torch_occlusion.py, test_torch_dof.py), and an open lens
# without a focal plane in front of it (_DOF's focus_dist is 0) raises
# ValueError, as sfvp_tpu's camera does.
@pytest.mark.parametrize("kw,item", [
    pytest.param(dict(use_nee=True, use_mis=True, camera=_DOF), "A.12",
                 id="kw0-A.11"),
    (dict(camera=_DOF), "A.12"),
])
def test_bvh_route_still_refuses_unported_features(kw, item):
    _, tb, _, tw, _ = scene("cornell")
    with pytest.raises(ValueError, match="focus_dist") as e:
        select_render_step(T.RenderConfig(**BASE, traversal="bvh", **kw), tb,
                           wide=tw)
    assert item not in str(e.value)


def test_renderer_builds_the_wide_bvh_once(monkeypatch):
    calls = []
    real = t_wide.build_wide_from_buffers

    def counting(buffers, **kw):
        calls.append(buffers.num_tris)
        return real(buffers, **kw)

    monkeypatch.setattr(t_wide, "build_wide_from_buffers", counting)
    s = t_proc.sphere_mesh(12, 12, bump=0.3)
    cfg = T.RenderConfig(**dict(BASE, spp_per_step=1, max_depth=2))
    r = T.Renderer(cfg, s, "cpu")
    r.step(2)
    assert calls == [s.num_triangles]
    assert r.wide is not None and r.bvh_build_s > 0
    assert r.state.frame == 2
    cornell = T.Renderer(cfg, T.load_obj(), "cpu")
    assert cornell.wide is None and calls == [s.num_triangles]


@pytest.mark.parametrize("name", ["sphere", "terrain", "city"])
def test_cli_renders_procedural_scenes(name, tmp_path, capsys):
    out, log = tmp_path / "x.png", tmp_path / "x.jsonl"
    rc = cli.main(["--device", "cpu", "--scene", name, "--scene-tris", "300",
                   "--width", "8", "--height", "6", "--spp", "1",
                   "--max-depth", "2", "--steps", "2", "--sampling",
                   "cosine", "--rr", "--out", str(out), "--log", str(log)])
    assert rc == 0 and out.stat().st_size > 0
    assert len(log.read_text().splitlines()) == 2
    assert "set-up: wide BVH of" in capsys.readouterr().out


def test_cli_scene_sizing_and_view_match_jax_cli():
    """The procedural scene and view the port's CLI builds equal those of
    sfvp_tpu's CLI (cli.py:100-139)."""
    for name, n in (("sphere", 5000), ("terrain", 5000), ("city", 3000)):
        scene_t, cfg = cli.procedural_scene(name, n, T.RenderConfig())
        if name == "sphere":
            k = max(16, int(np.sqrt(n / 2)))
            scene_j = j_proc.sphere_mesh(n_lat=k, n_lon=k, bump=0.3)
        elif name == "terrain":
            scene_j = j_proc.terrain_mesh(n=max(16, int(np.sqrt(n / 2)) + 1))
        else:
            scene_j = j_proc.city_mesh(n_buildings=max(4, n // (12 * 81)),
                                       subdiv=9)
        assert np.array_equal(scene_t.vertices, scene_j.vertices)
        view = CITY_VIEW if name == "city" else SPHERE_VIEW
        assert cfg.camera == T.CameraConfig.look_at(**view)
        assert cfg.sky_emission == (0.8, 0.85, 1.0)


def test_cli_instanced_still_raises():
    """--scene instanced renders now (tests/test_torch_instances.py); with
    an environment map it raises ValueError, as sfvp_tpu's CLI does, and
    with an unported feature (--dist; --lens-radius renders now)
    NotImplementedError naming its item."""
    with pytest.raises(ValueError, match="env-map"):
        cli.main(["--device", "cpu", "--scene", "instanced", "--env-map",
                  "sky.hdr"])
    with pytest.raises(NotImplementedError, match="A.17"):
        cli.main(["--device", "cpu", "--scene", "instanced", "--dist"])


def test_dispatch_debug_is_quiet_by_default(capsys, monkeypatch):
    monkeypatch.delenv("SFVP_DISPATCH_DEBUG", raising=False)
    _, tb, _, tw, _ = scene("cornell")
    select_render_step(T.RenderConfig(**BASE, traversal="bvh"), tb, wide=tw)
    assert capsys.readouterr().err == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [("sphere", COSINE_RR), ("mirror", {})])
def test_cuda_k5_matches_twin(name, kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    _, tb, _, tw, view = scene(name)
    _, cfg = configs(dict(kw, width=64, height=48, max_depth=8), view)
    gpu_tb = T.scene.to_device(tb, "cuda")
    cpu = make_bvh_regen_render_step(cfg, tb, device_wide(tw, "cpu"))(
        T.init_state(48, 64, "cpu"))
    gpu = make_bvh_regen_render_step(cfg, gpu_tb, device_wide(tw, "cuda"))(
        T.init_state(48, 64, "cuda"))
    assert_close(gpu.accum.cpu().numpy(), cpu.accum.numpy(),
                 f"K5 CUDA vs twin ({name})", rel=1e-5, max_abs=1e-4)
