"""map_Kd textures in the port, against sfvp_tpu: the OBJ's vt and map_Kd,
the texture columns of the buffers, the wide BVH's tris_aux rows, the
payload's three texture planes of K3 (and K6), images of the eager loop
over brute force and over K3's twin against sfvp_tpu's jnp integrator, the
fused kernels' twins against the eager loop; and the repair of K1's and
K2's 480-triangle limit (their table past 48 KB of shared memory).

Tolerances: the columns, tris_aux and the payload planes are bitwise;
images relative RMSE <= 1e-5 with fewer than 0.1% of pixels apart by more
than 1e-4 (tests/test_torch_envmap.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.accel.sah import sah_bvh_from_arrays as j_sah  # noqa: E402
from sfvp_tpu.accel.wide import build_wide as j_build_wide  # noqa: E402
from sfvp_tpu.accel.wide import materials_array as j_materials  # noqa: E402
from sfvp_tpu.accel.wide import uv_array as j_uv  # noqa: E402
from sfvp_tpu.kernels.bvh_packet import make_packet_trace as j_k3  # noqa: E402
from sfvp_tpu.kernels.megakernel import scene_table as j_scene_table  # noqa: E402
from sfvp_tpu.render.png import encode_png  # noqa: E402
from sfvp_tpu.scene import procedural as j_proc  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch.accel.wide import build_wide_from_buffers  # noqa: E402
from sfvp_tpu_torch.camera import generate_rays_soa  # noqa: E402
from sfvp_tpu_torch.dispatch import select_render_step  # noqa: E402
from sfvp_tpu_torch.integrate.wavefront import make_render_step  # noqa: E402
from sfvp_tpu_torch.kernels import build  # noqa: E402
from sfvp_tpu_torch.kernels.bvh_packet import (  # noqa: E402
    device_wide,
    make_packet_occlusion,
    make_packet_trace,
    packet_trace,
    ray_planes,
)
from sfvp_tpu_torch.kernels.bvh_packet2 import packet_trace2  # noqa: E402
from sfvp_tpu_torch.kernels.megakernel import (  # noqa: E402
    buffers_from_table,
    make_wave_render_step,
    scene_table,
)
from sfvp_tpu_torch.kernels.megakernel_bvh import (  # noqa: E402
    make_bvh_regen_render_step)
from sfvp_tpu_torch.kernels.megakernel_regen import (  # noqa: E402
    make_regen_render_step)

from test_torch_envmap import (  # noqa: E402
    SPHERE_VIEW, assert_image, both, jax_image, port_cfg, sun_png)


def checker_png(path, n=8, cell=4):
    yy, xx = np.mgrid[0:n * cell, 0:n * cell]
    cells = ((xx // cell + yy // cell) % 2).astype(np.uint8)
    img = np.where(cells[..., None] > 0, [255, 255, 255],
                   [230, 40, 40]).astype(np.uint8)
    path.write_bytes(encode_png(img))
    return str(path)


def textured_obj(tmp_path):
    """A checkered quad facing +z (full [0,1]^2 vt) and a plain one
    behind it: an OBJ with vt and map_Kd, and a face without a texture."""
    checker_png(tmp_path / "check.png")
    (tmp_path / "m.mtl").write_text(
        "newmtl tex\nKd 1 1 1\nmap_Kd check.png\n"
        "newmtl plain\nKd 0.5 0.6 0.7\n")
    (tmp_path / "s.obj").write_text(
        "mtllib m.mtl\n"
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
        "v -3 -3 -1\nv 3 -3 -1\nv 3 3 -1\nv -3 3 -1\n"
        "vt 0 0\nvt 2 0\nvt 2 2\nvt 0 2\n"
        "usemtl tex\nf 1/1 2/2 3/3 4/4\n"
        "usemtl plain\nf 5 6 7 8\n")
    return str(tmp_path / "s.obj")


QUAD_VIEW = dict(origin=(0.3, 0.2, 2.5), target=(0.0, 0.0, 0.0),
                 fov_y_deg=50.0)


def textured_sphere(tmp_path, n=12, env=False):
    """bench.py's textured sphere (bench_textured_100k) at a small size:
    planar vt from x and z, the checker on two faces of three."""
    s = j_proc.sphere_mesh(n_lat=n, n_lon=n, bump=0.3)
    t = len(s.face_diffuse)
    tri = s.vertices[s.indices.reshape(-1)].reshape(t, 3, 3)
    s.face_uv = np.stack([tri[..., 0] * 0.5 + 0.5, tri[..., 2] * 0.5 + 0.5],
                         axis=-1).astype(np.float32)
    s.face_tex = np.where(np.arange(t) % 3 == 0, -1, 0).astype(np.int32)
    s.texture_paths = [checker_png(tmp_path / "check.png")]
    if env:
        s.env_map = sun_png(tmp_path / "sun.png")
    jb = J.upload(s)
    tb = both(jb)
    return jb, tb


def test_torch_obj_vt_map_kd_ingest(tmp_path):
    """The port's OBJ loader reads vt and map_Kd as sfvp_tpu's does, and
    its buffers carry the same texture columns, table and pool."""
    p = textured_obj(tmp_path)
    a, b = J.load_obj(p, native="never"), T.load_obj(p)
    np.testing.assert_array_equal(a.face_uv, b.face_uv)
    np.testing.assert_array_equal(a.face_tex, b.face_tex)
    assert a.texture_paths == b.texture_paths and b.face_tex.tolist() == [
        0, 0, -1, -1]
    jb, tb = J.upload(a, pad_to=8), T.upload(b, device="cpu", pad_to=8)
    assert tb.has_textures
    for k in ("u0", "v0t", "u1", "v1t", "u2", "v2t", "tex"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    for k in tb.textures._fields[:-1]:
        np.testing.assert_array_equal(getattr(tb.textures, k).numpy(),
                                      np.asarray(getattr(jb.textures, k)))
    tt = scene_table(tb)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(j_scene_table(jb)))
    back = buffers_from_table(tt, tb.num_tris, tb.textures)
    for k in ("u0", "v2t", "tex"):
        assert torch.equal(getattr(back, k), getattr(tb, k)[: tb.num_tris])


def test_torch_texture_table_keeps_sizes_on_host(tmp_path):
    """A table keeps each texture's (height, width) as host ints, equal to
    its size tensors, so that a launch reads a map's size without a copy
    from the device; moving the table or the scene keeps them."""
    from sfvp_tpu_torch.scene.buffers import to_device
    from sfvp_tpu_torch.scene.textures import build_texture_table

    paths = [checker_png(tmp_path / "c.png", n=4, cell=3),
             sun_png(tmp_path / "s.png")]
    table = build_texture_table(paths, "cpu")
    assert table.dims == ((12, 12), (32, 64))
    assert table.dims == tuple(zip(table.height.tolist(),
                                   table.width.tolist()))
    assert all(type(x) is int for hw in table.dims for x in hw)
    assert table.shape0() == (12, 12)
    assert table.to("cpu").dims == table.dims
    _, tb = textured_sphere(tmp_path, env=True)
    moved = to_device(tb, "cpu")
    assert moved.textures.dims == tb.textures.dims == ((32, 32),)
    assert moved.env.shape0() == (32, 64)


def test_torch_tris_aux_equals_jax(tmp_path):
    """tris_aux of a textured tree is byte-identical to sfvp_tpu's (its
    NumPy SAH build of the same triangles)."""
    jb, tb = textured_sphere(tmp_path)
    tw = build_wide_from_buffers(tb, builder="sah")
    tris = np.stack([np.stack([np.asarray(getattr(jb, f"v{c}{a}"))
                               [: jb.num_tris] for a in "xyz"], -1)
                     for c in range(3)], 1)
    jw = j_build_wide(j_sah(tris, leaf_size=8, native="never"),
                      j_materials(jb), aux=j_uv(jb))
    assert tw.tris_aux is not None and tw.tris_aux.dtype == np.float32
    assert tw.tris_aux.tobytes() == jw.tris_aux.tobytes()
    assert tw.tris.tobytes() == jw.tris.tobytes()


def _camera_wave(cfg, n):
    idx = torch.arange(n * n)
    px, py = idx % n, idx // n
    o, d = generate_rays_soa(px, py, torch.full((n * n,), 0.5),
                             torch.full((n * n,), 0.5), cfg.camera, n, n)
    return o, d


def test_torch_k3_texture_planes_equal_jax(tmp_path):
    """K3's twin writes the 22 payload planes of sfvp_tpu's K3 (in
    interpret mode) on a 16x16 camera wave of the textured sphere, as
    tests/test_torch_bvh_trace.py holds the 19: the same triangle on every
    ray, its slot's planes and texid equal, t, u, v and the interpolated
    texu, texv within 1e-5 (XLA-CPU rounds Moller-Trumbore's products in
    another order on a few rays); K6's twin writes K3's twin's planes."""
    jb, tb = textured_sphere(tmp_path)
    tw = build_wide_from_buffers(tb, builder="sah")
    cfg = port_cfg(dict(width=16, height=16), SPHERE_VIEW)
    o, d = _camera_wave(cfg, 16)
    dw = device_wide(tw, "cpu")
    got = packet_trace(dw, cfg.t_min, ray_planes(o, d, cfg.t_max))
    assert got.shape == (22, 256)
    jpay = j_k3(tw, t_min=cfg.t_min, interpret=True)(
        tuple(jnp.asarray(c.numpy()) for c in o),
        tuple(jnp.asarray(c.numpy()) for c in d), cfg.t_max)
    want = [jpay.t, jpay.u, jpay.v, *jpay.p0, *jpay.p1, *jpay.p2,
            *jpay.albedo, *jpay.emission, jpay.mtype, jpay.texu, jpay.texv,
            jpay.texid + 1]
    want = np.stack([np.asarray(w, np.float32) for w in want])
    g = got.numpy()
    np.testing.assert_array_equal(np.isinf(g[0]), np.isinf(want[0]))
    fin = np.isfinite(want[0])
    np.testing.assert_array_equal(g[3:19, fin], want[3:19, fin])
    np.testing.assert_array_equal(g[21], want[21])
    for i in (0, 1, 2, 19, 20):
        np.testing.assert_allclose(g[i, fin], want[i, fin], rtol=1e-5,
                                   atol=1e-5, err_msg=i)
    assert (g[1:, ~fin] == 0).all()
    hit = torch.isfinite(got[0])
    assert hit.any() and (got[21][hit] == 1).any() and (
        got[21][hit] == 0).any()
    assert torch.equal(packet_trace2(dw, cfg.t_min,
                                     ray_planes(o, d, cfg.t_max)), got)
    pay = make_packet_trace(dw, cfg.t_min)(o, d, cfg.t_max)
    assert torch.equal(pay.texid, got[21].to(torch.int32) - 1)


TEX_CASES = {
    "brute": dict(traversal="brute"),
    "payload": dict(traversal="bvh", megakernel_regen=False),
    "payload_nee": dict(traversal="bvh", megakernel_regen=False,
                        use_nee=True, use_mis=True, use_rr=True),
}


@pytest.mark.parametrize("case", sorted(TEX_CASES))
def test_torch_textured_image_matches_jax(case, tmp_path):
    """The eager loop over brute force, and over K3's twin (and K4's for
    the env sample's shadow rays under NEE), on the textured sphere under
    the sun, against sfvp_tpu's jnp integrator."""
    jb, tb = textured_sphere(tmp_path, env=True)
    kw = dict(width=16, height=16, spp_per_step=2, max_depth=3,
              sampling="cosine", **TEX_CASES[case])
    exp, mrays = jax_image({k: v for k, v in kw.items()
                            if k not in ("traversal", "megakernel_regen")},
                           jb, SPHERE_VIEW)
    cfg = port_cfg(kw, SPHERE_VIEW)
    wide = (build_wide_from_buffers(tb) if cfg.traversal == "bvh" else None)
    st = select_render_step(cfg, tb, wide=wide)(T.init_state(16, 16, "cpu"))
    assert_image(st.accum.numpy(), exp, f"textured {case} vs jax")
    assert float(st.mrays) == pytest.approx(mrays, rel=1e-6)


def test_torch_textured_quad_shows_the_checker(tmp_path):
    """The checker shows on the quad (the red cells kill green), and the
    plain face behind stays flat: K1's twin on the OBJ."""
    tb = T.upload(T.load_obj(textured_obj(tmp_path)), device="cpu")
    cfg = port_cfg(dict(width=32, height=32, spp_per_step=8, max_depth=2,
                        sampling="cosine", sky_emission=(1.0, 1.0, 1.0)),
                   QUAD_VIEW)
    step = select_render_step(cfg, tb)
    assert step.__module__ == "sfvp_tpu_torch.kernels.megakernel_regen"
    img = step(T.init_state(32, 32, "cpu")).accum.numpy()
    center = img[10:22, 10:22, 1]
    assert center.max() > 4 * max(center.min(), 1e-6)


@pytest.mark.parametrize("kernel", ["K1", "K5"])
def test_torch_fused_twins_textured_match_eager(kernel, tmp_path):
    """K1's and K5's twins on the textured sphere under the sun with NEE +
    MIS + RR, against the eager loop over brute force."""
    _, tb = textured_sphere(tmp_path, n=10, env=True)
    cfg = port_cfg(dict(width=12, height=12, spp_per_step=2, max_depth=3,
                        sampling="cosine", use_rr=True, use_nee=True,
                        use_mis=True), SPHERE_VIEW)
    if kernel == "K1":
        step = make_regen_render_step(cfg, tb)
    else:
        step = make_bvh_regen_render_step(
            cfg, tb, device_wide(build_wide_from_buffers(tb), "cpu"))
    a = step(T.init_state(12, 12, "cpu"))
    b = make_render_step(cfg, tb)(T.init_state(12, 12, "cpu"))
    assert_image(a.accum.numpy(), b.accum.numpy(), f"{kernel} twin textured")
    assert float(a.mrays) == float(b.mrays)


def test_torch_textured_routes(tmp_path, capfd, monkeypatch):
    """Brute force with megakernel_regen=False takes the eager loop for a
    textured scene (K2 has no textures and refuses them); K3's and K6's
    wavefront loops carry the texture planes; the instanced routes refuse
    textures, naming ROADMAP.md A.13b."""
    from sfvp_tpu_torch.accel.instances import Instance

    monkeypatch.setenv("SFVP_DISPATCH_DEBUG", "1")
    scene = T.load_obj(textured_obj(tmp_path))
    tb = T.upload(scene, device="cpu")
    cfg = T.RenderConfig(width=8, height=8, spp_per_step=1, max_depth=2,
                         megakernel_regen=False)
    select_render_step(cfg, tb)
    assert "wavefront(brute)" in capfd.readouterr().err
    with pytest.raises(ValueError, match="textures"):
        make_wave_render_step(cfg, tb)
    for stream in (False, True):
        c = dataclasses.replace(cfg, traversal="bvh", stream_tris=stream)
        st = select_render_step(c, tb, wide=build_wide_from_buffers(tb))(
            T.init_state(8, 8, "cpu"))
        err = capfd.readouterr().err
        assert f"stream={stream}" in err and "tex=True" in err
        assert float(st.accum.max()) > 0
    with pytest.raises(NotImplementedError, match="A.13b"):
        T.Renderer(cfg, [Instance(scene=scene)], "cpu")


# ---- repair: K1 and K2 past 480 triangles ----

def test_torch_table_plan():
    """The whole table sits in shared memory while it fits the 227 KB a
    block may opt in to (a 12-float record per triangle, textured or not:
    4,842); beyond, tiles of 1,024 triangles (9 rows)."""
    assert build.table_plan(36) == (0, 36 * 12 * 4)
    assert build.table_plan(3000) == (0, 3000 * 12 * 4)
    assert 3000 * 12 * 4 > 48 * 1024  # the opt-in path
    assert build.table_plan(4842)[0] == 0
    assert build.table_plan(4843) == (1024, 1024 * 9 * 4)
    assert build.table_plan(6000) == (1024, 1024 * 9 * 4)


def _big_brute(n_lat):
    s = J.scene.procedural.sphere_mesh(n_lat=n_lat, n_lon=n_lat, bump=0.3)
    jb = J.upload(s)
    return jb, both(jb)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_torch_brute_route_past_480_triangles(kernel):
    """About 1,000 triangles on the brute route through K1's and K2's
    twins: nothing raises (the kernels took at most 480 before); the
    images are sfvp_tpu's."""
    jb, tb = _big_brute(23)
    assert 900 < tb.num_tris < 1100
    kw = dict(width=8, height=8, spp_per_step=1, max_depth=2,
              sampling="cosine", traversal="brute",
              megakernel_regen=kernel == "K1")
    cfg = port_cfg(kw, SPHERE_VIEW)
    st = select_render_step(cfg, tb)(T.init_state(8, 8, "cpu"))
    exp, _ = jax_image({k: v for k, v in kw.items()
                        if k not in ("traversal", "megakernel_regen")},
                       jb, SPHERE_VIEW)
    assert_image(st.accum.numpy(), exp, f"{kernel} twin at 1,000 tris")


@pytest.mark.cuda
@pytest.mark.parametrize("n_lat", [39, 51], ids=["opt_in", "tiled"])
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_cuda_brute_past_480_triangles_matches_twin(kernel, n_lat):
    """K1 and K2 against their twins on ~3,000 triangles (the table in
    opted-in shared memory) and ~5,100 (in tiles) at 64x64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    _, tb = _big_brute(n_lat)
    cfg = port_cfg(dict(width=64, height=64, spp_per_step=2, max_depth=8,
                        sampling="cosine", use_rr=True, traversal="brute",
                        megakernel_regen=kernel == "K1"), SPHERE_VIEW)
    cpu = select_render_step(cfg, tb)(T.init_state(64, 64, "cpu"))
    gpu = select_render_step(cfg, T.scene.to_device(tb, "cuda"))(
        T.init_state(64, 64, "cuda"))
    assert_image(gpu.accum.cpu().numpy(), cpu.accum.numpy(),
                 f"{kernel} CUDA vs twin ({tb.num_tris} tris)", rel=1e-4)


@pytest.mark.cuda
def test_cuda_k1_textured_matches_twin(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    tb = T.upload(T.load_obj(textured_obj(tmp_path)), device="cpu")
    cfg = port_cfg(dict(width=64, height=48, spp_per_step=4, max_depth=8,
                        sampling="cosine", sky_emission=(1.0, 1.0, 1.0)),
                   QUAD_VIEW)
    cpu = make_regen_render_step(cfg, tb)(T.init_state(48, 64, "cpu"))
    gpu = make_regen_render_step(cfg, T.scene.to_device(tb, "cuda"))(
        T.init_state(48, 64, "cuda"))
    assert_image(gpu.accum.cpu().numpy(), cpu.accum.numpy(),
                 "K1 CUDA vs twin (textured)", rel=1e-4)


@pytest.mark.cuda
def test_cuda_k3_k5_textured_match_twins(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    _, tb = textured_sphere(tmp_path, env=True)
    tw = build_wide_from_buffers(tb)
    cfg = port_cfg(dict(width=64, height=48, spp_per_step=2, max_depth=8,
                        sampling="cosine", use_rr=True, use_nee=True,
                        use_mis=True), SPHERE_VIEW)
    o, d = _camera_wave(cfg, 64)
    rays = ray_planes(o, d, cfg.t_max)
    got = packet_trace(device_wide(tw, "cuda"), cfg.t_min, rays.cuda())
    want = packet_trace(device_wide(tw, "cpu"), cfg.t_min, rays)
    assert torch.equal(got.cpu(), want)
    cpu = make_bvh_regen_render_step(cfg, tb, device_wide(tw, "cpu"))(
        T.init_state(48, 64, "cpu"))
    gpu = make_bvh_regen_render_step(cfg, T.scene.to_device(tb, "cuda"),
                                     device_wide(tw, "cuda"))(
        T.init_state(48, 64, "cuda"))
    assert_image(gpu.accum.cpu().numpy(), cpu.accum.numpy(),
                 "K5 CUDA vs twin (textured)")
    occ = make_packet_occlusion(device_wide(tw, "cuda"), cfg.t_min)
    assert occ(tuple(c.cuda() for c in o), tuple(c.cuda() for c in d),
               cfg.t_max).dtype == torch.bool
