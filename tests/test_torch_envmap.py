"""Environment maps in the port: image decoding, the equirect fetch, the
env NEE distribution and its sampler against sfvp_tpu's, images of the
port's integrator against sfvp_tpu's jnp integrator (its oracle), the
fused kernels' twins against the port's eager loop, the fetch kernels P3
and P4 (kernels/envfetch.py), the routes and the refusals.

Tolerances: decoding, the texel CDF and pooled proposal, and the sampler's
cell indices are bitwise. torch-CPU and XLA-CPU round atan2 and acos
differently in the last ulp (on ~17% of random directions), so an
environment lookup is held to P3's own limit (benchmarks/probe_envfetch.py
:106: max abs < 3e-5 x the largest texel), sampled directions and pdfs to
1e-6 relative, and images to relative RMSE <= 1e-5 with fewer than 0.1%
of pixels apart by more than 1e-4. The twins of the fused kernels sum
their NEE terms in another float order than the eager loop: relative RMSE
<= 1e-5 there too.
"""

import dataclasses
import math
import struct
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.integrate import lights as j_lights  # noqa: E402
from sfvp_tpu.integrate.wavefront import make_render_step as j_make  # noqa: E402
from sfvp_tpu.render.png import encode_png  # noqa: E402
from sfvp_tpu.scene import image_io as j_io  # noqa: E402
from sfvp_tpu.scene import procedural as j_proc  # noqa: E402
from sfvp_tpu.scene import textures as j_tex  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch import cli  # noqa: E402
from sfvp_tpu_torch.accel.wide import build_wide_from_buffers  # noqa: E402
from sfvp_tpu_torch.dispatch import select_render_step  # noqa: E402
from sfvp_tpu_torch.integrate import lights as t_lights  # noqa: E402
from sfvp_tpu_torch.integrate.wavefront import make_render_step  # noqa: E402
from sfvp_tpu_torch.kernels import envfetch  # noqa: E402
from sfvp_tpu_torch.kernels.bvh_packet import device_wide  # noqa: E402
from sfvp_tpu_torch.kernels.megakernel_bvh import (  # noqa: E402
    make_bvh_regen_render_step)
from sfvp_tpu_torch.kernels.megakernel_regen import (  # noqa: E402
    make_regen_render_step)
from sfvp_tpu_torch.scene import image_io as t_io  # noqa: E402
from sfvp_tpu_torch.scene import textures as t_tex  # noqa: E402
from sfvp_tpu_torch.scene.buffers import (  # noqa: E402
    FIELDS, UV_FIELDS, from_numpy)

SPHERE_VIEW = dict(origin=(0.0, 2.2, 5.0), target=(0.0, 0.0, 0.0),
                   fov_y_deg=50.0)


def sun_png(path, h=32, w=64):
    """bench.py's sun map (bench_env_nee_100k): a dim sky, a 3 x 4 sun."""
    img = np.full((h, w, 3), 6, np.uint8)
    img[6:9, 40:44] = 255
    path.write_bytes(encode_png(img))
    return str(path)


def sky_png(path, h=16, w=32):
    """A smooth sky: a bright zenith fading to a dark horizon, tinted by
    longitude."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([255 - 12 * yy, 120 + 3 * xx, 200 - 6 * yy], -1)
    path.write_bytes(encode_png(np.clip(img, 0, 255).astype(np.uint8)))
    return str(path)


def both(jb):
    """The port's CPU buffers of sfvp_tpu buffers ``jb``, textures and
    environment map carried across."""
    cols = {k: np.asarray(getattr(jb, k)) for k in FIELDS}
    tex = None
    if jb.textures is not None:
        cols.update({k: np.asarray(getattr(jb, k))
                     for k in UV_FIELDS + ("tex",)})
        tex = [np.asarray(a) for a in jb.textures]
    env = None if jb.env is None else [np.asarray(a) for a in jb.env]
    return from_numpy(cols, jb.num_tris, "cpu", textures=tex, env=env)


def rel_rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()) / np.sqrt((b ** 2).mean()))


def assert_image(got, exp, what, rel=1e-5):
    r = rel_rmse(got, exp)
    off = float((np.abs(got - exp) > 1e-4).any(-1).mean())
    assert r <= rel and off < 1e-3, (
        f"{what}: relative RMSE {r:.3g} (bound {rel}), {off:.3%} of pixels "
        "apart by more than 1e-4 (bound 0.1%)")
    assert float(exp.max()) > 0


def jax_image(kw, jb, camera=None):
    cfg = J.RenderConfig(**kw, **({"camera": J.CameraConfig.look_at(
        **camera)} if camera else {}))
    st = jax.jit(j_make(cfg, jb))(J.init_state(kw["height"], kw["width"]))
    return np.asarray(st.accum), float(st.mrays)


def port_cfg(kw, camera=None):
    return T.RenderConfig(**kw, **({"camera": T.CameraConfig.look_at(
        **camera)} if camera else {}))


def floor_scene(env_path):
    """A lightless floor and a box under the environment: env NEE alone."""
    quads = [[(-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3)],
             [(-0.5, 0, -0.5), (0.5, 0, -0.5), (0.5, 1, -0.5),
              (-0.5, 1, -0.5)]]
    tris = []
    for a, b, c, d in quads:
        tris += [(a, b, c), (a, c, d)]
    tris = np.asarray(tris, np.float32)
    t = len(tris)
    return J.scene.objload.Scene(
        vertices=tris.reshape(-1, 3), indices=np.arange(3 * t,
                                                         dtype=np.uint32),
        face_diffuse=np.full((t, 3), 0.7, np.float32),
        face_emission=np.zeros((t, 3), np.float32),
        face_specular=np.zeros((t, 3), np.float32),
        face_mat_type=np.zeros((t,), np.int32), env_map=env_path)


FLOOR_VIEW = dict(origin=(0.0, 2.0, 4.0), target=(0.0, 0.0, 0.0),
                  fov_y_deg=45.0)


# ---- image decoding ----

def _png_filtered(img):
    """PNG bytes of (H, W, 3) u8 ``img`` with scanline filter y % 5 on row
    y, so every filter type is decoded."""
    h, w, _ = img.shape
    raw = img.reshape(h, 3 * w).astype(np.int32)
    rows = []
    prev = np.zeros(3 * w, np.int32)
    for y in range(h):
        f, cur = y % 5, raw[y]
        left = np.concatenate([np.zeros(3, np.int32), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int32), prev[:-3]])
        if f == 0:
            out = cur
        elif f == 1:
            out = cur - left
        elif f == 2:
            out = cur - prev
        elif f == 3:
            out = cur - ((left + prev) >> 1)
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            out = cur - pred
        rows.append(bytes([f]) + (out & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def _hdr(img, rle):
    """Radiance .hdr bytes of (H, W, 4) RGBE u8 ``img``, flat or RLE."""
    h, w, _ = img.shape
    out = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n",
           f"-Y {h} +X {w}\n".encode()]
    for y in range(h):
        if not rle:
            out.append(img[y].tobytes())
            continue
        out.append(bytes([2, 2, w >> 8, w & 0xFF]))
        for c in range(4):
            plane = img[y, :, c]
            half = w // 2  # one run, then literals
            out.append(bytes([128 + half, int(plane[0])]))
            out.append(bytes([w - half]) + plane[half:].tobytes())
    return b"".join(out)


@pytest.mark.parametrize("fmt", ["png", "ppm", "hdr_flat", "hdr_rle"])
def test_torch_image_decode_equals_jax(fmt, tmp_path):
    g = np.random.default_rng(3)
    img = g.integers(0, 256, (10, 12, 3), dtype=np.uint8)
    if fmt == "png":
        data = _png_filtered(img)
    elif fmt == "ppm":
        data = b"P6\n# a comment\n12 10\n255\n" + img.tobytes()
    else:
        rgbe = g.integers(0, 256, (10, 12, 4), dtype=np.uint8)
        rgbe[:, :6] = rgbe[:, :1]  # the run of the RLE rows
        rgbe[..., 3] = g.integers(120, 140, (10, 12))
        data = _hdr(rgbe, rle=fmt == "hdr_rle")
    p = tmp_path / f"img.{fmt[:3]}"
    p.write_bytes(data)
    for srgb in (True, False):
        a = t_io.load_image(str(p), srgb=srgb)
        b = j_io.load_image(str(p), srgb=srgb)
        assert a.dtype == np.float32 and a.shape[:2] == (10, 12)
        np.testing.assert_array_equal(a, b)
    if fmt == "png":
        np.testing.assert_array_equal(t_io.decode_png(data), img)


# ---- the fetch and the distribution ----

def test_torch_bilinear_and_environment_match_jax(tmp_path):
    """sample_bilinear of a two-texture pool at the same (u, v) (repeat
    wrap, negative coordinates, untextured ids) is bitwise sfvp_tpu's; the
    environment lookup differs only through atan2/acos ulps."""
    paths = [sun_png(tmp_path / "a.png"), sky_png(tmp_path / "b.png")]
    jt, tt = j_tex.build_texture_table(paths), t_tex.build_texture_table(
        paths, "cpu")
    for f in tt._fields[:-1]:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)))
    assert tt.dims == tuple(zip(np.asarray(jt.height).tolist(),
                                np.asarray(jt.width).tolist()))
    g = np.random.default_rng(5)
    u, v = (g.uniform(-2.5, 2.5, 4096).astype(np.float32) for _ in range(2))
    tid = g.integers(-1, 2, 4096).astype(np.int32)
    a = j_tex.sample_bilinear(jt, jnp.asarray(tid), jnp.asarray(u),
                              jnp.asarray(v))
    b = t_tex.sample_bilinear(tt, torch.tensor(tid), torch.tensor(u),
                              torch.tensor(v))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    d = g.normal(size=(3, 4096)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    a = j_tex.sample_environment(j_tex.build_texture_table(paths[:1]),
                                 tuple(jnp.asarray(x) for x in d))
    env = t_tex.build_texture_table(paths[:1], "cpu")
    b = t_tex.sample_environment(env, tuple(torch.tensor(x) for x in d))
    err = max(float(np.abs(y.numpy() - np.asarray(x)).max())
              for x, y in zip(a, b))
    assert err < 3e-5 * float(env.tr.max()), err
    # P3's twin is this lookup
    np.testing.assert_array_equal(
        envfetch.env_fetch(env, torch.tensor(d)).numpy(),
        torch.stack(b).numpy())


def _big_env(h=1024, w=2048):
    """bench.py's oversized sun sky (bench_env_big_nee_100k)."""
    sky = np.tile(np.linspace(0.05, 0.4, h, dtype=np.float32)[:, None],
                  (1, w))
    sky[180:196, 1400:1416] = 200.0
    flat = sky.reshape(-1)
    return (flat, flat * 0.9 + 0.02, flat * 0.7 + 0.05,
            np.zeros(1, np.int32), np.full(1, w, np.int32),
            np.full(1, h, np.int32))


@pytest.mark.parametrize("size", ["exact", "pooled"])
def test_torch_env_distribution_bitwise(size, tmp_path):
    """The texel CDF of a small map and the pooled 256 x 512 proposal of a
    2048 x 1024 one are sfvp_tpu's bit for bit, and so is the rule that
    picks between them."""
    if size == "exact":
        path = sun_png(tmp_path / "sun.png")
        jt = j_tex.build_texture_table([path])
        tt = t_tex.build_texture_table([path], "cpu")
    else:
        arrs = _big_env()
        jt = j_tex.TextureTable(*(jnp.asarray(a) for a in arrs))
        tt = t_tex.table_from_arrays(*arrs, device="cpu")
    jd, td = j_lights.env_distribution_for(jt), t_lights.env_distribution_for(tt)
    assert (td.width, td.height) == (jd.width, jd.height) == (
        (64, 32) if size == "exact" else (512, 256))
    assert t_lights.env_exact_cdf(tt) == (size == "exact")
    np.testing.assert_array_equal(td.cdf.numpy(), np.asarray(jd.cdf))
    np.testing.assert_array_equal(td.pdf_flat.numpy(), np.asarray(jd.pdf_flat))


def test_torch_sample_env_matches_jax(tmp_path):
    """The sampler's cells are sfvp_tpu's on every draw (searchsorted,
    side "right"), its directions and pdfs within 1e-6 relative, and the
    pdf of a direction (env_pdf) within 1e-6 relative except where an
    acos ulp moves theta * H / pi across a row (a rare few)."""
    path = sun_png(tmp_path / "sun.png")
    jd = j_lights.env_distribution_for(j_tex.build_texture_table([path]))
    td = t_lights.env_distribution_for(t_tex.build_texture_table([path],
                                                                 "cpu"))
    g = np.random.default_rng(7)
    r = [g.random(20000, np.float32) for _ in range(3)]
    r[0][:4] = [0.0, 1.0, float(jd.cdf[100]), float(jd.cdf[-1])]
    want = np.minimum(np.asarray(jnp.searchsorted(jd.cdf, jnp.asarray(r[0]),
                                                  side="right")),
                      jd.width * jd.height - 1)
    np.testing.assert_array_equal(t_lights.env_cell(td, torch.tensor(r[0])),
                                  want)
    (jdir, jpdf) = j_lights.sample_env(jd, *(jnp.asarray(x) for x in r))
    (tdir, tpdf) = t_lights.sample_env(td, *(torch.tensor(x) for x in r))
    for a, b in zip(jdir, tdir):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-6)
    d = g.normal(size=(3, 20000)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    a = np.asarray(j_lights.env_pdf(jd, tuple(jnp.asarray(x) for x in d)))
    b = t_lights.env_pdf(td, tuple(torch.tensor(x) for x in d)).numpy()
    close = np.isclose(b, a, rtol=1e-6, atol=0)
    assert close.mean() > 0.999, 1 - close.mean()


# ---- images against sfvp_tpu's jnp integrator ----

ENV_CASES = {
    # the sky alone, on the Cornell Box (its ceiling light and no NEE)
    "sky": dict(scene="cornell", env="sky"),
    # env NEE alone, under MIS, on a lightless floor
    "env_nee": dict(scene="floor", env="sun", use_nee=True, use_mis=True,
                    sampling="cosine"),
    "env_nee_nomis": dict(scene="floor", env="sun", use_nee=True),
    # the ceiling light and the sky, both sampled (one light sample and one
    # env sample a bounce), with MIS and roulette
    "combined": dict(scene="cornell", env="sun", use_nee=True, use_mis=True,
                     use_rr=True, sampling="cosine"),
}


def env_case(case, tmp_path):
    kw = dict(ENV_CASES[case])
    name, env = kw.pop("scene"), kw.pop("env")
    path = (sun_png if env == "sun" else sky_png)(tmp_path / f"{env}.png")
    if name == "cornell":
        s, view = J.load_obj(native="never"), None
    else:
        s, view = floor_scene(path), FLOOR_VIEW
    s.env_map = path
    jb = J.upload(s)
    return jb, both(jb), kw, view


@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_torch_env_eager_loop_matches_jax(case, tmp_path):
    jb, tb, kw, view = env_case(case, tmp_path)
    kw.update(width=16, height=16, spp_per_step=4, max_depth=3)
    exp, mrays = jax_image(kw, jb, view)
    st = make_render_step(port_cfg(kw, view), tb)(T.init_state(16, 16, "cpu"))
    assert_image(st.accum.numpy(), exp, f"eager loop vs jax ({case})")
    assert float(st.mrays) == mrays


@pytest.mark.parametrize("case", ["sky", "combined", "env_nee"])
def test_torch_k1_twin_env_matches_eager(case, tmp_path):
    """K1's twin (the fused float order) against the eager loop."""
    _, tb, kw, view = env_case(case, tmp_path)
    cfg = port_cfg(dict(kw, width=16, height=16, spp_per_step=4,
                        max_depth=3), view)
    a = make_regen_render_step(cfg, tb)(T.init_state(16, 16, "cpu"))
    b = make_render_step(cfg, tb)(T.init_state(16, 16, "cpu"))
    assert_image(a.accum.numpy(), b.accum.numpy(), f"K1 twin ({case})")
    assert float(a.mrays) == float(b.mrays)


def sphere_env(tmp_path, n=12):
    s = j_proc.sphere_mesh(n_lat=n, n_lon=n, bump=0.3)
    s.env_map = sun_png(tmp_path / "sun.png")
    jb = J.upload(s)
    tb = both(jb)
    return jb, tb, build_wide_from_buffers(tb)


@pytest.mark.parametrize("nee", [False, True])
def test_torch_k5_twin_env_matches_eager(nee, tmp_path):
    """K5's twin on the sphere under the sun, against the eager loop over
    brute force; with NEE + MIS + RR the env sample's shadow rays take K4's
    twin."""
    _, tb, wide = sphere_env(tmp_path)
    kw = dict(width=12, height=12, spp_per_step=2, max_depth=3,
              sampling="cosine", use_rr=nee, use_nee=nee, use_mis=nee)
    cfg = port_cfg(kw, SPHERE_VIEW)
    a = make_bvh_regen_render_step(cfg, tb, device_wide(wide, "cpu"))(
        T.init_state(12, 12, "cpu"))
    b = make_render_step(cfg, tb)(T.init_state(12, 12, "cpu"))
    assert_image(a.accum.numpy(), b.accum.numpy(), f"K5 twin (nee={nee})")


def test_torch_pooled_proposal_k5_matches_jax_oracle():
    """Env NEE on the oversized 2048 x 1024 sun sky: sfvp_tpu routes it to
    its wavefront loop (dispatch.py:303-316); the port keeps it on K5,
    whose twin draws the pooled proposal's streams: held to sfvp_tpu's
    jnp integrator."""
    s = j_proc.sphere_mesh(n_lat=10, n_lon=10, bump=0.3)
    arrs = _big_env()
    jb = J.upload(s)._replace(env=j_tex.TextureTable(
        *(jnp.asarray(a) for a in arrs)))
    tb = both(jb)
    kw = dict(width=16, height=16, spp_per_step=2, max_depth=3,
              sampling="cosine", use_rr=True, use_nee=True, use_mis=True,
              sky_emission=(0.8, 0.85, 1.0), traversal="bvh")
    exp, _ = jax_image(kw, jb, SPHERE_VIEW)
    cfg = port_cfg(kw, SPHERE_VIEW)
    step = select_render_step(cfg, tb, wide=build_wide_from_buffers(tb))
    assert step.__module__ == "sfvp_tpu_torch.kernels.megakernel_bvh"
    got = step(T.init_state(16, 16, "cpu")).accum.numpy()
    assert_image(got, exp, "K5 twin, pooled proposal, vs jax")


# ---- P3 and P4 ----

def test_torch_envfetch_ablations_twins(tmp_path):
    """P4's twins: trig writes (u, v, u + v) of the fetch; noread the
    weights' sum (1 within rounding); half within float16 rounding of full
    (relative 1e-3); full is P3."""
    env = t_tex.build_texture_table([sun_png(tmp_path / "sun.png")], "cpu")
    g = np.random.default_rng(11)
    d = g.normal(size=(3, 2048)).astype(np.float32)
    d = torch.tensor(d / np.linalg.norm(d, axis=0))
    full = envfetch.env_fetch(env, d)
    assert torch.equal(envfetch.env_fetch_ablate(env, d, "full"), full)
    u, v = t_tex.equirect_uv(env, tuple(d))
    trig = envfetch.env_fetch_ablate(env, d, "trig")
    assert torch.equal(trig, torch.stack([u, v, u + v]))
    assert float(u.min()) >= 0 and float(u.max()) <= 1
    ones = envfetch.env_fetch_ablate(env, d, "noread")
    assert torch.allclose(ones, torch.ones_like(ones), atol=1e-6)
    half = envfetch.env_fetch_ablate(env, d, "half")
    assert torch.allclose(half, full, rtol=1e-3, atol=1e-3 * float(
        full.abs().max()))
    with pytest.raises(ValueError, match="mode"):
        envfetch.env_fetch_ablate(env, d, "high")
    with pytest.raises(ValueError, match="CUDA tensor"):
        envfetch.env_fetch(env, torch.empty((3, 4), device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(32, 64), (1024, 2048)])
def test_cuda_envfetch_matches_twin(hw, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    h, w = hw
    g = np.random.default_rng(2)
    env = t_tex.table_from_arrays(
        *(g.uniform(0, 9, h * w).astype(np.float32) for _ in range(3)),
        [0], [w], [h], device="cuda")
    d = g.normal(size=(3, 65536)).astype(np.float32)
    d = torch.tensor(d / np.linalg.norm(d, axis=0), device="cuda")
    got = envfetch.env_fetch(env, d)
    want = envfetch.env_fetch_plain(env, d)
    assert float((got - want).abs().max()) < 3e-5 * 9.0
    for mode in envfetch.ABLATIONS:
        g_m = envfetch.env_fetch_ablate(env, d, mode)
        assert torch.equal(g_m, envfetch.env_fetch_plain(env, d, mode))
    assert torch.equal(envfetch.env_fetch_ablate(env, d, "full"), got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sky", "combined", "env_nee"])
def test_cuda_k1_env_matches_twin(case, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    _, tb, kw, view = env_case(case, tmp_path)
    cfg = port_cfg(dict(kw, width=64, height=48, spp_per_step=4,
                        max_depth=8), view)
    cpu = make_regen_render_step(cfg, tb)(T.init_state(48, 64, "cpu"))
    gpu = make_regen_render_step(cfg, T.scene.to_device(tb, "cuda"))(
        T.init_state(48, 64, "cuda"))
    assert_image(gpu.accum.cpu().numpy(), cpu.accum.numpy(),
                 f"K1 CUDA vs twin ({case})", rel=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("nee", [False, True])
def test_cuda_k5_env_matches_twin(nee, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    _, tb, wide = sphere_env(tmp_path)
    cfg = port_cfg(dict(width=64, height=48, spp_per_step=2, max_depth=8,
                        sampling="cosine", use_rr=nee, use_nee=nee,
                        use_mis=nee), SPHERE_VIEW)
    cpu = make_bvh_regen_render_step(cfg, tb, device_wide(wide, "cpu"))(
        T.init_state(48, 64, "cpu"))
    gpu = make_bvh_regen_render_step(
        cfg, T.scene.to_device(tb, "cuda"), device_wide(wide, "cuda"))(
        T.init_state(48, 64, "cuda"))
    assert_image(gpu.accum.cpu().numpy(), cpu.accum.numpy(),
                 f"K5 CUDA vs twin (nee={nee})")


# ---- routes, the CLI and the refusals ----

@pytest.mark.parametrize("argv,route", [
    ([], "megakernel_regen(brute)"),
    (["--nee", "--mis", "--sampling", "cosine", "--rr"],
     "megakernel_regen(brute)"),
    (["--scene", "sphere", "--scene-tris", "600", "--sampling", "cosine",
      "--rr", "--nee", "--mis"], "megakernel_bvh(fused regen)")],
    ids=["cornell", "cornell_nee", "sphere_nee"])
def test_torch_cli_env_map_renders(argv, route, tmp_path, capfd,
                                   monkeypatch):
    """--env-map on the CPU (the kernels' twins): K1 on the Cornell Box,
    K5 on a sphere, with and without NEE; a PNG and a JSONL record a
    step."""
    monkeypatch.setenv("SFVP_DISPATCH_DEBUG", "1")
    out, log = tmp_path / "env.png", tmp_path / "env.jsonl"
    assert cli.main(["--device", "cpu", "--width", "16", "--height", "16",
                     "--spp", "2", "--steps", "2", "--max-depth", "3",
                     "--env-map", sun_png(tmp_path / "sun.png"), *argv,
                     "--out", str(out), "--log", str(log), "--quiet"]) == 0
    assert out.exists() and len(log.read_text().splitlines()) == 2
    assert route in capfd.readouterr().err


def test_torch_env_routes(tmp_path, capfd, monkeypatch):
    """Brute force with megakernel_regen=False and an environment map
    takes the eager loop (K2 has none, as sfvp_tpu's dispatch); the bvh
    route's wavefront loop takes K3 and K4 with it."""
    monkeypatch.setenv("SFVP_DISPATCH_DEBUG", "1")
    jb, tb, kw, _ = env_case("combined", tmp_path)
    cfg = T.RenderConfig(**kw, width=8, height=8, spp_per_step=1,
                         max_depth=2, megakernel_regen=False)
    st = select_render_step(cfg, tb)(T.init_state(8, 8, "cpu"))
    assert "wavefront(brute)" in capfd.readouterr().err
    assert float(st.accum.max()) > 0
    nee_off = dataclasses.replace(cfg, use_nee=False, use_mis=False)
    select_render_step(nee_off, tb)
    assert "wavefront(brute)" in capfd.readouterr().err
    bvh = dataclasses.replace(cfg, traversal="bvh")
    select_render_step(bvh, tb, wide=build_wide_from_buffers(tb))
    assert "env=True" in capfd.readouterr().err


def test_torch_instanced_env_raises_naming_a13b(tmp_path):
    """Environment maps on instanced scenes (K7, K8, K9) come with
    ROADMAP.md A.13b: the Renderer and the adaptive sampler refuse them."""
    from sfvp_tpu_torch.accel.instances import Instance
    from sfvp_tpu_torch.integrate.adaptive import AdaptiveRenderer

    s = T.load_obj()
    s.env_map = sun_png(tmp_path / "sun.png")
    cfg = T.RenderConfig(width=16, height=16, spp_per_step=1, max_depth=2)
    for make in (lambda: T.Renderer(cfg, [Instance(scene=s)], "cpu"),
                 lambda: AdaptiveRenderer(cfg, [Instance(scene=s)], "cpu",
                                          tile=8)):
        with pytest.raises(NotImplementedError, match="A.13b"):
            make()


def test_torch_env_constants_are_float32():
    """The float32 constants the kernels take (build.make_params) are
    those the twins use."""
    from sfvp_tpu_torch.kernels import build

    env = t_tex.table_from_arrays(*_big_env(8, 16), device="cpu")
    dist = t_lights.env_distribution_for(env)
    cfg = T.RenderConfig(use_nee=True, use_mis=True)
    p = build.make_params(cfg, frame=0, row0=0, global_shape=(8, 8), npix=64,
                          num_tris=0, tp=0, env=env, env_dist=dist)
    assert (p.use_env, p.use_env_nee, p.use_mis, p.use_nee) == (1, 1, 1, 0)
    assert (p.env_w, p.env_h, p.dist_w, p.dist_h) == (16, 8, 16, 8)
    assert p.env_inv_patch == dist.inv_patch
    assert p.env_pi_over_h == np.float32(math.pi / 8)
    assert p.env_h_over_pi == np.float32(8 / math.pi)
    assert p.inv_two_pi == np.float32(0.5 / np.pi)
    assert p.pi == np.float32(np.pi)
