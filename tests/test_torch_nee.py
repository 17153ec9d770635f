"""Next-event estimation and MIS in the port against sfvp_tpu: the light
table and its sampling, the eager wavefront integrator (the brute route
with megakernel_regen=False) against sfvp_tpu's jnp integrator, K1's plain
twin against the JAX K1 Pallas kernel in interpret mode (as
tests/test_megakernel.py runs it), the dispatch of the four NEE routes, and
the CLI's --nee / --mis.

Tolerances: relative RMSE < 1e-5 and max abs < 1e-4 (ROADMAP.md §C, the
framework bound of test_torch_integrator.py), traced segments equal. The
light tables are equal bit for bit, and light picks equal on every draw.

The ``cuda`` test holds the CUDA kernel against its twin and skips without
a card; chip_smoke.py runs the same comparison on the H100.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import sfvp_tpu as J  # noqa: E402
from sfvp_tpu.integrate import lights as j_lights  # noqa: E402
from sfvp_tpu.integrate.wavefront import make_render_step as j_make  # noqa: E402
from sfvp_tpu.kernels.megakernel_regen import (  # noqa: E402
    make_regen_render_step as j_k1,
)
from sfvp_tpu.scene.objload import Scene as JScene  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch import cli  # noqa: E402
from sfvp_tpu_torch.dispatch import select_render_step  # noqa: E402
from sfvp_tpu_torch.integrate import lights as t_lights  # noqa: E402
from sfvp_tpu_torch.integrate.wavefront import make_render_step  # noqa: E402
from sfvp_tpu_torch.kernels import build  # noqa: E402
from sfvp_tpu_torch.kernels.megakernel import scene_table  # noqa: E402
from sfvp_tpu_torch.kernels.megakernel_regen import (  # noqa: E402
    make_regen_render_step,
    regen_render,
)
from sfvp_tpu_torch.scene.buffers import FIELDS, from_numpy  # noqa: E402

from test_torch_integrator import (  # noqa: E402
    assert_close,
    both_buffers,
    mirror_scene_arrays,
)

H, W = 8, 16
# the shape of tests/test_megakernel.py:94-120 and :301-330
K1_BASE = dict(width=W, height=H, spp_per_step=2, max_depth=3,
               sampling="cosine", use_rr=True, rr_start_depth=1)
LIGHTS_VIEW = dict(origin=(0.0, 1.8, 5.5), target=(0.0, 0.5, 0.0),
                   fov_y_deg=50.0)


def lights_scene(n_lights, seed=9):
    """A floor under ``n_lights`` small emissive triangles (the scene of
    tests/test_megakernel.py:211-239 for 80): (JAX buffers, port
    buffers)."""
    g = np.random.default_rng(seed)
    big = 6.0
    tris = [
        [[-big, 0, -big], [big, 0, -big], [big, 0, big]],
        [[-big, 0, -big], [big, 0, big], [-big, 0, big]],
    ]
    emission = [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]]
    cols = max(10, int(np.ceil(np.sqrt(n_lights))))
    for i in range(n_lights):
        cx = -5.0 + (i % cols) * (10.0 / cols)
        cz = -5.0 + (i // cols) * (12.0 / cols)
        s = 0.15 + 0.1 * g.random()
        tris.append([[cx - s, 3.0, cz - s], [cx + s, 3.0, cz - s],
                     [cx, 3.0, cz + s]])
        emission.append(list(2.0 + 4.0 * g.random(3)))
    t = len(tris)
    scene = JScene(
        vertices=np.asarray(tris, np.float32).reshape(-1, 3),
        indices=np.arange(3 * t, dtype=np.uint32),
        face_diffuse=np.tile(np.asarray([[0.6, 0.5, 0.4]], np.float32),
                             (t, 1)),
        face_emission=np.asarray(emission, np.float32),
    )
    jb = J.upload(scene)
    tb = from_numpy({k: np.asarray(getattr(jb, k)) for k in FIELDS},
                    jb.num_tris, "cpu")
    return jb, tb


def _tables(n_lights):
    if n_lights == 2:
        jb, tb = both_buffers("cornell")
    else:
        jb, tb = lights_scene(n_lights)
    return (j_lights.build_light_table_from_buffers(jb),
            t_lights.build_light_table_from_buffers(tb))


@pytest.mark.parametrize("n_lights", [2, 80, 200])
def test_light_table_is_bitwise_jax(n_lights):
    jl, tl = _tables(n_lights)
    assert tl.num == jl.num == n_lights
    assert tl.total_area == jl.total_area
    # rows v0, v1, v2, n, le (xyz each), the layout the kernels read
    for i, name in enumerate(("v0", "v1", "v2", "n", "le")):
        for a, b in zip(tl.rows[3 * i:3 * i + 3], getattr(jl, name)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tl.cdf.numpy(), np.asarray(jl.cdf))
    from sfvp_tpu_torch.scene.procedural import sphere_mesh

    assert t_lights.build_light_table_from_buffers(
        T.upload(sphere_mesh(8, 8), device="cpu")) is None


def _draws(cdf, n, seed):
    """n selection numbers in [0, 1], a quarter of them exactly on CDF
    entries (where the strict and the non-strict pick differ)."""
    g = np.random.default_rng(seed)
    r = g.uniform(0, 1, n).astype(np.float32)
    r[: n // 4] = np.asarray(cdf)[g.integers(0, len(cdf), n // 4)]
    return r, g.uniform(0, 1, n).astype(np.float32), g.uniform(
        0, 1, n).astype(np.float32)


@pytest.mark.parametrize("n_lights", [2, 80, 200])
def test_sample_light_matches_jax(n_lights):
    """sfvp_tpu's pick rule: compare-sum up to 64 lights, searchsorted
    beyond. The picked normal and emission are equal on every draw; the
    sampled point to float32 rounding (XLA on the CPU may contract its
    multiply-adds into fused ones), which a wrong pick, a light elsewhere,
    would exceed by orders of magnitude."""
    jl, tl = _tables(n_lights)
    r_sel, r1, r2 = _draws(tl.cdf, 4096, seed=n_lights)
    want = j_lights.sample_light(jl, jnp.asarray(r_sel), jnp.asarray(r1),
                                 jnp.asarray(r2))
    got = t_lights.sample_light(tl, torch.from_numpy(r_sel),
                                torch.from_numpy(r1), torch.from_numpy(r2))
    for g3, w3 in zip(got[1:3], want[1:3]):
        for a, b in zip(g3, w3):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    assert got[3] == float(want[3])


@pytest.mark.parametrize("n_lights", [2, 80, 200])
def test_fused_pick_is_the_kernels_chain(n_lights):
    """The fused kernels' pick (megakernel_regen.py:676-688): the count of
    CDF entries below r_sel over the first L - 1, on every draw; and where
    no draw lands on a CDF entry it equals sfvp_tpu's sample_light pick."""
    _, tl = _tables(n_lights)
    r_sel = _draws(tl.cdf, 4096, seed=n_lights + 1)[0]
    cdf = tl.cdf.numpy()
    chain = np.zeros(r_sel.shape, np.int64)
    for i in range(n_lights - 1):
        chain += r_sel > cdf[i]
    r = torch.from_numpy(r_sel)
    fused = t_lights.light_index(tl, r, fused=True).numpy()
    np.testing.assert_array_equal(fused, chain)
    off = ~np.isin(r_sel, cdf)
    np.testing.assert_array_equal(
        fused[off], t_lights.light_index(tl, r).numpy()[off])


@pytest.mark.parametrize("scene", ["cornell", "mirror"])
@pytest.mark.parametrize("sampling", ["uniform", "cosine"])
@pytest.mark.parametrize("mis", [False, True], ids=["nee", "mis"])
def test_eager_wavefront_nee_matches_jax(scene, sampling, mis):
    """The brute route with megakernel_regen=False under NEE: the port's
    eager wavefront integrator against sfvp_tpu's jnp one, RR on."""
    jb, tb = both_buffers(scene)
    kw = dict(width=32, height=32, spp_per_step=2, max_depth=4,
              sampling=sampling, use_rr=True, rr_start_depth=1,
              use_nee=True, use_mis=mis, megakernel_regen=False)
    want = jax.jit(j_make(J.RenderConfig(**kw), jb))(J.init_state(32, 32))
    step = select_render_step(T.RenderConfig(**kw), tb)
    assert "make_render_step" in step.__qualname__
    got = step(T.init_state(32, 32, "cpu"))
    assert_close(got.accum.numpy(), np.asarray(want.accum),
                 f"eager wavefront vs jax ({scene}, {sampling}, mis={mis})")
    assert float(got.mrays) == float(want.mrays), "traced segments differ"


def _k1_case(case):
    """(JAX buffers, port buffers, config kwargs) of a K1 NEE case."""
    if case == "lights80":
        jb, tb = lights_scene(80)
        return jb, tb, dict(width=W, height=H, spp_per_step=1, max_depth=2,
                            sampling="cosine", use_nee=True, use_mis=True,
                            sky_emission=(0.05, 0.05, 0.05))
    scene = "mirror" if case.startswith("mirror") else "cornell"
    jb, tb = both_buffers(scene)
    return jb, tb, dict(K1_BASE, use_nee=True,
                        use_mis=case.endswith("mis"))


@pytest.mark.parametrize("case", ["nee", "mis", "mirror_mis", "lights80"])
def test_k1_twin_matches_jax_k1_interpret(case):
    jb, tb, kw = _k1_case(case)
    cams = {}
    if case == "lights80":
        cams = {mod: dict(camera=mod.CameraConfig.look_at(**LIGHTS_VIEW))
                for mod in (J, T)}
    want = jax.jit(j_k1(J.RenderConfig(**kw, **cams.get(J, {})), jb,
                        interpret=True))(J.init_state(H, W))
    step = make_regen_render_step(T.RenderConfig(**kw, **cams.get(T, {})),
                                  tb)
    got = step(T.init_state(H, W, "cpu"))
    assert_close(got.accum.numpy(), np.asarray(want.accum),
                 f"K1 twin vs jax K1 ({case})")
    assert float(got.mrays) == float(want.mrays), "traced segments differ"
    assert float(got.accum.max()) > 0


def test_k1_twin_and_eager_wavefront_agree():
    """The fused and the wavefront float orders of the NEE term estimate
    the same light: K1's twin and the eager wavefront agree to rounding."""
    _, tb = both_buffers("cornell")
    cfg = T.RenderConfig(**dict(K1_BASE, use_nee=True, use_mis=True))
    k1 = make_regen_render_step(cfg, tb)(T.init_state(H, W, "cpu"))
    wf = make_render_step(cfg, tb)(T.init_state(H, W, "cpu"))
    assert_close(k1.accum.numpy(), wf.accum.numpy(), "K1 twin vs wavefront")
    assert float(k1.mrays) == float(wf.mrays)


def test_nee_without_lights_renders_as_without_nee():
    """A scene with no emissive triangle: NEE and MIS engage nowhere, and
    the image is bitwise the one without them, through K1's, K5's and the
    wavefront loop's twins and the eager wavefront."""
    from sfvp_tpu_torch.accel.wide import build_wide_from_buffers
    from sfvp_tpu_torch.scene.procedural import sphere_mesh

    tb = T.upload(sphere_mesh(10, 10, bump=0.3), device="cpu")
    wide = build_wide_from_buffers(tb)
    kw = dict(width=W, height=H, spp_per_step=2, max_depth=3,
              sampling="cosine", use_rr=True, traversal="brute")
    steps = {
        "k1": lambda c: select_render_step(c, tb),
        "eager": lambda c: make_render_step(c, tb),
        "k5": lambda c: select_render_step(
            dataclasses.replace(c, traversal="bvh"), tb, wide=wide),
        "k3_k4": lambda c: select_render_step(
            dataclasses.replace(c, traversal="bvh", megakernel_regen=False),
            tb, wide=wide),
    }
    for route, make in steps.items():
        imgs = [make(T.RenderConfig(**kw, **nee))(
            T.init_state(H, W, "cpu")).accum
            for nee in ({}, dict(use_nee=True, use_mis=True))]
        assert torch.equal(*imgs), route


@pytest.mark.parametrize("kw,route", [
    (dict(), "megakernel_regen(brute)"),
    (dict(megakernel_regen=False), "wavefront(brute)"),
    (dict(traversal="bvh"), "megakernel_bvh(fused regen)"),
    (dict(traversal="bvh", megakernel_regen=False),
     "wavefront(packet kernels)"),
], ids=["k1", "eager", "k5", "k3_k4"])
def test_dispatch_nee_routes(kw, route, capsys, monkeypatch):
    from sfvp_tpu_torch.accel.wide import build_wide_from_buffers

    monkeypatch.setenv("SFVP_DISPATCH_DEBUG", "1")
    _, tb = both_buffers("cornell")
    cfg = T.RenderConfig(width=W, height=H, spp_per_step=1, max_depth=2,
                         use_nee=True, use_mis=True, **kw)
    step = select_render_step(cfg, tb, wide=build_wide_from_buffers(tb))
    err = capsys.readouterr().err
    assert f"[sfvp_tpu_torch dispatch] {route}" in err, err
    assert float(step(T.init_state(H, W, "cpu")).accum.max()) > 0


def test_many_lights_stay_on_the_fused_kernel(capsys, monkeypatch):
    """More than sfvp_tpu's MAX_KERNEL_LIGHTS (16384, a VMEM cap that
    sends it to its wavefront loop): the port keeps K5, whose light table
    lives in device memory."""
    from sfvp_tpu_torch.accel.wide import build_wide_from_buffers
    from sfvp_tpu_torch.scene.buffers import from_arrays

    n = 16400
    g = np.random.default_rng(3)
    tris = (g.uniform(-5, 5, (n, 1, 3))
            + g.normal(0, 0.05, (n, 3, 3))).astype(np.float32)
    tb = from_arrays(tris, np.full((n, 3), 0.5, np.float32),
                     np.full((n, 3), 1.0, np.float32), device="cpu")
    assert t_lights.build_light_table_from_buffers(tb).num == n
    monkeypatch.setenv("SFVP_DISPATCH_DEBUG", "1")
    select_render_step(T.RenderConfig(use_nee=True), tb,
                       wide=build_wide_from_buffers(tb))
    assert "megakernel_bvh(fused regen)" in capsys.readouterr().err


@pytest.mark.parametrize("kw", [dict(use_nee=True),
                                dict(use_nee=True, use_mis=True)],
                         ids=["nee", "mis"])
def test_config_hash_equals_jax(kw):
    assert (T.RenderConfig(**kw).config_hash()
            == J.RenderConfig(**kw).config_hash())
    assert (T.RenderConfig(**kw).config_hash()
            != T.RenderConfig().config_hash())


def test_cli_nee_mis_renders_on_cpu(tmp_path):
    """--mis implies --nee (as sfvp_tpu's CLI, cli.py:89-90); the render
    is K1's twin, and its checkpoint carries the NEE + MIS config hash."""
    out, ck = tmp_path / "n.png", tmp_path / "n.npz"
    rc = cli.main(["--device", "cpu", "--width", "8", "--height", "8",
                   "--spp", "2", "--max-depth", "3", "--steps", "2",
                   "--sampling", "cosine", "--rr", "--mis", "--out",
                   str(out), "--checkpoint", str(ck), "--quiet"])
    assert rc == 0 and out.stat().st_size > 0
    from sfvp_tpu_torch.render.checkpoint import load_checkpoint

    want = T.RenderConfig(width=8, height=8, spp_per_step=2, max_depth=3,
                          sampling="cosine", use_rr=True, use_nee=True,
                          use_mis=True).config_hash()
    state, got = load_checkpoint(str(ck), device="cpu")
    assert got == want and state.frame == 2


def test_kernel_refuses_a_light_table_it_cannot_read():
    """The light table K1 and K5 read: contiguous float32 (16, L) on the
    scene's device; anything else raises before a launch."""
    with pytest.raises(ValueError, match="16, L"):
        build.check_lights(torch.empty((15, 2), device="meta"), "meta")
    with pytest.raises(ValueError, match="16, L"):
        build.check_lights(torch.empty((16, 4), dtype=torch.float64,
                                       device="meta"), "meta")
    with pytest.raises(ValueError, match="light table on"):
        build.check_lights(torch.empty((16, 2), device="meta"), "cpu")
    # a meta scene table never reaches a twin: the wrapper refuses it
    _, tb = both_buffers("cornell")
    lights = t_lights.build_light_table_from_buffers(tb)
    with pytest.raises(ValueError, match="CUDA tensor"):
        regen_render(torch.empty((20, 36), device="meta"), 0, 0,
                     cfg=T.RenderConfig(width=8, height=8, use_nee=True),
                     num_tris=36, global_shape=(8, 8), npix=64,
                     has_mirrors=False, lights=lights)


def test_nee_params_mirror_the_light_table():
    """make_params carries the light table's count and the float32 area
    constants the twins use; without lights NEE and MIS are off."""
    _, tb = both_buffers("cornell")
    lt = t_lights.build_light_table_from_buffers(tb)
    cfg = T.RenderConfig(width=8, height=8, use_nee=True, use_mis=True)
    kw = dict(frame=0, row0=0, global_shape=(8, 8), npix=64, num_tris=36,
              tp=36)
    p = build.make_params(cfg, lights=lt, **kw)
    assert (p.use_nee, p.use_mis, p.num_lights) == (1, 1, 2)
    assert p.total_area == np.float32(lt.total_area)
    assert p.inv_area == np.float32(1.0 / lt.total_area)
    assert p.inv_pi == np.float32(1.0 / np.pi)
    assert p.uniform_pdf == np.float32(1.0) / np.float32(2.0 * np.pi)
    q = build.make_params(cfg, **kw)
    assert (q.use_nee, q.use_mis, q.num_lights) == (0, 0, 0)
    # the kernels' shadow-ray scale, 0.999f, is float32(1 - 1e-3)
    assert np.float32(1.0 - 1e-3) == np.float32(0.999)


def test_k1_twin_counts_the_kernels_shadow_tests():
    """The counts behind K1's bound: the tests of the kernel's scan in id
    order that stops at its first hit (brute_any_hit), here replayed
    triangle by triangle; counting never changes the image."""
    from sfvp_tpu_torch.kernels.intersect import any_hit_tests, moller_trumbore_soa
    from sfvp_tpu_torch.kernels.megakernel_regen import regen_render_plain

    _, tb = both_buffers("cornell")
    g = np.random.default_rng(5)
    m = 512
    o = tuple(torch.from_numpy(g.uniform(-0.9, 0.9, m).astype(np.float32))
              for _ in range(3))
    d = torch.from_numpy(g.normal(size=(3, m)).astype(np.float32))
    d = tuple(d / d.norm(dim=0))
    t_max = torch.from_numpy(g.uniform(0.0, 3.0, m).astype(np.float32))
    active = torch.from_numpy(g.uniform(size=m) > 0.2)
    alive, tests = active.clone(), 0
    for k in range(tb.num_tris):
        tests += int(alive.sum())
        tri = [tuple(getattr(tb, f"v{c}{a}")[k] for a in "xyz")
               for c in range(3)]
        alive &= ~moller_trumbore_soa(o, d, *tri, 1e-3, t_max)[0]
    assert any_hit_tests(o, d, tb, 1e-3, t_max, active) == tests
    assert int(active.sum()) * 1 < tests < int(active.sum()) * tb.num_tris

    cfg = T.RenderConfig(**dict(K1_BASE, use_nee=True, use_mis=True))
    table = scene_table(tb)
    args = dict(cfg=cfg, num_tris=tb.num_tris, global_shape=(H, W),
                npix=H * W, has_mirrors=False,
                lights=t_lights.build_light_table_from_buffers(tb))
    counts = {}
    got = regen_render_plain(table, 1, 0, counts=counts, **args)
    want = regen_render_plain(table, 1, 0, **args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert 0 < counts["shadow_rays"] < int(got[3].sum())
    assert (counts["shadow_rays"] <= counts["shadow_tests"]
            <= counts["shadow_rays"] * tb.num_tris)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nee", "mis", "mirror_mis", "lights80"])
def test_cuda_k1_nee_matches_twin(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    _, tb, kw = _k1_case(case)
    kw.update(width=64, height=48, max_depth=8)
    cfg = T.RenderConfig(**kw)
    gpu_tb = type(tb)(*(getattr(tb, k).cuda() for k in tb._fields[:-1]),
                      num_tris=tb.num_tris)
    cpu = make_regen_render_step(cfg, tb)(T.init_state(48, 64, "cpu"))
    gpu = make_regen_render_step(cfg, gpu_tb)(T.init_state(48, 64, "cuda"))
    assert_close(gpu.accum.cpu().numpy(), cpu.accum.numpy(),
                 f"K1 NEE CUDA vs twin ({case})", rel=1e-4, max_abs=0.1)


def test_mirror_scene_has_mirror_faces():
    """The mirror Cornell Box of these tests has mirrors (mtype 1) and
    the Cornell Box's two emissive triangles."""
    tris, kd, ke, ks, mt = mirror_scene_arrays()
    assert (mt == 1).sum() > 0 and (np.asarray(ke).max(1) > 0).sum() == 2
