"""K4, the any-hit shadow-ray trace, and next-event estimation on the
large-scene routes, against sfvp_tpu: K4's plain twin
(kernels/bvh_packet.py packet_occlusion_plain) against the JAX K4 Pallas
kernel make_packet_occlusion in interpret mode and against closest-hit
oracles; the wavefront loop over K3's and K4's twins against sfvp_tpu's
over its K3 and K4 kernels (make_render_step(trace_payload_fn=...,
occlusion_fn=...)), with the ray sort on and off; and K5's twin with NEE
and MIS against the JAX K5 kernel in interpret mode, on the Cornell Box
(traversal="bvh") and a 2k-triangle city with emissive rooftops.

Bounds: occlusion is a yes-or-no answer that does not depend on the order
in which nodes are visited, so K4's twin equals JAX's K4 and the oracles
on every ray. Images: relative RMSE < 1e-5 and max abs < 1e-4 (ROADMAP.md
§C), traced segments equal.

The ``cuda`` tests hold the CUDA kernels against their twins and skip
without a card; chip_smoke.py runs the same comparisons on the H100.
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
from sfvp_tpu.integrate.wavefront import make_render_step as j_make  # noqa: E402
from sfvp_tpu.kernels.bvh_packet import (  # noqa: E402
    make_packet_occlusion as j_occlusion,
    make_packet_trace as j_packet,
)
from sfvp_tpu.kernels.intersect import trace_brute_jnp  # noqa: E402
from sfvp_tpu.kernels.megakernel_bvh import (  # noqa: E402
    make_bvh_regen_render_step as j_k5,
)
from sfvp_tpu.scene import procedural as j_proc  # noqa: E402

import sfvp_tpu_torch as T  # noqa: E402
from sfvp_tpu_torch.accel.wide import build_wide_from_buffers  # noqa: E402
from sfvp_tpu_torch.dispatch import select_render_step  # noqa: E402
from sfvp_tpu_torch.kernels import build  # noqa: E402
from sfvp_tpu_torch.kernels.bvh_packet import (  # noqa: E402
    DeviceWide,
    device_wide,
    make_packet_occlusion,
    packet_occlusion,
    packet_occlusion_plain,
    ray_planes,
)
from sfvp_tpu_torch.kernels.intersect import trace_brute  # noqa: E402
from sfvp_tpu_torch.kernels.megakernel_bvh import (  # noqa: E402
    make_bvh_regen_render_step,
)
from sfvp_tpu_torch.scene import procedural as t_proc  # noqa: E402
from sfvp_tpu_torch.scene.buffers import FIELDS, from_numpy  # noqa: E402

from test_torch_integrator import assert_close, mirror_scene_arrays  # noqa: E402

T_MIN = 1e-3
H, W = 8, 16
NEE_MIS = dict(sampling="cosine", use_rr=True, rr_start_depth=1,
               use_nee=True, use_mis=True)
CITY_VIEW = dict(origin=(13.0, 9.0, 13.0), target=(0.0, 0.8, 0.0),
                 fov_y_deg=55.0)
# a city of about 2k triangles (22 buildings, subdiv 3) with a few
# emissive rooftops
CITY_KW = dict(n_buildings=22, subdiv=3, emissive_frac=0.3, seed=1)


def _jax_scene(name):
    if name == "cornell":
        return J.upload(J.load_obj(native="never")), None
    if name == "mirror":
        return J.scene.buffers.from_arrays(*mirror_scene_arrays()), None
    if name == "soup":
        g = np.random.default_rng(3)
        n = 200
        tris = (g.uniform(-5, 5, (n, 1, 3))
                + g.normal(0, 0.8, (n, 3, 3))).astype(np.float32)
        return J.scene.buffers.from_arrays(
            tris, g.uniform(0, 1, (n, 3)).astype(np.float32),
            g.uniform(0, 1, (n, 3)).astype(np.float32)), None
    return J.upload(j_proc.city_mesh(**CITY_KW)), CITY_VIEW


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
        assert np.array_equal(jw.nodes, tw.nodes)
        _CACHE[name] = (jb, tb, jw, tw, view)
    return _CACHE[name]


def _shadow_rays(m, seed, spread):
    """Random shadow rays: origins in the scene's box, unit directions,
    t_max in (0, 2 spread) with a tenth at 0 or below (no walk), a fifth
    inactive."""
    g = np.random.default_rng(seed)
    o = g.uniform(-spread, spread, (m, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) * 0.5
    d = g.normal(size=(m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = g.uniform(0, 2 * spread, m).astype(np.float32)
    tmax[: m // 10] = g.uniform(-1, T_MIN, m // 10)
    active = g.uniform(size=m) > 0.2
    return o, d, tmax, active


def _cols(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                 for i in range(3))


def _jcols(a):
    return tuple(jnp.asarray(np.ascontiguousarray(a[:, i]))
                 for i in range(3))


@pytest.mark.parametrize("name", ["soup", "city"])
def test_k4_twin_matches_jax_k4_and_brute_force(name):
    """On every ray: K4's twin, sfvp_tpu's K4 (interpret mode), and the
    closest-hit oracles occluded <=> trace_brute(..., t_max).prim >= 0 of
    both packages."""
    jb, tb, jw, tw, _ = scene(name)
    spread = 6.0 if name == "soup" else 10.0
    o, d, tmax, active = _shadow_rays(2048, seed=21, spread=spread)
    want = np.asarray(j_occlusion(jw, t_min=T_MIN, interpret=True)(
        _jcols(o), _jcols(d), jnp.asarray(tmax),
        active=jnp.asarray(active)))
    act = torch.from_numpy(active)
    got = make_packet_occlusion(device_wide(tw, "cpu"), T_MIN)(
        _cols(o), _cols(d), torch.from_numpy(tmax), active=act).numpy()
    np.testing.assert_array_equal(got, want)
    assert 100 < got.sum() < act.sum() - 100
    brute = trace_brute(_cols(o), _cols(d), tb, T_MIN,
                        torch.from_numpy(tmax), active=act).prim >= 0
    np.testing.assert_array_equal(got, brute.numpy())
    jbrute = np.asarray(trace_brute_jnp(jnp.asarray(o), jnp.asarray(d), jb,
                                        T_MIN, jnp.asarray(tmax)).prim) >= 0
    np.testing.assert_array_equal(got, jbrute & active)


def test_k4_twin_retires_rays_on_their_first_hit():
    """The twin counts its pops: a ray stops at its first hit, so an
    any-hit walk to t_max never pops more than the closest-hit walk of
    the same rays, and an inactive wave pops nothing."""
    from sfvp_tpu_torch.kernels.bvh_packet import packet_trace_plain

    _, _, _, tw, _ = scene("city")
    o, d, _, _ = _shadow_rays(1024, seed=22, spread=10.0)
    dw = device_wide(tw, "cpu")
    rays = ray_planes(_cols(o), _cols(d), 1e4)
    any_hit, closest = {}, {}
    occ = packet_occlusion_plain(dw, T_MIN, rays, any_hit)
    pay = packet_trace_plain(dw, T_MIN, rays, closest)
    assert torch.equal(occ, torch.isfinite(pay[0]))
    assert any_hit["leaf_pops"] < closest["leaf_pops"]
    none = {}
    dead = ray_planes(_cols(o), _cols(d), 1e4,
                      active=torch.zeros(1024, dtype=torch.bool))
    assert not packet_occlusion_plain(dw, T_MIN, dead, none).any()
    assert none.get("node_pops", 0) == 0


def test_cpu_k4_runs_twin_and_counts_no_launch():
    _, _, _, tw, _ = scene("soup")
    dw = device_wide(tw, "cpu")
    o, d, tmax, active = _shadow_rays(256, seed=23, spread=6.0)
    rays = ray_planes(_cols(o), _cols(d), torch.from_numpy(tmax),
                      torch.from_numpy(active))
    before = packet_occlusion.launches
    got = packet_occlusion(dw, T_MIN, rays)
    assert got.dtype == torch.bool and got.shape == (256,)
    assert torch.equal(got, packet_occlusion_plain(dw, T_MIN, rays))
    assert packet_occlusion.launches == before


def test_k4_refuses_what_it_cannot_take():
    """A tensor that is not on the CPU never reaches the twin, bad planes
    and an oversized wave raise before a launch."""
    dw = DeviceWide(nodes=torch.empty((4, 128), device="meta"),
                    tris=torch.empty((4, 128), device="meta"), max_stack=26)
    with pytest.raises(ValueError, match="CUDA tensor"):
        packet_occlusion(dw, T_MIN, torch.empty((7, 16), device="meta"))
    with pytest.raises(ValueError, match="7, N"):
        packet_occlusion(dw, T_MIN, torch.empty((6, 16), device="meta"))
    with pytest.raises(ValueError, match="fewer than"):
        build.launch_bvh_occlusion(
            None, torch.empty((7, build.MAX_WAVE_RAYS), device="meta"))


def configs(kw, view):
    """The same RenderConfig in both packages (traversal="bvh"; the sky of
    the CLI's procedural scenes when there is a view)."""
    kw = dict(width=W, height=H, spp_per_step=2, max_depth=3,
              traversal="bvh", **kw)
    out = []
    for mod in (J, T):
        extra = {}
        if view is not None:
            extra = dict(camera=mod.CameraConfig.look_at(**view),
                         sky_emission=(0.8, 0.85, 1.0))
        out.append(mod.RenderConfig(**kw, **extra))
    return out


def _run(step, steps=1):
    st = T.init_state(H, W, "cpu")
    for _ in range(steps):
        st = step(st)
    return st


@pytest.mark.parametrize("name", ["city", "mirror"])
def test_payload_route_with_k4_matches_jax(name):
    """The wavefront loop over K3's and K4's twins, NEE + MIS, with the
    ray sort on and off, against sfvp_tpu's loop over its K3 and K4
    kernels; the sort never changes a bit of the image."""
    jb, tb, jw, tw, view = scene(name)
    jcfg, tcfg = configs(dict(NEE_MIS, megakernel_regen=False), view)
    want = jax.jit(j_make(
        jcfg, jb, trace_payload_fn=j_packet(jw, t_min=jcfg.t_min,
                                            interpret=True),
        occlusion_fn=j_occlusion(jw, t_min=jcfg.t_min, interpret=True)))(
        J.init_state(H, W))
    got = {}
    for sort in (True, False):
        cfg = dataclasses.replace(tcfg, sort_bounce_rays=sort)
        got[sort] = _run(select_render_step(cfg, tb, wide=tw))
        assert_close(got[sort].accum.numpy(), np.asarray(want.accum),
                     f"payload route + K4 vs jax ({name}, sort={sort})")
        assert float(got[sort].mrays) == float(want.mrays)
    assert torch.equal(got[True].accum, got[False].accum)
    assert float(got[False].accum.max()) > 0


@pytest.mark.parametrize("name,kw", [
    ("cornell", dict(NEE_MIS, use_mis=False)), ("cornell", NEE_MIS),
    ("city", NEE_MIS)], ids=["cornell-nee", "cornell-mis", "city-mis"])
def test_k5_twin_with_nee_matches_jax_k5(name, kw):
    jb, tb, jw, tw, view = scene(name)
    jcfg, tcfg = configs(kw, view)
    want = jax.jit(j_k5(jcfg, jb, wide=jw, interpret=True))(
        J.init_state(H, W))
    got = _run(make_bvh_regen_render_step(tcfg, tb, device_wide(tw, "cpu")))
    assert_close(got.accum.numpy(), np.asarray(want.accum),
                 f"K5 twin vs jax K5 ({name}, NEE)")
    assert float(got.mrays) == float(want.mrays), "traced segments differ"


@pytest.mark.parametrize("mis", [False, True], ids=["nee", "mis"])
def test_k5_twin_equals_k1_twin_with_nee(mis):
    """K5 on the Cornell Box with traversal="bvh" against K1 by brute
    force, NEE (and MIS) on: the same streams, closest hits and shadow
    answers, so the same image."""
    from sfvp_tpu_torch.kernels.megakernel_regen import make_regen_render_step

    _, tb, _, tw, _ = scene("mirror")
    cfg = T.RenderConfig(width=W, height=H, spp_per_step=3, max_depth=4,
                         **dict(NEE_MIS, use_mis=mis))
    k1 = _run(make_regen_render_step(cfg, tb), steps=2)
    k5 = _run(make_bvh_regen_render_step(
        dataclasses.replace(cfg, traversal="bvh"), tb,
        device_wide(tw, "cpu")), steps=2)
    assert_close(k5.accum.numpy(), k1.accum.numpy(), "K5 vs K1 with NEE",
                 rel=1e-6, max_abs=1e-6)
    assert float(k5.mrays) == float(k1.mrays)


def test_city_scene_matches_jax_and_has_lights():
    city_t = t_proc.city_mesh(**CITY_KW)
    city_j = j_proc.city_mesh(**CITY_KW)
    assert np.array_equal(city_t.vertices, city_j.vertices)
    lit = (np.asarray(city_t.face_emission) > 0).any(1).sum()
    assert 1500 < city_t.num_triangles < 2500 and lit >= 18


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["soup", "city"])
def test_cuda_k4_matches_twin(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    _, _, _, tw, _ = scene(name)
    o, d, tmax, active = _shadow_rays(8192, seed=24, spread=10.0)
    rays = ray_planes(_cols(o), _cols(d), torch.from_numpy(tmax),
                      torch.from_numpy(active))
    got = packet_occlusion(device_wide(tw, "cuda"), T_MIN, rays.cuda())
    want = packet_occlusion_plain(device_wide(tw, "cpu"), T_MIN, rays)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_k5_nee_matches_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    _, tb, _, tw, view = scene("city")
    _, cfg = configs(dict(NEE_MIS, max_depth=8), view)
    cfg = dataclasses.replace(cfg, width=64, height=48)
    gpu_tb = type(tb)(*(getattr(tb, k).cuda() for k in tb._fields[:-1]),
                      num_tris=tb.num_tris)
    cpu = make_bvh_regen_render_step(cfg, tb, device_wide(tw, "cpu"))(
        T.init_state(48, 64, "cpu"))
    gpu = make_bvh_regen_render_step(cfg, gpu_tb, device_wide(tw, "cuda"))(
        T.init_state(48, 64, "cuda"))
    assert_close(gpu.accum.cpu().numpy(), cpu.accum.numpy(),
                 "K5 NEE CUDA vs twin", rel=1e-5, max_abs=1e-4)
